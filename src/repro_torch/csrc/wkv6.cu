// wkv6: the RWKV6 WKV recurrence, chunkwise, with an initial state:
//
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T          (w_t = exp(w_log_t))
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//
// r, k, v (B, H, T, C) fp32 or bf16; w_log (B, H, T, C) fp32, <= 0; u (H, C)
// fp32; s0 (B, H, C, C) fp32. Writes out (B, H, T, C) fp32 and the final
// state s_T (B, H, C, C) fp32.
//
// Replaces `_wkv6_kernel` (src/repro/kernels/wkv6.py:36, launched by
// `wkv6_pallas` at :87), which started from a zero state, returned no final
// state and needed T % chunk == 0; the model path (`rwkv.wkv6_chunked`,
// src/repro/models/rwkv.py:80) needs both states. The function does not
// depend on the chunk size, so the kernels tile with their own chunk of
// L = 64 steps whatever chunk the caller names. Within a chunk, with
// lp = cumsum(w_log) (inclusive) and lp_prev = lp - w_log (exclusive), both
// non-increasing in t (summed from the chunk's start, or from the one
// before it, see "Rounding" below), and lp_start their value at the step
// before the chunk (0 where the sum starts at the chunk):
//
//   out = (r * exp(lp_prev - lp_start)) @ S_start + A @ V
//   A[t, s] = sum_c r_tc k_sc exp(lp_prev_tc - lp_sc)   (s < t)
//   A[t, t] = sum_c r_tc u_c k_tc
//   S_end   = diag(exp(lp_L)) S_start + (K * exp(lp_L - lp))^T V
//
// Three launches, all on the caller's stream:
//  (a) `wkv6_state`, grid (chunks, B*H): each chunk's local state
//      dS_j = (K * exp(lp_L - lp))^T V and lp_L, its total log-decay, into
//      the wrapper's scratch (B, H, chunks, C, C) and (B, H, chunks, C);
//  (b) `wkv6_scan`, a thread per (b, h, c, 4 d): S_{j+1} = diag(exp(lp_L,j))
//      S_j + dS_j from s0, in fp32, in order over j; it overwrites dS_j with
//      S_j, the chunk's start state, and writes s_T;
//  (c) `wkv6_out`, grid (chunks, B*H): out of each chunk from S_j.
// At B = 1, H = 64, T = 4096 that is 4,096 CTAs in (a) and (c), where one
// CTA per (b, h) walking the chunks in order filled 64 of the 132 SMs.
//
// Overflow. w_log reaches -exp(4) a step, so lp falls to about -3500 over
// a chunk of 64: the whole-chunk factorised form (r e^{lp_prev})(k e^{-lp})^T
// overflows fp32. It is factorised per sub-chunk of 16 steps instead. For
// t in sub-chunk J, s in an earlier sub-chunk, and ref = lp_{start(J)-1}:
//
//   A[t, s] = sum_c (r_tc e^{lp_prev_tc - ref_c}) (k_sc e^{ref_c - lp_sc})
//
// lp is non-increasing and s <= start(J) - 1 <= t - 1, so
// lp_prev_t <= ref <= lp_s: both exponents are <= 0 (up to one rounding of
// lp, which the clamp at 0 takes) and no factor exceeds 1.
// A factor that underflows to 0 stands for a product that is smaller still
// (the other factor is at most 1), so nothing is lost that the pairwise form
// would keep above 2^-126. Every other exponent here (lp_prev - lp_start,
// lp_L - lp, lp_L) is <= 0 as well. Inside a 16 x 16 diagonal block the
// same argument takes its lower-left 8 x 8 quadrant (ref = lp at the
// block's 8th step), so only the 8 x 8 diagonal blocks keep the pairwise
// exp(min(lp_prev_t - lp_s, 0)), on the CUDA cores, with the u bonus on
// the diagonal: 8 blocks of 28 pairs a chunk instead of 2,016 pairs.
//
// Tensor cores at fp32 accuracy. The products q_dec @ S, the off-diagonal
// A blocks, A @ V and the dS product run as `mma.sync.m16n8k8` TF32 with
// split precision (CUTLASS's 3xTF32): x = hi + lo, each a TF32 number, and
// a_lo b_hi + a_hi b_lo + a_hi b_hi summed in fp32, which keeps about 21 of
// the 24 mantissa bits where one TF32 pass keeps 10 (the card check holds
// out and s_T at 1e-4 of their max). bf16 inputs are exact in TF32, so with
// bf16 v the terms of v_lo are dropped (two products instead of three).
// A @ V reads A's fragments from shared memory with the k index of the
// m16n8k8 product permuted (k = q <-> s = 2q, k = q + 4 <-> s = 2q + 1), so
// a thread's two columns are one 8-byte load; V's B fragment reads rows 2q
// and 2q + 1 to match. The dS product reads K and V the same way.
//
// Exponentials are ex2.approx.ftz(min(x, 0) * log2(e)): relative error
// about 2^-22 where the result matters, and every argument is <= 0, so a
// result that flushes to 0 is below 2^-126.
//
// Rounding of the cumulative sums. The card holds out and s_T to the plain
// version (`wkv6_plain`, the reference's `wkv6_chunked` formulas) at 1e-4
// of their max, also with every w_log at the +4 clip (-e^4 a step). There
// the plain version's lp_prev = lp - w_log, at |lp| up to ~7000 over its
// chunk of 128, moves the adjacent step's decay, exactly exp(0), by up to
// one ulp of lp (2^-11), and that term carries most of out: an exact
// lp_prev (lp of the step before) would differ from the plain version by
// about as much as the tolerance. So lp is summed as torch.cumsum sums it,
// one thread a column adding in series in fp32 from the start of the plain
// version's block, and lp_prev is lp - w_log; every exponent is a
// difference of those values, clamped at 0 as the plain version clamps.
// With a block of 128 steps (the rwkv6 model's chunk), an odd chunk of
// (c) starts its sum at the lp_L of the chunk before it (`pairs`); the
// wrapper names the frame (`cumsum_frame`). The series costs 64 dependent
// adds a column a chunk, in (a) and (c), while the CTA's other warps wait
// and the SM's other CTAs compute.
//
// Loads: r, k, v, w_log, u and S_start go by cp.async (16 bytes a thread)
// into shared memory in three groups, w_log and u first, so the cumulative
// sum starts while r, k, v are in flight, and A is built while S_start is
// in flight. The tail chunk's rows past T are zero-filled (w_log = 0,
// k = 0 leave the state and the decays unchanged) and never stored. A
// chunk's tiles are not double-buffered across chunks inside a CTA: at
// 97.5 KB a CTA ((c), bf16, C = 64) two CTAs of 8 warps share an SM, and
// one CTA's loads overlap the other's products; a second stage would cut
// that to one CTA an SM.
//
// Work split. (a): 4 warps, each 16 rows c of dS (all d), k over the 64
// steps. (c): 8 warps, two to each sub-chunk J. Warp (J, 1) builds A's
// off-diagonal blocks (s < 16 J) and the diagonal block's lower-left
// quadrant by mma; warp (J, 0) the two 8 x 8 pairwise blocks, their 56
// pairs and 16 bonuses spread over its lanes, four columns a load. A goes
// through shared memory; after a barrier each warp of the pair computes
// half of the 16 x C output tile, A @ V then q_dec @ S. Shared rows are
// padded (r, k, v, lp by 4 words, or 8 bf16; S and A by 8 words) so that
// the fragment reads are free of bank conflicts.
//
// Bound on the H100 at B = 1, H = 64, T = 4096, C = 64, bf16: one read of
// r, k, v, w_log, u, s0 and one write of out and s_T is 237 MB, 0.071 ms at
// 3.35 TB/s, and that is the bound: the recurrence's ~5 C^2 operations a
// token and head, three times over on the TF32 tensor cores (3xTF32, 495
// TFLOP/s), take 0.033 ms. At 67 TFLOP/s in fp32, the rate the former
// one-CTA-per-(b, h) kernel was held to, they take 0.080 ms; chip_smoke
// reports that term beside the bound so that the two compare. The split
// adds the scratch's round trip: dS written by (a), read and overwritten
// by (b), read by (c), 4 x 64 MiB.
#include <type_traits>

#include "wkv6_common.cuh"

namespace {

constexpr int NT = 32 * NW;     // (a): a warp a sub-chunk
constexpr int NT_OUT = 2 * NT;  // (c): two warps a sub-chunk
constexpr int AP = L + 8;       // pitch of A in shared memory

// (a) dS = (K * exp(lp_L - lp))^T V and lp_L (lp from the chunk's start) of
// chunk blockIdx.x of (b, h) = blockIdx.y
template <typename E, int C>
__global__ void __launch_bounds__(NT)
wkv6_state(const E* __restrict__ k, const E* __restrict__ v,
           const float* __restrict__ w, float* __restrict__ ds,
           float* __restrict__ lp_end, int T) {
  using Ti = Tile<E, C>;
  constexpr int PE = Ti::PE, PL = Ti::PL, NC = C / 8;
  constexpr bool EXACT = std::is_same<E, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  E* ks = reinterpret_cast<E*>(smem);
  E* vs = reinterpret_cast<E*>(smem + Ti::RKV);
  float* lp = reinterpret_cast<float*>(smem + 2 * Ti::RKV);

  const int j = blockIdx.x, bh = blockIdx.y, nch = gridDim.x;
  const int c0 = j * L, lc = min(L, T - c0);
  const int64_t base = (static_cast<int64_t>(bh) * T + c0) * C;
  load_rows<C>(lp, PL, w + base, L, lc);
  cp_commit();
  load_rows<C>(ks, PE, k + base, L, lc);
  load_rows<C>(vs, PE, v + base, L, lc);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  cumsum<C>(lp, nullptr, nullptr);
  cp_wait<0>();
  __syncthreads();

  const float* last = lp + (L - 1) * PL;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  float* out = ds + (static_cast<int64_t>(bh) * nch + j) * C * C;
  for (int m = warp; m < C / 16; m += NW) {       // rows c of dS
    const int ca = 16 * m + g, cb = ca + 8;
    const float la = last[ca], lb = last[cb];
    float acc[NC][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < L / 8; ++kk) {          // steps s, permuted
      const int s = 8 * kk + 2 * q;
      const float* l0 = lp + s * PL;
      const E* k0 = ks + s * PE;
      FragA a;
      a.set(to_f(k0[ca]) * expn(la - l0[ca]), to_f(k0[cb]) * expn(lb - l0[cb]),
            to_f(k0[PE + ca]) * expn(la - l0[PL + ca]),
            to_f(k0[PE + cb]) * expn(lb - l0[PL + cb]));
#pragma unroll
      for (int nt = 0; nt < NC; ++nt) {
        const E* v0 = vs + s * PE + 8 * nt + g;
        FragB b;
        b.set<EXACT>(to_f(v0[0]), to_f(v0[PE]));
        mma3<EXACT>(acc[nt], a, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NC; ++nt) {
      const int d = 8 * nt + 2 * q;
      *reinterpret_cast<float2*>(out + ca * C + d) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(out + cb * C + d) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  if (threadIdx.x < C)
    lp_end[(static_cast<int64_t>(bh) * nch + j) * C + threadIdx.x] =
        last[threadIdx.x];
}

// (b) S_0 = s0; S_{j+1} = diag(exp(lp_end_j)) S_j + dS_j; st[j] <- S_j; s_T.
template <int C>
__global__ void __launch_bounds__(256)
wkv6_scan(float* __restrict__ st, const float* __restrict__ lp_end,
          const float* __restrict__ s0, float* __restrict__ s_out, int nch,
          int64_t total) {
  scan_chunks<C, false>(st, lp_end, s0, s_out, nch, total);
}

// (c) out of chunk blockIdx.x of (b, h) = blockIdx.y from its start state.
// With `pairs`, an odd chunk continues the cumulative sum of the chunk
// before it (lp_end), so lp runs over frames of 2 L steps, as the plain
// version's does at its chunk of 128. Two warps to a sub-chunk J: warp
// (J, 0) builds the diagonal block's pairwise entries, warp (J, 1) the
// factorised rest of A's row block; after a barrier each takes half of
// the output columns for A @ V and q_dec @ S.
template <typename E, int C>
__global__ void __launch_bounds__(NT_OUT)
wkv6_out(const E* __restrict__ r, const E* __restrict__ k,
         const E* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, const float* __restrict__ st,
         const float* __restrict__ lp_end, float* __restrict__ out, int H,
         int T, bool pairs) {
  using Ti = Tile<E, C>;
  constexpr int PE = Ti::PE, PL = Ti::PL, PS = Ti::PS, NH = C / 16;
  constexpr bool EXACT = std::is_same<E, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  E* rs = reinterpret_cast<E*>(smem);
  E* ks = reinterpret_cast<E*>(smem + Ti::RKV);
  E* vs = reinterpret_cast<E*>(smem + 2 * Ti::RKV);
  float* lp = reinterpret_cast<float*>(smem + 3 * Ti::RKV);
  float* lpp = lp + L * PL;
  float* ss = lpp + L * PL;
  float* as = ss + C * PS;        // A (L x L, lower triangle), pitch AP
  float* us = as + L * AP;
  float* bs = us + C;             // lp at the chunk's start - 1 (0 or lp_end)

  const int j = blockIdx.x, bh = blockIdx.y, nch = gridDim.x;
  const int c0 = j * L, lc = min(L, T - c0);
  const int64_t base = (static_cast<int64_t>(bh) * T + c0) * C;
  load_rows<C>(lp, PL, w + base, L, lc);
  load_rows<C>(us, C, u + (bh % H) * C, 1, 1);
  if (pairs && (j & 1))
    load_rows<C>(bs, C, lp_end + (static_cast<int64_t>(bh) * nch + j - 1) * C,
                 1, 1);
  else
    load_rows<C>(bs, C, lp_end, 1, 0);            // zero-fill
  cp_commit();
  load_rows<C>(rs, PE, r + base, L, lc);
  load_rows<C>(ks, PE, k + base, L, lc);
  load_rows<C>(vs, PE, v + base, L, lc);
  cp_commit();
  load_rows<C>(ss, PS, st + (static_cast<int64_t>(bh) * nch + j) * C * C, C,
               C);
  cp_commit();
  cp_wait<2>();
  __syncthreads();
  cumsum<C>(lp, lpp, bs);
  cp_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int J = warp / 2, half = warp % 2;
  const int g = lane / 4, q = lane % 4;
  const int t0 = SUB * J + g, t1 = t0 + 8;         // this thread's rows
  const float* p0 = lpp + t0 * PL;
  const float* p1 = lpp + t1 * PL;
  const E* r0 = rs + t0 * PE;
  const E* r1 = rs + t1 * PE;
  float* a0row = as + t0 * AP;
  float* a1row = as + t1 * AP;

  if (half == 1) {
    // A[t, s] for s < SUB J by the sub-chunk factorisation, ref =
    // lp_{SUB J - 1}; then the diagonal block's lower-left quadrant (rows
    // t1, s in SUB J + [0, 8)) the same way, ref = lp_{SUB J + 7}, with the
    // fragment's rows t0 zero.
    if (J > 0) {
      float aa[2 * (NW - 1)][4] = {};
      const float* ref = lp + (SUB * J - 1) * PL;
#pragma unroll 2
      for (int kk = 0; kk < C / 8; ++kk) {
        const int ca = 8 * kk + q, cb = ca + 4;
        const float fa = ref[ca], fb = ref[cb];
        FragA a;
        a.set(to_f(r0[ca]) * expn(p0[ca] - fa),
              to_f(r1[ca]) * expn(p1[ca] - fa),
              to_f(r0[cb]) * expn(p0[cb] - fb),
              to_f(r1[cb]) * expn(p1[cb] - fb));
#pragma unroll
        for (int nt = 0; nt < 2 * (NW - 1); ++nt) {
          if (nt < 2 * J) {
            const int s = 8 * nt + g;
            const E* kr = ks + s * PE;
            const float* lr = lp + s * PL;
            FragB b;
            b.set(to_f(kr[ca]) * expn(fa - lr[ca]),
                  to_f(kr[cb]) * expn(fb - lr[cb]));
            mma3<false>(aa[nt], a, b);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2 * (NW - 1); ++nt) {
        if (nt < 2 * J) {
          const int s = 8 * nt + 2 * q;
          *reinterpret_cast<float2*>(a0row + s) =
              make_float2(aa[nt][0], aa[nt][1]);
          *reinterpret_cast<float2*>(a1row + s) =
              make_float2(aa[nt][2], aa[nt][3]);
        }
      }
    }
    float qd[4] = {};
    const float* ref = lp + (SUB * J + 7) * PL;
    const int s = SUB * J + g;
    const E* kr = ks + s * PE;
    const float* lr = lp + s * PL;
#pragma unroll 2
    for (int kk = 0; kk < C / 8; ++kk) {
      const int ca = 8 * kk + q, cb = ca + 4;
      const float fa = ref[ca], fb = ref[cb];
      FragA a;
      a.set(0.0f, to_f(r1[ca]) * expn(p1[ca] - fa), 0.0f,
            to_f(r1[cb]) * expn(p1[cb] - fb));
      FragB b;
      b.set(to_f(kr[ca]) * expn(fa - lr[ca]), to_f(kr[cb]) * expn(fb - lr[cb]));
      mma3<false>(qd, a, b);
    }
    *reinterpret_cast<float2*>(a1row + SUB * J + 2 * q) =
        make_float2(qd[2], qd[3]);
  } else {
    // The diagonal block's two 8 x 8 diagonal blocks, pairwise: 2 x 28
    // pairs s < t and the 16 u bonuses, spread over the lanes (slots 0 and
    // 1: pair e = lane + 32 i of the 56, block e / 28; slot 2: the bonus of
    // row lane, lanes < 16), summed over c four columns at a time. The
    // block's upper-right quadrant and the pairs' upper triangles are 0.
    float* blk = as + SUB * J * AP + SUB * J;
#pragma unroll
    for (int i = 0; i < SUB * SUB / 32; ++i) {
      const int e = lane + 32 * i, row = e / SUB, col = e % SUB;
      if (row < 8 || col >= 8) blk[row * AP + col] = 0.0f;
    }
    float sum[3] = {0.0f, 0.0f, 0.0f};
    int tr[2], sc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = lane + 32 * i, pi = e % 28;
      int t = 1;
      while (t * (t + 1) / 2 <= pi) ++t;       // pair pi: (t, pi - t(t-1)/2)
      const int off = e < 56 ? 8 * (e / 28) : 0;
      tr[i] = off + t;
      sc[i] = off + pi - t * (t - 1) / 2;
    }
    const bool has1 = lane < 24, has2 = lane < SUB;
    const int td = lane % SUB;
    const int row0 = SUB * J;
#pragma unroll 2
    for (int c = 0; c < C; c += 4) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 0 || has1) {
          const float4 rv = load4(rs + (row0 + tr[i]) * PE + c);
          const float4 kv = load4(ks + (row0 + sc[i]) * PE + c);
          const float4 pv = load4(lpp + (row0 + tr[i]) * PL + c);
          const float4 lv = load4(lp + (row0 + sc[i]) * PL + c);
          sum[i] = fmaf(rv.x * kv.x, expn(pv.x - lv.x), sum[i]);
          sum[i] = fmaf(rv.y * kv.y, expn(pv.y - lv.y), sum[i]);
          sum[i] = fmaf(rv.z * kv.z, expn(pv.z - lv.z), sum[i]);
          sum[i] = fmaf(rv.w * kv.w, expn(pv.w - lv.w), sum[i]);
        }
      }
      if (has2) {
        const float4 rv = load4(rs + (row0 + td) * PE + c);
        const float4 kv = load4(ks + (row0 + td) * PE + c);
        const float4 uv = load4(us + c);
        sum[2] = fmaf(rv.x * uv.x, kv.x, sum[2]);
        sum[2] = fmaf(rv.y * uv.y, kv.y, sum[2]);
        sum[2] = fmaf(rv.z * uv.z, kv.z, sum[2]);
        sum[2] = fmaf(rv.w * uv.w, kv.w, sum[2]);
      }
    }
    __syncwarp();                       // zeros before the entries
    blk[tr[0] * AP + sc[0]] = sum[0];
    if (has1) blk[tr[1] * AP + sc[1]] = sum[1];
    if (has2) blk[td * AP + td] = sum[2];
  }
  cp_wait<0>();
  __syncthreads();                      // A, and S, complete

  // out[:, half] = A @ V (A's k index permuted, see the note) + q_dec @ S
  float acc[NH][4] = {};
#pragma unroll
  for (int kk = 0; kk < NW * 2; ++kk) {            // A's column tiles
    if (kk <= 2 * J + 1) {
      const int s = 8 * kk + 2 * q;
      const float2 x0 = *reinterpret_cast<const float2*>(a0row + s);
      const float2 x1 = *reinterpret_cast<const float2*>(a1row + s);
      FragA a;
      a.set(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const E* v0 = vs + s * PE + 8 * (half * NH + n) + g;
        FragB b;
        b.set<EXACT>(to_f(v0[0]), to_f(v0[PE]));
        mma3<EXACT>(acc[n], a, b);
      }
    }
  }
#pragma unroll 2
  for (int kk = 0; kk < C / 8; ++kk) {
    const int ca = 8 * kk + q, cb = ca + 4;
    const float ba = bs[ca], bb = bs[cb];
    FragA a;
    a.set(to_f(r0[ca]) * expn(p0[ca] - ba), to_f(r1[ca]) * expn(p1[ca] - ba),
          to_f(r0[cb]) * expn(p0[cb] - bb), to_f(r1[cb]) * expn(p1[cb] - bb));
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const float* sr = ss + ca * PS + 8 * (half * NH + n) + g;
      FragB b;
      b.set(sr[0], sr[4 * PS]);
      mma3<false>(acc[n], a, b);
    }
  }
  float* o = out + base;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const int d = 8 * (half * NH + n) + 2 * q;
    if (t0 < lc)
      *reinterpret_cast<float2*>(o + t0 * C + d) =
          make_float2(acc[n][0], acc[n][1]);
    if (t1 < lc)
      *reinterpret_cast<float2*>(o + t1 * C + d) =
          make_float2(acc[n][2], acc[n][3]);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename E, int C>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0,
                   float* out, float* s_out, float* st, float* lp_end,
                   int B, int H, int T, bool pairs, cudaStream_t stream) {
  using Ti = Tile<E, C>;
  const int nch = (T + L - 1) / L;
  const dim3 grid(nch, B * H);
  const E* re = static_cast<const E*>(r);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const size_t smem_a = 2 * Ti::RKV + Ti::LP;
  const size_t smem_c =
      3 * Ti::RKV + 2 * Ti::LP + Ti::S + sizeof(float) * (L * AP + 2 * C);
  cudaError_t err = set_smem(wkv6_state<E, C>, smem_a);
  if (err != cudaSuccess) return err;
  err = set_smem(wkv6_out<E, C>, smem_c);
  if (err != cudaSuccess) return err;
  wkv6_state<E, C><<<grid, NT, smem_a, stream>>>(ke, ve, w, st, lp_end, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = static_cast<int64_t>(B) * H * C * C;
  wkv6_scan<C><<<static_cast<unsigned>((total / 4 + 255) / 256), 256, 0,
                 stream>>>(st, lp_end, s0, s_out, nch, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_out<E, C><<<grid, NT_OUT, smem_c, stream>>>(re, ke, ve, w, u, st, lp_end,
                                               out, H, T, pairs);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_c(int C, const void* r, const void* k, const void* v,
                       const float* w, const float* u, const float* s0,
                       float* out, float* s_out, float* st, float* lp_end,
                       int B, int H, int T, bool pairs, cudaStream_t s) {
  switch (C) {
    case 16:
      return launch<E, 16>(r, k, v, w, u, s0, out, s_out, st, lp_end, B, H, T,
                           pairs, s);
    case 64:
      return launch<E, 64>(r, k, v, w, u, s0, out, s_out, st, lp_end, B, H, T,
                           pairs, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v: 0 = fp32, 1 = bf16. C in {16, 64} (the reduced and the
// full rwkv6); B * H <= 65535. Every pointer 16-byte aligned. st (B, H,
// chunks, C, C) and lp_end (B, H, chunks, C) are fp32 scratch, and chunks
// must be ceil(T / L), L = 64. frame: 128 when the plain version's
// cumulative sums run over 128 steps (its chunk 128, or one chunk of all
// T > 64 steps), else 64.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const float* w, const float* u, const float* s0,
                          float* out, float* s_out, float* st, float* lp_end,
                          int dtype, int B, int H, int T, int C, int chunks,
                          int frame, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || T <= 0 || B * H > 65535 ||
      chunks != (T + L - 1) / L || (frame != L && frame != 2 * L))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pairs = frame == 2 * L;
  if (dtype == 0)
    err = dispatch_c<float>(C, r, k, v, w, u, s0, out, s_out, st, lp_end, B,
                            H, T, pairs, s);
  else if (dtype == 1)
    err = dispatch_c<__nv_bfloat16>(C, r, k, v, w, u, s0, out, s_out, st,
                                    lp_end, B, H, T, pairs, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
