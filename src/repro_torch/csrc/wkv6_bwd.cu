// wkv6_bwd: the gradient of the RWKV6 WKV recurrence (csrc/wkv6.cu)
//
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T          (w_t = exp(w_log_t))
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//
// from dout (B, H, T, C) and ds_T (B, H, C, C), chunk by chunk: the
// chunked mirror of the forward, with the same chunk of L = 64 steps, the
// same cumulative log-decays and the same products on the tensor cores.
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel, its
// gradient of `rwkv.wkv6_chunked` (src/repro/models/rwkv.py:80) comes from
// JAX's autodiff. It is the backward of the port's `wkv6` under autograd
// (kernels/wkv6.py), so that the ssm family trains on the card.
//
// The algebra. Inside chunk j, lp is the cumulative log-decay in the
// forward's frame (one or two chunks, summed in series as the forward's
// (c) sums it), lp_prev = lp - w_log, base the lp of the step before the
// chunk in its frame (0 at a frame's start), lp_L the chunk's last lp,
// S_j its start state (the forward's scratch), G_end = dL/dS after its
// last step, B = dO V^T and beta_t = B[t, t]:
//
//   dr = e^{lp_prev - base} (dO S_j^T) + intra_r + adj_r + u k beta
//   dk = e^{lp_L - lp} (V G_end^T)     + intra_k + adj_k + u r beta
//   dv = A^T dO + (K e^{lp_L - lp}) G_end
//   G_start = diag(e^{lp_L - base}) G_end + (R e^{lp_prev - base})^T dO
//
// with A the forward's matrix (the u bonus on its diagonal), intra_r[t] =
// sum_{s < t-1} B[t,s] k_s e^{lp_prev_t - lp_s}, intra_k[s] = sum_{t > s+1}
// B[t,s] r_t e^{lp_prev_t - lp_s}, and the adjacent pairs (s = t - 1)
// apart: adj_r[t] = B[t,t-1] k_{t-1} e^{lp_prev_t - lp_{t-1}}, adj_k[s] =
// B[s+1,s] r_{s+1} e^{lp_prev_{s+1} - lp_s}. G_end of the last chunk is
// ds_T; ds0 is G_start of chunk 0.
//
// dw_log sums each pair's term over the steps it spans: the term of a pair
// s < t belongs to dw_i for s < i < t. With Y = k e^{lp_L - lp} (V G_end^T)
// (the pairs of a step and the chunk's end), F = k intra_k, P = r
// (e^{lp_prev - base} (dO S_j^T) + intra_r) (the pairs of a step and a
// later one, or the chunk's start) and Z = e^{lp_L - base} sum_d S_j
// G_end (the start and the end),
//
//   dw_i = (Z + sum_{s<i} Y_s) - sum_{s>=i} F_s + sum_{t>i} P_t.
//
// An adjacent pair spans no step, so its term, which carries most of each
// gradient with every w_log at the +4 clip (the decays of farther pairs
// are below e^{-109} there), never enters dw at all: the form that adds
// dlp_prev = r (dr - u k beta) over t > i and subtracts dlp = k (dk - u r
// beta) over t >= i adds it once and takes it away once, in two roundings
// of about 6e-8 of max|dr|, as large as the check's 1e-6 of max(1, |dr|)
// over a chunk. du = sum over b and t of r k beta, in a fixed order.
//
// Five launches on the caller's stream, no atomics (two calls give the
// same bits):
//  (a) `wkv6_bwd_dstate`, grid (chunks, B*H), 4 warps: each chunk's local
//      dG_j = (R e^{lp_prev - base})^T dO into scratch (B, H, chunks, C,
//      C), and its decay lp_L - base into (B, H, chunks, C). An odd chunk
//      of a frame of two sums the chunk before it first, for its base.
//  (b) `wkv6_bwd_gscan`: the forward's `wkv6_scan` run backward
//      (wkv6_common.cuh, `scan_chunks`): G from ds_T, G_end,j written over
//      dG_j, each chunk's Z from the forward's S_j (B, H, chunks, C), and
//      ds0.
//  (c1) `wkv6_bwd_dkv`, grid (chunks, B*H), 8 warps, two to each
//      sub-chunk of 16 steps s: one builds A^T's row block and takes
//      A^T dO + (K e^{lp_L - lp}) G_end (dv); the other B^T's row block
//      (pairs t > s + 1), B^T (R e^{...}) (intra_k), V G_end^T, adj_k and
//      the bonus (dk), then Y and F summed over the steps within the warp
//      by shuffles and across the warps through shared memory: dw's part
//      (Z + sum Y) - sum F. The heavier sub-chunks (the L x L part shrinks
//      with J) share a scheduler with lighter ones.
//  (c2) `wkv6_bwd_drw`, the same grid, 8 warps, two to each sub-chunk of
//      16 steps t, each half of the columns: dO S_j^T, B's row block
//      (pairs s < t - 1) times (K e^{...}), adj_r and the bonus (dr); P
//      summed over t > i and added to dw; each chunk's partial du.
//  (d) `wkv6_bwd_du`: du as the sum over b and chunks of the partials.
// At B = 1, H = 64, T = 4096 that is 4,096 CTAs in (a), (c1) and (c2).
//
// Products and overflow: every L x C x C and L x L x C product (dG_j,
// dO S_j^T, V G_end^T, (K e) G_end, A^T and B^T's blocks, A^T dO, B' K,
// B'^T R) runs on mma.sync.m16n8k8 TF32 in split precision (3xTF32, as
// the forward, wkv6_common.cuh, but split by masks, `split_fast`): bf16
// r, k, v are exact in TF32, so the products with V as an operand drop
// their lo terms. The L x L blocks are factorised per sub-chunk as the
// forward's A is: for s in sub-chunk J' and t in a later one, with ref =
// lp at the end of J', A^T[s, t] = sum_c (k_s e^{ref - lp_s}) (r_t
// e^{lp_prev_t - ref}), and intra_k[s] = e^{ref - lp_s} sum_t B[t,s]
// (r_t e^{lp_prev_t - ref}); for t in sub-chunk J and s in an earlier
// one, ref = lp just before J, intra_r[t] = e^{lp_prev_t - ref} sum_s
// B[t,s] (k_s e^{ref - lp_s}). lp is
// non-increasing, so every exponent is <= 0 (up to one rounding of lp,
// which the clamp at 0 takes) and no factor exceeds 1 at the +4 clip,
// where lp falls by 3,500 over a chunk. Inside a 16 x 16 diagonal block
// the quadrant off the two 8 x 8 diagonal blocks is factorised the same
// way (ref = lp at the block's 8th step), and only the 8 x 8 diagonal
// blocks stay pairwise, on the CUDA cores; their B entries, beta and
// B[t, t-1] are fp32 dot products, 9 a row, in shared memory.
//
// Shared memory at C = 64, bf16: r, k, v, dO, lp, lp_prev and S_j (c2) or
// G_end (c1), with rows padded for conflict-free fragment reads: ~100 KB
// a CTA of (c1) or (c2), two CTAs of 8 warps an SM (at most 128 registers
// a thread, `__launch_bounds__(256, 2)`); fp32 r, k, v take 125 KB, one
// CTA an SM. A^T's and B's blocks stay in registers: a product's 16 x 8
// accumulator is the next product's A fragment when its k index is
// permuted (k = q <-> 2q, k = q + 4 <-> 2q + 1), as the forward's A @ V
// reads A. Tiles are loaded by cp.async in three groups (w_log, u and
// base first, so the cumulative sum starts while the rest is in flight).
//
// Bound on the H100 at B = 1, H = 64, T = 4096, C = 64: one read of r, k,
// v, w_log, u, dout and one write of dr, dk, dv, dw_log, du, ds0 (0.40 GB,
// 0.12 ms at 3.35 TB/s) bounds it; the recurrence's 14 C^2 operations a
// step and head, priced as the forward's are, three times over on the
// TF32 tensor cores at 495 TFLOP/s, take 0.09 ms. The split adds the
// scratch's round trip: dG written by (a), read and overwritten by (b),
// read by (c1); S_j read by (b) and (c2); dw written by (c1), read by
// (c2): ~6 x 64 MiB.
#include <type_traits>

#include "wkv6_common.cuh"

namespace {

constexpr int NT_A = 32 * NW;       // (a): 4 warps
constexpr int NT_C = 2 * 32 * NW;   // (c1), (c2): two warps a sub-chunk
constexpr int NB = 9;               // dot products a row, see `dots`

// x = hi + lo, both TF32, by masks: hi is x with its low 13 bits cleared
// and lo the remainder (exact in fp32) cleared the same way, so about 20
// of x's 24 bits are kept where the forward's rounding split (cvt.rna)
// keeps 21; two logic operations instead of two conversions made the
// kernels 0.12 ms faster at rwkv6's shape in bf16
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// a's fragment (rows g, g + 8; columns q, q + 4) split by `split_fast`;
// EXACT: the values are TF32 numbers already (bf16), lo is not used
template <bool EXACT = false>
__device__ __forceinline__ void seta(FragA& a, float a0, float a1, float a2,
                                     float a3) {
  if (EXACT) {
    a.hi[0] = __float_as_uint(a0);
    a.hi[1] = __float_as_uint(a1);
    a.hi[2] = __float_as_uint(a2);
    a.hi[3] = __float_as_uint(a3);
  } else {
    split_fast(a0, a.hi[0], a.lo[0]);
    split_fast(a1, a.hi[1], a.lo[1]);
    split_fast(a2, a.hi[2], a.lo[2]);
    split_fast(a3, a.hi[3], a.lo[3]);
  }
}

// b's fragment (rows q, q + 4; column g), as `seta`
template <bool EXACT = false>
__device__ __forceinline__ void setb(FragB& b, float b0, float b1) {
  if (EXACT) {
    b.hi[0] = __float_as_uint(b0);
    b.hi[1] = __float_as_uint(b1);
  } else {
    split_fast(b0, b.hi[0], b.lo[0]);
    split_fast(b1, b.hi[1], b.lo[1]);
  }
}

// d += a b at fp32 accuracy; A_EXACT: a's lo part is zero
template <bool A_EXACT>
__device__ __forceinline__ void mma3a(float (&d)[4], const FragA& a,
                                      const FragB& b) {
  if (!A_EXACT) mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// a 16 x 8 accumulator (rows g, g + 8; columns 2q, 2q + 1) as the A
// fragment of the next product, its k index permuted (k = q <-> 2q)
__device__ __forceinline__ void acc_as_a(FragA& a, const float (&x)[4]) {
  seta(a, x[0], x[2], x[1], x[3]);
}

// two consecutive values from shared memory, 8- (fp32) or 4-byte (bf16)
// aligned
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xffff0000u));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// bt[t * NB + i] <- do_t . v_s for s = 8 floor(t / 8) + i <= t (i < 8),
// and for i = 8 the pair (t, t - 1) across an 8-block boundary; 0 where
// there is no such pair. Each by one thread, in series over c.
template <typename E, int C>
__device__ __forceinline__ void dots(float* bt, const float* dos, int PO,
                                     const E* vs, int PE) {
  for (int e = threadIdx.x; e < L * NB; e += blockDim.x) {
    const int t = e / NB, i = e % NB;
    const int s = i < 8 ? 8 * (t / 8) + i : t - 1;
    const bool ok = i < 8 ? s <= t : (t % 8 == 0 && t > 0);
    float sum = 0.0f;
    if (ok) {
#pragma unroll 4
      for (int c = 0; c < C; c += 4) {
        const float4 dv = load4(dos + t * PO + c);
        const float4 vv = load4(vs + s * PE + c);
        sum = fmaf(dv.x, vv.x, sum);
        sum = fmaf(dv.y, vv.y, sum);
        sum = fmaf(dv.z, vv.z, sum);
        sum = fmaf(dv.w, vv.w, sum);
      }
    }
    bt[e] = sum;
  }
}

__device__ __forceinline__ float beta_of(const float* bt, int t) {
  return bt[t * NB + t % 8];
}
// B[t, t - 1], t >= 1
__device__ __forceinline__ float bsub_of(const float* bt, int t) {
  return bt[t * NB + (t % 8 ? t % 8 - 1 : 8)];
}

// A[t, s] for s <= t inside one 8-block, pairwise: sum_c r_t k_s
// e^{lp_prev_t - lp_s}, or the bonus sum_c r_t u k_t at s = t
template <typename E, int C>
__device__ __forceinline__ float pair_a(const E* rs, const E* ks, int PE,
                                        const float* lp, const float* lpp,
                                        int PL, const float* us, int t,
                                        int s) {
  float sum = 0.0f;
  if (t == s) {
#pragma unroll 4
    for (int c = 0; c < C; c += 4) {
      const float4 rv = load4(rs + t * PE + c);
      const float4 kv = load4(ks + t * PE + c);
      const float4 uv = load4(us + c);
      sum = fmaf(rv.x * uv.x, kv.x, sum);
      sum = fmaf(rv.y * uv.y, kv.y, sum);
      sum = fmaf(rv.z * uv.z, kv.z, sum);
      sum = fmaf(rv.w * uv.w, kv.w, sum);
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < C; c += 4) {
      const float4 rv = load4(rs + t * PE + c);
      const float4 kv = load4(ks + s * PE + c);
      const float4 pv = load4(lpp + t * PL + c);
      const float4 lv = load4(lp + s * PL + c);
      sum = fmaf(rv.x * kv.x, expn(pv.x - lv.x), sum);
      sum = fmaf(rv.y * kv.y, expn(pv.y - lv.y), sum);
      sum = fmaf(rv.z * kv.z, expn(pv.z - lv.z), sum);
      sum = fmaf(rv.w * kv.w, expn(pv.w - lv.w), sum);
    }
  }
  return sum;
}

// acc += tile dO[8 nt + (0..7)], the tile (rows g, g + 8; columns t =
// 8 nt + 2q, 2q + 1) as the A fragment, dO's rows as B's k index
template <int NC>
__device__ __forceinline__ void times_do(float (&acc)[NC][4],
                                         const float (&tile)[4],
                                         const float* dos, int PL, int nt,
                                         int g, int q) {
  FragA a;
  acc_as_a(a, tile);
  const float* d0 = dos + (8 * nt + 2 * q) * PL + g;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    FragB b;
    setb(b, d0[8 * n], d0[PL + 8 * n]);
    mma3<false>(acc[n], a, b);
  }
}

// acc += (K e^{lp_L - lp}) G_end for the rows s0 + (0..7, 8..15): the
// state part of dv
template <typename E, int C>
__device__ __forceinline__ void dv_state(float (&acc)[C / 8][4], const E* ks,
                                         const float* lp, const float* gs,
                                         int s0, int g, int q) {
  using Ti = Tile<E, C>;
  constexpr int PE = Ti::PE, PL = Ti::PL, PS = Ti::PS;
  const E* k0 = ks + (s0 + g) * PE;
  const E* k1 = k0 + 8 * PE;
  const float* l0 = lp + (s0 + g) * PL;
  const float* l1 = l0 + 8 * PL;
  const float* last = lp + (L - 1) * PL;
#pragma unroll 2
  for (int kk = 0; kk < C / 8; ++kk) {
    const int ca = 8 * kk + q, cb = ca + 4;
    FragA a;
    seta(a, to_f(k0[ca]) * expn(last[ca] - l0[ca]),
         to_f(k1[ca]) * expn(last[ca] - l1[ca]),
         to_f(k0[cb]) * expn(last[cb] - l0[cb]),
         to_f(k1[cb]) * expn(last[cb] - l1[cb]));
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      FragB b;
      setb(b, gs[ca * PS + 8 * n + g], gs[cb * PS + 8 * n + g]);
      mma3<false>(acc[n], a, b);
    }
  }
}

// st += V G_end^T for the rows s0 + (0..7, 8..15): the state part of dk
// before its scale e^{lp_L - lp_s}
template <typename E, int C>
__device__ __forceinline__ void dk_state(float (&st)[C / 8][4], const E* vs,
                                         const float* gs, int s0, int g,
                                         int q) {
  using Ti = Tile<E, C>;
  constexpr int PE = Ti::PE, PS = Ti::PS;
  constexpr bool EXACT = std::is_same<E, __nv_bfloat16>::value;
  const E* v0 = vs + (s0 + g) * PE;
  const E* v1 = v0 + 8 * PE;
#pragma unroll 2
  for (int kd = 0; kd < C / 8; ++kd) {
    const int da = 8 * kd + q, db = da + 4;
    FragA a;
    seta<EXACT>(a, to_f(v0[da]), to_f(v1[da]), to_f(v0[db]), to_f(v1[db]));
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      const float* gr = gs + (8 * n + g) * PS;
      FragB b;
      setb(b, gr[da], gr[db]);
      mma3a<EXACT>(st[n], a, b);
    }
  }
}

// shared-memory layout of (c1) and (c2): r, k, v, dO, lp, lp_prev, a C x C
// state (S_j or G_end), u, base, Z, the dot products, the warps' totals
template <typename E, int C>
struct BwdSmem {
  using Ti = Tile<E, C>;
  static constexpr size_t DO = sizeof(float) * L * Ti::PL;
  static constexpr size_t VEC = sizeof(float) * C;
  static constexpr size_t BT = sizeof(float) * L * NB;
  static constexpr size_t TOT = sizeof(float) * 2 * NW * C;
  static constexpr size_t BYTES =
      3 * Ti::RKV + DO + 2 * Ti::LP + Ti::S + 3 * VEC + BT + TOT;
};

// w_log (into lp), u and base (lp_end of the chunk before, or zeros), then
// r, k, v, dO, then the C x C state: three cp.async groups
template <typename E, int C>
__device__ __forceinline__ void load_chunk(
    E* rs, E* ks, E* vs, float* dos, float* lp, float* us, float* bs,
    float* xs, const E* r, const E* k, const E* v, const float* w,
    const float* u, const float* dout, const float* state,
    const float* lpe, int64_t base, int lc, int bh, int j, int nch, int H,
    bool pairs) {
  using Ti = Tile<E, C>;
  load_rows<C>(lp, Ti::PL, w + base, L, lc);
  load_rows<C>(us, C, u + (bh % H) * C, 1, 1);
  if (pairs && (j & 1))
    load_rows<C>(bs, C, lpe + (static_cast<int64_t>(bh) * nch + j - 1) * C,
                 1, 1);
  else
    load_rows<C>(bs, C, lpe, 1, 0);               // zero-fill
  cp_commit();
  load_rows<C>(rs, Ti::PE, r + base, L, lc);
  load_rows<C>(ks, Ti::PE, k + base, L, lc);
  load_rows<C>(vs, Ti::PE, v + base, L, lc);
  load_rows<C>(dos, Ti::PL, dout + base, L, lc);
  cp_commit();
  load_rows<C>(xs, Ti::PS,
               state + (static_cast<int64_t>(bh) * nch + j) * C * C, C, C);
  cp_commit();
}

// (a) dG_j = (R e^{lp_prev - base})^T dO and lp_L - base of chunk
// blockIdx.x of (b, h) = blockIdx.y
template <typename E, int C>
__global__ void __launch_bounds__(NT_A)
wkv6_bwd_dstate(const E* __restrict__ r, const float* __restrict__ w,
                const float* __restrict__ dout, float* __restrict__ dg,
                float* __restrict__ lpe, int T, bool pairs) {
  using Ti = Tile<E, C>;
  constexpr int PE = Ti::PE, PL = Ti::PL, NC = C / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  E* rs = reinterpret_cast<E*>(smem);
  float* dos = reinterpret_cast<float*>(smem + Ti::RKV);
  float* lp = dos + L * PL;
  float* lpp = lp + L * PL;
  float* prev = lpp + L * PL;

  const int j = blockIdx.x, bh = blockIdx.y, nch = gridDim.x;
  const int c0 = j * L, lc = min(L, T - c0);
  const bool odd = pairs && (j & 1);
  const int64_t base = (static_cast<int64_t>(bh) * T + c0) * C;
  load_rows<C>(lp, PL, w + base, L, lc);
  if (odd) load_rows<C>(prev, PL, w + base - L * C, L, L);
  cp_commit();
  load_rows<C>(rs, PE, r + base, L, lc);
  load_rows<C>(dos, PL, dout + base, L, lc);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  const float* bp = nullptr;
  if (odd) {
    cumsum<C>(prev, nullptr, nullptr);
    bp = prev + (L - 1) * PL;
  }
  cumsum<C>(lp, lpp, bp);
  const float* last = lp + (L - 1) * PL;
  if (threadIdx.x < C)
    lpe[(static_cast<int64_t>(bh) * nch + j) * C + threadIdx.x] =
        bp ? last[threadIdx.x] - bp[threadIdx.x] : last[threadIdx.x];
  cp_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  float* out = dg + (static_cast<int64_t>(bh) * nch + j) * C * C;
  for (int m = warp; m < C / 16; m += NW) {       // rows c of dG
    const int ca = 16 * m + g, cb = ca + 8;
    const float ba = bp ? bp[ca] : 0.0f, bb = bp ? bp[cb] : 0.0f;
    float acc[NC][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < L / 8; ++kk) {          // steps t, permuted
      const int t = 8 * kk + 2 * q;
      const float* p0 = lpp + t * PL;
      const E* r0 = rs + t * PE;
      FragA a;
      seta(a, to_f(r0[ca]) * expn(p0[ca] - ba),
           to_f(r0[cb]) * expn(p0[cb] - bb),
           to_f(r0[PE + ca]) * expn(p0[PL + ca] - ba),
           to_f(r0[PE + cb]) * expn(p0[PL + cb] - bb));
#pragma unroll
      for (int nt = 0; nt < NC; ++nt) {
        const float* d0 = dos + t * PL + 8 * nt + g;
        FragB b;
        setb(b, d0[0], d0[PL]);
        mma3<false>(acc[nt], a, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NC; ++nt) {
      const int d = 8 * nt + 2 * q;
      store2(out + ca * C + d, acc[nt][0], acc[nt][1]);
      store2(out + cb * C + d, acc[nt][2], acc[nt][3]);
    }
  }
}

// (b) G = ds_T; over the chunks from the last: G_end,j <- G; Z_j <-
// e^{lp_L,j - base_j} sum_d S_j G_end,j; G = diag(e^{lp_L,j - base_j}) G +
// dG_j; ds0 <- G
template <int C>
__global__ void __launch_bounds__(256)
wkv6_bwd_gscan(float* __restrict__ dg, const float* __restrict__ lpe,
               const float* __restrict__ ds_t, float* __restrict__ ds0,
               const float* __restrict__ states, float* __restrict__ zs,
               int nch, int64_t total) {
  scan_chunks<C, true, true>(dg, lpe, ds_t, ds0, nch, total, states, zs);
}

// (c1) dk, dv and dw's part (Z + sum_{s<i} Y_s) - sum_{s>=i} F_s of chunk
// blockIdx.x of (b, h) = blockIdx.y. Warp (J, 0): dv of the rows s in
// sub-chunk J; warp (J, 1): dk of those rows, then Y and F.
template <typename E, int C>
__global__ void __launch_bounds__(NT_C, 2)
wkv6_bwd_dkv(const E* __restrict__ r, const E* __restrict__ k,
             const E* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ dout,
             const float* __restrict__ zsrc,
             const float* __restrict__ g_end, const float* __restrict__ lpe,
             E* __restrict__ dk, E* __restrict__ dv, float* __restrict__ dw,
             int H, int T, bool pairs) {
  using Ti = Tile<E, C>;
  constexpr int PE = Ti::PE, PL = Ti::PL, PS = Ti::PS, NC = C / 8;
  constexpr bool EXACT = std::is_same<E, __nv_bfloat16>::value;
  constexpr int NF = 2 * (NW - 1);                 // far tiles at most
  extern __shared__ __align__(16) unsigned char smem[];
  E* rs = reinterpret_cast<E*>(smem);
  E* ks = reinterpret_cast<E*>(smem + Ti::RKV);
  E* vs = reinterpret_cast<E*>(smem + 2 * Ti::RKV);
  float* dos = reinterpret_cast<float*>(smem + 3 * Ti::RKV);
  float* lp = dos + L * PL;
  float* lpp = lp + L * PL;
  float* gs = lpp + L * PL;                        // G_end, C x PS
  float* us = gs + C * PS;
  float* bs = us + C;
  float* zs = bs + C;
  float* bt = zs + C;
  float* toty = bt + L * NB;                       // NW x C
  float* totf = toty + NW * C;

  const int j = blockIdx.x, bh = blockIdx.y, nch = gridDim.x;
  const int c0 = j * L, lc = min(L, T - c0);
  const int64_t base = (static_cast<int64_t>(bh) * T + c0) * C;
  load_rows<C>(zs, C, zsrc + (static_cast<int64_t>(bh) * nch + j) * C, 1, 1);
  load_chunk<E, C>(rs, ks, vs, dos, lp, us, bs, gs, r, k, v, w, u, dout,
                   g_end, lpe, base, lc, bh, j, nch, H, pairs);
  cp_wait<2>();
  __syncthreads();
  cumsum<C>(lp, lpp, bs);
  cp_wait<1>();
  __syncthreads();
  dots<E, C>(bt, dos, PL, vs, PE);
  cp_wait<0>();
  __syncthreads();
  const float* last = lp + (L - 1) * PL;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // heavy and light warps paired on each scheduler (warps w and w + 4):
  // dv of J = 0, 1, dk of 0, dv of 2 with dk of 3, 2, dv of 3, dk of 1
  const int J = (0x13232010u >> (4 * warp)) & 15, role = (0xB4u >> warp) & 1;
  const int g = lane / 4, q = lane % 4;
  const int s0r = SUB * J + g, s1r = s0r + 8;      // this thread's rows s
  const float* ref = lp + (SUB * J + SUB - 1) * PL;   // far pairs
  const float* ref8 = lp + (SUB * J + 7) * PL;        // the quadrant
  const int nfar = NF - 2 * J;
  const E* k0 = ks + s0r * PE;
  const E* k1 = ks + s1r * PE;
  const float* l0 = lp + s0r * PL;
  const float* l1 = lp + s1r * PL;

  if (role == 0) {
    // ---- dv = A^T dO + (K e^{lp_L - lp}) G_end ----
    // A^T's row block: far tiles (t in later sub-chunks), the quadrant
    // (rows s < 8, t >= 8 of the diagonal block), the two 8 x 8 diagonal
    // blocks pairwise (t >= s)
    float far[NF][4] = {};
    float quad[4] = {}, diag[4] = {};
#pragma unroll 2
    for (int kk = 0; kk < C / 8; ++kk) {
      const int ca = 8 * kk + q, cb = ca + 4;
      const float fa = ref[ca], fb = ref[cb];
      FragA a;
      seta(a, to_f(k0[ca]) * expn(fa - l0[ca]),
           to_f(k1[ca]) * expn(fa - l1[ca]),
           to_f(k0[cb]) * expn(fb - l0[cb]),
           to_f(k1[cb]) * expn(fb - l1[cb]));
#pragma unroll
      for (int ft = 0; ft < NF; ++ft) {
        if (ft < nfar) {
          const int t = SUB * (J + 1) + 8 * ft + g;
          const E* rt = rs + t * PE;
          const float* pt = lpp + t * PL;
          FragB b;
          setb(b, to_f(rt[ca]) * expn(pt[ca] - fa),
               to_f(rt[cb]) * expn(pt[cb] - fb));
          mma3<false>(far[ft], a, b);
        }
      }
      const float ga = ref8[ca], gb = ref8[cb];
      FragA a8;
      seta(a8, to_f(k0[ca]) * expn(ga - l0[ca]), 0.0f,
           to_f(k0[cb]) * expn(gb - l0[cb]), 0.0f);
      const int t = SUB * J + 8 + g;
      const E* rt = rs + t * PE;
      const float* pt = lpp + t * PL;
      FragB b;
      setb(b, to_f(rt[ca]) * expn(pt[ca] - ga),
           to_f(rt[cb]) * expn(pt[cb] - gb));
      mma3<false>(quad, a8, b);
    }
    // pairwise: rows g of the first 8-block (into diag) and rows g + 8 of
    // the second (into quad's rows g + 8), columns 2q, 2q + 1
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int col = 2 * q + x;
        if (col >= g) {
          const int s = SUB * J + 8 * blk + g, t = SUB * J + 8 * blk + col;
          const float val = pair_a<E, C>(rs, ks, PE, lp, lpp, PL, us, t, s);
          if (blk == 0) diag[x] = val;
          else quad[2 + x] = val;
        }
      }
    }
    float acc[NC][4] = {};
    times_do(acc, diag, dos, PL, 2 * J, g, q);
    times_do(acc, quad, dos, PL, 2 * J + 1, g, q);
#pragma unroll
    for (int ft = 0; ft < NF; ++ft)
      if (ft < nfar) times_do(acc, far[ft], dos, PL, 2 * J + 2 + ft, g, q);
    dv_state<E, C>(acc, ks, lp, gs, SUB * J, g, q);
    E* o = dv + base;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int d = 8 * n + 2 * q;
      if (s0r < lc) store2(o + s0r * C + d, acc[n][0], acc[n][1]);
      if (s1r < lc) store2(o + s1r * C + d, acc[n][2], acc[n][3]);
    }
    __syncthreads();                   // the dk warps' totals
  } else {
    // ---- dk = e^{lp_L - lp} (V G_end^T) + intra_k + adj_k + u r beta ----
    const E* v0 = vs + s0r * PE;
    const E* v1 = vs + s1r * PE;
    // B^T's far tiles and the quadrant (rows s < 8 of the block), t > s + 1
    float far[NF][4] = {};
    float quad[4] = {};
#pragma unroll 2
    for (int kd = 0; kd < C / 8; ++kd) {
      const int da = 8 * kd + q, db = da + 4;
      FragA a;
      seta<EXACT>(a, to_f(v0[da]), to_f(v1[da]), to_f(v0[db]), to_f(v1[db]));
#pragma unroll
      for (int ft = 0; ft < NF; ++ft) {
        if (ft < nfar) {
          const float* d0 = dos + (SUB * (J + 1) + 8 * ft + g) * PL;
          FragB b;
          setb(b, d0[da], d0[db]);
          mma3a<EXACT>(far[ft], a, b);
        }
      }
      FragA a8;
      seta<EXACT>(a8, to_f(v0[da]), 0.0f, to_f(v0[db]), 0.0f);
      const float* d0 = dos + (SUB * J + 8 + g) * PL;
      FragB b;
      setb(b, d0[da], d0[db]);
      mma3a<EXACT>(quad, a8, b);
    }
    // drop the adjacent pairs (t = s + 1): the far tiles' first column at
    // s = 16 J + 15, the quadrant's at s = 16 J + 7
    if (nfar > 0 && g == 7 && q == 0) far[0][2] = 0.0f;
    if (g == 7 && q == 0) quad[0] = 0.0f;
    float acc[NC][4] = {};
#pragma unroll
    for (int ft = 0; ft < NF; ++ft) {
      if (ft < nfar) {
        FragA a;
        acc_as_a(a, far[ft]);
        const int t = SUB * (J + 1) + 8 * ft + 2 * q;
        const E* r0 = rs + t * PE;
        const float* p0 = lpp + t * PL;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = 8 * n + g;
          FragB b;
          setb(b, to_f(r0[c]) * expn(p0[c] - ref[c]),
               to_f(r0[PE + c]) * expn(p0[PL + c] - ref[c]));
          mma3<false>(acc[n], a, b);
        }
      }
    }
    FragA aq;
    acc_as_a(aq, quad);
    const int tq = SUB * J + 8 + 2 * q;
    const E* rq = rs + tq * PE;
    const float* pq = lpp + tq * PL;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int ca = 8 * n + 2 * q, cb = ca + 1;
      // the far part's scale e^{ref - lp_s}, then the quadrant's own
      acc[n][0] *= expn(ref[ca] - l0[ca]);
      acc[n][1] *= expn(ref[cb] - l0[cb]);
      acc[n][2] *= expn(ref[ca] - l1[ca]);
      acc[n][3] *= expn(ref[cb] - l1[cb]);
      const int c = 8 * n + g;
      float tmp[4] = {};
      FragB b;
      setb(b, to_f(rq[c]) * expn(pq[c] - ref8[c]),
           to_f(rq[PE + c]) * expn(pq[PL + c] - ref8[c]));
      mma3<false>(tmp, aq, b);
      acc[n][0] = fmaf(tmp[0], expn(ref8[ca] - l0[ca]), acc[n][0]);
      acc[n][1] = fmaf(tmp[1], expn(ref8[cb] - l0[cb]), acc[n][1]);
    }
    // the 8 x 8 diagonal blocks, pairwise, t > s + 1
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int s = row ? s1r : s0r;
      const float* ls = row ? l1 : l0;
      for (int t = s + 2; t < s - g + 8; ++t) {
        const float bts = bt[t * NB + g];
        const E* rt = rs + t * PE;
        const float* pt = lpp + t * PL;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int ca = 8 * n + 2 * q, cb = ca + 1;
          acc[n][2 * row] = fmaf(bts * to_f(rt[ca]), expn(pt[ca] - ls[ca]),
                                 acc[n][2 * row]);
          acc[n][2 * row + 1] = fmaf(bts * to_f(rt[cb]),
                                     expn(pt[cb] - ls[cb]),
                                     acc[n][2 * row + 1]);
        }
      }
    }
    // V G_end^T, scaled below by e^{lp_L - lp_s}
    float st[NC][4] = {};
    dk_state<E, C>(st, vs, gs, SUB * J, g, q);
    // dk, then F = k intra_k and Y = k state in place
    const float beta0 = beta_of(bt, s0r), beta1 = beta_of(bt, s1r);
    const float sub0 = s0r + 1 < L ? bsub_of(bt, s0r + 1) : 0.0f;
    const float sub1 = s1r + 1 < L ? bsub_of(bt, s1r + 1) : 0.0f;
    E* o = dk + base;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int ca = 8 * n + 2 * q;
      const float2 lastv = load2(last + ca), uv = load2(us + ca);
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const int s = row ? s1r : s0r;
        const float2 kv = load2(ks + s * PE + ca);
        const float2 ls = load2(lp + s * PL + ca);
        const float2 rv = load2(rs + s * PE + ca);
        float2 an = make_float2(0.0f, 0.0f);
        if (s + 1 < L) {
          const float sub = row ? sub1 : sub0;
          const float2 rn = load2(rs + (s + 1) * PE + ca);
          const float2 pn = load2(lpp + (s + 1) * PL + ca);
          an = make_float2(sub * rn.x * expn(pn.x - ls.x),
                           sub * rn.y * expn(pn.y - ls.y));
        }
        const float beta = row ? beta1 : beta0;
        const int e = 2 * row;
        const float sa = st[n][e] * expn(lastv.x - ls.x);
        const float sb = st[n][e + 1] * expn(lastv.y - ls.y);
        const float da = ((acc[n][e] + sa) + an.x) + uv.x * rv.x * beta;
        const float db = ((acc[n][e + 1] + sb) + an.y) + uv.y * rv.y * beta;
        if (s < lc) store2(o + s * C + ca, da, db);
        acc[n][e] *= kv.x;                            // F
        acc[n][e + 1] *= kv.y;
        st[n][e] = kv.x * sa;                         // Y
        st[n][e + 1] = kv.y * sb;
      }
    }
    // over the rows of the warp (lanes g = 0..7 of one q hold rows g and
    // g + 8 of the same columns): Y summed over s < i, F over s >= i
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int o2 = 4; o2 < 32; o2 *= 2) {         // inclusive, over g
          const float yu = __shfl_up_sync(0xffffffffu, st[n][e], o2);
          const float fd = __shfl_down_sync(0xffffffffu, acc[n][e], o2);
          if (lane >= o2) st[n][e] += yu;    // Y over rows 0..g of a half
          if (lane + o2 < 32) acc[n][e] += fd;   // F over rows g..7
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        // half totals: Y's at g = 7, F's at g = 0
        const float ty0 = __shfl_sync(0xffffffffu, st[n][x], 28 + q);
        const float ty1 = __shfl_sync(0xffffffffu, st[n][2 + x], 28 + q);
        const float tf1 = __shfl_sync(0xffffffffu, acc[n][2 + x], q);
        // exclusive sums of Y: the row before's inclusive one
        float ye0 = __shfl_up_sync(0xffffffffu, st[n][x], 4);
        float ye1 = __shfl_up_sync(0xffffffffu, st[n][2 + x], 4);
        if (g == 0) ye0 = ye1 = 0.0f;
        st[n][x] = ye0;                        // rows g: Y over s < i
        st[n][2 + x] = ty0 + ye1;              // rows g + 8
        acc[n][x] += tf1;                      // rows g: F over s >= i
        if (g == 0) {
          const int c = 8 * n + 2 * q + x;
          toty[J * C + c] = ty0 + ty1;
          totf[J * C + c] = acc[n][x];
        }
      }
    }
    __syncthreads();                   // every warp's totals
    float* o2 = dw + base;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int ca = 8 * n + 2 * q;
      float part[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = ca + (e & 1);
        float yb = 0.0f, fa = 0.0f;
        for (int jj = 0; jj < J; ++jj) yb += toty[jj * C + c];
        for (int jj = J + 1; jj < NW; ++jj) fa += totf[jj * C + c];
        part[e] = (zs[c] + (yb + st[n][e])) - (acc[n][e] + fa);
      }
      if (s0r < lc) store2(o2 + s0r * C + ca, part[0], part[1]);
      if (s1r < lc) store2(o2 + s1r * C + ca, part[2], part[3]);
    }
  }
}

// (c2) dr, dw += sum_{t>i} P_t and the chunk's partial du, of chunk
// blockIdx.x of (b, h) = blockIdx.y. Warp (J, half): the rows t in
// sub-chunk J, columns half * C / 2 + [0, C / 2).
template <typename E, int C>
__global__ void __launch_bounds__(NT_C, 2)
wkv6_bwd_drw(const E* __restrict__ r, const E* __restrict__ k,
             const E* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ dout,
             const float* __restrict__ states, const float* __restrict__ lpe,
             E* __restrict__ dr, float* __restrict__ dw,
             float* __restrict__ du_part, int H, int T, bool pairs) {
  using Ti = Tile<E, C>;
  constexpr int PE = Ti::PE, PL = Ti::PL, PS = Ti::PS, NH = C / 16;
  constexpr bool EXACT = std::is_same<E, __nv_bfloat16>::value;
  constexpr int NF = 2 * (NW - 1);                 // far s-tiles at most
  extern __shared__ __align__(16) unsigned char smem[];
  E* rs = reinterpret_cast<E*>(smem);
  E* ks = reinterpret_cast<E*>(smem + Ti::RKV);
  E* vs = reinterpret_cast<E*>(smem + 2 * Ti::RKV);
  float* dos = reinterpret_cast<float*>(smem + 3 * Ti::RKV);
  float* lp = dos + L * PL;
  float* lpp = lp + L * PL;
  float* ss = lpp + L * PL;                        // S_j, C x PS
  float* us = ss + C * PS;
  float* bs = us + C;
  float* bt = bs + 2 * C;
  float* totp = bt + L * NB;                       // NW x C

  const int j = blockIdx.x, bh = blockIdx.y, nch = gridDim.x;
  const int c0 = j * L, lc = min(L, T - c0);
  const int64_t base = (static_cast<int64_t>(bh) * T + c0) * C;
  load_chunk<E, C>(rs, ks, vs, dos, lp, us, bs, ss, r, k, v, w, u, dout,
                   states, lpe, base, lc, bh, j, nch, H, pairs);
  cp_wait<2>();
  __syncthreads();
  cumsum<C>(lp, lpp, bs);
  cp_wait<1>();
  __syncthreads();
  dots<E, C>(bt, dos, PL, vs, PE);
  cp_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int J = warp / 2, half = warp % 2;
  const int g = lane / 4, q = lane % 4;
  const int t0 = SUB * J + g, t1 = t0 + 8;         // this thread's rows t
  const float* d0 = dos + t0 * PL;
  const float* d1 = dos + t1 * PL;
  const float* p0 = lpp + t0 * PL;
  const float* p1 = lpp + t1 * PL;
  const float* ref = lp + (SUB * J - 1) * PL;      // far pairs (J > 0)
  const float* ref8 = lp + (SUB * J + 7) * PL;     // the quadrant
  const int nfar = 2 * J;                          // s-tiles before J

  // dO S_j^T (inter) and B's row block (s < 16 J + 8: the far s-tiles and
  // the diagonal block's first 8 columns), one pass over d
  float inter[NH][4] = {};
  float far[NF][4] = {};
  float quad[4] = {};
#pragma unroll 2
  for (int kd = 0; kd < C / 8; ++kd) {
    const int da = 8 * kd + q, db = da + 4;
    FragA a;
    seta(a, d0[da], d1[da], d0[db], d1[db]);
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const float* sr = ss + (8 * (half * NH + n) + g) * PS;
      FragB b;
      setb(b, sr[da], sr[db]);
      mma3<false>(inter[n], a, b);
    }
#pragma unroll
    for (int st = 0; st < NF; ++st) {
      if (st < nfar) {
        const E* vr = vs + (8 * st + g) * PE;
        FragB b;
        setb<EXACT>(b, to_f(vr[da]), to_f(vr[db]));
        mma3<EXACT>(far[st], a, b);
      }
    }
    const E* vr = vs + (SUB * J + g) * PE;
    FragB b;
    setb<EXACT>(b, to_f(vr[da]), to_f(vr[db]));
    mma3<EXACT>(quad, a, b);
  }
  // the quadrant's rows t < 8 are the pairwise block's; drop the adjacent
  // pairs (s = t - 1): the far tiles' at t = 16 J, the quadrant's at
  // t = 16 J + 8
  quad[0] = quad[1] = 0.0f;
  if (g == 0 && q == 3) quad[3] = 0.0f;
  // intra_r: far tiles times K e^{ref - lp}, scaled by e^{lp_prev - ref}
  float intra[NH][4] = {};
#pragma unroll
  for (int st = 0; st < NF; ++st) {
    if (st < nfar) {
      if (st == nfar - 1 && g == 0 && q == 3) far[st][1] = 0.0f;
      FragA a;
      acc_as_a(a, far[st]);
      const int s = 8 * st + 2 * q;
      const E* k0 = ks + s * PE;
      const float* l0 = lp + s * PL;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int c = 8 * (half * NH + n) + g;
        FragB b;
        setb(b, to_f(k0[c]) * expn(ref[c] - l0[c]),
             to_f(k0[PE + c]) * expn(ref[c] - l0[PL + c]));
        mma3<false>(intra[n], a, b);
      }
    }
  }
  FragA aq;
  acc_as_a(aq, quad);
  const int sq = SUB * J + 2 * q;
  const E* kq = ks + sq * PE;
  const float* lq = lp + sq * PL;
  const float beta0 = beta_of(bt, t0), beta1 = beta_of(bt, t1);
  const float sub0 = t0 > 0 ? bsub_of(bt, t0) : 0.0f;
  const float sub1 = bsub_of(bt, t1);
  float pv[NH][4];
  E* o = dr + base;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const int ca = 8 * (half * NH + n) + 2 * q, cb = ca + 1;
    if (J > 0) {
      intra[n][0] *= expn(p0[ca] - ref[ca]);
      intra[n][1] *= expn(p0[cb] - ref[cb]);
      intra[n][2] *= expn(p1[ca] - ref[ca]);
      intra[n][3] *= expn(p1[cb] - ref[cb]);
    }
    const int c = 8 * (half * NH + n) + g;
    float tmp[4] = {};
    FragB b;
    setb(b, to_f(kq[c]) * expn(ref8[c] - lq[c]),
         to_f(kq[PE + c]) * expn(ref8[c] - lq[PL + c]));
    mma3<false>(tmp, aq, b);
    intra[n][2] = fmaf(tmp[2], expn(p1[ca] - ref8[ca]), intra[n][2]);
    intra[n][3] = fmaf(tmp[3], expn(p1[cb] - ref8[cb]), intra[n][3]);
    // the 8 x 8 diagonal blocks, pairwise, s < t - 1
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int t = row ? t1 : t0;
      const float2 pt = load2((row ? p1 : p0) + ca);
      float x0 = intra[n][2 * row], x1 = intra[n][2 * row + 1];
      for (int s = t - g; s < t - 1; ++s) {
        const float bts = bt[t * NB + s % 8];
        const float2 kv = load2(ks + s * PE + ca);
        const float2 lv = load2(lp + s * PL + ca);
        x0 = fmaf(bts * kv.x, expn(pt.x - lv.x), x0);
        x1 = fmaf(bts * kv.y, expn(pt.y - lv.y), x1);
      }
      intra[n][2 * row] = x0;
      intra[n][2 * row + 1] = x1;
    }
    const float2 bv = load2(bs + ca), uv = load2(us + ca);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int t = row ? t1 : t0, e = 2 * row;
      const float2 pt = load2(lpp + t * PL + ca);
      const float2 kv = load2(ks + t * PE + ca);
      const float2 rv = load2(rs + t * PE + ca);
      const float ia = inter[n][e] * expn(pt.x - bv.x);
      const float ib = inter[n][e + 1] * expn(pt.y - bv.y);
      float2 an = make_float2(0.0f, 0.0f);
      if (t > 0) {
        const float sub = row ? sub1 : sub0;
        const float2 kp = load2(ks + (t - 1) * PE + ca);
        const float2 lq2 = load2(lp + (t - 1) * PL + ca);
        an = make_float2(sub * kp.x * expn(pt.x - lq2.x),
                         sub * kp.y * expn(pt.y - lq2.y));
      }
      const float beta = row ? beta1 : beta0;
      const float da = ((ia + intra[n][e]) + an.x) + uv.x * kv.x * beta;
      const float db = ((ib + intra[n][e + 1]) + an.y) + uv.y * kv.y * beta;
      if (t < lc) store2(o + t * C + ca, da, db);
      pv[n][e] = rv.x * (ia + intra[n][e]);                  // P
      pv[n][e + 1] = rv.y * (ib + intra[n][e + 1]);
    }
  }
  // P summed over t > i: within the warp over g, then across the warps
#pragma unroll
  for (int n = 0; n < NH; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = pv[n][e];
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 *= 2) {          // inclusive, rows >= g
        const float xd = __shfl_down_sync(0xffffffffu, x, o2);
        if (lane + o2 < 32) x += xd;
      }
      pv[n][e] = x;
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float tot1 = __shfl_sync(0xffffffffu, pv[n][2 + x], q);
      float pe0 = __shfl_down_sync(0xffffffffu, pv[n][x], 4);
      float pe1 = __shfl_down_sync(0xffffffffu, pv[n][2 + x], 4);
      if (g == 7) pe0 = pe1 = 0.0f;
      if (g == 0)
        totp[J * C + 8 * (half * NH + n) + 2 * q + x] = pv[n][x] + tot1;
      pv[n][x] = pe0 + tot1;              // rows g: over t > i
      pv[n][2 + x] = pe1;                 // rows g + 8
    }
  }
  __syncthreads();
  float* ow = dw + base;
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    const int ca = 8 * (half * NH + n) + 2 * q;
    float after[2] = {0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 2; ++x)
      for (int jj = J + 1; jj < NW; ++jj) after[x] += totp[jj * C + ca + x];
    if (t0 < lc) {
      const float2 d = *reinterpret_cast<const float2*>(ow + t0 * C + ca);
      store2(ow + t0 * C + ca, d.x + (pv[n][0] + after[0]),
             d.y + (pv[n][1] + after[1]));
    }
    if (t1 < lc) {
      const float2 d = *reinterpret_cast<const float2*>(ow + t1 * C + ca);
      store2(ow + t1 * C + ca, d.x + (pv[n][2] + after[0]),
             d.y + (pv[n][3] + after[1]));
    }
  }
  // this chunk's part of du: sum_t r k beta, in order over t
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    float sum = 0.0f;
    for (int t = 0; t < L; ++t)
      sum = fmaf(to_f(rs[t * PE + c]) * to_f(ks[t * PE + c]), beta_of(bt, t),
                 sum);
    du_part[(static_cast<int64_t>(bh) * nch + j) * C + c] = sum;
  }
}

// (d) du[h, c] = sum over b, then chunks, of the partials
template <int C>
__global__ void __launch_bounds__(256)
wkv6_bwd_du(const float* __restrict__ du_part, float* __restrict__ du, int B,
            int H, int nch) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * C) return;
  const int h = e / C, c = e % C;
  float sum = 0.0f;
  for (int b = 0; b < B; ++b)
    for (int j = 0; j < nch; ++j)
      sum += du_part[((static_cast<int64_t>(b) * H + h) * nch + j) * C + c];
  du[e] = sum;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename E, int C>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* dout,
                   const float* ds_t, const float* states, void* dr,
                   void* dk, void* dv, float* dw, float* du, float* ds0,
                   float* dg, float* lpe, float* zs, float* du_part, int B,
                   int H, int T, bool pairs, cudaStream_t stream) {
  using Ti = Tile<E, C>;
  const int nch = (T + L - 1) / L;
  const dim3 grid(nch, B * H);
  const E* re = static_cast<const E*>(r);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const size_t smem_a = Ti::RKV + 4 * Ti::LP;
  const size_t smem_c = BwdSmem<E, C>::BYTES;
  cudaError_t err = set_smem(wkv6_bwd_dstate<E, C>, smem_a);
  if (err != cudaSuccess) return err;
  err = set_smem(wkv6_bwd_dkv<E, C>, smem_c);
  if (err != cudaSuccess) return err;
  err = set_smem(wkv6_bwd_drw<E, C>, smem_c);
  if (err != cudaSuccess) return err;
  wkv6_bwd_dstate<E, C><<<grid, NT_A, smem_a, stream>>>(re, w, dout, dg, lpe,
                                                        T, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = static_cast<int64_t>(B) * H * C * C;
  wkv6_bwd_gscan<C><<<static_cast<unsigned>((total / 4 + 255) / 256), 256, 0,
                      stream>>>(dg, lpe, ds_t, ds0, states, zs, nch,
                                total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_dkv<E, C><<<grid, NT_C, smem_c, stream>>>(
      re, ke, ve, w, u, dout, zs, dg, lpe, static_cast<E*>(dk),
      static_cast<E*>(dv), dw, H, T, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_drw<E, C><<<grid, NT_C, smem_c, stream>>>(
      re, ke, ve, w, u, dout, states, lpe, static_cast<E*>(dr), dw, du_part,
      H, T, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_du<C><<<(H * C + 255) / 256, 256, 0, stream>>>(du_part, du, B, H,
                                                         nch);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_c(int C, const void* r, const void* k, const void* v,
                       const float* w, const float* u, const float* dout,
                       const float* ds_t, const float* states, void* dr,
                       void* dk, void* dv, float* dw, float* du, float* ds0,
                       float* dg, float* lpe, float* zs, float* du_part,
                       int B, int H, int T, bool pairs, cudaStream_t s) {
  switch (C) {
    case 16:
      return launch<E, 16>(r, k, v, w, u, dout, ds_t, states, dr, dk, dv, dw,
                           du, ds0, dg, lpe, zs, du_part, B, H, T, pairs, s);
    case 64:
      return launch<E, 64>(r, k, v, w, u, dout, ds_t, states, dr, dk, dv, dw,
                           du, ds0, dg, lpe, zs, du_part, B, H, T, pairs, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of r, k, v, dr, dk, dv: 0 = fp32, 1 = bf16. C in {16, 64}; B * H <=
// 65535; T >= 1. w (the log-decays), u, dout, ds_t, states, dw, du, ds0 are
// fp32; states is the forward's (B, H, chunks, C, C) chunk start states,
// chunks = ceil(T / 64); ds_t (B, H, C, C) is not null (zeros for none).
// dg (B, H, chunks, C, C), lpe, zs and du_part (B, H, chunks, C) are fp32
// scratch. frame: the forward's (`repro_wkv6`): 128 when its cumulative
// sums run over two chunks, else 64. Every pointer 16-byte aligned.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                              const float* w, const float* u,
                              const float* dout, const float* ds_t,
                              const float* states, void* dr, void* dk,
                              void* dv, float* dw, float* du, float* ds0,
                              float* dg, float* lpe, float* zs,
                              float* du_part, int dtype, int B, int H, int T,
                              int C,
                              int chunks, int frame, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || T <= 0 || static_cast<int64_t>(B) * H > 65535 ||
      chunks != (T + L - 1) / L || (frame != L && frame != 2 * L) ||
      ds_t == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pairs = frame == 2 * L;
  if (dtype == 0)
    err = dispatch_c<float>(C, r, k, v, w, u, dout, ds_t, states, dr, dk, dv,
                            dw, du, ds0, dg, lpe, zs, du_part, B, H, T, pairs,
                            s);
  else if (dtype == 1)
    err = dispatch_c<__nv_bfloat16>(C, r, k, v, w, u, dout, ds_t, states, dr,
                                    dk, dv, dw, du, ds0, dg, lpe, zs, du_part,
                                    B, H, T, pairs, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
