// swa: causal sliding-window attention with GQA, an optional prefix-LM
// band and an optional tanh softcap. Query i attends keys j with
// i - W < j and (j <= i or j < P), where the first P positions (a vlm's
// image prefix; P = 0: none) are seen by every query within the window,
// as the reference's prefix-LM mask does
// (src/repro/models/layers.py:199-206):
//
//   s[i, j] = (q_i . k_j) / sqrt(hd)               (fp32)
//   s       = cap * tanh(s / cap)                  (when cap > 0)
//   out_i   = sum_j softmax_j(s[i, :]) v_j         (fp32, cast to q's type)
//
// q (B, S, H, hd), k/v (B, S, KH, hd), all contiguous, fp32 or bf16; query
// head h reads KV head (h % H) / (H / KH), which takes any group size
// (hymba's 25 heads over 5 KV heads, g = 5). The output has q's layout and
// is acc / max(l, 1e-30), so a row with no key would give 0.
//
// Replaces `_swa_kernel` (src/repro/kernels/swa.py:27, launched by
// `swa_pallas` at :110). The Pallas grid walked a fixed number of KV blocks
// per query block, clamped at the left edge and masking the duplicate
// visits; it needed S % bq == 0, W % bk == 0 and bq % bk == 0. Here a CTA
// loops over exactly the key tiles of its band, so there are no duplicate
// visits and S, W and every tail are free. A query tile's band is
// [max(0, q0 - W + 1), max(q_last, min(P, S) - 1)]: the prefix adds key
// tiles above the diagonal to the first ceil(P / tile) query tiles only.
//
// Bound on the H100: 4 * hd operations per (query, key) pair of the band
// against one read of q, k, v and one write of the output, so at hymba's
// prefill shape the operations bound it, at the 989 TFLOP/s bf16
// tensor-core rate. At hd 64 the softmax's one exp per pair (16 per clock
// per SM) costs about as much as the two products.
//
// bf16 (`swa_wgmma`), the serving path: one CTA per (b, h, 128 queries),
// two consumer warpgroups of 64 query rows and one producer warp; at 96
// registers a thread two CTAs share an SM, so four warpgroups interleave
// their products and softmaxes (the time follows that count: one CTA an SM
// was slower, and so was an FA3-style pipeline inside a warpgroup).
//  - The producer's one thread loads the Q tile once and the band's K and
//    V tiles of 64 keys by TMA (3-D tensor maps over (B, S, KH * hd), box
//    (64 rows, min(hd, 64)) at column kvh * hd, so rows past S arrive as
//    zeros) into a ring of NS stages with full/empty mbarriers. Tiles are
//    swizzled (128 B rows at hd 64, 32 B at hd 16) as wgmma reads them. A
//    128-byte swizzle spans 64 bf16 columns, so at hd 128 a tile is two
//    such slabs side by side and at hd 256 four, one box each; S = Q K^T
//    walks its hd / 16 k16 steps over them, and O += P V runs one m64n64
//    product per slab.
//  - S = Q K^T is `wgmma.m64n64k16` bf16 -> fp32 with Q and K from shared
//    memory, both K-major. O += P V is `wgmma.m64n{hd}k16` with P in
//    registers (the S accumulator's layout is the A fragment's, so P is
//    packed to bf16 in place) and V from shared memory in its stored
//    [key][hd] layout, MN-major, read with the transpose bit.
//  - Only the band's left-edge and diagonal tiles, and a tile reaching
//    past S, are masked; interior tiles skip the mask. The online softmax
//    keeps (m, l) in fp32 registers in the log2 domain (one FFMA and one
//    ex2 per score, log2(e) folded into the scale); m is reduced over the
//    four lanes that hold a row, l stays a per-lane partial sum until the
//    end. P is rounded to bf16 for the second product (2^-9 relative per
//    weight): a row with few keys does not average that out, and where its
//    values cancel it can move the output by more than half a bf16 ulp of
//    the row before the output's own rounding.
//  - The output is staged in shared memory, laid out as the Q tile, and
//    written with 16-byte stores, rows past S skipped.
//  - Under autograd (`repro_swa` given an lse pointer) a second build of
//    the kernel also writes each row's lse = (m + log2 l) ln 2, (B, H, S)
//    fp32, which the backward's bf16 kernels read (swa_bwd.cu); the
//    serving path (lse null) runs the first build, whose instructions the
//    lse does not change.
//  - hd 256 (paligemma): the O accumulator is 128 fp32 registers a thread
//    and S 32 more. The producer is a whole warpgroup that gives its
//    registers up (setmaxnreg 24), so each consumer thread takes 240, as
//    FlashAttention-3 does at this head dim; the 16 k16 steps of each
//    product add their descriptor offsets inside the asm, so they hold two
//    descriptor registers and not 32 (a first build, at 224 registers a
//    thread with the offsets added outside the asm, spilled 960 bytes and
//    had its wgmmas serialised, ptxas C7512). One K +
//    V stage is 64 KB, so the ring has two stages, and each warpgroup
//    stages its output over its own rows of the Q tile once its last
//    product has read them (192 KB in all, one CTA an SM).
//  - The grid puts the g query heads of one KV head innermost, then the
//    query blocks from the heaviest (latest) down, so the CTAs resident at
//    one time re-read one (b, kvh)'s K and V from L2.
//
// fp32 (`swa_fp32`), the model-level checks' path, on the CUDA cores: one
// CTA per (b*h, 64 queries), Q, K and V tiles in shared memory (rows padded
// by one word), a 4 x 4 register tile of scores per thread, (m, l) reduced
// with 16-lane shuffles. The tensor cores take no fp32 operands (TF32 would
// drop 13 bits).
#include "hopper.cuh"

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads: 16 row groups x 16 column lanes

template <int HD>
__global__ void __launch_bounds__(NT)
swa_fp32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ out, int S, int H,
         int KH, int W, int P, float scale, float cap) {
  constexpr int HP = HD + 1;          // padded row of Q and K
  constexpr int DJ = HD / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // [BQ][HP], scaled q
  float* ks = qs + BQ * HP;           // [BK][HP]
  float* vs = ks + BK * HP;           // [BK][HD]
  float* ps = vs + BK * HD;           // [BQ][BK + 1] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;            // column lane
  const int ty = tid >> 4;            // row group: rows ty*4 .. ty*4+3
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;

  const int64_t q_row = static_cast<int64_t>(H) * HD;     // stride of s in q
  const int64_t kv_row = static_cast<int64_t>(KH) * HD;   // and in k, v
  const float* qb = q + static_cast<int64_t>(b) * S * q_row + h * HD;
  const float* kb = k + static_cast<int64_t>(b) * S * kv_row + kvh * HD;
  const float* vb = v + static_cast<int64_t>(b) * S * kv_row + kvh * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int qp = q0 + r;
    qs[r * HP + d] = qp < S ? qb[qp * q_row + d] * scale : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  const int q_last = min(q0 + BQ - 1, S - 1);
  const int lo = max(0, q0 - W + 1);
  const int hi = max(q_last, min(P, S) - 1);   // the prefix's keys
  for (int k0 = lo; k0 <= hi; k0 += BK) {
    __syncthreads();                  // previous tile fully consumed
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int kp = k0 + r;
      const bool in = kp < S;
      ks[r * HP + d] = in ? kb[kp * kv_row + d] : 0.0f;
      vs[r * HD + d] = in ? vb[kp * kv_row + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * HP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * HP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool valid[4];
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        valid[j] = kp < S && (kp <= qp || kp < P) && kp > qp - W;
        float x = s[i][j];
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        s[i][j] = x;
        if (valid[j]) row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float m_safe = isinf(m_new) ? 0.0f : m_new;
      const float corr = isinf(m[i]) ? 0.0f : expf(m[i] - m_safe);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_safe) : 0.0f;
        ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();     // a row's probabilities are written by its own warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = out + static_cast<int64_t>(b) * S * q_row + h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[qp * q_row + tx + 16 * j] = acc[i][j] / den;
  }
}

template <int HD>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int S, int H, int KH,
                        int W, int P, float scale, float cap,
                        cudaStream_t stream) {
  if (lse != nullptr) return cudaErrorInvalidValue;   // bf16 only
  constexpr int HP = HD + 1;
  const size_t smem =
      sizeof(float) * (BQ * HP + BK * HP + BK * HD + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      swa_fp32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  swa_fp32<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KH, W,
      P, scale, cap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int WQ = 64;               // query rows per consumer warpgroup
constexpr int NWG = 2;               // consumer warpgroups
constexpr int TQ = WQ * NWG;         // query rows per CTA
constexpr int TK = 64;               // keys per tile
// + one producer warp; at head_dim 256 a producer warpgroup, so that
// setmaxnreg can move its registers to the consumers
template <int HD>
constexpr int NTW = NWG * 128 + (HD == 256 ? 128 : 32);
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory layout of one CTA; every tile is 1024-byte aligned, as the
// 128-byte swizzle needs. A tile of HD columns is stored as SLABS slabs of
// COLS columns side by side ([rows][COLS] each, swizzled): a 128-byte
// swizzle spans at most 64 bf16 columns, so head_dim 128 takes two slabs
// and 256 four, each loaded by its own TMA box and laid out as a
// head_dim-64 tile.
template <int HD>
struct Smem {
  static constexpr int COLS = HD < 64 ? HD : 64; // columns of one slab
  static constexpr int SLABS = HD / COLS;
  static constexpr int ROW = COLS * 2;           // bytes of one slab row
  // stages of the K/V ring: one K + V stage is 64 KB at head_dim 256
  static constexpr int NS = HD == 256 ? 2 : 4;
  static constexpr int Q = 0;                    // SLABS x [TQ][COLS]
  // output staging, laid out as Q; at head_dim 256 it is the Q tile itself
  // (each warpgroup writes its own rows after its last product)
  static constexpr int O = HD == 256 ? Q : Q + TQ * HD * 2;
  static constexpr int K = O + TQ * HD * 2;      // NS x SLABS x [TK][COLS]
  static constexpr int V = K + NS * TK * HD * 2; // NS x SLABS x [TK][COLS]
  static constexpr int BAR = V + NS * TK * HD * 2;  // full[NS], empty[NS], q
  static constexpr int BYTES = BAR + 8 * (2 * NS + 1);
  static constexpr int TILE = TK * HD * 2;       // one K or V stage
  static constexpr int SLAB = TK * ROW;          // one slab of a K/V tile
  static constexpr int QSLAB = TQ * ROW;         // one slab of the Q tile
  // swizzle of a slab row of ROW bytes: the span is the row (128 or 32)
  static constexpr uint32_t MODE = ROW == 128 ? 1 : 3;
  static constexpr uint32_t ATOM = 8 * ROW;      // 8 rows of one swizzle
};

// At head_dim 16 and 64 two CTAs fit on an SM (96 registers a thread):
// four consumer warpgroups, so one's softmax runs beside another's
// products. At 128 the O accumulator alone is 64 registers a thread and
// the shared memory ~193 KB: one CTA an SM; at 256 the accumulator is 128
// registers and the shared memory 192 KB with two stages.
template <int HD, bool LSE>
__global__ void __launch_bounds__(NTW<HD>, HD >= 128 ? 1 : 2)
swa_wgmma(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S,
          int H, int KH, int W, int P, float scale_log2, float cap) {
  using L = Smem<HD>;
  constexpr int NS = L::NS;
  static_assert(HD == 16 || HD == 64 || HD == 128 || HD == 256,
                "head_dim 16, 64, 128 or 256");
  extern __shared__ uint8_t smem_raw[];
  // align the tiles to 1024 bytes of the shared window
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L::BAR;
  const uint32_t empty0 = full0 + 8 * NS;
  const uint32_t qbar = empty0 + 8 * NS;

  // the g query heads of one KV head innermost, then the query blocks from
  // the latest (heaviest) down, then (b, kvh)
  const int g = H / KH;
  const int nqb = (S + TQ - 1) / TQ;
  int idx = blockIdx.x;
  const int hg = idx % g;
  idx /= g;
  const int qb = nqb - 1 - idx % nqb;
  idx /= nqb;
  const int kvh = idx % KH;
  const int b = idx / KH;
  const int h = kvh * g + hg;
  const int q0 = qb * TQ;
  const int q_last = min(q0 + TQ - 1, S - 1);
  const int p_last = min(P, S) - 1;              // the prefix's last key
  const int t_lo = max(0, q0 - W + 1) / TK;      // the CTA's key tiles
  const int n_tiles = max(q_last, p_last) / TK - t_lo + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 4 * NWG);          // one per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // tile t of the CTA sits in stage t % NS, filled for the (t / NS)-th time
  if (tid >= NWG * 128) {
    // producer: one thread issues every copy; at head_dim 256 its
    // warpgroup first gives its registers up to the consumers
    if constexpr (HD == 256)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == NWG * 128) {
      mbar_expect_tx(qbar, TQ * HD * 2);
      for (int j = 0; j < L::SLABS; ++j)
        tma_load(base + L::Q + j * L::QSLAB, &qmap, h * HD + j * L::COLS,
                 q0, b, qbar);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % NS;
        mbar_wait(empty0 + 8 * st, ((t / NS) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * st, 2 * L::TILE);
        const int k0 = (t_lo + t) * TK;
        for (int j = 0; j < L::SLABS; ++j) {
          const int col = kvh * HD + j * L::COLS;
          tma_load(base + L::K + st * L::TILE + j * L::SLAB, &kmap, col, k0,
                   b, full0 + 8 * st);
          tma_load(base + L::V + st * L::TILE + j * L::SLAB, &vmap, col, k0,
                   b, full0 + 8 * st);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows r0 .. r0 + 63; at head_dim 256
  // each takes 240 registers a thread (O alone is 128)
  if constexpr (HD == 256)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int row = 16 * ((tid / 32) % 4) + lane / 4;   // and row + 8
  const int r0 = q0 + WQ * wg;
  const int qp0 = r0 + row, qp1 = qp0 + 8;
  // this warpgroup's tiles, as indices into the CTA's (none if r0 >= S)
  const int my_lo = max(0, r0 - W + 1) / TK - t_lo;
  const int my_hi =
      r0 < S ? max(min(r0 + WQ - 1, S - 1), p_last) / TK - t_lo : -1;

  const uint64_t qdesc = make_desc(base + L::Q + wg * WQ * L::ROW, 16,
                                   L::ATOM, L::MODE);   // slab 0
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float s[TK / 2] = {};

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % NS;
    mbar_wait(full0 + 8 * st, (t / NS) & 1);
    if (t >= my_lo && t <= my_hi) {
      // S = Q K^T: both K-major; a k16 step is 32 bytes along the slab
      // row, and step kk lies in slab kk / (COLS / 16)
      fence_regs(s);
      wgmma_fence();
      const uint64_t kdesc =
          make_desc(base + L::K + st * L::TILE, 16, L::ATOM, L::MODE);
      if constexpr (HD == 256) {
        qk_256<L::QSLAB, L::SLAB>(s, qdesc, kdesc);
      } else {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int slab = kk / (L::COLS / 16), in = kk % (L::COLS / 16);
          wgmma_ss(s, qdesc + ((slab * L::QSLAB) >> 4) + 2 * in,
                   kdesc + ((slab * L::SLAB) >> 4) + 2 * in, kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // s[4j + e] is row (e < 2 ? row : row + 8), key k0 + 8j + 2 quad +
      // (e & 1); sc * s is the score in the log2 domain
      const int k0 = (t_lo + t) * TK;
      float sc = scale_log2;
      if (cap > 0.0f) {
        const float capl = cap * LOG2E;
#pragma unroll
        for (int i = 0; i < TK / 2; ++i)
          s[i] = capl * tanhf(s[i] * (scale_log2 / capl));
        sc = 1.0f;
      }
      if (k0 + TK - 1 > r0 || k0 <= r0 + WQ - 1 - W || k0 + TK > S) {
#pragma unroll
        for (int i = 0; i < TK / 2; ++i) {
          const int kp = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
          const int qp = (i & 2) ? qp1 : qp0;
          if (!((kp <= qp || kp < P) && kp > qp - W && kp < S))
            s[i] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float n0 = fmaxf(m0, quad_max(mx0) * sc);
      const float n1 = fmaxf(m1, quad_max(mx1) * sc);
      const float b0 = n0 == -INFINITY ? 0.0f : n0;   // a fully masked row
      const float b1 = n1 == -INFINITY ? 0.0f : n1;
      const float c0 = ex2(m0 - b0), c1 = ex2(m1 - b1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], sc, -b0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sc, -b0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sc, -b1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sc, -b1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
      // P as the A fragment of k16 step kk: the accumulator's columns
      // 16 kk .. 16 kk + 15 are its registers 8 kk .. 8 kk + 7
      uint32_t p[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V: V is [key][hd], MN-major; a k16 step is 16 rows. Slab
      // j holds output columns 64 j .. 64 j + 63, which are the
      // accumulator's registers 32 j .. 32 j + 31 (one m64n64 product each)
      fence_regs(o);
      wgmma_fence();
      const uint64_t vdesc = make_desc(base + L::V + st * L::TILE, L::ATOM,
                                       L::ATOM, L::MODE);
      if constexpr (HD == 256) {
        pv_256<L::SLAB, L::ROW>(o, p, vdesc);
      } else {
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
          for (int j = 0; j < L::SLABS; ++j)
            wgmma_rs(*reinterpret_cast<float(*)[HD / 2 / L::SLABS]>(
                         o + j * (HD / 2 / L::SLABS)),
                     p[kk], vdesc + ((j * L::SLAB + 16 * L::ROW * kk) >> 4));
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // out = o / max(l, 1e-30) in bf16, staged in shared memory as the Q
  // tile is laid out (this warpgroup's rows of each slab), the 16-byte
  // chunks of a slab row rotated by the row (no bank conflicts), then
  // 16-byte stores. Chunk j of a row (columns 8j .. 8j + 7) is chunk
  // j % CS of slab j / CS.
  constexpr int CH = HD / 8;                      // 16-byte chunks per row
  constexpr int CS = L::ROW / 16;                 // per slab row
  const float l0s = quad_sum(l0), l1s = quad_sum(l1);
  const float d0 = fmaxf(l0s, 1e-30f);
  const float d1 = fmaxf(l1s, 1e-30f);
  if constexpr (LSE) {
    // under autograd: each row's log-sum-exp in natural-log units, for the
    // backward (swa_bwd.cu); m is in the log2 domain
    if (quad == 0) {
      float* lrow = lse + (static_cast<int64_t>(b) * H + h) * S;
      if (qp0 < S) lrow[qp0] = (m0 + log2f(l0s)) * LN2;
      if (qp1 < S) lrow[qp1] = (m1 + log2f(l1s)) * LN2;
    }
  }
  uint8_t* stage = smem + L::O + wg * WQ * L::ROW;
  const int ra = row, rb = row + 8;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    uint8_t* sp = stage + (j / CS) * L::QSLAB + 4 * quad;
    const int c = j % CS;
    *reinterpret_cast<uint32_t*>(sp + ra * L::ROW + ((c ^ (ra % CS)) * 16))
        = pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
    *reinterpret_cast<uint32_t*>(sp + rb * L::ROW + ((c ^ (rb % CS)) * 16))
        = pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  const int64_t q_row = static_cast<int64_t>(H) * HD;
  for (int e = tid % 128; e < WQ * CH; e += 128) {
    const int r = e / CH, c = e % CH;
    const int qp = r0 + r;
    if (qp >= S) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        stage + (c / CS) * L::QSLAB + r * L::ROW
        + (((c % CS) ^ (r % CS)) * 16));
    *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(b) * S + qp) * q_row
                              + h * HD + c * 8) = val;
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int S, int H, int KH,
                        int W, int P, float scale, float cap,
                        cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!encode(&qmap, q, B, S, H, HD, TQ) ||
      !encode(&kmap, k, B, S, KH, HD, TK) ||
      !encode(&vmap, v, B, S, KH, HD, TK))
    return cudaErrorInvalidValue;
  // the serving path (lse null) and the training path are two builds, so
  // that the former runs exactly the instructions it ran before lse
  const auto kernel = lse == nullptr ? swa_wgmma<HD, false>
                                     : swa_wgmma<HD, true>;
  const int smem = Smem<HD>::BYTES + 1024;          // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t ctas = static_cast<int64_t>(B) * H * ((S + TQ - 1) / TQ);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(ctas), NTW<HD>, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), lse, S, H, KH, W,
      P, scale * LOG2E, cap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 (CUDA cores), 1 = bf16 (wgmma + TMA); q, k, v and out
// share it. hd in {16, 64, 128, 256} (the reduced and the full hymba, the
// head_dim-128 decoders: chatglm3, moonshot, grok, llama4; paligemma);
// H % KH == 0; W >= 1; P >= 0 prefix positions (0: none); cap <= 0: no
// softcap. bf16 pointers must be 16-byte aligned. lse: null, or (bf16
// only) a (B, H, S) fp32 output of each row's log-sum-exp, which the
// backward's bf16 kernels read.
extern "C" int repro_swa(const void* q, const void* k, const void* v,
                         void* out, float* lse, int dtype, int B, int S,
                         int H, int KH, int hd, int W, int P, float scale,
                         float cap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || W < 1 || P < 0 ||
      (hd != 16 && hd != 64 && hd != 128 && hd != 256) || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = dtype == 0
      ? (hd == 256 ? launch_fp32<256> : hd == 128 ? launch_fp32<128>
         : hd == 64 ? launch_fp32<64> : launch_fp32<16>)
      : (hd == 256 ? launch_bf16<256> : hd == 128 ? launch_bf16<128>
         : hd == 64 ? launch_bf16<64> : launch_bf16<16>);
  return static_cast<int>(launch(q, k, v, out, lse, B, S, H, KH, W, P,
                                 scale, cap, s));
}
