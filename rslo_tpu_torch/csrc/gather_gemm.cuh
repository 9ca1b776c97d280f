// One gather-GEMM for NVIDIA Hopper (sm_90a), shared by the sparse conv's
// rulebook kernel (B1, csrc/gather_matmul.cu) and the band engine's conv
// (B4, csrc/band_conv.cu).  Each .cu supplies its row-source policy and
// its C entry point; the body lives here once.
//
//   out[v, :] = sum_k [src(v, k) >= 0] f[src(v, k)] @ W[k]   (+ bias, then
//               zeroed where out_mask[v] is false)
//
// src(v, k) is the policy: a rulebook's (idx, valid) of shape (V, K), or
// a band plan's base (nB, K) + sel (nB, K, B).  It replaces the bodies of
// the TPU Pallas kernels rslo_tpu/ops/dma_gather.py::dma_gather_matmul and
// rslo_tpu/ops/band_conv.py::_windowed_pallas_conv.
//
// Modes (the compute dtype of the contract):
//   MODE_BF16        operands rounded to bf16 (round-to-nearest-even) and
//                    multiplied on the tensor cores (mma.sync m16n8k16,
//                    bf16 x bf16 -> f32).  A bf16 product is exact in f32.
//                    Each 16-deep MMA starts from 0 and its result is
//                    added to the f32 sums with an ordinary f32 add: a
//                    Hopper MMA aligns its addends and truncates inside
//                    the instruction, so chaining MMAs over all taps would
//                    carry that error through every sum.
//   MODE_BF16_DGRAD  the feature gradient of a bf16 conv: f32 rows times
//                    weights already rounded to bf16, each tap's partial
//                    rounded to bf16 before it joins the f32 sum.  On the
//                    tensor cores: each f32 row is split into exact
//                    hi + mid + lo bf16 pieces, so every product is exact,
//                    and the tap's three MMAs run into a fresh fragment.
//                    Its reference (autograd's f32 product, rounded to
//                    bf16) sums the channels in order; a partial summed in
//                    another order can round to the other bf16 neighbour,
//                    which costs up to 2^-7 of the partial against the
//                    backward's tolerance of 2^-8 of the magnitudes.  So a
//                    fourth MMA sums the magnitudes, and an entry that is
//                    both large against them and within the MMAs' error
//                    bound of a rounding tie is summed again as the
//                    in-order f32 chain (rare: the kernel body says when).
//   MODE_F32         exact f32 products, f32 FMAs on the CUDA cores (no
//                    TF32, which would round the operands).
//
// What bounds it on this card.  The math is tiny: the widest conv (64 ->
// 64, 20480 rows, 27 taps) is well under 1 us of bf16 tensor-core time.
// The kernel is bound by moving one feature row (28-256 bytes) per valid
// (row, tap) pair and W[k] per (tile, tap) from L2 into the SMs (the
// features, <= 10.5 MB, stay in the 50 MB L2) and by the latency of each
// such gather.  The scalar kernel it replaces paid, per tap, two dependent
// L2 round trips (indices, then rows) and three barriers with nothing in
// flight, then f32 FMAs with two shared loads each.  The bf16 feature
// gradient issues four MMAs where the forward issues one; at 64 -> 64 its
// mma.sync rate, not the gathers, bounds it (about 2x the forward's time;
// PERF.md has the per-conv times, H100 80GB HBM3 at 700 W).
//
// What the design does about it.
//   * A block owns 64 output rows.  It loads the (64, K) sources of its
//     rows once (the policy's arrays, read contiguously, eight loads in
//     flight per thread) into shared memory, and lists the taps that any
//     of its rows uses; it loops over that list only.
//   * The rows and W[k] of the next taps are gathered with cp.async while
//     the current tap computes: 3 stages, or 2 where 3 would leave too few
//     blocks per SM to run the grid in one wave; one barrier per tap.  A
//     warp whose 16 rows have no pair at a tap skips its math there.
//     16-byte copies where the row width and pointer allow, else 4-byte
//     ones (Cin = 7 rows are 28 bytes).  Only the rows that have a pair at
//     the tap are copied (at L0 ~6% of a tile's rows per tap: zero-fill
//     copies of the others cost most of the time in this design's first
//     version); the math masks the other rows' stale words to zero, so a
//     row behind an invalid tap is never read and a NaN there cannot
//     reach a sum.
//   * bf16: four warps, one per 16 output rows; the f32 sums stay in
//     registers across all taps in the MMA's accumulator layout.  The A
//     fragments are built from the staged f32 rows with cvt.rn.bf16x2, so
//     features stay f32 in device memory and no cast kernel is launched;
//     the B fragments likewise from the staged f32 W[k].  Cin is padded to
//     16 and Cout to 8 with zeros (then to a power of two of k steps and n
//     tiles: the kernel is compiled for those widths).  (W[k] read into
//     registers one tap ahead and stored as packed bf16 pairs took half
//     the shared memory but left each tap waiting on that read: 31.5 us
//     at the L0 conv on an H100 80GB HBM3 at 700 W, 2-3 us more than
//     this.)
//   * The bf16 feature gradient: the same fragments, four MMAs per k step
//     and n tile (lo, mid, hi chained into one fresh fragment; |hi| x |W|
//     for the magnitudes), summed over the k steps in f32; the near-tie
//     test (near_tie) runs on every entry without a branch, and a
//     warp-wide vote guards the re-sum of the few entries it flags.
//   * f32: the same staged rows and W[k], and each lane's f32 FMAs in the
//     same accumulator layout.
//   * The epilogue adds the bias, zeroes masked rows and writes the tile
//     once, row-major through shared memory, with coalesced stores.  A row
//     is owned by one block: no atomics, the result is deterministic.
// Why mma.sync and not wgmma/TMA: wgmma needs 64-row tiles of A in a
// swizzled shared layout fed by TMA or a transposing copy, and buys math
// throughput this kernel does not need.  TMA copies boxes of a tensor;
// its gather mode (rows by index) is sm_100's, not Hopper's, and the rows
// here are random.  cp.async is Hopper's tool for gathered rows.
//
// Shared memory per block: stages x (64 x (Cin' + 8) + Cin' x (Cout' + 4))
// f32 and 64 x K int32 sources; the pads make the fragment loads free of
// bank conflicts.  Above 48 KB it is opted into with cudaFuncSetAttribute.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: the static locals below (and the kernels) are each
// library's own, even where two builds of a source share a process.
namespace gather_gemm {
namespace {

constexpr int TILE_M = 64;           // output rows per block
constexpr int WARPS = TILE_M / 16;   // one warp per 16 rows
constexpr int THREADS = WARPS * 32;
constexpr int MAX_C = 64;            // widest Cin / Cout taken
constexpr int FILL_UNROLL = 8;       // source loads in flight per thread
constexpr int SMEM_MAX = 227 * 1024;
constexpr int SMEM_SM = 228 * 1024;  // an SM's shared memory ...
constexpr int SMEM_RESERVED = 1024;  // ... of which each block reserves

enum Mode { MODE_F32 = 0, MODE_BF16 = 1, MODE_BF16_DGRAD = 2 };

__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

// Shared-memory layout, in 4-byte words; the same on host and device.
struct Layout {
  int cin_p, cout_p;  // Cin padded to 16 x KS, Cout to 8 x NT
  int ls, lw;         // row strides of a staged row tile and of W[k]
  int stage;          // words per stage: rows, then W[k]
  int nstage;
  int src_off;        // (K, TILE_M) int32 sources
  int used_off;       // K flags, then the list of used taps, then its size
  int epi_off;        // the epilogue's bias (Cout') and row mask (TILE_M)
  int words;

  __host__ __device__ Layout(int ks, int nt, int K, int stages) {
    cin_p = 16 * ks;
    cout_p = 8 * nt;
    ls = cin_p + 8;
    lw = cout_p + 4;
    stage = TILE_M * ls + cin_p * lw;
    nstage = stages;
    src_off = nstage * stage;
    used_off = src_off + K * TILE_M;
    epi_off = used_off + 2 * K + 1;
    words = epi_off + cout_p + TILE_M;
    // the epilogue's (TILE_M, Cout') tile reuses the stages, which always
    // hold it: 2 x 64 x (16 + 8) >= 64 x 8 and 2 x (64 x 24 + 16 x 68) >=
    // 64 x 64
  }
  __host__ __device__ int bytes() const { return words * 4; }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return (uint32_t)__bfloat16_as_ushort(v.x) |
         ((uint32_t)__bfloat16_as_ushort(v.y) << 16);
}

// cvt.rn.bf16x2.f32: the lower k (or column) in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}

// d = a @ b for one m16n8k16 bf16 tile, f32 result, from a zero sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d += a @ b, in one MMA
__device__ __forceinline__ void mma_bf16_acc(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// An f32 pair as three bf16 pairs, x = hi + mid + lo exactly (each piece
// takes the next 8 bits of x's 24; the differences are exact in f32).
__device__ __forceinline__ void split3_bf16(float2 x, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(x.x - hf.x, x.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = pack_bf16(r.x - mf.x, r.y - mf.y);
}


// Gather the valid rows of one tap into a stage; a row whose source is
// -1 is not copied (its stale words are masked out of the math).  The
// loops run over the padded widths, compile-time, and skip the padding.
template <int KS>
__device__ __forceinline__ void load_rows(float* g, const int* src_k,
                                          const float* __restrict__ f,
                                          int Cin, int ls, bool vec_f) {
  if (vec_f) {
    constexpr int NC = KS * 4;             // 16-byte chunks of a row
#pragma unroll
    for (int e = threadIdx.x; e < TILE_M * NC; e += THREADS) {
      const int r = e / NC;
      const int c = (e % NC) * 4;
      const int s = src_k[r];
      if (s >= 0 && c < Cin)
        cp_async16(g + r * ls + c, f + (int64_t)s * Cin + c);
    }
  } else {   // two threads per row, alternate words
    static_assert(THREADS == 2 * TILE_M, "two threads per row");
    const int r = threadIdx.x / 2;
    const int s = src_k[r];
    if (s >= 0)
      for (int c = threadIdx.x % 2; c < Cin; c += 2)
        cp_async4(g + r * ls + c, f + (int64_t)s * Cin + c);
  }
}

// Stage W[k] as f32 rows of stride lw.
template <int KS, int NT>
__device__ __forceinline__ void load_w(float* ws, const float* __restrict__ wk,
                                       int Cin, int Cout, int lw,
                                       bool vec_w) {
  if (vec_w) {
    constexpr int NC = NT * 2;             // 16-byte chunks of a row
#pragma unroll
    for (int e = threadIdx.x; e < KS * 16 * NC; e += THREADS) {
      const int r = e / NC;
      const int c = (e % NC) * 4;
      if (r < Cin && c < Cout)
        cp_async16(ws + r * lw + c, wk + r * Cout + c);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < KS * 16 * NT * 8; e += THREADS) {
      const int r = e / (NT * 8);
      const int c = e % (NT * 8);
      if (r < Cin && c < Cout) cp_async4(ws + r * lw + c, wk + r * Cout + c);
    }
  }
}

// f32 FMA chains over the channels in order, for the lane's two rows and
// two columns of each n tile.
// A row that has no pair at the tap reads as zeros.
template <int NT>
__device__ __forceinline__ void fma_tap(float (&s)[NT][4], const float* g_lo,
                                        const float* g_hi, bool v_lo,
                                        bool v_hi, const float* ws, int Cin,
                                        int lw, int tig) {
#pragma unroll 4
  for (int ci = 0; ci < Cin; ++ci) {
    const float a_lo = v_lo ? g_lo[ci] : 0.f;
    const float a_hi = v_hi ? g_hi[ci] : 0.f;
    const float* wr = ws + ci * lw + 2 * tig;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(wr + 8 * j);
      s[j][0] = fmaf(a_lo, b.x, s[j][0]);
      s[j][1] = fmaf(a_lo, b.y, s[j][1]);
      s[j][2] = fmaf(a_hi, b.x, s[j][2]);
      s[j][3] = fmaf(a_hi, b.y, s[j][3]);
    }
  }
}

// One entry of a tap's partial as fma_tap sums it: an f32 FMA chain over
// the channels in order (gr: the staged row, wc: W[k]'s column).
__device__ __forceinline__ float fma_entry(const float* gr, const float* wc,
                                           int Cin, int lw) {
  float s = 0.f;
  for (int ci = 0; ci < Cin; ++ci) s = fmaf(gr[ci], wc[ci * lw], s);
  return s;
}

// e / magnitudes: a bound on |MMA sum - in-order f32 chain| of a tap's
// partial over Cin channels in KS k steps, relative to the sum of its
// terms' magnitudes.  2^-17 for the truncation of the MMAs (each within
// ~18 units of 2^-23 of the magnitudes of its own terms and addend; ~4x
// over); Cin + KS + 3 units of 2^-24 for the chain's and the k steps'
// roundings, 2 more for those of p +- e; 1.01 covers |hi| against the
// rows' magnitudes.
__device__ __forceinline__ float near_tie_rel(int Cin, int KS) {
  return 1.01f * (7.62939453125e-6f +                 // 2^-17
                  (Cin + KS + 5) * 5.9604644775390625e-8f);   // 2^-24
}

// Whether the bf16 rounding of a partial p (terms' magnitudes m) must be
// settled by the in-order chain: p - e and p + e round apart (rounding is
// monotonic, so a tie lies within e of p, e = rel x m), and a wrong
// neighbour would cost more than the entry's share of the backward's
// tolerance, |p| > 0.44 m.
__device__ __forceinline__ bool near_tie(float p, float m, float rel) {
  const float e = rel * m;
  const uint32_t r = pack_bf16(p - e, p + e);
  return ((r ^ (r >> 16)) & 0xffffu) != 0 && fabsf(p) > 0.44f * m;
}

// The stage of tap i: i % nstage for the 2 or 3 stages taken, by a
// constant modulus (a division per tap cost ~10% at the L0 convs on an
// H100 80GB HBM3 at 700 W).
__device__ __forceinline__ int stage_of(int i, int nstage) {
  return nstage == 3 ? i % 3 : i & 1;
}

// Policy interface (Src): `__device__ int source(int v, int k, int K,
// int Vin) const` gives output row v's input row at tap k, or -1, with no
// load behind a branch (so the fill keeps its loads in flight);
// `kTapFastest` says which order of (row, tap) reads the policy's arrays
// contiguously; `kFeatureGradient` whether MODE_BF16_DGRAD is compiled
// for it.  KS: 16-deep k steps of Cin; NT: 8-wide n tiles of Cout.
template <int MODE, int KS, int NT, class Src>
__global__ void __launch_bounds__(THREADS)
gather_gemm_kernel(const float* __restrict__ f, Src src,
                   const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const uint8_t* __restrict__ out_mask,
                   float* __restrict__ out, int Vin, int V, int K, int Cin,
                   int Cout, int nstage, int vec_f, int vec_w) {
  constexpr bool MMA = MODE != MODE_F32;
  extern __shared__ __align__(16) float smem[];
  const Layout L(KS, NT, K, nstage);
  int* src_s = reinterpret_cast<int*>(smem + L.src_off);
  int* used_s = reinterpret_cast<int*>(smem + L.used_off);
  int* list_s = used_s + K;
  int* n_used_s = list_s + K;
  float* bias_s = smem + L.epi_off;
  int* keep_s = reinterpret_cast<int*>(bias_s + L.cout_p);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;     // fragment row (and B column) of the lane
  const int tig = lane % 4;     // fragment column pair of the lane
  const int row0 = blockIdx.x * TILE_M;
  const int rows = min(TILE_M, V - row0);

  // the padding columns of the rows and of W[k] feed the MMAs and must
  // read as zeros; cp.async never writes them (the FMA chains stop at Cin)
  if (MMA && (L.cin_p != Cin || L.cout_p != Cout)) {
    for (int e = tid; e < nstage * L.stage; e += THREADS) smem[e] = 0.f;
  }
  if (tid < L.cout_p)
    bias_s[tid] = bias != nullptr && tid < Cout ? bias[tid] : 0.f;
  if (tid < TILE_M)
    keep_s[tid] = out_mask == nullptr || tid >= rows || out_mask[row0 + tid];
  // the block's sources, (K, TILE_M), -1 for none.  Every load is issued
  // unconditionally (past the tile's last row at that row), so the
  // unrolled loads are all in flight before the first is used.
  const int n_src = TILE_M * K;
  for (int e0 = tid; e0 < n_src; e0 += THREADS * FILL_UNROLL) {
    int s[FILL_UNROLL], r[FILL_UNROLL], k[FILL_UNROLL];
#pragma unroll
    for (int u = 0; u < FILL_UNROLL; ++u) {
      const int e = min(e0 + u * THREADS, n_src - 1);
      if (Src::kTapFastest) {
        r[u] = e / K;
        k[u] = e - r[u] * K;
      } else {
        k[u] = e / TILE_M;
        r[u] = e - k[u] * TILE_M;
      }
      s[u] = src.source(row0 + min(r[u], rows - 1), k[u], K, Vin);
    }
#pragma unroll
    for (int u = 0; u < FILL_UNROLL; ++u)
      if (e0 + u * THREADS < n_src)
        src_s[k[u] * TILE_M + r[u]] = r[u] < rows ? s[u] : -1;
  }
  __syncthreads();
  for (int k = warp; k < K; k += WARPS) {
    const int* sk = src_s + k * TILE_M;
    const bool any = __any_sync(0xffffffffu, sk[lane] >= 0 ||
                                                 sk[lane + 32] >= 0);
    if (lane == 0) used_s[k] = any;
  }
  __syncthreads();
  if (warp == 0) {   // the used taps, in order
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool u = k < K && used_s[k];
      const unsigned m = __ballot_sync(0xffffffffu, u);
      if (u) list_s[n + __popc(m & ((1u << lane) - 1u))] = k;
      n += __popc(m);
    }
    if (lane == 0) *n_used_s = n;
  }
  __syncthreads();
  const int n_used = *n_used_s;

  float acc[NT][4];   // the lane's sums, in the MMA accumulator layout
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  const int r_lo = warp * 16 + gid;    // the lane's two rows in the tile
  const int r_hi = r_lo + 8;

  const int64_t wstride = (int64_t)Cin * Cout;
  for (int s = 0; s < nstage - 1; ++s) {
    if (s < n_used) {
      float* st = smem + s * L.stage;
      load_rows<KS>(st, src_s + list_s[s] * TILE_M, f, Cin, L.ls, vec_f);
      load_w<KS, NT>(st + TILE_M * L.ls, w + list_s[s] * wstride, Cin, Cout,
                     L.lw, vec_w);
    }
    cp_async_commit();
  }
  for (int i = 0; i < n_used; ++i) {
    if (nstage == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();   // tap i has landed; tap i - 1's stage is free
    const int nxt = i + nstage - 1;
    if (nxt < n_used) {   // into the stage of tap i - 1
      float* st = smem + stage_of(nxt, nstage) * L.stage;
      load_rows<KS>(st, src_s + list_s[nxt] * TILE_M, f, Cin, L.ls, vec_f);
      load_w<KS, NT>(st + TILE_M * L.ls, w + list_s[nxt] * wstride, Cin,
                     Cout, L.lw, vec_w);
    }
    cp_async_commit();

    // a warp whose 16 rows have no pair at this tap has nothing to add
    const int* src_k = src_s + list_s[i] * TILE_M;
    if (!__any_sync(0xffffffffu, src_k[warp * 16 + lane % 16] >= 0))
      continue;
    const bool v_lo = src_k[r_lo] >= 0;
    const bool v_hi = src_k[r_hi] >= 0;
    const float* g = smem + stage_of(i, nstage) * L.stage;
    const float* ws = g + TILE_M * L.ls;
    if constexpr (MODE == MODE_BF16) {
      // A fragments of the lane: rows r_lo / r_hi, columns 2t, 2t+1 and
      // 2t+8, 2t+9 of each 16-deep k step
      uint32_t a[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int c = ks * 16 + 2 * tig;
        const float2 x0 = *reinterpret_cast<const float2*>(g + r_lo * L.ls + c);
        const float2 x1 = *reinterpret_cast<const float2*>(g + r_hi * L.ls + c);
        const float2 x2 =
            *reinterpret_cast<const float2*>(g + r_lo * L.ls + c + 8);
        const float2 x3 =
            *reinterpret_cast<const float2*>(g + r_hi * L.ls + c + 8);
        a[ks][0] = v_lo ? pack_bf16(x0.x, x0.y) : 0u;
        a[ks][1] = v_hi ? pack_bf16(x1.x, x1.y) : 0u;
        a[ks][2] = v_lo ? pack_bf16(x2.x, x2.y) : 0u;
        a[ks][3] = v_hi ? pack_bf16(x3.x, x3.y) : 0u;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          // B fragment: W rows 2t, 2t+1 and 2t+8, 2t+9 of the k step,
          // column 8j + g
          const float* wc = ws + (ks * 16 + 2 * tig) * L.lw + 8 * j + gid;
          float d[4];
          mma_bf16(d, a[ks], pack_bf16(wc[0], wc[L.lw]),
                   pack_bf16(wc[8 * L.lw], wc[9 * L.lw]));
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] += d[q];
        }
      }
    } else if constexpr (MODE == MODE_BF16_DGRAD) {
      // this tap's partial (rounded to bf16 on its own below) and the sum
      // of its terms' magnitudes, in the accumulator layout
      float part[NT][4], mag[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[j][q] = mag[j][q] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // the rows as exact hi + mid + lo bf16 pieces (A fragments as in
        // the forward); |hi| gives the magnitudes
        const int c = ks * 16 + 2 * tig;
        const float* xs[4] = {g + r_lo * L.ls + c, g + r_hi * L.ls + c,
                              g + r_lo * L.ls + c + 8, g + r_hi * L.ls + c + 8};
        uint32_t hi[4], mid[4], lo[4], ahi[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool v = q % 2 ? v_hi : v_lo;
          split3_bf16(v ? *reinterpret_cast<const float2*>(xs[q])
                        : make_float2(0.f, 0.f),
                      hi[q], mid[q], lo[q]);
          ahi[q] = hi[q] & 0x7fff7fffu;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* wc = ws + (ks * 16 + 2 * tig) * L.lw + 8 * j + gid;
          const uint32_t b0 = pack_bf16(wc[0], wc[L.lw]);
          const uint32_t b1 = pack_bf16(wc[8 * L.lw], wc[9 * L.lw]);
          float d[4], t[4];
          mma_bf16(d, lo, b0, b1);   // smallest pieces first
          mma_bf16_acc(d, mid, b0, b1);
          mma_bf16_acc(d, hi, b0, b1);
          mma_bf16(t, ahi, b0 & 0x7fff7fffu, b1 & 0x7fff7fffu);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            part[j][q] += d[q];
            mag[j][q] += t[q];
          }
        }
      }
      // Every product above is exact, but the MMAs sum in another order
      // (and truncate), so an entry's partial may round to the other bf16
      // neighbour than its reference (an in-order f32 chain) does.  Where
      // that could cost more than the entry's share of the backward's
      // tolerance (|partial| > 0.44 of its magnitudes: one bf16 ulp is up
      // to 2^-7 of the partial, the tolerance 2^-8 of the magnitudes) and
      // a rounding tie lies within e of the partial, the entry is summed
      // again as the in-order chain (near_tie).  The test runs without a
      // branch per entry (a branch per entry serializes the entries'
      // tests); one warp-wide vote guards the rare re-sum.
      const float rel = near_tie_rel(Cin, KS);
      uint32_t fix = 0;   // bit 4j + q: entry (j, q) is summed again
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          fix |= (uint32_t)near_tie(part[j][q], mag[j][q], rel)
                 << (4 * j + q);
      if (__any_sync(0xffffffffu, fix != 0)) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (fix >> (4 * j + q) & 1u)
              part[j][q] = fma_entry(g + (q < 2 ? r_lo : r_hi) * L.ls,
                                     ws + 8 * j + 2 * tig + q % 2, Cin, L.lw);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += round_bf16(part[j][q]);
    } else {
      fma_tap<NT>(acc, g + r_lo * L.ls, g + r_hi * L.ls, v_lo, v_hi, ws, Cin,
                  L.lw, tig);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages

  // epilogue: the tile, row-major (TILE_M, Cout'), through the stages
  float* o_s = smem;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(o_s + r_lo * L.cout_p + c) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(o_s + r_hi * L.cout_p + c) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  float* out_t = out + (int64_t)row0 * Cout;
  // element e = r * Cout + c, stepped without a division per element
  const int dr = THREADS / Cout, dc = THREADS - dr * Cout;
  int r = tid / Cout, c = tid - r * Cout;
#pragma unroll 4
  for (int e = tid; e < rows * Cout; e += THREADS) {
    out_t[e] = keep_s[r] ? o_s[r * L.cout_p + c] + bias_s[c] : 0.f;
    r += dr;
    c += dc;
    if (c >= Cout) {
      c -= Cout;
      ++r;
    }
  }
}

// Blocks of `bytes` shared memory that fit one SM.
inline int blocks_per_sm(int bytes) {
  return SMEM_SM / (bytes + SMEM_RESERVED);
}

// The layout of a launch over V rows: 3 stages, unless 3 leave too few
// blocks per SM for one wave and 2 would give more.  (Up to 5 stages where
// they fit was no faster at the L0 convs: the taps in flight do not bound
// the loop there.)
inline Layout pick_layout(int KS, int NT, int V, int K, int sms) {
  const int grid = (V + TILE_M - 1) / TILE_M;
  const int want = (grid + sms - 1) / sms;
  const Layout L3(KS, NT, K, 3), L2(KS, NT, K, 2);
  return blocks_per_sm(L3.bytes()) < want &&
                 blocks_per_sm(L2.bytes()) > blocks_per_sm(L3.bytes())
             ? L2
             : L3;
}

// SMs of the current device (asked once per device); 0 on an error.
inline int device_sms(int* dev) {
  static int sms[64] = {0};
  if (cudaGetDevice(dev) != cudaSuccess || *dev >= 64) return 0;
  if (sms[*dev] == 0 &&
      cudaDeviceGetAttribute(&sms[*dev], cudaDevAttrMultiProcessorCount,
                             *dev) != cudaSuccess)
    return 0;
  return sms[*dev];
}

template <int MODE, int KS, int NT, class Src>
int launch_widths(const float* f, Src src, const float* w, const float* bias,
                  const uint8_t* out_mask, float* out, int Vin, int V, int K,
                  int Cin, int Cout, cudaStream_t stream) {
  int dev = 0;
  const int sms = device_sms(&dev);
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  static int granted[64] = {0};    // the largest opt-in set so far
  const Layout L = pick_layout(KS, NT, V, K, sms);
  if (L.bytes() > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  auto kernel = gather_gemm_kernel<MODE, KS, NT, Src>;
  if (L.bytes() > 48 * 1024 && granted[dev] < L.bytes()) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.bytes());
    if (e != cudaSuccess) return (int)e;
    granted[dev] = L.bytes();
  }
  // 16-byte copies need 16-byte rows and 16-byte aligned bases
  const int vec_f = Cin % 4 == 0 && (uintptr_t)f % 16 == 0;
  const int vec_w = Cout % 4 == 0 && (uintptr_t)w % 16 == 0;
  const int grid = (V + TILE_M - 1) / TILE_M;
  kernel<<<grid, THREADS, L.bytes(), stream>>>(
      f, src, w, bias, out_mask, out, Vin, V, K, Cin, Cout, L.nstage, vec_f,
      vec_w);
  return (int)cudaGetLastError();
}

template <int MODE, int KS, class Src>
int launch_nt(const float* f, Src src, const float* w, const float* bias,
              const uint8_t* out_mask, float* out, int Vin, int V, int K,
              int Cin, int Cout, cudaStream_t stream) {
  switch (pow2_at_least((Cout + 7) / 8)) {
    case 1:
      return launch_widths<MODE, KS, 1>(f, src, w, bias, out_mask, out, Vin,
                                        V, K, Cin, Cout, stream);
    case 2:
      return launch_widths<MODE, KS, 2>(f, src, w, bias, out_mask, out, Vin,
                                        V, K, Cin, Cout, stream);
    case 4:
      return launch_widths<MODE, KS, 4>(f, src, w, bias, out_mask, out, Vin,
                                        V, K, Cin, Cout, stream);
    default:
      return launch_widths<MODE, KS, 8>(f, src, w, bias, out_mask, out, Vin,
                                        V, K, Cin, Cout, stream);
  }
}

template <int MODE, class Src>
int launch_ks(const float* f, Src src, const float* w, const float* bias,
              const uint8_t* out_mask, float* out, int Vin, int V, int K,
              int Cin, int Cout, cudaStream_t stream) {
  switch (pow2_at_least((Cin + 15) / 16)) {
    case 1:
      return launch_nt<MODE, 1>(f, src, w, bias, out_mask, out, Vin, V, K,
                                Cin, Cout, stream);
    case 2:
      return launch_nt<MODE, 2>(f, src, w, bias, out_mask, out, Vin, V, K,
                                Cin, Cout, stream);
    default:
      return launch_nt<MODE, 4>(f, src, w, bias, out_mask, out, Vin, V, K,
                                Cin, Cout, stream);
  }
}

// Dynamic shared memory (bytes) and stages of a launch over V rows, or -1.
inline int shared_bytes(int V, int K, int Cin, int Cout, int* stages) {
  int dev = 0;
  const int sms = device_sms(&dev);
  if (sms == 0 || V <= 0 || K <= 0 || Cin <= 0 || Cout <= 0 || Cin > MAX_C ||
      Cout > MAX_C)
    return -1;
  const Layout L = pick_layout(pow2_at_least((Cin + 15) / 16),
                               pow2_at_least((Cout + 7) / 8), V, K, sms);
  *stages = L.nstage;
  return L.bytes();
}

// Launch over V output rows.  Returns a cudaError_t (0 = launched).
template <class Src>
int launch(const float* f, Src src, const float* w, const float* bias,
           const uint8_t* out_mask, float* out, int Vin, int V, int K,
           int Cin, int Cout, int mode, cudaStream_t stream) {
  if (V <= 0 || Vin <= 0 || K <= 0 || Cin <= 0 || Cout <= 0 ||
      Cin > MAX_C || Cout > MAX_C)
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case MODE_F32:
      return launch_ks<MODE_F32>(f, src, w, bias, out_mask, out, Vin, V, K,
                                 Cin, Cout, stream);
    case MODE_BF16:
      return launch_ks<MODE_BF16>(f, src, w, bias, out_mask, out, Vin, V, K,
                                  Cin, Cout, stream);
    case MODE_BF16_DGRAD:
      if constexpr (Src::kFeatureGradient)
        return launch_ks<MODE_BF16_DGRAD>(f, src, w, bias, out_mask, out, Vin,
                                          V, K, Cin, Cout, stream);
      [[fallthrough]];
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace gather_gemm
