// Chamfer 1-NN search for NVIDIA Hopper (sm_90a).
//
//   for each pair p and src point n:
//     d[m]      = dx*dx + dy*dy + dz*dz + penalty[m]   (dx = src - tgt)
//     dist[p,n] = min(min_m d[m], BIG),  idx[p,n] = lowest m at that min
//   penalty is BIG for an invalid tgt point; a masked src gives (BIG, 0);
//   distances are clamped at >= 0.
//
// Replaces the TPU Pallas kernel rslo_tpu/ops/chamfer.py::
// nn_search_pallas.  The plain PyTorch version is
// rslo_tpu_torch/ops/chamfer.py::nn_search_plain.
//
// Rounding: every product and sum goes through __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA.  The distance is
// then rounded exactly as the plain version (and the Pallas kernel)
// rounds it, ((dx*dx + dy*dy) + dz*dz), so at near-ties both pick the
// same index: the two are bit-equal in dist and idx.
//
// The penalty add is dropped: an invalid tgt is staged as (+inf, +inf,
// +inf), a valid one as it is.  For a valid tgt d + 0 == d (d >= +0 or
// NaN), so its distance is unchanged; the plain version never selects an
// invalid tgt (d + BIG >= BIG fails the strict d < best against the
// initial best of BIG), and neither does this kernel (its d is +inf or
// NaN, which fails the same test).
//
// Ties: each thread keeps, per src point, the running minimum of CHUNK
// distances at a time (fminf, which skips NaN as the strict compare
// does) and takes a chunk's minimum only when it is below the best so
// far (strict), remembering the chunk.  The first chunk that reaches the
// final minimum is the one remembered; after the cluster's merge that
// chunk alone is scanned again, recomputing the same bits, for the first
// index at the minimum.  So the lowest index at the minimum wins, as in
// the plain version's sequential strict update.
//
// What bounds it on this card: instruction issue.  A deployed call is 3
// pairs x 20000 src x 20000 tgt = 1.2e9 distances of 8 rounded f32 ops
// (none may fuse) and a min, ~9.1 issued instructions a pair: ~330 us at
// the H100's 4 warp-instructions per SM and clock.  Its 12 bytes a point
// stay in L2.  The design:
//   * a thread holds R = 8 src points, so each tgt read from shared
//     memory (one broadcast float4) serves 8 independent chains;
//   * a thread-block cluster of CLUSTER blocks works on one src tile,
//     each block scanning its share of the tgts, so a 3 x 20000 call runs
//     480 blocks of 4 warps, all resident at once on the 132 SMs;
//   * a chunk's minimum costs one fminf a pair, where a compare-select of
//     (dist, idx) would cost three; the index is found once a src point,
//     by the scan again of one chunk;
//   * the blocks' partial (best, chunk) are merged through distributed
//     shared memory: the lexicographic minimum, which is the first chunk
//     at the minimum in any order of blocks (the shares lie in rank
//     order).  One launch, no scratch in device memory, no atomics.
// scripts/torch_nn_search_variants.py times the neighbours of this
// design (threads, src points a thread, cluster size, unrolling) and
// the parts of the work (the second scan; an FMA-contracted distance,
// whose time falls with its instruction count).
// Any N and M (ragged tiles are masked, M may be 0 or below CLUSTER), and
// a leading pair axis on the grid's y, so one launch serves every pair.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;              // blocks sharing one src tile
constexpr int THREADS = 128;
constexpr int R = 8;                    // src points per thread
constexpr int SRC_TILE = THREADS * R;   // src points per cluster
constexpr int CHUNK = 32;               // distances per running-min step
constexpr int TILE_M = 512;             // tgts staged at a time (8 KB)
constexpr int SEG = SRC_TILE / CLUSTER; // src points each block merges
constexpr float BIG = 1e30f;
static_assert(TILE_M % CHUNK == 0 && SRC_TILE % CLUSTER == 0, "tiling");

// tgt m as staged: its coordinates if valid, +inf if invalid or past M
__device__ __forceinline__ float4 stage(const float* tg, const uint8_t* tm,
                                        int m, int M) {
  const float inf = __int_as_float(0x7f800000);
  if (m >= M) return make_float4(inf, inf, inf, 0.f);
  const float* t = tg + (int64_t)m * 3;
  const float x = t[0], y = t[1], z = t[2];   // loaded with the mask
  return tm[m] ? make_float4(x, y, z, 0.f) : make_float4(inf, inf, inf, 0.f);
}

__device__ __forceinline__ float sq_dist(float sx, float sy, float sz,
                                         float4 t) {
  const float dx = __fsub_rn(sx, t.x);
  const float dy = __fsub_rn(sy, t.y);
  const float dz = __fsub_rn(sz, t.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __cluster_dims__(CLUSTER, 1, 1)
__launch_bounds__(THREADS, 6)
nn_search_kernel(const float* __restrict__ src,
                 const uint8_t* __restrict__ src_mask,
                 const float* __restrict__ tgt,
                 const uint8_t* __restrict__ tgt_mask,
                 float* __restrict__ dist, int32_t* __restrict__ idx,
                 int N, int M) {
  __shared__ float4 t_s[TILE_M];
  __shared__ float part_d[SRC_TILE];
  __shared__ int part_f[SRC_TILE];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int p = blockIdx.y;
  const int n0 = (blockIdx.x / CLUSTER) * SRC_TILE;
  const float* tg = tgt + (int64_t)p * M * 3;
  const uint8_t* tm = tgt_mask + (int64_t)p * M;

  float sx[R], sy[R], sz[R], best[R];
  int first[R];   // tgt index of the chunk that set best, -1 for none
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r * THREADS + tid;
    const float* s = src + ((int64_t)p * N + n) * 3;
    sx[r] = n < N ? s[0] : 0.f;
    sy[r] = n < N ? s[1] : 0.f;
    sz[r] = n < N ? s[2] : 0.f;
    best[r] = BIG;
    first[r] = -1;
  }

  // this block's share of the tgts: whole chunks, in rank order
  const int64_t share =
      ((M + (int64_t)CLUSTER - 1) / CLUSTER + CHUNK - 1) / CHUNK * CHUNK;
  const int m_lo = (int)min((int64_t)M, rank * share);
  const int m_hi = (int)min((int64_t)M, m_lo + share);
  const float inf = __int_as_float(0x7f800000);
  for (int m0 = m_lo; m0 < m_hi; m0 += TILE_M) {
    const int tile = min(TILE_M, m_hi - m0);
    const int chunks = (tile + CHUNK - 1) / CHUNK;
    __syncthreads();   // the previous tile is no longer read
    for (int j = tid; j < chunks * CHUNK; j += THREADS)
      t_s[j] = j < tile ? stage(tg, tm, m0 + j, M)
                        : make_float4(inf, inf, inf, 0.f);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      float cmin[R];
#pragma unroll
      for (int r = 0; r < R; ++r) cmin[r] = inf;
#pragma unroll 8
      for (int j = 0; j < CHUNK; ++j) {
        const float4 t = t_s[c * CHUNK + j];
#pragma unroll
        for (int r = 0; r < R; ++r)
          cmin[r] = fminf(cmin[r], sq_dist(sx[r], sy[r], sz[r], t));
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (cmin[r] < best[r]) {
          best[r] = cmin[r];
          first[r] = m0 + c * CHUNK;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    part_d[r * THREADS + tid] = best[r];
    part_f[r * THREADS + tid] = first[r];
  }

  // merge the cluster's partials, each block SEG src points: the
  // lexicographic minimum of (best, first) is the first chunk of the
  // cluster's tgts at the minimum (the shares lie in rank order)
  cluster.sync();
  for (int k = tid; k < SEG; k += THREADS) {
    const int s = rank * SEG + k;
    float d = BIG;
    int f = -1;
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
      const float dq = cluster.map_shared_rank(part_d, q)[s];
      const int fq = cluster.map_shared_rank(part_f, q)[s];
      if (dq < d || (dq == d && fq < f)) {
        d = dq;
        f = fq;
      }
    }
    const int n = n0 + s;
    int at = 0;
    if (f >= 0 && n < N) {
      // the first index at the minimum, in the one chunk that set it:
      // its distances recomputed from independent loads, last to first
      const float* sp = src + ((int64_t)p * N + n) * 3;
      const float x = sp[0], y = sp[1], z = sp[2];
      const int end = min((int64_t)M, f + (int64_t)CHUNK);
#pragma unroll 8
      for (int j = CHUNK - 1; j >= 0; --j)
        if (sq_dist(x, y, z, stage(tg, tm, f + j, end)) == d) at = f + j;
    }
    if (n < N) {
      const int64_t sp = (int64_t)p * N + n;
      const bool ok = src_mask[sp] != 0;
      dist[sp] = ok ? fmaxf(d, 0.f) : BIG;
      idx[sp] = ok ? at : 0;
    }
  }
  cluster.sync();   // no block leaves while another reads its partials
}

}  // namespace

extern "C" {

// All pointers are device pointers: src (P, N, 3) f32, src_mask (P, N)
// bool, tgt (P, M, 3) f32, tgt_mask (P, M) bool -> dist (P, N) f32,
// idx (P, N) int32.  Returns cudaGetLastError() after the launch.
int nn_search_launch(const void* src, const void* src_mask, const void* tgt,
                     const void* tgt_mask, void* dist, void* idx, int P,
                     int N, int M, void* stream) {
  if (P <= 0 || N <= 0 || M < 0 || P > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (N + (int64_t)SRC_TILE - 1) / SRC_TILE;
  if (tiles * CLUSTER > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * CLUSTER), P);
  nn_search_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const uint8_t*>(src_mask),
      static_cast<const float*>(tgt), static_cast<const uint8_t*>(tgt_mask),
      static_cast<float*>(dist), static_cast<int32_t*>(idx), N, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
