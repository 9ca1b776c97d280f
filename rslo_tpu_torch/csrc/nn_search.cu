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
// rounds it, ((dx*dx + dy*dy) + dz*dz) + penalty, so at near-ties both
// pick the same index: the two are bit-equal in dist and idx.
//
// Ties: each thread scans m in ascending order and takes a new best only
// when d < best (strict), so the lowest index at the minimum wins; an
// invalid tgt has d == BIG after rounding (|x|^2 << ulp(1e30)), which
// never beats the initial best of BIG, so a src with no valid tgt keeps
// (BIG, 0), as the Pallas kernel's strict cross-tile update does.
//
// What bounds it on this card: arithmetic.  A deployed call is 3 pairs x
// 20000 src x 20000 tgt = 1.2e9 distance evaluations of 9 f32 ops, on
// 12 bytes per point (all of it fits in L2).  The design: one thread per
// src point with its best (dist, idx) in registers; the block stages tgt
// tiles of (x, y, z, penalty) as float4 in shared memory, so each tgt
// point is read from device memory once per block and broadcast to all
// threads from shared memory.  Any N and M (ragged last tiles are
// masked), and a leading pair axis on the grid's y, so one launch serves
// every frame pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // src points per block
constexpr int TILE_M = 1024;   // tgt points staged per tile (16 KB)
constexpr float BIG = 1e30f;

__global__ void __launch_bounds__(THREADS)
nn_search_kernel(const float* __restrict__ src,
                 const uint8_t* __restrict__ src_mask,
                 const float* __restrict__ tgt,
                 const uint8_t* __restrict__ tgt_mask,
                 float* __restrict__ dist, int32_t* __restrict__ idx,
                 int N, int M) {
  __shared__ float4 t_s[TILE_M];
  const int p = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const bool live = n < N;
  const int64_t sp = (int64_t)p * N + n;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (live) {
    sx = src[sp * 3 + 0];
    sy = src[sp * 3 + 1];
    sz = src[sp * 3 + 2];
  }
  const float* tg = tgt + (int64_t)p * M * 3;
  const uint8_t* tm = tgt_mask + (int64_t)p * M;

  float best = BIG;
  int best_i = 0;
  for (int m0 = 0; m0 < M; m0 += TILE_M) {
    const int tile = min(TILE_M, M - m0);
    __syncthreads();   // the previous tile is no longer read
    for (int j = threadIdx.x; j < tile; j += THREADS) {
      const int64_t m = m0 + j;
      t_s[j] = make_float4(tg[m * 3 + 0], tg[m * 3 + 1], tg[m * 3 + 2],
                           tm[m] ? 0.f : BIG);
    }
    __syncthreads();
    for (int j = 0; j < tile; ++j) {
      const float4 t = t_s[j];
      const float dx = __fsub_rn(sx, t.x);
      const float dy = __fsub_rn(sy, t.y);
      const float dz = __fsub_rn(sz, t.z);
      float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      d = __fadd_rn(d, __fmul_rn(dz, dz));
      d = __fadd_rn(d, t.w);
      if (d < best) {
        best = d;
        best_i = m0 + j;
      }
    }
  }
  if (live) {
    const bool ok = src_mask[sp] != 0;
    dist[sp] = ok ? fmaxf(best, 0.f) : BIG;
    idx[sp] = ok ? best_i : 0;
  }
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
  const dim3 grid((N + THREADS - 1) / THREADS, P);
  nn_search_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const uint8_t*>(src_mask),
      static_cast<const float*>(tgt), static_cast<const uint8_t*>(tgt_mask),
      static_cast<float*>(dist), static_cast<int32_t*>(idx), N, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
