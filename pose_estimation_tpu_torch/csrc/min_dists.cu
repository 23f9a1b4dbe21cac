// Nearest source point of each target point: its distance and its index.
//
// Replaces pose_estimation_tpu/ops/pallas_pointops.py:_min_dists_kernel
// (launched by _min_dists_pallas), whose math is the main path's XLA form
// (core/pointops/neighbors.py:min_dists / nearest_index):
//   d[i, j] = (|t_i|^2 + |s_j|^2) - 2 t_i.s_j   in fp32,
//   best_i  = min_j d[i, j], index_i = argmin_j (ties to the lower j),
//   dist_i  = sqrt(max(best_i, eps^2)).
// The index is what the backward (ops/pointops.py:_MinDists) and the
// up-sampling maps of FusionNetLite (nearest_index) need; one kernel
// serves both.
//
// Design: one thread per target keeps the running minimum and its index in
// registers; the sources and their squared norms are staged through shared
// memory in tiles of MD_TILE, so the [n, m] distance matrix never exists.
// Bound on the card by the fp32 issue rate of the distance-and-compare loop
// (n * m * ~8 flops), not by memory: the inputs are a few hundred KB. The
// 3-term dots are rounded term by term (dot3_rn) in the plain version's
// order, so kernel and plain version agree bit for bit.
#include "common.cuh"

#define MD_THREADS 128
#define MD_TILE 1024

__global__ void __launch_bounds__(MD_THREADS)
min_dists_kernel(const float* __restrict__ target,
                 const float* __restrict__ source, float* __restrict__ dist,
                 int* __restrict__ index, int n, int m, float eps2) {
  __shared__ float4 tile[MD_TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  const float* tb = target + (size_t)b * n * 3;
  const float* sb = source + (size_t)b * m * 3;

  float tx = 0.f, ty = 0.f, tz = 0.f;
  if (active) {
    tx = tb[(size_t)i * 3 + 0];
    ty = tb[(size_t)i * 3 + 1];
    tz = tb[(size_t)i * 3 + 2];
  }
  const float t2 = dot3_rn(tx, ty, tz, tx, ty, tz);

  float best = INFINITY;
  int best_j = 0;
  for (int base = 0; base < m; base += MD_TILE) {
    const int cnt = min(MD_TILE, m - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const float x = sb[(size_t)(base + t) * 3 + 0];
      const float y = sb[(size_t)(base + t) * 3 + 1];
      const float z = sb[(size_t)(base + t) * 3 + 2];
      tile[t] = make_float4(x, y, z, dot3_rn(x, y, z, x, y, z));
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < cnt; ++t) {
      const float4 s = tile[t];
      const float inner = dot3_rn(tx, ty, tz, s.x, s.y, s.z);
      const float d = __fsub_rn(__fadd_rn(t2, s.w), __fmul_rn(2.f, inner));
      // strict '<' keeps the lower index on ties; a NaN distance is kept
      // (the first one), as torch.min propagates it
      if (d < best || (d != d && best == best)) {
        best = d;
        best_j = base + t;
      }
    }
  }
  if (!active) return;
  // clamp as torch.clamp does: a NaN stays NaN
  const float clamped = (best < eps2) ? eps2 : best;
  dist[(size_t)b * n + i] = __fsqrt_rn(clamped);
  index[(size_t)b * n + i] = best_j;
}

extern "C" int pose_min_dists(const float* target, const float* source,
                              float* dist, int* index, int batch, int n, int m,
                              float eps2, cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || n < 1 || m < 1) return POSE_UNSUPPORTED;
  dim3 grid((n + MD_THREADS - 1) / MD_THREADS, batch);
  min_dists_kernel<<<grid, MD_THREADS, 0, stream>>>(target, source, dist,
                                                    index, n, m, eps2);
  return pose_last_error();
}
