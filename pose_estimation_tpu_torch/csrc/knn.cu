// K nearest neighbours, self and cross form, for the 3D-GCN graphs.
//
// Replaces pose_estimation_tpu/ops/pallas_pointops.py:_knn_kernel (launched
// by _knn_pallas), whose math is the main path's XLA search
// (core/pointops/neighbors.py:knn_indices / knn_indices_cross):
//   d[i, j] = (|q_i|^2 + |k_j|^2) - 2 q_i.k_j   in fp32,
//   the kk smallest per query, ties to the lower key index (lax.top_k),
//   the first `drop` columns dropped (drop = 1 excludes self).
//
// Design: one thread per query, the running top-kk kept sorted in
// registers by insertion (kk is a template parameter so the arrays stay in
// registers); the keys and their squared norms are staged through shared
// memory in tiles of KNN_TILE, so the [nq, nk] distance matrix never exists
// anywhere. On the card it is bound by the fp32 issue rate of the distance
// and compare loop (nq * nk * ~8 flops), not by memory: the inputs are a
// few hundred KB.
#include "common.cuh"

#define KNN_THREADS 128
#define KNN_TILE 1024

template <int KK>
__global__ void __launch_bounds__(KNN_THREADS)
knn_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
           int* __restrict__ out, int nq, int nk, int drop) {
  __shared__ float4 tile[KNN_TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < nq;
  const float* qb = queries + (size_t)b * nq * 3;
  const float* kb = keys + (size_t)b * nk * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = qb[(size_t)i * 3 + 0];
    qy = qb[(size_t)i * 3 + 1];
    qz = qb[(size_t)i * 3 + 2];
  }
  const float q2 = dot3_rn(qx, qy, qz, qx, qy, qz);

  float bd[KK];
  int bi[KK];
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    bd[j] = INFINITY;
    bi[j] = 0;
  }

  for (int base = 0; base < nk; base += KNN_TILE) {
    const int cnt = min(KNN_TILE, nk - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const float x = kb[(size_t)(base + t) * 3 + 0];
      const float y = kb[(size_t)(base + t) * 3 + 1];
      const float z = kb[(size_t)(base + t) * 3 + 2];
      tile[t] = make_float4(x, y, z, dot3_rn(x, y, z, x, y, z));
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < cnt; ++t) {
      const float4 kv = tile[t];
      const float inner = dot3_rn(qx, qy, qz, kv.x, kv.y, kv.z);
      const float d = __fsub_rn(__fadd_rn(q2, kv.w), __fmul_rn(2.f, inner));
      if (d < bd[KK - 1]) {
        // insertion from the back; strict '>' keeps equal distances in
        // key order, i.e. ties go to the lower index
        const int idx = base + t;
        bool placed = false;
#pragma unroll
        for (int j = KK - 1; j >= 0; --j) {
          const bool shift = (j > 0) ? (bd[j > 0 ? j - 1 : 0] > d) : false;
          if (!placed) {
            if (shift) {
              bd[j] = bd[j > 0 ? j - 1 : 0];
              bi[j] = bi[j > 0 ? j - 1 : 0];
            } else {
              bd[j] = d;
              bi[j] = idx;
              placed = true;
            }
          }
        }
      }
    }
  }
  if (!active) return;
  const int k_out = KK - drop;
  int* ob = out + ((size_t)b * nq + i) * k_out;
#pragma unroll
  for (int j = 0; j < KK; ++j) {
    if (j >= drop) ob[j - drop] = bi[j];
  }
}

#define KNN_CASE(KK)                                                       \
  case KK:                                                                 \
    knn_kernel<KK><<<grid, KNN_THREADS, 0, stream>>>(queries, keys, out,   \
                                                     nq, nk, drop);        \
    break;

extern "C" int pose_knn(const float* queries, const float* keys, int* out,
                        int batch, int nq, int nk, int kk, int drop,
                        cudaStream_t stream) {
  if (kk < 1 || kk > 17 || drop < 0 || drop >= kk || kk > nk || nq < 1 ||
      batch < 1)
    return POSE_UNSUPPORTED;
  dim3 grid((nq + KNN_THREADS - 1) / KNN_THREADS, batch);
  switch (kk) {
    KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4) KNN_CASE(5) KNN_CASE(6)
    KNN_CASE(7) KNN_CASE(8) KNN_CASE(9) KNN_CASE(10) KNN_CASE(11)
    KNN_CASE(12) KNN_CASE(13) KNN_CASE(14) KNN_CASE(15) KNN_CASE(16)
    KNN_CASE(17)
    default:
      return POSE_UNSUPPORTED;
  }
  return pose_last_error();
}
