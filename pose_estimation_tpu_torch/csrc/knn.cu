// K nearest neighbours, self and cross form, for the 3D-GCN graphs.
//
// Replaces pose_estimation_tpu/ops/pallas_pointops.py:_knn_kernel (launched
// by _knn_pallas), whose math is the main path's XLA search
// (core/pointops/neighbors.py:knn_indices / knn_indices_cross):
//   d[i, j] = (|q_i|^2 + |k_j|^2) - 2 q_i.k_j   in fp32,
//   the kk smallest per query, ties to the lower key index (lax.top_k),
//   the first `drop` columns dropped (drop = 1 excludes self).
//
// What bounds it: the searches of a forward are small (64 to 1024 points
// per batch element, a few hundred KB of input), so one thread per query
// leaves most of the card idle, and keeping a sorted top-kk per thread is
// bound by the insertions: under SIMT a warp pays for any lane's
// insertion, and early in a scan most keys insert somewhere. The distance
// work itself is nq * nk * ~9 fp32 operations, microseconds at the card's
// fp32 rate even at the largest search.
//
// Design: each query gets a group of G lanes of one warp (G = 8, 16 or
// 32, chosen at launch: the smallest that puts batch * nq * G >= KNN_FILL
// threads on the card, four 128-thread blocks per SM, so the 64-point
// searches at batch 32 fill it as well as the 1024-point ones). A block
// stages its batch element's keys with their squared norms (float4) in
// shared memory, in tiles of up to KNN_TILE, and lane l of a group takes
// keys l, l + G, ... Distances are computed in the plain version's
// operation order without FMA contraction (dot3_rn), so they are
// bit-exact. Three steps, none with a data-dependent branch on the common
// path:
//   1. each lane keeps the M = ceil(kk / 8) smallest distances of its keys
//      (values only, a min/max network);
//   2. the group's bound tau is the kk-th smallest of its G * M values
//      (kk rounds of a warp-shuffle minimum), so at least kk keys lie at
//      or below it and the kk nearest all do; a second scan appends every
//      key with d <= tau to the query's list in shared memory (~kk-2kk of
//      them on a point cloud);
//   3. each candidate's rank is the number of candidates before it in
//      (distance, index) order, compared lexicographically, so equal
//      distances go to the lower index, the stable sort's rule: rank r
//      goes to output slot r - drop.
// Where ties put more than the list's capacity (64 keys, 4 * KM above
// kk = 16) at or below tau (duplicated points), the block rescans for
// those queries with a sorted top-KM per lane (lexicographic insertion)
// and merges the G lists by warp shuffles. The kernel is compiled for
// KM = 8, 16, 24 and 32 (kk <= KM, a runtime count; M = KM / 8), so it
// takes kk <= KNN_MAX_KK. The [nq, nk] distance matrix never exists
// anywhere.
#include <limits.h>

#include "common.cuh"

#define KNN_THREADS 128
#define KNN_TILE 1024
#define KNN_FILL (132 * 4 * KNN_THREADS)
#define KNN_MAX_KK 32
#define KNN_QMAX 16      // queries per block at most (G >= 8)

// candidates kept per query for kk <= km: at least kk of them lie at or
// below tau, and on a point cloud rarely more than 2 kk
__host__ __device__ constexpr int knn_cap(int km) {
  return km <= 16 ? 64 : 4 * km;
}

__device__ __forceinline__ float knn_dist(float qx, float qy, float qz,
                                          float q2, float4 k) {
  const float inner = dot3_rn(qx, qy, qz, k.x, k.y, k.z);
  return __fsub_rn(__fadd_rn(q2, k.w), __fmul_rn(2.f, inner));
}

// (d, i) before (e, j) in a stable sort by distance
__device__ __forceinline__ bool lex_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

template <int KK>
__device__ __forceinline__ void insert_sorted(float (&bd)[KK], int (&bi)[KK],
                                              float d, int idx) {
  if (!lex_less(d, idx, bd[KK - 1], bi[KK - 1])) return;
  bool placed = false;
#pragma unroll
  for (int j = KK - 1; j >= 0; --j) {
    const int p = j > 0 ? j - 1 : 0;
    const bool shift = j > 0 && lex_less(d, idx, bd[p], bi[p]);
    if (!placed) {
      if (shift) {
        bd[j] = bd[p];
        bi[j] = bi[p];
      } else {
        bd[j] = d;
        bi[j] = idx;
        placed = true;
      }
    }
  }
}

template <int KM>   // kk <= KM, a multiple of 8
__global__ void __launch_bounds__(KNN_THREADS)
knn_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
           int* __restrict__ out, int nq, int nk, int kk, int drop, int G) {
  constexpr int M = KM / 8;   // G >= 8 lanes hold G * M >= kk values
  constexpr int CAP = knn_cap(KM);
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ float4 smem[];
  const int cap = min(nk, KNN_TILE);
  float4* tile = smem;                                  // [cap]
  int* cnt = (int*)(tile + cap);                        // [KNN_QMAX]
  int2* cand = (int2*)(cnt + KNN_QMAX);                 // [qb][CAP]
  const int qb = KNN_THREADS / G;
  const int b = blockIdx.y;
  const int ql = threadIdx.x / G, lane = threadIdx.x & (G - 1);
  const int i = blockIdx.x * qb + ql;
  const bool active = i < nq;
  const float* qp = queries + ((size_t)b * nq + (active ? i : 0)) * 3;
  const float* kb = keys + (size_t)b * nk * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float q2 = dot3_rn(qx, qy, qz, qx, qy, qz);
  const bool resident = nk <= KNN_TILE;   // one tile serves every scan

  // stages keys [base, base + cap) of the batch element; block-wide
  auto stage = [&](int base) {
    const int n = min(cap, nk - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < n; t += KNN_THREADS) {
      const float* k = kb + (size_t)(base + t) * 3;
      tile[t] = make_float4(k[0], k[1], k[2], dot3_rn(k[0], k[1], k[2], k[0],
                                                      k[1], k[2]));
    }
    __syncthreads();
    return n;
  };

  // 1. the M smallest distances of this lane's keys
  if (threadIdx.x < qb) cnt[threadIdx.x] = 0;
  float top[M];
#pragma unroll
  for (int m = 0; m < M; ++m) top[m] = INFINITY;
  for (int base = 0; base < nk; base += cap) {
    const int n = stage(base);
    if (!active) continue;
#pragma unroll 4
    for (int t = lane; t < n; t += G) {
      float d = fminf(knn_dist(qx, qy, qz, q2, tile[t]), INFINITY);  // NaN
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float lo = fminf(top[m], d);
        d = fmaxf(top[m], d);
        top[m] = lo;
      }
    }
  }

  // 2. tau: the kk-th smallest of the group's G * M values, one popped per
  //    round (the lowest lane among equal heads)
  float tau = INFINITY;
  for (int r = 0; r < kk; ++r) {
    float v = top[0];
    int w = lane;
    for (int off = G >> 1; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, off);
      const int ow = __shfl_xor_sync(FULL, w, off);
      if (ov < v || (ov == v && ow < w)) {
        v = ov;
        w = ow;
      }
    }
    tau = v;
    if (w == lane) {
#pragma unroll
      for (int m = 0; m + 1 < M; ++m) top[m] = top[m + 1];
      top[M - 1] = INFINITY;
    }
  }
  for (int base = 0; base < nk; base += cap) {
    const int n = resident ? cap : stage(base);
    if (!active) continue;
#pragma unroll 4
    for (int t = lane; t < n; t += G) {
      const float d = knn_dist(qx, qy, qz, q2, tile[t]);
      if (d <= tau) {
        const int pos = atomicAdd(&cnt[ql], 1);
        if (pos < CAP)
          cand[ql * CAP + pos] = make_int2(__float_as_int(d), base + t);
      }
    }
  }
  __syncthreads();

  // 3. rank the candidates
  const int c = cnt[ql];
  const bool overflow = active && c > CAP;
  int* ob = out + ((size_t)b * nq + i) * (kk - drop);
  if (active && !overflow) {
    const int2* cq = cand + ql * CAP;
    for (int j = lane; j < c; j += G) {
      const float dj = __int_as_float(cq[j].x);
      const int ij = cq[j].y;
      int rank = 0;
      for (int l = 0; l < c; ++l)
        rank += lex_less(__int_as_float(cq[l].x), cq[l].y, dj, ij);
      if (rank < kk && rank >= drop) ob[rank - drop] = ij;
    }
    // fewer than kk finite distances (non-finite input): index 0
    for (int r = c + lane; r < kk; r += G)
      if (r >= drop) ob[r - drop] = 0;
  }
  if (!__syncthreads_or(overflow)) return;

  // ties overflowed a list: a sorted top-KM per lane, then a merge of the
  // group's G lists (every lane of the warp takes part in the shuffles)
  float bd[KM];
  int bi[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    bd[j] = INFINITY;
    bi[j] = INT_MAX;
  }
  for (int base = 0; base < nk; base += cap) {
    const int n = resident ? cap : stage(base);
    if (!overflow) continue;
    for (int t = lane; t < n; t += G) {
      const float d = knn_dist(qx, qy, qz, q2, tile[t]);
      if (d <= tau) insert_sorted(bd, bi, d, base + t);
    }
  }
  for (int r = 0; r < kk; ++r) {
    float d = bd[0];
    int id = bi[0];
    for (int off = G >> 1; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, d, off);
      const int oi = __shfl_xor_sync(FULL, id, off);
      if (lex_less(od, oi, d, id)) {
        d = od;
        id = oi;
      }
    }
    if (bi[0] == id) {  // this lane held the minimum: pop it
#pragma unroll
      for (int j = 0; j + 1 < KM; ++j) {
        bd[j] = bd[j + 1];
        bi[j] = bi[j + 1];
      }
      bd[KM - 1] = INFINITY;
      bi[KM - 1] = INT_MAX;
    }
    if (overflow && lane == 0 && r >= drop) ob[r - drop] = id;
  }
}

#define KNN_CASE(KM)                                                      \
  case KM:                                                                \
    knn_kernel<KM><<<grid, KNN_THREADS, smem, stream>>>(queries, keys, out, \
                                                        nq, nk, kk, drop, G); \
    break;

extern "C" int pose_knn(const float* queries, const float* keys, int* out,
                        int batch, int nq, int nk, int kk, int drop,
                        cudaStream_t stream) {
  if (kk < 1 || kk > KNN_MAX_KK || drop < 0 || drop >= kk || kk > nk ||
      nq < 1 || batch < 1)
    return POSE_UNSUPPORTED;
  int G = 8;
  while (G < 32 && (long long)batch * nq * G < KNN_FILL) G *= 2;
  const int qb = KNN_THREADS / G;
  const int km = (kk + 7) / 8 * 8;
  dim3 grid((nq + qb - 1) / qb, batch);
  const size_t smem = sizeof(float4) * (size_t)(nk < KNN_TILE ? nk : KNN_TILE) +
                      sizeof(int) * KNN_QMAX + sizeof(int2) * qb * knn_cap(km);
  switch (km) {
    KNN_CASE(8) KNN_CASE(16) KNN_CASE(24) KNN_CASE(32)
    default:
      return POSE_UNSUPPORTED;
  }
  return pose_last_error();
}
