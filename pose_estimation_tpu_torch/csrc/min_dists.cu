// Nearest source point of each target point: its distance and its index,
// for up to MD_MAX_CLOUDS source clouds that share the targets, in one
// launch.
//
// Replaces pose_estimation_tpu/ops/pallas_pointops.py:_min_dists_kernel
// (launched by _min_dists_pallas), whose math is the main path's XLA form
// (core/pointops/neighbors.py:min_dists / nearest_index):
//   d[i, j] = (|t_i|^2 + |s_j|^2) - 2 t_i.s_j   in fp32,
//   best_i  = min_j d[i, j], index_i = argmin_j (ties to the lower j; the
//             first NaN wins, as torch.min's),
//   dist_i  = sqrt(max(best_i, eps^2)).
// The index is what the backward (ops/pointops.py:_MinDists) and the
// up-sampling maps of the fusion nets (nearest_index_multi: the vertices
// against pool_1 and against pool_2, one launch, as the JAX package takes
// both maps from one distance matrix) need; one kernel serves both.
//
// What bounds it: at the serving shapes (B=32, 1024 targets against 256
// and 64 sources) a few microseconds of work, so the card has to be
// filled; at large clouds the fp32 issue rate of the distance-and-compare
// loop, ~12 slots per pair. The 3-term dots are rounded term by term
// (dot3_rn) in the plain version's order, so kernel and plain version
// agree bit for bit.
//
// Design: each target gets a group of G lanes of one warp (G = 1..32,
// chosen at launch: the smallest that puts batch * clouds * targets / R * G
// >= MD_FILL threads on the card), and each group takes R targets (R = 2
// for large source clouds, so that every source read from shared memory
// feeds two distances). The block stages its batch element's sources with
// their squared norms (float4) in shared memory, in tiles of MD_TILE; lane
// l takes sources l, l + G, ... and keeps its running minimum and index in
// registers (strict '<': the lower index of its own; the first NaN kept).
// Where every coordinate of the tile and of the lane's targets is at most
// 2^60 in magnitude (every real cloud), no distance can be NaN and the
// scan takes MD_U sources at a time: their distances (the last step an
// fma, exact there, see md_small), their minimum, and the index only when
// that beats the running minimum: ~8 slots per pair instead of ~14;
// elsewhere each pair is compared on its own with the NaN rule.
// The group's G pairs meet by warp shuffles in torch.min's order: a NaN
// before a number, then the smaller distance, then the lower index. The
// [n, m] distance matrix never exists anywhere.
#include <limits.h>

#include "common.cuh"

#define MD_THREADS 128
#define MD_TILE 1024
#define MD_FILL (132 * 4 * MD_THREADS)
#define MD_MAX_CLOUDS 4
#define MD_R2_FROM 1024   // sources from which each group takes two targets
#define MD_U 8            // sources a lane takes at a time in the fast scan

struct MdSources {
  const float* p[MD_MAX_CLOUDS];   // [B, m_c, 3]
  int m[MD_MAX_CLOUDS];
};

// (d, j) before (e, i) in torch.min's order
__device__ __forceinline__ bool md_before(float d, int j, float e, int i) {
  const bool dn = d != d, en = e != e;
  if (dn || en) return dn && (!en || j < i);
  return d < e || (d == e && j < i);
}

// |x| <= 2^60 for every coordinate of a pair: its distance is finite and
// 2 t.s does not overflow, so d = fma(-2, inner, a) rounds the exact
// a - 2 inner, the same bits as subtracting the (exact) product 2 * inner
__device__ __forceinline__ bool md_small(float x, float y, float z) {
  return fmaxf(fmaxf(fabsf(x), fabsf(y)), fabsf(z)) <= 0x1p60f;
}

template <int R>
__global__ void __launch_bounds__(MD_THREADS)
min_dists_kernel(const float* __restrict__ target, MdSources src,
                 float* __restrict__ dist, int* __restrict__ index, int n,
                 float eps2, int G) {
  __shared__ float4 tile[MD_TILE + MD_U * 32];
  constexpr unsigned FULL = 0xffffffffu;
  const int b = blockIdx.y, cl = blockIdx.z;
  const int m = src.m[cl];
  const float* sb = src.p[cl] + (size_t)b * m * 3;
  const int lane = threadIdx.x & (G - 1);
  const int i0 = (blockIdx.x * (MD_THREADS / G) + threadIdx.x / G) * R;

  float tx[R], ty[R], tz[R], t2[R], best[R];
  int bj[R];
  bool small = true;   // fmaxf drops a NaN coordinate: tested below
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    const float* tp = target + ((size_t)b * n + (i < n ? i : 0)) * 3;
    tx[r] = tp[0];
    ty[r] = tp[1];
    tz[r] = tp[2];
    t2[r] = dot3_rn(tx[r], ty[r], tz[r], tx[r], ty[r], tz[r]);
    small = small && md_small(tx[r], ty[r], tz[r]) && t2[r] == t2[r];
    best[r] = INFINITY;
    // this lane's first source: all-infinite distances keep it, as
    // torch.min keeps the first index of its minimum
    bj[r] = lane < m ? lane : INT_MAX;
  }
  for (int base = 0; base < m; base += MD_TILE) {
    const int cnt = min(MD_TILE, m - base);
    // the fast scan reads whole chunks: pad the tile to MD_U * G sources
    // with ones at infinite distance
    const int padded = (cnt + MD_U * G - 1) / (MD_U * G) * (MD_U * G);
    __syncthreads();  // the previous tile is no longer read
    bool ok = true;
    for (int t = threadIdx.x; t < padded; t += MD_THREADS) {
      if (t < cnt) {
        const float* s = sb + (size_t)(base + t) * 3;
        const float w = dot3_rn(s[0], s[1], s[2], s[0], s[1], s[2]);
        tile[t] = make_float4(s[0], s[1], s[2], w);
        ok = ok && md_small(s[0], s[1], s[2]) && w == w;
      } else {
        tile[t] = make_float4(0.f, 0.f, 0.f, INFINITY);
      }
    }
    if (__syncthreads_and(ok) && small) {
      // no distance here is NaN: MD_U sources at a time, their minimum
      // first (fminf), the index only where it beats the running one
      for (int t0 = lane; t0 < padded; t0 += MD_U * G) {
        float dv[R][MD_U];
#pragma unroll
        for (int u = 0; u < MD_U; ++u) {
          const float4 s = tile[t0 + u * G];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float inner = dot3_rn(tx[r], ty[r], tz[r], s.x, s.y, s.z);
            dv[r][u] = __fmaf_rn(-2.f, inner, __fadd_rn(t2[r], s.w));
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float cm = dv[r][0];
#pragma unroll
          for (int u = 1; u < MD_U; ++u) cm = fminf(cm, dv[r][u]);
          if (cm < best[r]) {   // strict: an equal minimum keeps the lower j
            int uu = 0;
#pragma unroll
            for (int u = MD_U - 1; u >= 0; --u)
              if (dv[r][u] == cm) uu = u;
            best[r] = cm;
            bj[r] = base + t0 + uu * G;
          }
        }
      }
      continue;
    }
#pragma unroll 4
    for (int t = lane; t < cnt; t += G) {
      const float4 s = tile[t];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float inner = dot3_rn(tx[r], ty[r], tz[r], s.x, s.y, s.z);
        const float d = __fsub_rn(__fadd_rn(t2[r], s.w), __fmul_rn(2.f, inner));
        // strict '<' keeps the lower index on ties; a NaN distance is kept
        // (the first one), as torch.min propagates it
        if (d < best[r] || (d != d && best[r] == best[r])) {
          best[r] = d;
          bj[r] = base + t;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float d = best[r];
    int j = bj[r];
    for (int off = G >> 1; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, d, off);
      const int oj = __shfl_xor_sync(FULL, j, off);
      if (md_before(od, oj, d, j)) {
        d = od;
        j = oj;
      }
    }
    const int i = i0 + r;
    if (lane == 0 && i < n) {
      const size_t o = ((size_t)cl * gridDim.y + b) * n + i;
      // clamp as torch.clamp does: a NaN stays NaN
      dist[o] = __fsqrt_rn(d < eps2 ? eps2 : d);
      index[o] = j;
    }
  }
}

// Targets [batch, n, 3]; source cloud c < clouds at src_c [batch, m_c, 3]
// (the rest null); dist and index [clouds, batch, n].
extern "C" int pose_min_dists(const float* target, const float* src0,
                              const float* src1, const float* src2,
                              const float* src3, int m0, int m1, int m2,
                              int m3, int clouds, float* dist, int* index,
                              int batch, int n, float eps2,
                              cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || n < 1 || clouds < 1 ||
      clouds > MD_MAX_CLOUDS)
    return POSE_UNSUPPORTED;
  const MdSources src = {{src0, src1, src2, src3}, {m0, m1, m2, m3}};
  int mmax = 0;
  for (int c = 0; c < clouds; ++c) {
    if (src.m[c] < 1) return POSE_UNSUPPORTED;
    mmax = src.m[c] > mmax ? src.m[c] : mmax;
  }
  const int R = mmax >= MD_R2_FROM ? 2 : 1;
  const long long groups = (long long)batch * clouds * ((n + R - 1) / R);
  int G = 1;
  while (G < 32 && G < mmax && groups * G < MD_FILL) G *= 2;
  const int per_block = MD_THREADS / G * R;
  dim3 grid((n + per_block - 1) / per_block, batch, clouds);
  if (R == 2)
    min_dists_kernel<2><<<grid, MD_THREADS, 0, stream>>>(target, src, dist,
                                                         index, n, eps2, G);
  else
    min_dists_kernel<1><<<grid, MD_THREADS, 0, stream>>>(target, src, dist,
                                                         index, n, eps2, G);
  return pose_last_error();
}
