// 3D-GCN aggregates: the fused ones of the fusion nets' levels 0 and 1,
// and the wide-table one of a wide ConvLayer.
//
// theta[n, k, s, o] = relu(<nd[n, k], dirs[:, s*O + o]>)      (d = 3)
// surface:  out[n, o] = sum_s max_k theta[n, k, s, o]
// linear:   out[n, o] = sum_s max_k theta[n, k, s, o] * T[idx[n, k], s*O + o]
//           with the support table T = X @ W + b at every point.
// aggregate: the linear form for one stream with the table F given and
//           d = 3 or 9 (agg_kernel).
// Several streams (the vertex / xyz / normal streams of the fusion nets)
// share one KNN graph and run in one launch; outputs are [B, N, streams*O]
// fp32.
//
// Replaces pose_estimation_tpu/ops/pallas_gcn.py:_surface_multi_kernel
// (launched by _surface_pallas_core), _linear_multi_kernel (launched by
// _linear_pallas_core) and _agg_kernel (launched by
// _gcn_aggregate_fwd_pallas). The TPU kernels gather neighbour rows with
// one-hot matmuls, or take a pre-gathered table, because random gathers
// are slow there; on the card the rows are loaded directly.
#include "common.cuh"

// ---------------------------------------------------------------------------
// Surface aggregate (kernel 2).
// One thread per output (point, stream, o); it loops over k and keeps the S
// running maxima in registers. The arithmetic follows the XLA formulation
// the JAX package runs off the TPU (_surface_multi_xla -> _fwd_xla, which
// computes in bf16): theta is rounded to bf16 after an fp32 dot, the sum
// over supports is taken in fp32 and rounded to bf16. Bound on the card by
// the fp32 issue rate (K*S*~6 flops per output) and the fp32 output write;
// nd is read once per point and broadcast across the o threads of a warp.
// ---------------------------------------------------------------------------
template <int S>
__global__ void surface_kernel(const bf16* __restrict__ nd,
                               const bf16* __restrict__ dirs,
                               float* __restrict__ out, long long total,
                               int K, int streams, int O) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int o = (int)(t % O);
  const long long r = t / O;
  const int st = (int)(r % streams);
  const long long p = r / streams;
  const int so = S * O;
  const bf16* dr = dirs + (size_t)st * 3 * so;
  float d0[S], d1[S], d2[S], m[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    d0[s] = to_f32(dr[s * O + o]);
    d1[s] = to_f32(dr[so + s * O + o]);
    d2[s] = to_f32(dr[2 * so + s * O + o]);
    m[s] = -INFINITY;
  }
  const bf16* np_ = nd + (size_t)p * K * streams * 3 + st * 3;
  for (int k = 0; k < K; ++k) {
    const bf16* v = np_ + (size_t)k * streams * 3;
    const float n0 = to_f32(v[0]), n1 = to_f32(v[1]), n2 = to_f32(v[2]);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float th = dot3_rn(n0, n1, n2, d0[s], d1[s], d2[s]);
      th = __bfloat162float(__float2bfloat16_rn(th));
      m[s] = fmaxf(m[s], fmaxf(th, 0.f));
    }
  }
  float acc = m[0];
#pragma unroll
  for (int s = 1; s < S; ++s) acc = __fadd_rn(acc, m[s]);
  out[(size_t)p * streams * O + st * O + o] =
      __bfloat162float(__float2bfloat16_rn(acc));
}

// ---------------------------------------------------------------------------
// Linear aggregate (kernel 1), pass A: the support table.
// table[r, st, c] = X[r, st*cin : (st+1)*cin] @ W[st, :, c] + b[st, c],
// rows r over B*M points, fp32 accumulation, stored in the input dtype.
// A plain 64x64 shared-memory tile with a 16-deep k step; each of the 256
// threads owns a 4x4 strided block of outputs. This is the product the TPU
// kernel computes per neighbour slot in its body (pallas_gcn.py:257-260);
// here it runs once per point instead of once per slot (~22 GFLOP at level
// 0 instead of ~225), and is bound by shared-memory bandwidth on the
// card's CUDA cores.
// ---------------------------------------------------------------------------
#define TB 64
#define TK 16

template <typename T>
__global__ void __launch_bounds__(256)
table_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ bias, T* __restrict__ table, int rows,
             int streams, int cin, int so) {
  __shared__ float as[TK][TB + 1];
  __shared__ float bs[TK][TB];
  const int st = blockIdx.z;
  const int row0 = blockIdx.y * TB;
  const int col0 = blockIdx.x * TB;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t xstride = (size_t)streams * cin;
  const T* xs = x + (size_t)st * cin;
  const T* ws = w + (size_t)st * cin * so;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += TK) {
    // 64 rows x 16 k of X and 16 k x 64 cols of W: 4 elements per thread
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = threadIdx.x + l * 256;
      const int ar = e / TK, ak = e % TK;
      const int gr = row0 + ar, gk = k0 + ak;
      as[ak][ar] = (gr < rows && gk < cin) ? to_f32(xs[gr * xstride + gk])
                                           : 0.f;
      const int bk = e / TB, bc = e % TB;
      const int gk2 = k0 + bk, gc = col0 + bc;
      bs[bk][bc] = (gk2 < cin && gc < so) ? to_f32(ws[(size_t)gk2 * so + gc])
                                          : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc >= so) continue;
      table[((size_t)gr * streams + st) * so + gc] =
          from_f32<T>(__fadd_rn(acc[i][j], bias[(size_t)st * so + gc]));
    }
  }
}

// ---------------------------------------------------------------------------
// Linear aggregate (kernel 1), pass B: gather, theta, product, max, sum.
// One block per (point tile, batch, stream); thread o keeps its 3*S
// direction weights in registers for the whole tile. For each point and
// neighbour slot the block reads the neighbour's table row for its stream:
// S*O contiguous values, so each warp's loads coalesce. theta and the
// product are fp32. Bound by the table reads (B*N*K*streams*S*O elements,
// mostly from L2: one batch element's table is a few MB) and the fp32
// issue rate.
// ---------------------------------------------------------------------------
template <typename T, int S>
__global__ void linear_agg_kernel(const int* __restrict__ idx,
                                  const T* __restrict__ nd,
                                  const T* __restrict__ dirs,
                                  const T* __restrict__ table,
                                  float* __restrict__ out, int N, int M,
                                  int K, int streams, int O, int pts) {
  const int o = threadIdx.x;
  if (o >= O) return;
  const int b = blockIdx.y;
  const int st = blockIdx.z;
  const int so = S * O;
  const T* dr = dirs + (size_t)st * 3 * so;
  float d0[S], d1[S], d2[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    d0[s] = to_f32(dr[s * O + o]);
    d1[s] = to_f32(dr[so + s * O + o]);
    d2[s] = to_f32(dr[2 * so + s * O + o]);
  }
  const int n_end = min(N, (blockIdx.x + 1) * pts);
  for (int n = blockIdx.x * pts; n < n_end; ++n) {
    const size_t pn = (size_t)b * N + n;
    float m[S];
#pragma unroll
    for (int s = 0; s < S; ++s) m[s] = -INFINITY;
    for (int k = 0; k < K; ++k) {
      const int j = idx[pn * K + k];
      const T* v = nd + (pn * K + k) * streams * 3 + st * 3;
      const float n0 = to_f32(v[0]), n1 = to_f32(v[1]), n2 = to_f32(v[2]);
      const T* row = table + (((size_t)b * M + j) * streams + st) * so;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float th =
            fmaxf(dot3_rn(n0, n1, n2, d0[s], d1[s], d2[s]), 0.f);
        m[s] = fmaxf(m[s], __fmul_rn(th, to_f32(row[s * O + o])));
      }
    }
    float acc = m[0];
#pragma unroll
    for (int s = 1; s < S; ++s) acc = __fadd_rn(acc, m[s]);
    out[pn * streams * O + st * O + o] = acc;
  }
}

// ---------------------------------------------------------------------------
// Wide-table aggregate (kernel 5), one stream, d = 3 or 9.
// out[n, o] = sum_s max_k relu(<nd[n, k], dirs[:, s*O + o]>) * F[idx[n, k], s*O + o]
// with the support table F [B, M, S*O] given (the wide ConvLayer computes
// it with one matmul). Replaces pallas_gcn.py:_agg_kernel, which reads a
// pre-gathered [B, N, K, S*O] table; here the block gathers rows of F by
// idx, as linear_agg_kernel reads rows of its table.
// One block per (point tile, batch element), thread o keeps its D*S
// direction weights (63 floats at D=9, S=7) and S running maxima in
// registers. Arithmetic follows the plain version op for op: in T = bf16
// every product, sum, theta, product with F and the support sum is
// rounded to bf16 as PyTorch's eager bf16 ops round them (rn<T>); in fp32
// nothing is rounded. Bound on the card by the fp32 issue rate
// (K*S*(2D+2) operations per output, with bf16 rounding about twice that)
// and by the table rows, read K times, mostly from L2 (one batch
// element's table is under 2 MB at the profiler's shape).
// ---------------------------------------------------------------------------
template <typename T, int S, int D>
__global__ void agg_kernel(const int* __restrict__ idx,
                           const T* __restrict__ nd, const T* __restrict__ dirs,
                           const T* __restrict__ feats,
                           float* __restrict__ out, int N, int M, int K,
                           int O, int pts) {
  const int o = threadIdx.x;
  if (o >= O) return;
  const int b = blockIdx.y;
  const int so = S * O;
  float w[S][D];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int d = 0; d < D; ++d) w[s][d] = to_f32(dirs[d * so + s * O + o]);
  const int n_end = min(N, (blockIdx.x + 1) * pts);
  for (int n = blockIdx.x * pts; n < n_end; ++n) {
    const size_t pn = (size_t)b * N + n;
    float m[S];
#pragma unroll
    for (int s = 0; s < S; ++s) m[s] = -INFINITY;
    for (int k = 0; k < K; ++k) {
      const int j = idx[pn * K + k];
      float v[D];
#pragma unroll
      for (int d = 0; d < D; ++d) v[d] = to_f32(nd[(pn * K + k) * D + d]);
      const T* row = feats + ((size_t)b * M + j) * so;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float th = fmaxf(dot_rn<T, D>(v, w[s]), 0.f);
        m[s] = fmaxf(m[s], rn<T>(__fmul_rn(th, to_f32(row[s * O + o]))));
      }
    }
    float acc = m[0];
#pragma unroll
    for (int s = 1; s < S; ++s) acc = rn<T>(__fadd_rn(acc, m[s]));
    out[pn * O + o] = acc;
  }
}

#define GCN_PTS 8

#define SURF_CASE(S)                                                    \
  case S:                                                               \
    surface_kernel<S><<<blocks, threads, 0, stream>>>(                  \
        (const bf16*)nd, (const bf16*)dirs, out, total, K, streams, O); \
    break;

extern "C" int pose_gcn_surface(const void* nd, const void* dirs, float* out,
                                long long points, int K, int streams, int S,
                                int O, cudaStream_t stream) {
  if (points < 1 || K < 1 || streams < 1 || O < 1) return POSE_UNSUPPORTED;
  const long long total = points * streams * O;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  switch (S) {
    SURF_CASE(1) SURF_CASE(2) SURF_CASE(3) SURF_CASE(4)
    SURF_CASE(5) SURF_CASE(6) SURF_CASE(7) SURF_CASE(8)
    default:
      return POSE_UNSUPPORTED;
  }
  return pose_last_error();
}

template <typename T>
static int launch_linear(const int* idx, const void* nd, const void* dirs,
                         const void* x, const void* w, const float* bias,
                         void* table, float* out, int B, int N, int M, int K,
                         int streams, int cin, int S, int O,
                         cudaStream_t stream) {
  const int so = S * O;
  const int rows = B * M;
  dim3 tgrid((so + TB - 1) / TB, (rows + TB - 1) / TB, streams);
  table_kernel<T><<<tgrid, 256, 0, stream>>>(
      (const T*)x, (const T*)w, bias, (T*)table, rows, streams, cin, so);
  int err = pose_last_error();
  if (err) return err;
  dim3 agrid((N + GCN_PTS - 1) / GCN_PTS, B, streams);
  const int threads = (O + 31) / 32 * 32;
#define AGG_CASE(SS)                                                        \
  case SS:                                                                  \
    linear_agg_kernel<T, SS><<<agrid, threads, 0, stream>>>(                \
        idx, (const T*)nd, (const T*)dirs, (const T*)table, out, N, M, K,   \
        streams, O, GCN_PTS);                                               \
    break;
  switch (S) {
    AGG_CASE(1) AGG_CASE(2) AGG_CASE(3) AGG_CASE(4)
    AGG_CASE(5) AGG_CASE(6) AGG_CASE(7) AGG_CASE(8)
    default:
      return POSE_UNSUPPORTED;
  }
#undef AGG_CASE
  return pose_last_error();
}

extern "C" int pose_gcn_linear(const int* idx, const void* nd,
                               const void* dirs, const void* x, const void* w,
                               const float* bias, void* table, float* out,
                               int B, int N, int M, int K, int streams,
                               int cin, int S, int O, int is_bf16,
                               cudaStream_t stream) {
  if (B < 1 || N < 1 || M < 1 || K < 1 || streams < 1 || cin < 1 || O < 1 ||
      O > 1024 || S < 1 || S > 8)
    return POSE_UNSUPPORTED;
  if (is_bf16)
    return launch_linear<bf16>(idx, nd, dirs, x, w, bias, table, out, B, N, M,
                               K, streams, cin, S, O, stream);
  return launch_linear<float>(idx, nd, dirs, x, w, bias, table, out, B, N, M,
                              K, streams, cin, S, O, stream);
}

template <typename T, int D>
static int launch_aggregate(const int* idx, const void* nd, const void* dirs,
                            const void* feats, float* out, int B, int N,
                            int M, int K, int S, int O, cudaStream_t stream) {
  dim3 grid((N + GCN_PTS - 1) / GCN_PTS, B);
  const int threads = (O + 31) / 32 * 32;
#define AGG5_CASE(SS)                                                      \
  case SS:                                                                 \
    agg_kernel<T, SS, D><<<grid, threads, 0, stream>>>(                    \
        idx, (const T*)nd, (const T*)dirs, (const T*)feats, out, N, M, K,  \
        O, GCN_PTS);                                                       \
    break;
  switch (S) {
    AGG5_CASE(1) AGG5_CASE(2) AGG5_CASE(3) AGG5_CASE(4)
    AGG5_CASE(5) AGG5_CASE(6) AGG5_CASE(7) AGG5_CASE(8)
    default:
      return POSE_UNSUPPORTED;
  }
#undef AGG5_CASE
  return pose_last_error();
}

extern "C" int pose_gcn_aggregate(const int* idx, const void* nd,
                                  const void* dirs, const void* feats,
                                  float* out, int B, int N, int M, int K,
                                  int D, int S, int O, int is_bf16,
                                  cudaStream_t stream) {
  if (B < 1 || N < 1 || M < 1 || K < 1 || O < 1 || O > 1024 || S < 1 ||
      S > 8)
    return POSE_UNSUPPORTED;
  if (D == 3)
    return is_bf16 ? launch_aggregate<bf16, 3>(idx, nd, dirs, feats, out, B,
                                               N, M, K, S, O, stream)
                   : launch_aggregate<float, 3>(idx, nd, dirs, feats, out, B,
                                                N, M, K, S, O, stream);
  if (D == 9)
    return is_bf16 ? launch_aggregate<bf16, 9>(idx, nd, dirs, feats, out, B,
                                               N, M, K, S, O, stream)
                   : launch_aggregate<float, 9>(idx, nd, dirs, feats, out, B,
                                                N, M, K, S, O, stream);
  return POSE_UNSUPPORTED;
}
