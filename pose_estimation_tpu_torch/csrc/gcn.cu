// 3D-GCN aggregates: the fused ones of the fusion nets' levels 0 and 1,
// and the wide-table one of a wide ConvLayer.
//
// theta[n, k, s, o] = relu(<nd[n, k], dirs[:, s*O + o]>)      (d = 3)
// surface:  out[n, o] = sum_s max_k theta[n, k, s, o]
// linear:   out[n, o] = sum_s max_k theta[n, k, s, o] * T[idx[n, k], s*O + o]
//           with the support table T = X @ W + b at every point.
// aggregate: the linear form for one stream with the table F given and
//           d = 3 or 9 (wide_agg_kernel).
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
//
// The linear aggregate (kernel 1) runs in two passes. Pass A builds the
// support table once per point: in bf16 on the tensor cores (wgmma), where
// writing the table is its floor; in fp32 on the CUDA cores. Pass B gathers
// K table rows per point and is bound by those gathers (B*N*K*streams*S*O
// elements, mostly from L2) and by the fp32 issue rate of theta, product
// and max; it reads 16 bytes per thread per slot and keeps several slots'
// loads in flight.
#include <stdint.h>

#include "common.cuh"

// ---------------------------------------------------------------------------
// Surface aggregate (kernel 2).
// out[p, st*O + o] =
//     bf16(sum_s relu(bf16(max_k <nd[p, k, st], dirs[st, :, s*O + o]>)))
// The arithmetic is the XLA formulation the JAX package runs off the TPU
// (_surface_multi_xla -> _fwd_xla, which computes in bf16): nd and dirs
// rounded to bf16, theta = bf16(fp32 dot), max over k, the sum over
// supports in fp32 in order s = 0..S-1, rounded to bf16. Rounding to
// nearest is monotone and relu commutes with it (bf16(x) <= 0 for x <= 0),
// so max_k relu(bf16(x_k)) = bf16(relu(max_k x_k)) bit for bit: the k-loop
// keeps the unrounded maxima and rounds once per (point, s, o). The max
// propagates NaN, as torch.maximum does.
//
// Bound on the card by the fp32 issue rate: per (point, slot, stream,
// support, channel) a 3-term dot (3 slots, below) and a max, 3.5 G slots
// at level 0. A block owns one stream and a tile of
// SURF_PTS points; it stages the tile's nd (one coalesced read of each
// stream's own tensor, fp32 or bf16, rounded to bf16 here) in shared memory
// as float4s, and each thread owns C consecutive channels of all S
// supports: its 3*S*C direction weights sit in registers for the whole
// tile, every nd vector read from shared memory (a broadcast across the
// warp) feeds 6*S*C slots, and it writes C outputs with one store. Up to
// SURF_MAX_STREAMS streams come as separate pointers, so the wrapper does
// no stack or cast.
//
// The dot's products are of two bf16 values, 8 significant bits each, so
// each is exact in fp32 wherever it neither overflows nor falls below the
// normal range; then fma(n1, d1, n0*d0) = round(n0*d0 + n1*d1) is the
// rounded sum of exact products, the same bits as the separate multiply
// and add, and the dot takes 3 slots instead of 5. A thread takes that
// form only where every nd value of its block's tile and every one of its
// weights is 0, not finite, or of magnitude in [2^-60, 2^60] (products in
// [2^-120, 2^120] or 0, inf or NaN alike in both forms); anywhere else it
// keeps the separate roundings.
// ---------------------------------------------------------------------------
#define SURF_MAX_STREAMS 4
#define SURF_PTS 64       // points per block
#define SURF_THREADS 256  // at most, per block
#define SURF_OCB 128      // channel groups per block at most (grid.z more)

struct SurfStreams {
  const void* nd[SURF_MAX_STREAMS];    // [B, N, K, 3] each
  const void* dirs[SURF_MAX_STREAMS];  // [3, S*O] each
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// p[i] rounded to bf16, p fp32 or bf16
__device__ __forceinline__ float ld_bf16(const void* p, size_t i, bool bf) {
  return bf ? __bfloat162float(((const bf16*)p)[i])
            : rn<bf16>(((const float*)p)[i]);
}

// a product of x with any value in the range is exact in fp32 or not
// finite in both forms (see above)
__device__ __forceinline__ bool exact_factor(float x) {
  const float a = fabsf(x);
  return a == 0.f || !(a <= 3.4028235e38f) || (a >= 0x1p-60f && a <= 0x1p60f);
}

// max over the K slots of point p's theta, unrounded, into m
template <int S, int C, bool FMA>
__device__ __forceinline__ void surface_max(
    const float4* __restrict__ v, int K, const float (&w0)[S][C],
    const float (&w1)[S][C], const float (&w2)[S][C], float (&m)[S][C]) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 n = v[k];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float th =
            FMA ? __fmaf_rn(n.z, w2[s][c],
                            __fmaf_rn(n.y, w1[s][c], __fmul_rn(n.x, w0[s][c])))
                : dot3_rn(n.x, n.y, n.z, w0[s][c], w1[s][c], w2[s][c]);
        m[s][c] = max_nan(m[s][c], th);
      }
  }
}

// SP supports a pass: a thread walks the S supports in passes of SP (S <= 8
// takes one pass) and carries the fp32 support sum from one pass to the
// next in its own output elements, so any S keeps the order s = 0..S-1.
template <int SP, int C>
__global__ void __launch_bounds__(SURF_THREADS)
surface_kernel(SurfStreams in, unsigned bf16_mask, float* __restrict__ out,
               long long points, int K, int streams, int S, int O) {
  extern __shared__ float4 s_nd[];   // [SURF_PTS * K]
  const int st = blockIdx.y;
  const int so = S * O, oc = O / C;
  const int ocb = min(oc, SURF_OCB);
  const int lanes = blockDim.x / ocb;   // points in parallel
  const int pl = threadIdx.x / ocb;
  const int j = blockIdx.z * ocb + threadIdx.x - pl * ocb;   // channel group
  const int o0 = j * C;
  const long long p0 = (long long)blockIdx.x * SURF_PTS;
  const int np = (int)min((long long)SURF_PTS, points - p0);
  const bool nd_bf = (bf16_mask >> st) & 1;
  const bool dir_bf = (bf16_mask >> (SURF_MAX_STREAMS + st)) & 1;
  bool nd_exact;

  {
    const void* ndp = in.nd[st];
    const size_t e0 = (size_t)p0 * K * 3;
    float* sf = (float*)s_nd;
    bool ok = true;
    for (int e = threadIdx.x; e < np * K * 3; e += blockDim.x) {
      const int q = e / 3;
      const float x = ld_bf16(ndp, e0 + e, nd_bf);
      sf[q * 4 + (e - q * 3)] = x;
      ok = ok && exact_factor(x);
    }
    nd_exact = __syncthreads_and(ok);
  }
  if (j >= oc) return;

  for (int s0 = 0; s0 < S; s0 += SP) {
    const bool last = s0 + SP >= S;
    float w0[SP][C], w1[SP][C], w2[SP][C];
    {
      const void* dr = in.dirs[st];
#pragma unroll
      for (int s = 0; s < SP; ++s)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int i = (s0 + s) * O + o0 + c;
          const bool live = s0 + s < S;
          w0[s][c] = live ? ld_bf16(dr, i, dir_bf) : 0.f;
          w1[s][c] = live ? ld_bf16(dr, so + i, dir_bf) : 0.f;
          w2[s][c] = live ? ld_bf16(dr, 2 * so + i, dir_bf) : 0.f;
        }
    }
    bool use_fma = nd_exact;
#pragma unroll
    for (int s = 0; s < SP; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c)
        use_fma = use_fma && exact_factor(w0[s][c]) &&
                  exact_factor(w1[s][c]) && exact_factor(w2[s][c]);
    for (int p = pl; p < np; p += lanes) {
      float m[SP][C];
#pragma unroll
      for (int s = 0; s < SP; ++s)
#pragma unroll
        for (int c = 0; c < C; ++c) m[s][c] = -INFINITY;
      if (use_fma)
        surface_max<SP, C, true>(s_nd + p * K, K, w0, w1, w2, m);
      else
        surface_max<SP, C, false>(s_nd + p * K, K, w0, w1, w2, m);
      float* dst = out + ((p0 + p) * streams + st) * O + o0;
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float first = rn<bf16>(max_nan(m[0][c], 0.f));
        acc[c] = s0 == 0 ? first : __fadd_rn(dst[c], first);
#pragma unroll
        for (int s = 1; s < SP; ++s)
          if (s0 + s < S)
            acc[c] = __fadd_rn(acc[c], rn<bf16>(max_nan(m[s][c], 0.f)));
        if (last) acc[c] = rn<bf16>(acc[c]);
      }
      if (C == 2)
        *(float2*)dst = make_float2(acc[0], acc[C - 1]);
      else
        dst[0] = acc[0];
    }
  }
}

// ---------------------------------------------------------------------------
// Linear aggregate (kernel 1), pass A: the support table.
// table[r, st, c] = X[r, st*cin : (st+1)*cin] @ W[st, :, c] + b[st, c],
// rows r over B*M points, fp32 accumulation, the fp32 bias added, rounded
// once to the input dtype and stored [B*M, streams, S*O], the layout pass B
// reads. This is the product the TPU kernel computes per neighbour slot in
// its body (pallas_gcn.py:257-260); here it runs once per point instead of
// once per slot (22.5 GFLOP at level 0 instead of ~225).
//
// bf16: table_wgmma_kernel. A block owns BM rows of one stream (BM = 256
// for Cin <= 128, else 128: one warpgroup per 64 rows) and walks a range
// of 128-column tiles; each warpgroup issues wgmma m64n128k16 (bf16 in,
// fp32 accumulators in registers) on operands in shared memory, in the
// no-swizzle core-matrix layout (8 rows x 16 bytes per core matrix). The
// pass is bound by moving X and W from L2 into shared memory, so the X
// rows stay resident for all of the block's column tiles (loaded once,
// rows past B*M and k past Cin zero-filled) and only W streams, in k
// chunks of 64 through a three-stage cp.async ring (16 bytes per thread,
// neighbouring threads on neighbouring addresses), two chunks ahead of the
// products; a large BM halves how often W is re-read. W arrives from the
// wrapper transposed to [streams, S*O padded to 128, Cin padded to 64], so
// its chunks need no masks; a Cin that is not a multiple of 8 takes plain
// loads for X. The epilogue adds the fp32 bias, rounds once to bf16 and
// stages the tile in shared memory (16-byte chunks XOR-swizzled by row),
// so the table is written in whole 256-byte row segments. Cin above 512
// (no layer has one) takes table_kernel. The products take ~0.02 ms at
// level 0; the floor is the table write (176 MB, ~0.05 ms at 3.35 TB/s).
//
// fp32: table_kernel on the CUDA cores, a 64x64 shared-memory tile with a
// 16-deep k step, each of 256 threads owning a 4x4 strided block of
// outputs; bound by shared-memory bandwidth. TF32 on the tensor cores
// would not hold the fp32 tolerance (1e-4 of max|ref|): it keeps ~3
// decimal digits.
// ---------------------------------------------------------------------------
#define WG_BN 128     // table columns per tile (the wgmma n)
#define WG_BK 64      // k per W chunk: four wgmma k-steps
#define WG_STAGES 3   // W ring depth: two chunks' loads in flight
#define WG_BCHUNK (WG_BN * WG_BK * 2)   // bytes of one W chunk
#define WG_MAX_CINP 512

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], bf16 operands in shared memory
// (both k-major), fp32 accumulators d in the warpgroup's registers; row
// (w*16 + lane/4 + 8*(i/2 % 2)), column (i/4*8 + lane%4*2 + i%2) of the
// tile sits in d[i] of lane `lane` of warp w.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));   // acc = 0: D = A * B
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products (they change d behind its back until the wait).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma operand descriptor for a no-swizzle tile in shared memory: lbo
// bytes between core matrices adjacent in k, sbo between 8-row groups.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Byte offset of the 16-byte vector (row r, k-group kg of 8 values) in a
// tile of `rows` rows: core matrices k-group-major, so lbo = rows * 16 and
// sbo = 128.
__device__ __forceinline__ int core_off(int r, int kg, int rows) {
  return ((kg * (rows >> 3) + (r >> 3)) << 7) + ((r & 7) << 4);
}

// Vector v of a 64-deep chunk: 8 rows per 8 threads (conflict-free 16-byte
// stores to shared memory), 4 k-groups of one row per 4 threads (64
// contiguous bytes of global memory).
__device__ __forceinline__ void chunk_vec(int v, int& r, int& kg) {
  kg = ((v >> 5) & 1) * 4 + ((v >> 3) & 3);
  r = (v >> 6) * 8 + (v & 7);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// Byte offset of (row r, 16-byte chunk j) of the BM x 128 bf16 output tile
// staged row-major in shared memory, chunks XOR-swizzled by row so that the
// accumulator fragments' writes do not conflict.
__device__ __forceinline__ int out_off(int r, int j) {
  return (r << 8) + ((j ^ (r & 7)) << 4);
}

template <int WGS>   // warpgroups per block; BM = 64 * WGS rows
__global__ void __launch_bounds__(WGS * 128)
table_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                   const float* __restrict__ bias, bf16* __restrict__ table,
                   int rows, int streams, int cin, int cinp, int so, int sop,
                   int tiles_per_block) {
  constexpr int BM = 64 * WGS, NT = WGS * 128;
  extern __shared__ __align__(128) char smem[];
  char* const sa = smem;                              // [kchunks][BM x 64]
  char* const ring = sa + BM * cinp * 2;              // [WG_STAGES][chunk]
  char* const so_tile = ring + WG_STAGES * WG_BCHUNK; // [BM][128] bf16
  const int st = blockIdx.z;
  const int row0 = blockIdx.x * BM;
  const int nt0 = blockIdx.y * tiles_per_block;
  const int nt1 = min(sop / WG_BN, nt0 + tiles_per_block);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int kchunks = cinp / WG_BK;
  const int iters = (nt1 - nt0) * kchunks;
  const bf16* ws = wt + (size_t)st * sop * cinp;

  // X rows [row0, row0 + BM), all of Cin, once
  {
    const size_t xstride = (size_t)streams * cin;
    const bf16* xs = x + (size_t)st * cin;
    const bool vec = (cin & 7) == 0;
    for (int v = tid; v < kchunks * BM * 8; v += NT) {
      int r, kg;
      chunk_vec(v % (BM * 8), r, kg);
      const int kc = v / (BM * 8);
      const int gr = row0 + r, gk = kc * WG_BK + kg * 8;
      const bool in = gr < rows && gk < cin;
      const bf16* src = in ? xs + (size_t)gr * xstride + gk : xs;
      char* dst = sa + kc * BM * 128 + core_off(r, kg, BM);
      if (vec) {
        cp_async16(dst, src, in);
      } else {
        bf16 h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = in && gk + e < cin ? src[e] : __float2bfloat16_rn(0.f);
        memcpy(dst, h, 16);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // the W chunk of iteration `it` into its ring slot
  auto load_w = [&](int it) {
    char* sb = ring + (it % WG_STAGES) * WG_BCHUNK;
    const int k0 = (it % kchunks) * WG_BK;
    const bf16* wc = ws + (size_t)(nt0 + it / kchunks) * WG_BN * cinp + k0;
#pragma unroll
    for (int l = 0; l < WG_BN * WG_BK / 8 / NT; ++l) {
      int n, kg;
      chunk_vec(l * NT + tid, n, kg);
      cp_async16(sb + core_off(n, kg, WG_BN), wc + (size_t)n * cinp + kg * 8,
                 true);
    }
  };

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const int lane = tid & 31;
  const int fr = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // tile row
  const float* bst = bias + (size_t)st * so;
  for (int it = 0; it < WG_STAGES - 1; ++it) {
    if (it < iters) load_w(it);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; it < iters; ++it) {
    if (it + WG_STAGES - 1 < iters) load_w(it + WG_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // X and this iteration's W chunk have landed
    asm volatile("cp.async.wait_group %0;\n" ::"n"(WG_STAGES - 1)
                 : "memory");
    // this thread's generic-proxy stores -> wgmma's async-proxy reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const char* sb = ring + (it % WG_STAGES) * WG_BCHUNK;
    const int kc = it % kchunks;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < WG_BK / 16; ++ks) {
      const uint64_t da = wgmma_desc(
          sa + kc * BM * 128 + core_off(wg * 64, 2 * ks, BM), BM * 16, 128);
      const uint64_t db = wgmma_desc(sb + core_off(0, 2 * ks, WG_BN),
                                     WG_BN * 16, 128);
      wgmma_m64n128k16(d, da, db, kc > 0 || ks > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    if (kc == kchunks - 1) {
      // the tile is done: bias, bf16, staged, then whole-row stores
      const int col0 = (nt0 + it / kchunks) * WG_BN;
#pragma unroll
      for (int n8 = 0; n8 < WG_BN / 8; ++n8) {
        const int c = col0 + n8 * 8 + (lane & 3) * 2;
        const float b0 = c < so ? bst[c] : 0.f;
        const float b1 = c < so ? bst[c + 1] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *(__nv_bfloat162*)(so_tile + out_off(fr + 8 * i, n8) +
                             (lane & 3) * 4) =
              __floats2bfloat162_rn(__fadd_rn(d[n8 * 4 + i * 2], b0),
                                    __fadd_rn(d[n8 * 4 + i * 2 + 1], b1));
      }
      __syncthreads();
      for (int q = tid; q < BM * WG_BN / 8; q += NT) {
        const int r = q >> 4, j = q & 15;
        const int gr = row0 + r, gc = col0 + j * 8;
        if (gr < rows && gc < so)   // so is a multiple of 8
          *(uint4*)(table + ((size_t)gr * streams + st) * so + gc) =
              *(const uint4*)(so_tile + out_off(r, j));
      }
    }
    __syncthreads();   // the ring slot and the staged tile are free again
  }
}

#define TB 64
#define TK 16

// W[st][k][c] sits at w[st * w_st + k * w_k + c * w_c].
template <typename T>
__global__ void __launch_bounds__(256)
table_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ bias, T* __restrict__ table, int rows,
             int streams, int cin, int so, long long w_st, int w_k,
             int w_c) {
  __shared__ float as[TK][TB + 1];
  __shared__ float bs[TK][TB];
  const int st = blockIdx.z;
  const int row0 = blockIdx.y * TB;
  const int col0 = blockIdx.x * TB;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t xstride = (size_t)streams * cin;
  const T* xs = x + (size_t)st * cin;
  const T* ws = w + st * w_st;
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
      bs[bk][bc] = (gk2 < cin && gc < so)
                       ? to_f32(ws[(size_t)gk2 * w_k + (size_t)gc * w_c])
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
// out[p, st*O + o] = sum_s max_k relu(<nd[p, k, st], dirs[st, :, s*O + o]>)
//                                   * table[b, idx[p, k], st, s*O + o]
// Each thread owns one support s and C = 16 / sizeof(T) consecutive
// channels (8 in bf16, 4 in fp32) of one stream: one 16-byte load of the
// neighbour's table row per slot, its 3*C direction weights and C running
// maxima in registers. A block serves one stream and a tile of AGG_PTS
// points, PC of them at a time (PC * S*O/C threads, 224 at O = 128 in
// bf16: whole warps, and small enough blocks that several fit per SM and
// keep enough row loads in flight to cover L2's latency). It stages the
// tile's idx and nd with one coalesced load, and issues the row loads of
// AGG_U slots before using them. The sum over supports goes through
// shared memory (double-buffered, one barrier per PC points) and is taken
// in order s = 0..S-1, the plain version's order. theta is contracted
// into FMAs: it moves theta by ~1 fp32 ulp, far inside the tolerances
// (1e-4 fp32, 2e-2 bf16, of max|ref|), and saves two of the ~9 issue
// slots per element, the other bound of this pass. The relu and the max
// propagate NaN (max.NaN), as torch.relu and torch.maximum do. S is
// compiled in up to 8 (SC = S: a runtime S costs registers, and with them
// spills under the 64-register cap); SC = 0 takes any S at run time. The
// thread layout limits S*O to AGG_THREADS 16-byte chunks (4096 bf16 or
// 2048 fp32 values).
// ---------------------------------------------------------------------------
#define AGG_U 4          // slots whose row loads are in flight together
#define AGG_PTS 8        // points per block
#define AGG_THREADS 512  // at most, per block; registers capped at 64 so
                         // that 1024 threads' loads are in flight per SM

__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <typename T, int SC>
__global__ void __launch_bounds__(AGG_THREADS, 2)
linear_agg_kernel(const int* __restrict__ idx, const T* __restrict__ nd,
                  const float* __restrict__ dirs, const T* __restrict__ table,
                  float* __restrict__ out, long long points, int N, int M,
                  int K, int streams, int s_rt, int O, int pc) {
  constexpr int C = 16 / sizeof(T);
  const int S = SC > 0 ? SC : s_rt;
  extern __shared__ __align__(16) float agg_smem[];
  const int so = S * O, oc = O / C, per = S * oc;
  const int tid = threadIdx.x;
  const int pl = tid / per, j = tid - pl * per;   // point lane, slot
  const int s = j / oc, o0 = (j - s * oc) * C;
  const int st = blockIdx.y;
  float* red = agg_smem;                               // [2][pc][so]
  int* s_idx = (int*)(agg_smem + 2 * pc * so);         // [AGG_PTS][K]
  float* s_nd = (float*)(s_idx + AGG_PTS * K);         // [AGG_PTS][K][3]
  const long long p0 = (long long)blockIdx.x * AGG_PTS;
  const int np = (int)min((long long)AGG_PTS, points - p0);

  // fp32 weights (the wrapper rounds them to T first): bf16 ones would be
  // unpacked again for every element, 3 more issue slots out of ~10
  float d0[C], d1[C], d2[C];
  {
    const float* dr = dirs + (size_t)st * 3 * so + s * O + o0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      d0[c] = __ldg(dr + c);
      d1[c] = __ldg(dr + so + c);
      d2[c] = __ldg(dr + 2 * so + c);
    }
  }
  for (int e = tid; e < np * K; e += blockDim.x) s_idx[e] = idx[p0 * K + e];
  for (int e = tid; e < np * K * 3; e += blockDim.x) {
    const int q = e / 3;   // (point, slot) of this value
    s_nd[e] = to_f32(nd[((p0 * K + q) * streams + st) * 3 + (e - q * 3)]);
  }
  __syncthreads();

  const size_t rstride = (size_t)streams * so;   // between table rows
  for (int p1 = 0; p1 < np; p1 += pc) {
    const int p = p1 + pl;
    float* buf = red + ((p1 / pc) & 1) * pc * so;
    if (p < np) {
      const long long pn = p0 + p;
      const T* tb = table + (size_t)(pn / N) * M * rstride + (size_t)st * so +
                    s * O + o0;
      const int* ip = s_idx + p * K;
      const float* np3 = s_nd + p * K * 3;
      float m[C];
#pragma unroll
      for (int c = 0; c < C; ++c) m[c] = -INFINITY;
      for (int k0 = 0; k0 < K; k0 += AGG_U) {
        uint4 v[AGG_U];
#pragma unroll
        for (int u = 0; u < AGG_U; ++u)
          if (k0 + u < K)
            v[u] = __ldg((const uint4*)(tb + (size_t)ip[k0 + u] * rstride));
#pragma unroll
        for (int u = 0; u < AGG_U; ++u) {
          if (k0 + u < K) {
            const float* n = np3 + (k0 + u) * 3;
            const float n0 = n[0], n1 = n[1], n2 = n[2];
            float f[C];
            unpack16(v[u], f);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float th = fmaf(n2, d2[c], fmaf(n1, d1[c], n0 * d0[c]));
              m[c] = max_nan(m[c], max_nan(th, 0.f) * f[c]);
            }
          }
        }
      }
      float* dst = buf + pl * so + s * O + o0;
#pragma unroll
      for (int c = 0; c < C; c += 4)
        *(float4*)(dst + c) = make_float4(m[c], m[c + 1], m[c + 2], m[c + 3]);
    }
    __syncthreads();
    // the sum over supports: one thread per (point lane, C channels)
    const int sp = tid / oc, q0 = (tid - sp * oc) * C;
    if (sp < pc && p1 + sp < np) {
      const float* src = buf + sp * so + q0;
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = src[c];
#pragma unroll
      for (int s2 = 1; s2 < S; ++s2)
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c] = __fadd_rn(acc[c], src[s2 * O + c]);
      float* o = out + ((p0 + p1 + sp) * streams + st) * O + q0;
#pragma unroll
      for (int c = 0; c < C; c += 4)
        *(float4*)(o + c) = make_float4(acc[c], acc[c + 1], acc[c + 2],
                                        acc[c + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Wide-table aggregate (kernel 5), one stream, d = 3 or 9.
// out[p, o] = sum_s max_k relu(<nd[p, k], dirs[:, s*O + o]>)
//                           * F[b, idx[p, k], s*O + o]
// with the support table F [B, M, S*O] given (the wide ConvLayer computes
// it with one matmul and passes a view of it: rows may be strided).
// Replaces pallas_gcn.py:_agg_kernel, which reads a pre-gathered
// [B, N, K, S*O] table; here the block gathers rows of F by idx.
//
// Everything before the support sum is per table column c = s*O + o, so a
// thread owns 16 bytes of the S*O row wherever they fall: 8 bf16 or 4 fp32
// columns, with their D direction weights in registers (at D = 9 in bf16,
// 36 bf16x2 registers). A point's row is then read by neighbouring threads
// in whole 16-byte loads (64 threads at S*O = 512 in bf16, 112 at 896), and
// WIDE_U slots' loads are issued before any is used. A block stages its
// tile of points' idx and nd once in shared memory (nd read as it comes,
// fp32 or bf16, and rounded there: the wrapper casts nothing), writes each
// point's column maxima to shared memory and sums the supports from there
// in order, ((m0 + m1) + m2) + ..., rounded per add in bf16.
//
// Numerics are the plain version's, op for op (aggregate_plain): in bf16
// each product and sum of theta, the relu, the product with F and the max
// run as packed bf16x2 instructions (mul.rn, add.rn, max.NaN), which round
// as PyTorch's fp32-then-bf16 eager ops do (a product of two bf16 values is
// exact in fp32, and fp32 then bf16 is an innocuous double rounding for +
// and x); the explicit .rn keeps the compiler from fusing them into FMAs.
// In fp32 nothing is rounded and nothing is contracted (__fmul_rn,
// __fadd_rn). The relu is max.NaN with +0, so NaN propagates as through
// torch.relu and torch.maximum; a theta of -0 comes out of it as +0
// (torch.relu keeps -0; the values compare equal).
//
// What bounds it: gathering K table rows per point, mostly from L2 (one
// batch element's table is 1.8 MB at the profiler's shape, 587 MB of row
// reads in all), and the packed issue rate (~2D + 2 bf16x2 instructions a
// column pair a slot). At the full FusionNet's fm_4 (2048 points) the
// tile is small enough that the grid fills the 132 SMs.
// ---------------------------------------------------------------------------
#define WIDE_THREADS 256   // at most, per block
#define WIDE_U 4           // slots whose row loads are in flight together
#define WIDE_FILL (4 * 132)   // blocks wanted before a lane takes more
#define WIDE_REPS 4           // points a lane takes at most (if the card
                              // is full)

__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t bf2_max(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// p[i] as fp32, p fp32 or bf16
__device__ __forceinline__ float ld_f32(const void* p, size_t i, bool bf) {
  return bf ? __bfloat162float(((const bf16*)p)[i]) : ((const float*)p)[i];
}

// One thread's 16 bytes of columns: NV registers of V, and the arithmetic.
template <typename T> struct Wide;

template <> struct Wide<bf16> {
  typedef uint32_t V;   // two bf16 columns, the lower one in the low half
  static constexpr int C = 8;
  static __device__ V mul(V a, V b) { return bf2_mul(a, b); }
  static __device__ V add(V a, V b) { return bf2_add(a, b); }
  static __device__ V max(V a, V b) { return bf2_max(a, b); }
  static __device__ V ninf() { return 0xff80ff80u; }
  // an nd value as staged in shared memory: bf16, twice
  static __device__ uint32_t stage(float x) {
    const uint32_t h = bf16_bits(x);
    return h | (h << 16);
  }
  static __device__ V from_bits(uint32_t u) { return u; }
  // columns c0, c0 + 1 of row d of dirs, zero past so
  static __device__ V weight(const void* dirs, bool bf, size_t row, int c,
                             int so) {
    const uint32_t lo = c < so ? bf16_bits(ld_f32(dirs, row + c, bf)) : 0u;
    const uint32_t hi =
        c + 1 < so ? bf16_bits(ld_f32(dirs, row + c + 1, bf)) : 0u;
    return lo | (hi << 16);
  }
  static __device__ uint32_t bits(V v) { return v; }
  // columns 2i, 2i + 1 of a chunk, read one value at a time
  static __device__ V scalar_pair(const bf16* p, int i, int n) {
    const unsigned short* q = (const unsigned short*)p;
    const uint32_t lo = 2 * i < n ? q[2 * i] : 0u;
    const uint32_t hi = 2 * i + 1 < n ? q[2 * i + 1] : 0u;
    return lo | (hi << 16);
  }
  static __device__ void store_scalar(bf16* dst, V v, int i, int n) {
    unsigned short* q = (unsigned short*)dst;
    if (2 * i < n) q[2 * i] = (unsigned short)(v & 0xffffu);
    if (2 * i + 1 < n) q[2 * i + 1] = (unsigned short)(v >> 16);
  }
  static __device__ float sum(float a, float b) {
    return rn<bf16>(__fadd_rn(a, b));
  }
};

template <> struct Wide<float> {
  typedef float V;
  static constexpr int C = 4;
  static __device__ V mul(V a, V b) { return __fmul_rn(a, b); }
  static __device__ V add(V a, V b) { return __fadd_rn(a, b); }
  static __device__ V max(V a, V b) { return max_nan(a, b); }
  static __device__ V ninf() { return -INFINITY; }
  static __device__ uint32_t stage(float x) { return __float_as_uint(x); }
  static __device__ V from_bits(uint32_t u) { return __uint_as_float(u); }
  static __device__ V weight(const void* dirs, bool bf, size_t row, int c,
                             int so) {
    return c < so ? ld_f32(dirs, row + c, bf) : 0.f;
  }
  static __device__ uint32_t bits(V v) { return __float_as_uint(v); }
  static __device__ V scalar_pair(const float* p, int i, int n) {
    return i < n ? p[i] : 0.f;
  }
  static __device__ void store_scalar(float* dst, V v, int i, int n) {
    if (i < n) dst[i] = v;
  }
  static __device__ float sum(float a, float b) { return __fadd_rn(a, b); }
};

// VEC: every row chunk is 16 whole, aligned bytes (the wrapper checks the
// table's base, strides and S*O); else each column is read on its own and
// the row's last chunk may be short.
template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS)
wide_agg_kernel(const int* __restrict__ idx, const void* __restrict__ nd,
                const void* __restrict__ dirs, unsigned in_bf16,
                const T* __restrict__ feats, long long batch_stride,
                long long row_stride, float* __restrict__ out,
                long long points, int N, int K, int S, int O, int tile,
                int pc, int tpp) {
  typedef Wide<T> W;
  typedef typename W::V V;
  constexpr int C = W::C, NV = 4;      // NV registers of V hold C columns
  constexpr int DP = D == 3 ? 4 : 12;  // staged nd words a slot (uint4s)
  extern __shared__ __align__(16) uint4 wide_smem[];
  const int so = S * O, chunks = (so + C - 1) / C;
  uint4* s_nd = wide_smem;                             // [tile][K][DP/4]
  int* s_idx = (int*)(s_nd + (size_t)tile * K * (DP / 4));   // [tile][K]
  T* s_m = (T*)(s_nd + (size_t)tile * K * (DP / 4) +
                ((size_t)tile * K + 3) / 4);           // [tile][so]
  const long long p0 = (long long)blockIdx.x * tile;
  const int np = (int)min((long long)tile, points - p0);
  const bool nd_bf = in_bf16 & 1, dir_bf = (in_bf16 >> 1) & 1;

  for (int e = threadIdx.x; e < np * K; e += blockDim.x)
    s_idx[e] = idx[p0 * K + e];
  {
    uint32_t* sw = (uint32_t*)s_nd;
    const size_t e0 = (size_t)p0 * K * D;
    for (int e = threadIdx.x; e < np * K * D; e += blockDim.x) {
      const int q = e / D;   // (point, slot) of this value
      sw[q * DP + (e - q * D)] = W::stage(ld_f32(nd, e0 + e, nd_bf));
    }
  }
  __syncthreads();

  const int pl = threadIdx.x / tpp, jt = threadIdx.x - pl * tpp;
  for (int j = jt; j < chunks; j += tpp) {
    const int c0 = j * C, nc = min(C, so - c0);
    V w[D][NV];
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int i = 0; i < NV; ++i)
        w[d][i] = W::weight(dirs, dir_bf, (size_t)d * so,
                            c0 + i * (C / NV), so);
    for (int p = pl; p < np; p += pc) {
      const long long pn = p0 + p;
      const T* rows = feats + (pn / N) * batch_stride + c0;
      const int* ip = s_idx + p * K;
      const uint4* nv = s_nd + (size_t)p * K * (DP / 4);
      V m[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) m[i] = W::ninf();
      for (int k0 = 0; k0 < K; k0 += WIDE_U) {
        V f[WIDE_U][NV];
#pragma unroll
        for (int u = 0; u < WIDE_U; ++u) {
          if (k0 + u < K) {
            const T* r = rows + (long long)ip[k0 + u] * row_stride;
            if (VEC) {
              const uint4 v = __ldg((const uint4*)r);
              f[u][0] = W::from_bits(v.x);
              f[u][1] = W::from_bits(v.y);
              f[u][2] = W::from_bits(v.z);
              f[u][3] = W::from_bits(v.w);
            } else {
#pragma unroll
              for (int i = 0; i < NV; ++i)
                f[u][i] = W::scalar_pair(r, i, nc);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < WIDE_U; ++u) {
          if (k0 + u >= K) continue;
          uint32_t n[DP];
#pragma unroll
          for (int q = 0; q < DP / 4; ++q) {
            const uint4 a = nv[(k0 + u) * (DP / 4) + q];
            n[4 * q] = a.x;
            n[4 * q + 1] = a.y;
            n[4 * q + 2] = a.z;
            n[4 * q + 3] = a.w;
          }
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            V th = W::mul(W::from_bits(n[0]), w[0][i]);
#pragma unroll
            for (int d = 1; d < D; ++d)
              th = W::add(th, W::mul(W::from_bits(n[d]), w[d][i]));
            th = W::max(th, V(0));
            m[i] = W::max(m[i], W::mul(th, f[u][i]));
          }
        }
      }
      T* dst = s_m + (size_t)p * so + c0;
      if (VEC) {
        *(uint4*)dst = make_uint4(W::bits(m[0]), W::bits(m[1]),
                                  W::bits(m[2]), W::bits(m[3]));
      } else {
#pragma unroll
        for (int i = 0; i < NV; ++i) W::store_scalar(dst, m[i], i, nc);
      }
    }
  }
  __syncthreads();

  // the sum over supports, one thread per (point, channel) at a time
  for (int e = threadIdx.x; e < np * O; e += blockDim.x) {
    const int p = e / O, o = e - p * O;
    const T* src = s_m + (size_t)p * so + o;
    float acc = to_f32(src[0]);
    for (int s = 1; s < S; ++s) acc = W::sum(acc, to_f32(src[s * O]));
    out[(p0 + p) * O + o] = acc;
  }
}

template <int C>
static int launch_surface(const SurfStreams& in, unsigned bf16_mask,
                          float* out, long long points, int K, int streams,
                          int S, int O, cudaStream_t stream) {
  typedef void (*surf_fn)(SurfStreams, unsigned, float*, long long, int, int,
                          int, int);
  surf_fn fn;
  const int passes = (S + 7) / 8;
  switch ((S + passes - 1) / passes) {   // supports a pass
    case 1: fn = surface_kernel<1, C>; break;
    case 2: fn = surface_kernel<2, C>; break;
    case 3: fn = surface_kernel<3, C>; break;
    case 4: fn = surface_kernel<4, C>; break;
    case 5: fn = surface_kernel<5, C>; break;
    case 6: fn = surface_kernel<6, C>; break;
    case 7: fn = surface_kernel<7, C>; break;
    case 8: fn = surface_kernel<8, C>; break;
    default: return POSE_UNSUPPORTED;
  }
  const int oc = O / C;
  const int ocb = oc < SURF_OCB ? oc : SURF_OCB;
  int lanes = SURF_THREADS / ocb;
  if (lanes > SURF_PTS) lanes = SURF_PTS;
  const size_t smem = sizeof(float4) * SURF_PTS * (size_t)K;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((points + SURF_PTS - 1) / SURF_PTS), streams,
            (oc + ocb - 1) / ocb);
  fn<<<grid, lanes * ocb, smem, stream>>>(in, bf16_mask, out, points, K,
                                          streams, S, O);
  return pose_last_error();
}

// nd_i [B, N, K, 3] and dirs_i [3, S*O] for streams i < `streams` (the rest
// null); bit i of bf16_mask says nd_i is bf16 (else fp32), bit
// SURF_MAX_STREAMS + i the same of dirs_i.
extern "C" int pose_gcn_surface(const void* nd0, const void* nd1,
                                const void* nd2, const void* nd3,
                                const void* dirs0, const void* dirs1,
                                const void* dirs2, const void* dirs3,
                                unsigned bf16_mask, float* out,
                                long long points, int K, int streams, int S,
                                int O, cudaStream_t stream) {
  if (points < 1 || K < 1 || K > 128 || streams < 1 ||
      streams > SURF_MAX_STREAMS || S < 1 || O < 1)
    return POSE_UNSUPPORTED;
  const SurfStreams in = {{nd0, nd1, nd2, nd3}, {dirs0, dirs1, dirs2, dirs3}};
  if (O % 2 == 0)
    return launch_surface<2>(in, bf16_mask, out, points, K, streams, S, O,
                             stream);
  return launch_surface<1>(in, bf16_mask, out, points, K, streams, S, O,
                           stream);
}

template <typename T>
static int launch_table(const void* x, const void* w, const float* bias,
                        void* table, int rows, int streams, int cin, int so,
                        cudaStream_t stream) {
  dim3 grid((so + TB - 1) / TB, (rows + TB - 1) / TB, streams);
  table_kernel<T><<<grid, 256, 0, stream>>>(
      (const T*)x, (const T*)w, bias, (T*)table, rows, streams, cin, so,
      (long long)cin * so, so, 1);
  return pose_last_error();
}

// bf16: w is [streams, round_up(so, WG_BN), round_up(cin, WG_BK)], W
// transposed and zero-padded by the wrapper (ops/gcn.py:_wgmma_weights).
template <>
int launch_table<bf16>(const void* x, const void* w, const float* bias,
                       void* table, int rows, int streams, int cin, int so,
                       cudaStream_t stream) {
  const int cinp = (cin + WG_BK - 1) / WG_BK * WG_BK;
  const int sop = (so + WG_BN - 1) / WG_BN * WG_BN;
  if (cinp > WG_MAX_CINP) {   // w is still [streams, sop, cinp]
    dim3 grid((so + TB - 1) / TB, (rows + TB - 1) / TB, streams);
    table_kernel<bf16><<<grid, 256, 0, stream>>>(
        (const bf16*)x, (const bf16*)w, bias, (bf16*)table, rows, streams,
        cin, so, (long long)sop * cinp, 1, cinp);
    return pose_last_error();
  }
  const int wgs = cinp <= 128 ? 4 : 2;
  const int bm = 64 * wgs;
  const int row_tiles = (rows + bm - 1) / bm;
  // split the column tiles over blocks until ~2 blocks per SM are there
  const int ntiles = sop / WG_BN;
  const int split = min(ntiles, max(1, (2 * 132 + row_tiles * streams - 1) /
                                           (row_tiles * streams)));
  const int per = (ntiles + split - 1) / split;
  dim3 grid(row_tiles, (ntiles + per - 1) / per, streams);
  const int smem = bm * cinp * 2 + WG_STAGES * WG_BCHUNK + bm * WG_BN * 2;
  auto fn = wgs == 4 ? table_wgmma_kernel<4> : table_wgmma_kernel<2>;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<grid, wgs * 128, smem, stream>>>((const bf16*)x, (const bf16*)w, bias,
                                        (bf16*)table, rows, streams, cin,
                                        cinp, so, sop, per);
  return pose_last_error();
}

template <typename T>
static int launch_linear(const int* idx, const void* nd, const void* dirs,
                         const void* x, const void* w, const float* bias,
                         void* table, float* out, int B, int N, int M, int K,
                         int streams, int cin, int S, int O,
                         cudaStream_t stream) {
  constexpr int C = 16 / sizeof(T);
  const int so = S * O;
  const int per = so / C;   // threads per point
  if (per > AGG_THREADS) return POSE_UNSUPPORTED;
  const int pc = max(1, min(AGG_PTS, 256 / per));   // points at a time
  typedef void (*agg_fn)(const int*, const T*, const float*, const T*, float*,
                         long long, int, int, int, int, int, int, int);
  agg_fn fn;
  switch (S) {
    case 1: fn = linear_agg_kernel<T, 1>; break;
    case 2: fn = linear_agg_kernel<T, 2>; break;
    case 3: fn = linear_agg_kernel<T, 3>; break;
    case 4: fn = linear_agg_kernel<T, 4>; break;
    case 5: fn = linear_agg_kernel<T, 5>; break;
    case 6: fn = linear_agg_kernel<T, 6>; break;
    case 7: fn = linear_agg_kernel<T, 7>; break;
    case 8: fn = linear_agg_kernel<T, 8>; break;
    default: fn = linear_agg_kernel<T, 0>;
  }
  const size_t smem = sizeof(float) * (2 * (size_t)pc * so +
                                       AGG_PTS * (size_t)K * 4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int err = launch_table<T>(x, w, bias, table, B * M, streams, cin, so,
                            stream);
  if (err) return err;
  const long long points = (long long)B * N;
  dim3 grid((unsigned)((points + AGG_PTS - 1) / AGG_PTS), streams);
  fn<<<grid, pc * per, smem, stream>>>(idx, (const T*)nd, (const float*)dirs,
                                       (const T*)table, out, points, N, M, K,
                                       streams, S, O, pc);
  return pose_last_error();
}

extern "C" int pose_gcn_linear(const int* idx, const void* nd,
                               const void* dirs, const void* x, const void* w,
                               const float* bias, void* table, float* out,
                               int B, int N, int M, int K, int streams,
                               int cin, int S, int O, int is_bf16,
                               cudaStream_t stream) {
  if (B < 1 || N < 1 || M < 1 || K < 1 || streams < 1 || cin < 1 || O < 1 ||
      O % 8 || S < 1)
    return POSE_UNSUPPORTED;
  if (is_bf16)
    return launch_linear<bf16>(idx, nd, dirs, x, w, bias, table, out, B, N, M,
                               K, streams, cin, S, O, stream);
  return launch_linear<float>(idx, nd, dirs, x, w, bias, table, out, B, N, M,
                              K, streams, cin, S, O, stream);
}

template <typename T, int D>
static int launch_aggregate(const int* idx, const void* nd, const void* dirs,
                            unsigned in_bf16, const T* feats,
                            long long batch_stride, long long row_stride,
                            float* out, int B, int N, int K, int S, int O,
                            cudaStream_t stream) {
  constexpr int C = Wide<T>::C, DP = D == 3 ? 4 : 12;
  const long long so = (long long)S * O;
  const long long chunks = (so + C - 1) / C;   // 16-byte chunks of a row
  const int tpp = chunks < WIDE_THREADS ? (int)chunks : WIDE_THREADS;
  int pc = max(1, WIDE_THREADS / tpp);   // points at a time
  const long long points = (long long)B * N;
  // a lane takes more than one point only once the grid fills the card
  const long long reps = points / ((long long)pc * WIDE_FILL);
  int tile = pc * (reps < 1 ? 1 : reps > WIDE_REPS ? WIDE_REPS : (int)reps);
  auto smem_of = [&](int t) {
    return 16 * ((size_t)t * K * (DP / 4) + ((size_t)t * K + 3) / 4) +
           (size_t)t * so * sizeof(T);
  };
  while (tile > 1 && smem_of(tile) > 48 * 1024) tile /= 2;
  pc = min(pc, tile);
  const size_t smem = smem_of(tile);
  if (smem > 227 * 1024) return POSE_UNSUPPORTED;
  const bool vec = so % C == 0 && (row_stride * sizeof(T)) % 16 == 0 &&
                   (batch_stride * sizeof(T)) % 16 == 0 &&
                   ((uintptr_t)feats & 15) == 0;
  auto fn = vec ? wide_agg_kernel<T, D, true> : wide_agg_kernel<T, D, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<(unsigned)((points + tile - 1) / tile), pc * tpp, smem, stream>>>(
      idx, nd, dirs, in_bf16, feats, batch_stride, row_stride, out, points, N,
      K, S, O, tile, pc, tpp);
  return pose_last_error();
}

// nd [B, N, K, D] and dirs [D, S*O], fp32 or bf16 (bit 0 of in_bf16: nd is
// bf16, bit 1: dirs), contiguous; the table's row (b, m) at feats +
// b * batch_stride + m * row_stride, its S*O columns contiguous, fp32 or
// bf16 (is_bf16), which sets the arithmetic.
extern "C" int pose_gcn_aggregate(const int* idx, const void* nd,
                                  const void* dirs, unsigned in_bf16,
                                  const void* feats, long long batch_stride,
                                  long long row_stride, float* out, int B,
                                  int N, int K, int D, int S, int O,
                                  int is_bf16, cudaStream_t stream) {
  if (B < 1 || N < 1 || K < 1 || O < 1 || S < 1 || (D != 3 && D != 9))
    return POSE_UNSUPPORTED;
  if (is_bf16)
    return D == 3 ? launch_aggregate<bf16, 3>(idx, nd, dirs, in_bf16,
                                              (const bf16*)feats, batch_stride,
                                              row_stride, out, B, N, K, S, O,
                                              stream)
                  : launch_aggregate<bf16, 9>(idx, nd, dirs, in_bf16,
                                              (const bf16*)feats, batch_stride,
                                              row_stride, out, B, N, K, S, O,
                                              stream);
  return D == 3 ? launch_aggregate<float, 3>(idx, nd, dirs, in_bf16,
                                             (const float*)feats, batch_stride,
                                             row_stride, out, B, N, K, S, O,
                                             stream)
                : launch_aggregate<float, 9>(idx, nd, dirs, in_bf16,
                                             (const float*)feats, batch_stride,
                                             row_stride, out, B, N, K, S, O,
                                             stream);
}
