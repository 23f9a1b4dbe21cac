// Bilinear up-sampling of NCHW maps, contiguous or channels-last:
//   F.interpolate(x, size=(ho, wo), mode="bilinear", align_corners=False),
// bit for bit, in fp32, bf16 and fp16, at any ratio, in the input's layout.
//
// Replaces no TPU kernel: the JAX package leaves jax.image.resize to XLA,
// and the port called F.interpolate. It was added because ATen's kernel for
// a contiguous NCHW map (upsample_bilinear2d_out_frame) launches one thread
// per output pixel of one plane (ho * wo threads) and has each thread walk
// all N * C planes in turn: a resize into HRNet's 32 x 32 branch at 128-px
// crops is 1,024 threads, one block on one of the card's 132 SMs, each
// running N * C dependent gathers (24,576 at 256 frames of 96 channels).
// At 256 frames a request those resizes were about half of the card's time
// in the KRRN forward. (Channels-last maps, which the BatchNorm models
// carry from their NHWC input, take the same path here.)
//
// What bounds it: HBM bytes. Each input byte is read once from device
// memory (a plane is 0.5-8 KB, so the reuse of a source pixel by its ~4
// outputs at 2x stays in L1) and each output byte is written once.
//
// Design: a map is `images` images of hi x wi pixels of `lanes` values
// each, the lanes innermost: a contiguous NCHW map is N * C images of one
// lane, a channels-last one N images of C lanes. The output is one flat
// array of images * ho * wo * lanes elements, cut into chunks of
// V = 16 / sizeof(T) consecutive elements (8 for bf16 and fp16, 4 for
// fp32); each thread computes one chunk and writes it with one 16-byte
// store, so the whole card takes part at any map size. A chunk may run
// past the end of a pixel, a row or an image: the thread walks (image, h2,
// w2, lane) on from its first element, so any size works, and the weights
// of a row or a column are computed where the walk enters it. The last
// chunk may be short: the scalar tail, stored element by element. The
// grid is the wrapper's (ops/resize.py:launch_plan); the entry refuses one
// that does not cover the output. Source pixels come through the
// read-only data path (ld.global.nc): an output's four are in two
// neighbouring rows of one image, shared with its neighbours in the chunk
// and in the next threads'.
//
// Arithmetic: ATen's (upsample_bilinear2d_out_frame and its channels-last
// twin compute alike), in its order. The scale in / out in fp32 on the
// host; the source index scale * (dst + 0.5) - 0.5, clamped at 0; h1 its
// integer part, h1p = h1 < in_h - 1, h1l = index - h1, h0l = 1 - h1l (w
// alike); then h0l * (w0l * a + w1l * b) + h1l * (w0l * d + w1l * e) in
// fp32, contracted to FMAs as ATen's kernels are (rs_sum), rounded once to
// T (to nearest, ties to even).
#include <cuda_fp16.h>

#include "common.cuh"

#define RS_MAX_THREADS 1024

// every map is loaded and stored as its bits
template <typename T> struct RsType;
template <> struct RsType<float> {
  typedef unsigned Bits;
  static __device__ __forceinline__ float load(const unsigned* p) {
    return __uint_as_float(__ldg(p));
  }
  static __device__ __forceinline__ unsigned bits(float v) {
    return __float_as_uint(v);
  }
};
template <> struct RsType<bf16> {
  typedef unsigned short Bits;
  static __device__ __forceinline__ float load(const unsigned short* p) {
    return __uint_as_float((unsigned)__ldg(p) << 16);
  }
  static __device__ __forceinline__ unsigned bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct RsType<__half> {
  typedef unsigned short Bits;
  static __device__ __forceinline__ float load(const unsigned short* p) {
    return __half2float(__ushort_as_half(__ldg(p)));
  }
  static __device__ __forceinline__ unsigned bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// ATen's area_pixel_compute_source_index (align_corners=False, not cubic),
// contracted to an FMA as ATen's kernels contract it
__device__ __forceinline__ float rs_source(float scale, int dst) {
  const float src = __fmaf_rn(scale, dst + 0.5f, -0.5f);
  return src < 0.f ? 0.f : src;
}

// the two source rows or columns of output row or column `dst`, as offsets
// (`step` elements apart), and their weights
struct RsPair {
  int o0, o1;
  float l0, l1;
};

__device__ __forceinline__ RsPair rs_pair(float scale, int dst, int in,
                                          int step) {
  const float r = rs_source(scale, dst);
  const int i = (int)r;
  const int ip = (i < in - 1) ? 1 : 0;
  const float l1 = r - i;
  return {i * step, (i + ip) * step, 1.f - l1, l1};
}

// ATen's sum of the four source values, with its FMAs, which its kernels
// do not all contract alike (found on the H100 against torch 2.11 + CUDA
// 12.8 by trying every pattern at ratios that tell them apart, one alone
// matching each; tests/test_torch_gpu.py holds them): the NCHW kernel as
//   fma(h0l, fma(w0l, a, w1l * b), h1l * fma(w0l, d, w1l * e))
// (a, b the top row's two values, d, e the bottom row's), and so does the
// channels-last one (ATen's for a channels-last map of 16 channels or
// more) in bf16 and fp16, but in fp32 it takes the first pair the other
// way round: fma(w1l, b, w0l * a).
__device__ __forceinline__ float rs_sum(const RsPair& r, const RsPair& c,
                                        float a, float b, float d, float e,
                                        bool swap) {
  const float top = swap ? __fmaf_rn(c.l1, b, __fmul_rn(c.l0, a))
                         : __fmaf_rn(c.l0, a, __fmul_rn(c.l1, b));
  const float bottom = __fmaf_rn(c.l0, d, __fmul_rn(c.l1, e));
  return __fmaf_rn(r.l0, top, __fmul_rn(r.l1, bottom));
}

// I: the index type, 32 bits where the output has at most 2^31 elements;
// CL: lanes > 1 (a channels-last map; else one lane, known here)
template <typename T, typename I, bool CL>
__global__ void __launch_bounds__(RS_MAX_THREADS)
resize_kernel(const typename RsType<T>::Bits* __restrict__ in,
              typename RsType<T>::Bits* __restrict__ out, I total,
              int lanes_, int hi, int wi, int ho, int wo, float rh,
              float rw) {
  typedef RsType<T> R;
  typedef typename R::Bits B;
  constexpr int V = 16 / sizeof(B);
  const int lanes = CL ? lanes_ : 1;
  // ATen's channels-last kernel in fp32
  const bool swap = CL && lanes >= 16 && sizeof(B) == 4;
  const I e0 = ((I)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e0 >= total) return;
  const I pix = e0 / lanes;                   // (image * ho + h2) * wo + w2
  int k = (int)(e0 - pix * lanes);
  const I row = pix / wo;                     // image * ho + h2
  int w2 = (int)(pix - row * wo);
  int h2 = (int)(row % ho);
  const B* image = in + (size_t)(row / ho) * hi * wi * lanes;
  const int n = total - e0 < (I)V ? (int)(total - e0) : V;
  RsPair r = rs_pair(rh, h2, hi, wi * lanes);
  RsPair c = rs_pair(rw, w2, wi, lanes);
  unsigned v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < n) {
      const B* top = image + r.o0 + k;
      const B* bottom = image + r.o1 + k;
      v[j] = R::bits(rs_sum(r, c, R::load(top + c.o0), R::load(top + c.o1),
                            R::load(bottom + c.o0), R::load(bottom + c.o1),
                            swap));
      if (++k == lanes) {   // the chunk goes on in the next pixel
        k = 0;
        if (++w2 == wo) {
          w2 = 0;
          if (++h2 == ho) {
            h2 = 0;
            image += (size_t)hi * wi * lanes;
          }
          r = rs_pair(rh, h2, hi, wi * lanes);
        }
        c = rs_pair(rw, w2, wi, lanes);
      }
    }
  }
  if (n == V) {
    uint4 q;
    if constexpr (V == 4)
      q = make_uint4(v[0], v[1], v[2], v[3]);
    else
      q = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                     v[6] | v[7] << 16);
    *reinterpret_cast<uint4*>(out + e0) = q;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < n) out[e0 + j] = (B)v[j];
  }
}

template <typename T, typename I, bool CL>
static void rs_start(const void* in, void* out, I total, int lanes, int hi,
                     int wi, int ho, int wo, int blocks, int threads,
                     cudaStream_t stream) {
  typedef typename RsType<T>::Bits B;
  const float rh = (float)hi / (float)ho, rw = (float)wi / (float)wo;
  resize_kernel<T, I, CL><<<blocks, threads, 0, stream>>>(
      (const B*)in, (B*)out, total, lanes, hi, wi, ho, wo, rh, rw);
}

template <typename T>
static int rs_launch(const void* in, void* out, long long total, int lanes,
                     int hi, int wi, int ho, int wo, int blocks, int threads,
                     cudaStream_t stream) {
  // 32-bit indices where every e0 < total + threads * vec fits in them
  const bool wide = total > (1LL << 31);
  if (lanes == 1 && !wide)
    rs_start<T, unsigned, false>(in, out, (unsigned)total, lanes, hi, wi, ho,
                                 wo, blocks, threads, stream);
  else if (lanes == 1)
    rs_start<T, unsigned long long, false>(in, out, total, lanes, hi, wi, ho,
                                           wo, blocks, threads, stream);
  else if (!wide)
    rs_start<T, unsigned, true>(in, out, (unsigned)total, lanes, hi, wi, ho,
                                wo, blocks, threads, stream);
  else
    rs_start<T, unsigned long long, true>(in, out, total, lanes, hi, wi, ho,
                                          wo, blocks, threads, stream);
  return pose_last_error();
}

// images x hi x wi pixels of `lanes` values in (lanes innermost: 1 for a
// contiguous NCHW map of N * C images, C for a channels-last map of N),
// images x ho x wo of them out. dtype: 0 fp32, 1 bf16, 2 fp16; vec: the
// elements a thread writes (16 bytes of them); blocks x threads: the grid,
// which must cover the output in chunks of vec, with no block past the
// last chunk. out 16-byte aligned.
extern "C" int pose_resize_bilinear(const void* in, void* out,
                                    long long images, int lanes, int hi,
                                    int wi, int ho, int wo, int dtype,
                                    int vec, int blocks, int threads,
                                    cudaStream_t stream) {
  const int size = dtype == 0 ? 4 : 2;
  const long long total = images * ho * wo * lanes;
  if (dtype < 0 || dtype > 2 || vec * size != 16 || images < 1 ||
      lanes < 1 || hi < 1 || wi < 1 || ho < 1 || wo < 1 || threads < 32 ||
      threads % 32 || threads > RS_MAX_THREADS || blocks < 1 ||
      (long long)blocks * threads * vec < total ||
      (long long)(blocks - 1) * threads * vec >= total ||
      (size_t)out % 16)
    return POSE_UNSUPPORTED;
  switch (dtype) {
    case 0:
      return rs_launch<float>(in, out, total, lanes, hi, wi, ho, wo, blocks,
                              threads, stream);
    case 1:
      return rs_launch<bf16>(in, out, total, lanes, hi, wi, ho, wo, blocks,
                             threads, stream);
    default:
      return rs_launch<__half>(in, out, total, lanes, hi, wi, ho, wo, blocks,
                               threads, stream);
  }
}
