// The train step's optimizer in three launches: the NaN guard, the clip by
// the global norm, gradient centralisation, RAdam, Lookahead and the add to
// the parameters, over every leaf of the model at once.
//
// Replaces no TPU kernel: the JAX package's optax chain (the guard,
// clip_by_global_norm, centralisation, scale_by_radam, the learning rate,
// lookahead) is left to XLA, which fuses it into a few loops over the
// leaves. The port ran it leaf by leaf in eager PyTorch: about 28 launches
// a leaf, 4,200 a step for the transparent models' ~150 leaves, with the
// card idle through most of them.
//
// What bounds it: HBM bytes. Per element the gradient is read twice (the
// reduction, the update), the first and second moments and the parameter
// read and written once, the slow weight read and written on Lookahead's
// sync steps: 32 bytes (40 on a sync step), about 1.0 GB a step at 30 M
// parameters, 0.3 ms at 3.35 TB/s.
//
// Design: a pointer table (per leaf: gradient, parameter, first moment,
// second moment, slow weight) copied to the card each step, and a plan
// built once per model (the leaves' shapes, the gradients' layouts):
//   1. rg_reduce: one block per task, a slice of one leaf's gradient read in
//      its memory order. It writes the slice's sum of squares and the sums
//      of each centralisation group the slice touches. A leaf of rank > 1
//      is grouped by its index along one dim (flax's axis 0): in memory,
//      element m is in group (m / stride) % size of that dim, so the leaf
//      is a matrix of rows of size x stride elements whose columns each
//      lie in one group. A task is a tile of up to 256 columns and a run
//      of rows (each thread sums one column over the run's rows), or a
//      contiguous run in one group (rank <= 1 leaves, one-group leaves,
//      and leaves of one row). Partial sums go to a workspace; there are
//      no float atomics, so a step repeats bit for bit.
//   2. rg_finish: block 0 sums the squares in a fixed order into the norm,
//      the guard's decision and the clip's; the other blocks sum each
//      group's partials (one warp a group) into its mean before the guard
//      and the clip (the clip is one scalar: the mean of the clipped
//      gradient is the clipped mean, within rounding).
//   3. rg_update: one block per chunk of 4,096 elements of one leaf, in
//      the parameter's (contiguous) order, 16-byte loads and stores of the
//      state; a channels-last gradient (what cuDNN's weight gradient of an
//      NHWC activation is) is gathered element by element.
// Arithmetic: the eager chain's, operation by operation in its order, with
// _rn intrinsics so that nothing is contracted into an FMA; the scalars are
// the float32 values ATen uses (its division of a tensor by a host scalar
// is a product with the float32 reciprocal). The two reductions (the norm,
// the group means) sum in another order than ATen's: that is the only
// departure from the eager chain.
#include "common.cuh"

#define RG_THREADS 256
#define RG_PTRS 5          // gradient, parameter, mu, nu, slow
#define RG_LEAF_INTS 8     // numel, groups, inner, gbase, layout, lanes, hw, 0
#define RG_TASK_INTS 12    // leaf, e0, row, cols, rows, n, c0, gdiv, 0, slot,
                           // ngroups, 0
#define RG_CHUNK_INTS 4    // leaf, start, len, 0
#define RG_GROUP_WARPS 8   // groups a finish block sums
#define RG_TREE_GROUPS 4   // a task with at most this many groups sums each
                           // with the block's tree

struct RgArgs {
  float clip, wd, b1, s1, b2, s2, inv_c1, inv_c2, r, eps, step, lrs, alpha;
  int use_clip, use_r, use_wd, sync;
};

// the block's sum of v in a fixed order (a warp tree, then one over the
// warps); the result in thread 0. Every thread of the block calls it.
__device__ __forceinline__ float rg_block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                      // red's last readers are done
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

__global__ void __launch_bounds__(RG_THREADS)
rg_reduce(const long long* __restrict__ table, const int* __restrict__ tasks,
          float* __restrict__ norm_part, float* __restrict__ group_part) {
  __shared__ float vals[RG_THREADS];
  __shared__ float red[32];
  const int* tk = tasks + (size_t)blockIdx.x * RG_TASK_INTS;
  const int leaf = tk[0], row = tk[2], cols = tk[3], rows = tk[4], n = tk[5],
            c0 = tk[6], gdiv = tk[7], slot = tk[9], ngroups = tk[10];
  const float* g = (const float*)table[(size_t)leaf * RG_PTRS] + tk[1];
  const int t = threadIdx.x, lanes = RG_THREADS / cols;
  const int col = t % cols, lane = t / cols;
  float s = 0.f, q = 0.f;
  if (lane < lanes)
    for (int r = lane; r < rows; r += lanes) {
      const long long off = (long long)r * row + col;
      if (off < n) {
        const float x = __ldg(g + off);
        s = __fadd_rn(s, x);
        q = __fadd_rn(q, __fmul_rn(x, x));
      }
    }
  q = rg_block_sum(q, red);
  if (t == 0) norm_part[blockIdx.x] = q;
  if (ngroups == 0) return;
  if (ngroups == 1) {
    s = rg_block_sum(s, red);
    if (t == 0) group_part[slot] = s;
    return;
  }
  const int first = c0 / gdiv;
  const bool on = lane < lanes;
  if (ngroups <= RG_TREE_GROUPS) {
    for (int j = 0; j < ngroups; ++j) {
      const float v = (on && (c0 + col) / gdiv - first == j) ? s : 0.f;
      const float sum = rg_block_sum(v, red);
      if (t == 0) group_part[slot + j] = sum;
    }
    return;
  }
  // many groups, each of few columns: a thread a group, in lane then
  // column order
  vals[t] = on ? s : 0.f;
  __syncthreads();
  if (t < ngroups) {
    const int lo = max((first + t) * gdiv, c0) - c0;
    const int hi = min((first + t + 1) * gdiv, c0 + cols) - c0;
    float sum = 0.f;
    for (int l = 0; l < lanes; ++l)
      for (int c = lo; c < hi; ++c) sum = __fadd_rn(sum, vals[l * cols + c]);
    group_part[slot + t] = sum;
  }
}

__global__ void __launch_bounds__(RG_THREADS)
rg_finish(const float* __restrict__ norm_part, int n_tasks,
          const float* __restrict__ group_part, const int* __restrict__ csr,
          const int* __restrict__ slots, const float* __restrict__ factor,
          int n_groups, const float* __restrict__ loss, float clip,
          int use_clip, float* __restrict__ scal, float* __restrict__ gmean,
          float* __restrict__ gnorm_out,
          unsigned char* __restrict__ finite_out) {
  __shared__ float red[32];
  if (blockIdx.x == 0) {
    float a = 0.f;
    for (int i = threadIdx.x; i < n_tasks; i += blockDim.x)
      a = __fadd_rn(a, norm_part[i]);
    a = rg_block_sum(a, red);
    if (threadIdx.x == 0) {
      const float gn = __fsqrt_rn(a);
      const bool fin = isfinite(*loss) && isfinite(gn);
      // the clip's norm: the guarded gradient's, 0 where it was zeroed
      const float cn = fin ? gn : 0.f;
      const bool keep = !use_clip || cn < clip;
      scal[0] = cn;
      scal[1] = fin ? 1.f : 0.f;
      scal[2] = keep ? 1.f : 0.f;
      *gnorm_out = gn;
      *finite_out = fin ? 1 : 0;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int gi = (blockIdx.x - 1) * RG_GROUP_WARPS + (threadIdx.x >> 5);
  if (gi >= n_groups) return;
  float a = 0.f;
  for (int i = csr[gi] + lane; i < csr[gi + 1]; i += 32)
    a = __fadd_rn(a, group_part[slots[i]]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, o));
  if (lane == 0) gmean[gi] = __fmul_rn(a, factor[gi]);
}

// one element of the chain: the guard's zeroing, the clip, centralisation
// (m: the group's mean of the guarded, clipped gradient), RAdam's moments
// and step, weight decay, the learning rate, Lookahead and the add
__device__ __forceinline__ void rg_elem(float g, float m, bool centred,
                                        float& p, float& mu, float& nu,
                                        float& sl, const RgArgs& a, float cn,
                                        bool fin, bool keep) {
  float v = fin ? g : 0.f;
  if (!keep) v = __fmul_rn(__fdiv_rn(v, cn), a.clip);
  if (centred) v = __fsub_rn(v, m);
  mu = __fadd_rn(__fmul_rn(v, a.s1), __fmul_rn(mu, a.b1));
  nu = __fadd_rn(__fmul_rn(__fmul_rn(v, v), a.s2), __fmul_rn(nu, a.b2));
  float u = __fmul_rn(mu, a.inv_c1);
  if (a.use_r)
    u = __fdiv_rn(__fmul_rn(u, a.r),
                  __fadd_rn(__fsqrt_rn(__fmul_rn(nu, a.inv_c2)), a.eps));
  if (a.use_wd) u = __fadd_rn(u, __fmul_rn(p, a.wd));
  u = __fmul_rn(__fmul_rn(u, a.step), a.lrs);
  if (a.sync) {
    const float synced =
        __fadd_rn(sl, __fmul_rn(__fsub_rn(__fadd_rn(p, u), sl), a.alpha));
    u = __fsub_rn(synced, p);
    sl = synced;
  }
  p = __fadd_rn(p, u);
}

struct RgLeaf {
  const float* g;
  float *p, *mu, *nu, *sl;
  const float* gmean;   // the leaf's groups' means, or null
  int inner, groups, layout, lanes, hw;
  float cn, clip;
  bool fin, keep;

  // element e (in the parameter's order) of the gradient
  __device__ __forceinline__ float grad(int e) const {
    if (layout == 0) return __ldg(g + e);
    // channels-last [O, I, H, W]: memory order O, H, W, I
    const int ihw = lanes * hw, o = e / ihw, rem = e - o * ihw;
    const int i = rem / hw, x = rem - i * hw;
    return __ldg(g + (size_t)o * ihw + (size_t)x * lanes + i);
  }
  // the group mean of element e, guarded and clipped as its gradient is
  __device__ __forceinline__ float mean(int e) const {
    if (!fin) return 0.f;
    const float m = gmean[(e / inner) % groups];
    return keep ? m : __fmul_rn(__fdiv_rn(m, cn), clip);
  }
};

// element e of leaf L, alone (unaligned state, the chunk's tail)
__device__ __forceinline__ void rg_scalar(const RgLeaf& L, int e,
                                          bool centred, const RgArgs& a) {
  float p = L.p[e], mu = L.mu[e], nu = L.nu[e], sl = a.sync ? L.sl[e] : 0.f;
  rg_elem(L.grad(e), centred ? L.mean(e) : 0.f, centred, p, mu, nu, sl, a,
          L.cn, L.fin, L.keep);
  L.p[e] = p;
  L.mu[e] = mu;
  L.nu[e] = nu;
  if (a.sync) L.sl[e] = sl;
}

__global__ void __launch_bounds__(RG_THREADS)
rg_update(const long long* __restrict__ table, const int* __restrict__ leaves,
          const int* __restrict__ chunks, const float* __restrict__ scal,
          const float* __restrict__ gmean, RgArgs a) {
  const int* ck = chunks + (size_t)blockIdx.x * RG_CHUNK_INTS;
  const int start = ck[1], end = ck[1] + ck[2];
  const int* lf = leaves + (size_t)ck[0] * RG_LEAF_INTS;
  const long long* tp = table + (size_t)ck[0] * RG_PTRS;
  RgLeaf L;
  L.g = (const float*)tp[0];
  L.p = (float*)tp[1];
  L.mu = (float*)tp[2];
  L.nu = (float*)tp[3];
  L.sl = (float*)tp[4];
  L.groups = lf[1];
  L.inner = lf[2];
  L.gmean = L.groups ? gmean + lf[3] : nullptr;
  L.layout = lf[4];
  L.lanes = lf[5];
  L.hw = lf[6];
  L.cn = scal[0];
  L.fin = scal[1] != 0.f;
  L.keep = scal[2] != 0.f;
  L.clip = a.clip;
  const bool centred = L.groups != 0;
  const bool vec =
      (((size_t)L.p | (size_t)L.mu | (size_t)L.nu |
        (a.sync ? (size_t)L.sl : 0) | (L.layout == 0 ? (size_t)L.g : 0)) &
       15) == 0;
  if (vec) {
    for (int e = start + 4 * threadIdx.x; e + 4 <= end;
         e += 4 * RG_THREADS) {
      float4 p4 = *reinterpret_cast<const float4*>(L.p + e);
      float4 m4 = *reinterpret_cast<const float4*>(L.mu + e);
      float4 n4 = *reinterpret_cast<const float4*>(L.nu + e);
      float4 s4 = a.sync ? *reinterpret_cast<const float4*>(L.sl + e)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 g4;
      if (L.layout == 0)
        g4 = __ldg(reinterpret_cast<const float4*>(L.g + e));
      else
        g4 = make_float4(L.grad(e), L.grad(e + 1), L.grad(e + 2),
                         L.grad(e + 3));
      float* pp = &p4.x; float* mm = &m4.x; float* nn = &n4.x;
      float* ss = &s4.x; const float* gg = &g4.x;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rg_elem(gg[j], centred ? L.mean(e + j) : 0.f, centred, pp[j], mm[j],
                nn[j], ss[j], a, L.cn, L.fin, L.keep);
      *reinterpret_cast<float4*>(L.p + e) = p4;
      *reinterpret_cast<float4*>(L.mu + e) = m4;
      *reinterpret_cast<float4*>(L.nu + e) = n4;
      if (a.sync) *reinterpret_cast<float4*>(L.sl + e) = s4;
    }
    // the chunk's last (len % 4) elements, one a thread
    const int e = start + ((end - start) & ~3) + threadIdx.x;
    if (e < end) rg_scalar(L, e, centred, a);
    return;
  }
  for (int e = start + threadIdx.x; e < end; e += RG_THREADS)
    rg_scalar(L, e, centred, a);
}

// table: per leaf the five pointers (gradient, parameter, mu, nu, slow) on
// the card. plan (on the card): n_leaves leaf rows, n_tasks reduction tasks,
// n_chunks update chunks, the n_groups + 1 offsets of each group's partial
// sums in `slots`, and the n_slots slots (ops/optim.py:make_plan). factor:
// each group's 1 / size as ATen's mean computes it. ws: 4 + n_tasks +
// n_slots + n_groups floats. loss: the step's total; gnorm_out, finite_out:
// the norm before the clip and the guard's decision. The rest: the chain's
// float32 scalars (b1 and its complement s1, b2 and s2, the reciprocals of
// the bias corrections, RAdam's rectifier when use_r), the clip when
// use_clip, weight decay when its value is not 0, Lookahead's alpha on a
// sync step.
extern "C" int pose_ranger_apply(
    const long long* table, const int* plan, const float* factor, float* ws,
    const float* loss, float* gnorm_out, unsigned char* finite_out,
    int n_leaves, int n_tasks, int n_chunks, int n_groups, int n_slots,
    float clip, int use_clip, float wd, float b1, float s1, float b2,
    float s2, float inv_c1, float inv_c2, float r, int use_r, float eps,
    float step, float lrs, int sync, float alpha, cudaStream_t stream) {
  if (n_leaves < 1 || n_tasks < 1 || n_chunks < 1 || n_groups < 0 ||
      n_slots < n_groups || (use_clip && !(clip > 0.f)))
    return POSE_UNSUPPORTED;
  const int* leaves = plan;
  const int* tasks = leaves + (size_t)n_leaves * RG_LEAF_INTS;
  const int* chunks = tasks + (size_t)n_tasks * RG_TASK_INTS;
  const int* csr = chunks + (size_t)n_chunks * RG_CHUNK_INTS;
  const int* slots = csr + n_groups + 1;
  float* scal = ws;
  float* norm_part = ws + 4;
  float* group_part = norm_part + n_tasks;
  float* gmean = group_part + n_slots;
  rg_reduce<<<n_tasks, RG_THREADS, 0, stream>>>(table, tasks, norm_part,
                                                group_part);
  const int finish_blocks =
      1 + (n_groups + RG_GROUP_WARPS - 1) / RG_GROUP_WARPS;
  rg_finish<<<finish_blocks, RG_GROUP_WARPS * 32, 0, stream>>>(
      norm_part, n_tasks, group_part, csr, slots, factor, n_groups, loss,
      clip, use_clip, scal, gmean, gnorm_out, finite_out);
  RgArgs a = {clip, wd, b1, s1, b2, s2, inv_c1, inv_c2, r, eps, step, lrs,
              alpha, use_clip, use_r, wd != 0.f, sync};
  rg_update<<<n_chunks, RG_THREADS, 0, stream>>>(table, leaves, chunks, scal,
                                                 gmean, a);
  return pose_last_error();
}
