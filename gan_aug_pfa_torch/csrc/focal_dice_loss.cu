// Fused FocalDice loss, forward and backward, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of gan_aug_pfa_tpu/ops/pallas_kernels/
// fused_loss.py: run_fwd (kernel body fwd_kernel) and run_bwd (bwd_kernel).
// Over n logits x (float32 or bfloat16, widened exactly) and float32
// targets t, with p = sigmoid(x),
//   bce     = softplus(x) - x*t,   pt = exp(-bce),
//   alpha_t = t*alpha + (1-t)*(1-alpha),   u = 1 - pt,
// the forward reduces four sums
//   S = [sum alpha_t * u^gamma * bce,  I = sum p*t,  P = sum p,  T = sum t]
// and the loss
//   L = beta * S[0]/n + (1-beta) * (1 - (2I + s) / (P + T + s)).
// The backward writes, for each element, in the logits' dtype,
//   dx = g * (beta * dfocal / n + (1-beta) * ddice),
//   dfocal = alpha_t * (p - t) * (gamma * u^(gamma-1) * pt * bce + u^gamma),
//   ddice  = (2I + s - 2t(P + T + s)) / (P + T + s)^2 * p * (1-p),
// from the saved sums and the upstream gradient g, both read from device
// memory, so a train step never waits on the host.
//
// Bound: bytes at large n.  The forward reads 8 bytes an element (6 with
// bf16 logits), the backward reads 8 and writes 4 (reads 6, writes 2):
// 40 and 60 us (30 and 40 us) at 16x1x1024x1024 and 3.35 TB/s.  Six (forward)
// and seven (backward) special-function results an element, at 16 a clock
// on each SM, take 24 and 28 us there.  At the train shape (65,536 elements)
// both are launch-bound.  The design:
//   * one launch a forward.  Each block reduces its four partial sums
//     (warp shuffles, then one shared-memory step, in a fixed order) into its
//     own row of a workspace, then takes an integer ticket (atomicAdd after
//     __threadfence).  The block that draws the last ticket sums every row
//     in block order in double, writes L and [S0, I, P, T], and puts the
//     ticket back to 0 for the next launch.  No float atomics: equal inputs
//     give equal bits, in a rerun and in a CUDA graph's replay.  A
//     cooperative launch with a grid barrier needs no ticket, but every
//     block waits there for the slowest one and the grid is capped at what
//     the card holds at once; with the ticket the other blocks just exit;
//   * 8 elements a thread an iteration: two 16-byte loads of float32 logits
//     (one of bf16) and two of targets, all in flight before any math; at
//     the train shape a group a thread in 64 blocks of 128, at 16M
//     elements 4 resident blocks of 256 an SM walking the groups (the
//     plan: ops/kernels/fused_loss.py);
//   * a view that does not start on a 16-byte boundary takes its first
//     `head` elements one at a time inside the kernel, then aligned groups
//     of 8, then a scalar tail; where logits and targets cannot both be
//     aligned, every element takes the scalar path;
//   * shared element math: e = exp(-|x|) once, for sigmoid (one reciprocal
//     of 1 + e, both p and 1 - p from it) and softplus (log2(1 + e));
//     u^gamma and u^(gamma-1) from one log2(u); the approximate hardware
//     exp2, log2 and reciprocal; 1/n, 1/(P+T+s)^2 and the dice constants
//     once a thread.  u^k = exp2(k * max(log2(u), -FLT_MAX)) keeps powf's
//     edges without a branch: 0^k = 0 for k > 0, u^0 = 1 also at u = 0;
//   * dx stored in the logits' dtype (bf16 rounded to nearest even), 16
//     bytes a store where dx allows, else one element a store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBlocksPerSM = 4;
// The grid's cap: kBlocksPerSM resident blocks on each of 132 SMs.  The
// workspace holds a row of 4 partial sums for each.
constexpr int kMaxBlocks = 132 * kBlocksPerSM;
constexpr int kVec = 8;  // elements a thread takes from each aligned group
// Workspace floats: the ticket (and 3 floats of padding), then the rows.
constexpr int kWorkspaceFloats = 4 + 4 * kMaxBlocks;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Hyper {
  float beta, gamma, alpha, smooth;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log2(u) for u^k = exp2(k * log2(u)), held at -FLT_MAX so that powf's
// edges stay without a branch: 0^k = 0 for k > 0 (k * -FLT_MAX lies below
// -126 for every k above 4e-37), 0^0 = 1 (0 * -FLT_MAX = -0, where
// 0 * -inf is NaN) and 0^k = inf for k < 0.
__device__ __forceinline__ float log2_for_pow(float u) {
  return fmaxf(lg2(u), -FLT_MAX);
}

// The terms both passes share: p = sigmoid(x), q = 1 - p, bce, pt.
struct Terms {
  float p, q, bce, pt;
};

__device__ __forceinline__ Terms terms(float x, float t) {
  const float e = ex2(-fabsf(x) * kLog2e);  // exp(-|x|), in (0, 1]
  const float one_e = 1.0f + e;
  const float r = rcp(one_e);
  const float er = e * r;
  const bool pos = x >= 0.0f;
  Terms k;
  k.p = pos ? r : er;
  k.q = pos ? er : r;
  // softplus(x) = max(x, 0) + log1p(exp(-|x|))
  const float sp = fmaf(lg2(one_e), kLn2, fmaxf(x, 0.0f));
  k.bce = fmaf(-x, t, sp);
  k.pt = ex2(-k.bce * kLog2e);
  return k;
}

// -- loads and stores ------------------------------------------------------

__device__ __forceinline__ float load1(const float* p, long long i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float load1(const __nv_bfloat16* p, long long i) {
  const unsigned short h =
      __ldg(reinterpret_cast<const unsigned short*>(p) + i);
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// 8 elements from a 16-byte-aligned address.
__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float v[kVec]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // the lower address is the low half
    v[2 * k] = __uint_as_float(u[k] << 16);
    v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store1(float* p, long long i, float v) {
  p[i] = v;
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, long long i,
                                       float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float v[kVec]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// -- reductions ------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

// Sums v[0..3] over the block in a fixed order; thread 0 gets the result.
template <typename T>
__device__ __forceinline__ void block_sum4(T v[4]) {
  __shared__ T partial[4][kMaxThreads / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) partial[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = warp_sum(lane < warps ? partial[k][lane] : T(0));
  }
}

// -- the kernels -----------------------------------------------------------

struct FwdConsts {
  float gamma, c0, c1;  // alpha_t = c0 + t * c1
};

__device__ __forceinline__ void fwd_elem(float x, float t,
                                         const FwdConsts& c, float v[4]) {
  const Terms k = terms(x, t);
  const float focal =
      fmaf(t, c.c1, c.c0) * ex2(c.gamma * log2_for_pow(1.0f - k.pt));
  v[0] = fmaf(focal, k.bce, v[0]);
  v[1] = fmaf(k.p, t, v[1]);
  v[2] += k.p;
  v[3] += t;
}

// Elements [0, head) and [head + 8*groups, n) one at a time; the groups of 8
// from x + head and t + head, both 16-byte aligned.
template <typename X>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
    focal_dice_fwd_kernel(const X* __restrict__ x,
                          const float* __restrict__ t, long long n,
                          long long head, long long groups, Hyper h,
                          float* __restrict__ workspace,
                          float* __restrict__ out) {
  const FwdConsts c{h.gamma, 1.0f - h.alpha, 2.0f * h.alpha - 1.0f};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long i = gid; i < head; i += stride)
    fwd_elem(load1(x, i), __ldg(t + i), c, v);
  const X* xv = x + head;
  const float* tv = t + head;
#pragma unroll 1
  for (long long j = gid; j < groups; j += stride) {
    float xs[kVec], ts[kVec];
    load8(xv + j * kVec, xs);
    load8(tv + j * kVec, ts);
#pragma unroll
    for (int k = 0; k < kVec; ++k) fwd_elem(xs[k], ts[k], c, v);
  }
  for (long long i = head + groups * kVec + gid; i < n; i += stride)
    fwd_elem(load1(x, i), __ldg(t + i), c, v);

  block_sum4(v);
  unsigned* ticket = reinterpret_cast<unsigned*>(workspace);
  float* rows = workspace + 4;
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) rows[blockIdx.x * 4 + k] = v[k];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block: every row is written; sum them in block order.
  __threadfence();
  double d[4] = {0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x) {
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] += __ldcg(rows + b * 4 + k);
  }
  block_sum4(d);
  if (threadIdx.x == 0) {
    const double focal_mean = d[0] / static_cast<double>(n);
    const double dice =
        1.0 - (2.0 * d[1] + h.smooth) / (d[2] + d[3] + h.smooth);
    out[0] = static_cast<float>(h.beta * focal_mean + (1.0 - h.beta) * dice);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[1 + k] = static_cast<float>(d[k]);
    *ticket = 0u;
  }
}

struct BwdConsts {
  float gamma, gamma1, c0, c1;  // alpha_t = c0 + t * c1
  float a, b;                   // ddice = (a - t*b) * p * (1-p)
  float cf, cd;                 // dx = cf * dfocal + cd * ddice
};

__device__ __forceinline__ float bwd_elem(float x, float t,
                                          const BwdConsts& c) {
  const Terms k = terms(x, t);
  const float lg = log2_for_pow(1.0f - k.pt);
  const float ug = ex2(c.gamma * lg);
  const float ug1 = ex2(c.gamma1 * lg);
  const float dfocal = fmaf(t, c.c1, c.c0) * (k.p - t) *
                       fmaf(c.gamma * ug1, k.pt * k.bce, ug);
  const float ddice = fmaf(-t, c.b, c.a) * (k.p * k.q);
  return fmaf(c.cf, dfocal, c.cd * ddice);
}

template <typename X>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
    focal_dice_bwd_kernel(const X* __restrict__ x,
                          const float* __restrict__ t,
                          const float* __restrict__ sums,
                          const float* __restrict__ grad, long long n,
                          long long head, long long groups, Hyper h,
                          X* __restrict__ dx) {
  const float g = __ldg(grad);
  const float denom = __ldg(sums + 2) + __ldg(sums + 3) + h.smooth;
  const float inv_d2 = 1.0f / (denom * denom);
  BwdConsts c;
  c.gamma = h.gamma;
  c.gamma1 = h.gamma - 1.0f;
  c.c0 = 1.0f - h.alpha;
  c.c1 = 2.0f * h.alpha - 1.0f;
  c.a = (2.0f * __ldg(sums + 1) + h.smooth) * inv_d2;
  c.b = 2.0f * denom * inv_d2;
  c.cf = g * h.beta / static_cast<float>(n);
  c.cd = g * (1.0f - h.beta);

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = gid; i < head; i += stride)
    store1(dx, i, bwd_elem(load1(x, i), __ldg(t + i), c));
  const X* xv = x + head;
  const float* tv = t + head;
  X* dv = dx + head;
  const bool vec_store = (reinterpret_cast<uintptr_t>(dv) & 15) == 0;
#pragma unroll 1
  for (long long j = gid; j < groups; j += stride) {
    float xs[kVec], ts[kVec];
    load8(xv + j * kVec, xs);
    load8(tv + j * kVec, ts);
#pragma unroll
    for (int k = 0; k < kVec; ++k) xs[k] = bwd_elem(xs[k], ts[k], c);
    if (vec_store) {
      store8(dv + j * kVec, xs);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) store1(dv, j * kVec + k, xs[k]);
    }
  }
  for (long long i = head + groups * kVec + gid; i < n; i += stride)
    store1(dx, i, bwd_elem(load1(x, i), __ldg(t + i), c));
}

// The plan (ops/kernels/fused_loss.py plan_launch) the kernels take:
// cudaSuccess, or cudaErrorInvalidValue for a plan they do not take.
cudaError_t check_plan(const void* x, int x_bytes, const float* t,
                       long long n, int threads, int blocks, long long head,
                       long long groups) {
  const bool ok =
      n > 0 && threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
      blocks >= 1 && blocks <= kMaxBlocks && head >= 0 && groups >= 0 &&
      head + groups * kVec <= n &&
      (groups == 0 ||
       ((reinterpret_cast<uintptr_t>(x) + head * x_bytes) % 16 == 0 &&
        (reinterpret_cast<uintptr_t>(t) + head * 4) % 16 == 0));
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Floats of the workspace one stream's forwards share: zeros before the
// first launch, and the kernel leaves the ticket at 0.
int focal_dice_workspace_floats() { return kWorkspaceFloats; }

// x: n logits, float32 (bf16 == 0) or bfloat16 (bf16 == 1); t: n float32
// targets; the plan (threads, blocks, head, groups); out: 5 float32, written
// with [L, S0, I, P, T]; workspace: focal_dice_workspace_floats() float32.
// All on the device.  Launches on `stream` and returns a CUDA error code (0
// on success).
int focal_dice_fwd(const void* x, int bf16, const float* t, long long n,
                   int threads, int blocks, long long head, long long groups,
                   float beta, float gamma, float alpha, float smooth,
                   float* out, float* workspace, void* stream) {
  cudaError_t err =
      check_plan(x, bf16 ? 2 : 4, t, n, threads, blocks, head, groups);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper h{beta, gamma, alpha, smooth};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    focal_dice_fwd_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), t, n, head, groups, h,
        workspace, out);
  } else {
    focal_dice_fwd_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), t, n, head, groups, h, workspace, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, t and the plan as for focal_dice_fwd; sums: the forward's [S0, I, P,
// T]; grad: the upstream gradient, one float32; dx: n elements of the
// logits' dtype.  All on the device.
int focal_dice_bwd(const void* x, int bf16, const float* t, const float* sums,
                   const float* grad, long long n, int threads, int blocks,
                   long long head, long long groups, float beta, float gamma,
                   float alpha, float smooth, void* dx, void* stream) {
  cudaError_t err =
      check_plan(x, bf16 ? 2 : 4, t, n, threads, blocks, head, groups);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper h{beta, gamma, alpha, smooth};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    focal_dice_bwd_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), t, sums, grad, n, head, groups,
        h, static_cast<__nv_bfloat16*>(dx));
  } else {
    focal_dice_bwd_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), t, sums, grad, n, head, groups, h,
        static_cast<float*>(dx));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
