// Fused FocalDice loss, forward and backward, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of gan_aug_pfa_tpu/ops/pallas_kernels/
// fused_loss.py: run_fwd (kernel body fwd_kernel) and run_bwd (bwd_kernel).
// Over n float32 logits x and binary targets t, with p = sigmoid(x),
//   bce     = softplus(x) - x*t,   pt = exp(-bce),
//   alpha_t = t*alpha + (1-t)*(1-alpha),   u = 1 - pt,
// the forward reduces four sums
//   S = [sum alpha_t * u^gamma * bce,  I = sum p*t,  P = sum p,  T = sum t]
// and the loss
//   L = beta * S[0]/n + (1-beta) * (1 - (2I + s) / (P + T + s)).
// The backward writes, for each element,
//   dx = g * (beta * dfocal / n + (1-beta) * ddice),
//   dfocal = alpha_t * (p - t) * (gamma * u^(gamma-1) * pt * bce + u^gamma),
//   ddice  = (2I + s - 2t(P + T + s)) / (P + T + s)^2 * p * (1-p),
// from the saved sums and the upstream gradient g, both read from device
// memory, so a train step never waits on the host.
//
// Bound: bytes.  The forward reads 8 bytes an element, the backward reads 8
// and writes 4: at the train shape (4x1x128x128, 65,536 elements) 0.16 and
// 0.23 us at 3.35 TB/s, so there a launch costs more than the work; at
// 16x1x1024x1024 40 and 60 us.  About 6 (forward) and 8 (backward)
// special-function operations an element are a smaller bound.  The design:
//   * no padding copy: any n runs, and a grid-stride loop masks the tail
//     (the TPU version pads to (rows, 128) only for its tiling);
//   * plain 4-byte loads, neighbouring threads on neighbouring elements,
//     so a view at any 4-byte-aligned address takes the same path;
//   * the forward is two launches.  The first has at most kMaxBlocks
//     blocks; each reduces its four partial sums (warp shuffles, then one
//     shared-memory step) into its own row of a (blocks, 4) buffer.  The
//     second, one block, sums that buffer in a fixed order in double and
//     writes L and [S0, I, P, T].  No float atomics: the loss does not
//     depend on the order in which blocks ran; equal inputs, equal bits;
//   * powf for u^gamma and u^(gamma-1): 0^0.793 = 0 and 0^0 = 1, where
//     exp(log(u) * k) would give NaN at u = 0;
//   * softplus as max(x, 0) + log1p(exp(-|x|)), finite for logits of +-1e4.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// One wave of 256-thread blocks on 132 SMs (8 resident blocks each).
constexpr int kMaxBlocks = 132 * 8;
// Elements for each thread of the forward before the grid is capped.
constexpr int kItems = 8;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

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
  __shared__ T partial[4][kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) partial[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = warp_sum(lane < kWarps ? partial[k][lane] : T(0));
  }
}

int forward_blocks(long long n) {
  const long long want = (n + kThreads * kItems - 1) / (kThreads * kItems);
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
    focal_dice_fwd_partial(const float* __restrict__ x,
                           const float* __restrict__ t, long long n,
                           float gamma, float alpha,
                           float* __restrict__ partials) {
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const float xi = x[i];
    const float ti = t[i];
    const float p = sigmoid(xi);
    const float bce = softplus(xi) - xi * ti;
    const float pt = expf(-bce);
    const float alpha_t = ti * alpha + (1.0f - ti) * (1.0f - alpha);
    v[0] += alpha_t * powf(1.0f - pt, gamma) * bce;
    v[1] += p * ti;
    v[2] += p;
    v[3] += ti;
  }
  block_sum4(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) partials[blockIdx.x * 4 + k] = v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
    focal_dice_fwd_finalize(const float* __restrict__ partials, int blocks,
                            long long n, float beta, float smooth,
                            float* __restrict__ loss,
                            float* __restrict__ sums) {
  double v[4] = {0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] += partials[b * 4 + k];
  }
  block_sum4(v);
  if (threadIdx.x == 0) {
    const double focal_mean = v[0] / static_cast<double>(n);
    const double dice =
        1.0 - (2.0 * v[1] + smooth) / (v[2] + v[3] + smooth);
    *loss = static_cast<float>(beta * focal_mean + (1.0 - beta) * dice);
#pragma unroll
    for (int k = 0; k < 4; ++k) sums[k] = static_cast<float>(v[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
    focal_dice_bwd(const float* __restrict__ x, const float* __restrict__ t,
                   const float* __restrict__ sums,
                   const float* __restrict__ grad, long long n, float beta,
                   float gamma, float alpha, float smooth,
                   float* __restrict__ dx) {
  const float inter = sums[1];
  const float denom = sums[2] + sums[3] + smooth;
  const float g = *grad;
  const float nf = static_cast<float>(n);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const float xi = x[i];
    const float ti = t[i];
    const float p = sigmoid(xi);
    const float bce = softplus(xi) - xi * ti;
    const float pt = expf(-bce);
    const float alpha_t = ti * alpha + (1.0f - ti) * (1.0f - alpha);
    const float u = 1.0f - pt;
    const float dfocal =
        alpha_t * (p - ti) *
        (gamma * powf(u, gamma - 1.0f) * pt * bce + powf(u, gamma));
    const float ddice = (2.0f * inter + smooth - 2.0f * ti * denom) /
                        (denom * denom) * p * (1.0f - p);
    dx[i] = g * (beta * dfocal / nf + (1.0f - beta) * ddice);
  }
}

}  // namespace

extern "C" {

// Floats of scratch the forward needs: 4 for each partial-sum block.
int focal_dice_fwd_scratch_floats(long long n) {
  return 4 * forward_blocks(n);
}

// x, t: n float32 on the device (any 4-byte-aligned address).  loss: one
// float32; sums: 4 float32, written with [sum focal, I, P, T]; partials:
// scratch of focal_dice_fwd_scratch_floats(n) float32, all on the device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int focal_dice_fwd_f32(const float* x, const float* t, long long n,
                       float beta, float gamma, float alpha, float smooth,
                       float* loss, float* sums, float* partials,
                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = forward_blocks(n);
  focal_dice_fwd_partial<<<blocks, kThreads, 0, s>>>(x, t, n, gamma, alpha,
                                                     partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  focal_dice_fwd_finalize<<<1, kThreads, 0, s>>>(partials, blocks, n, beta,
                                                 smooth, loss, sums);
  return static_cast<int>(cudaGetLastError());
}

// x, t, dx: n float32 on the device.  sums: the forward's [sum focal, I,
// P, T].  grad: the upstream gradient, one float32 on the device.
int focal_dice_bwd_f32(const float* x, const float* t, const float* sums,
                       const float* grad, long long n, float beta,
                       float gamma, float alpha, float smooth, float* dx,
                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  focal_dice_bwd<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, t, sums, grad, n, beta, gamma, alpha, smooth, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
