// Photometric augmentation (ColorJitter, then a 3x3 Gaussian blur) for
// Hopper (sm_90a).
//
// Replaces the two TPU kernels of gan_aug_pfa_tpu/ops/pallas_kernels/
// photometric.py:
//   * photometric_native_chw (kernel body _kernel_native): each padded
//     (3, Hp, Wp) image carries its native extent (h, w); the contrast mean
//     is the gray mean over that extent, and the blur reflects (reflect-101)
//     at the dynamic bottom and right edges.  Values outside the extent are
//     left unspecified, as in the TPU kernel.
//   * photometric_flip_chw (kernel body _kernel): the same at full extent,
//     with the sample's horizontal and vertical flips folded into the store
//     index (on the TPU the flips are separate XLA ops in the wrapper).
// Per image, from its row of a (B, 8) float32 parameter buffer:
//   native  [brightness, contrast, saturation, order, sigma, h, w, count]
//   flip    [brightness, contrast, saturation, order, sigma, flip_h,
//            flip_v, 0]
// the three ColorJitter ops run in one of six orders (torchvision
// semantics, each op clipped to [0, 1] and recomputed from the current
// value), with gray = 0.2989 r + 0.587 g + 0.114 b and
//   brightness  x * b
//   contrast    mean * (1 - c) + x * c,   mean = sum(gray) / count
//   saturation  gray * (1 - s) + x * s,
// then the separable blur, rows first and then columns on the row result,
// with taps k_edge = e / (2e + 1), k_mid = 1 / (2e + 1), e = exp(-0.5/sigma^2).
// The rows are read from device memory: a call never waits on the host.
//
// Bound: bytes.  A call must read the (B, 3, H, W) images and write them
// once, 24 bytes a pixel, plus 32 bytes of parameters an image: 0.470 us
// for 4 x 128 x 128 at 3.35 TB/s, 4.6 us for the 4 x 400 x 400 padded
// native batch of the test tree, 120 us for 16 x 1024 x 1024.  About 30
// float operations a pixel and channel are a smaller bound (0.35 us at
// 67 TFLOP/s for 4 x 128 x 128).
//
// The design.  The TPU kernel holds a whole (3, H, W) image in VMEM for one
// grid step.  An H100 block has at most 227 KB of shared memory, less than
// one 256 x 256 RGB float32 image (786 KB), and the contrast mean needs
// the whole image before any pixel after contrast can be written.  So a
// call is two launches:
//   1. statistics: each block applies the ops that precede contrast in the
//      image's order (none, brightness, saturation, or both) to its share
//      of the pixels inside the extent and sums their gray values into its
//      own slot of a (B, blocks) buffer.  No float atomics: each block's
//      sum, and the fixed-order sum of the slots below, do not depend on
//      the order in which blocks run, so equal inputs give equal bits;
//   2. apply: each block sums its image's slots in a fixed order (one
//      warp, a few dozen floats), loads a 32 x 32 output tile with a
//      one-pixel halo into shared memory, reflecting indices at the edge,
//      jitters it in place (jitter is pointwise once the mean is known),
//      blurs rows into a second shared tile, blurs its columns and stores.
//      Native tiles wholly outside the extent exit at once.
// The image is read twice (once in each launch, the second time with a 13%
// halo), so the best this design can reach is about two thirds of the byte
// bound; a simple, correct kernel comes first.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloH = kTileH + 2;
// Pixels for each thread of the statistics launch before its grid is
// capped, and the cap (blocks per image).
constexpr int kStatsItems = 16;
constexpr int kMaxStatsBlocks = 128;

// torchvision ColorJitter's six orders: 0 brightness, 1 contrast,
// 2 saturation.
__constant__ int kOrders[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                                  {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};

struct Params {
  float factor[3];
  int order;
  float k_edge, k_mid;
  int h, w;
  float count;
  bool flip_h, flip_v;
};

template <bool kNative>
__device__ __forceinline__ Params read_params(const float* __restrict__ row,
                                              int hp, int wp) {
  Params p;
  p.factor[0] = row[0];
  p.factor[1] = row[1];
  p.factor[2] = row[2];
  p.order = min(max(static_cast<int>(row[3]), 0), 5);
  const float sigma = row[4];
  const float e = expf(-0.5f / (sigma * sigma));
  const float s = (e + 1.0f) + e;
  p.k_edge = e / s;
  p.k_mid = 1.0f / s;
  if (kNative) {
    p.h = min(max(static_cast<int>(row[5]), 1), hp);
    p.w = min(max(static_cast<int>(row[6]), 1), wp);
    p.count = row[7];
    p.flip_h = p.flip_v = false;
  } else {
    p.h = hp;
    p.w = wp;
    p.count = static_cast<float>(hp) * static_cast<float>(wp);
    p.flip_h = row[5] > 0.5f;
    p.flip_v = row[6] > 0.5f;
  }
  return p;
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float gray(float r, float g, float b) {
  return 0.2989f * r + 0.587f * g + 0.114f * b;
}

// One ColorJitter op on one pixel.  `mean` is read by contrast only.
__device__ __forceinline__ void apply_op(int op, const Params& p, float mean,
                                         float& r, float& g, float& b) {
  if (op == 0) {
    const float f = p.factor[0];
    r = clip01(r * f);
    g = clip01(g * f);
    b = clip01(b * f);
  } else if (op == 1) {
    const float f = p.factor[1];
    const float m = mean * (1.0f - f);
    r = clip01(m + r * f);
    g = clip01(m + g * f);
    b = clip01(m + b * f);
  } else {
    const float f = p.factor[2];
    const float m = gray(r, g, b) * (1.0f - f);
    r = clip01(m + r * f);
    g = clip01(m + g * f);
    b = clip01(m + b * f);
  }
}

// Reflect-101 of index i into [0, n), clamped to the buffer [0, nbuf):
// -1 -> 1 and n -> n-2, as the TPU kernel's static top reflection and
// dynamic bottom fix-up give.  Indices further out belong to pixels
// outside the extent, whose values are unspecified.
__device__ __forceinline__ int reflect(int i, int n, int nbuf) {
  if (i >= n) i = 2 * (n - 1) - i;
  if (i < 0) i = -i;
  return min(i, nbuf - 1);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

int stats_blocks(int hp, int wp) {
  const long long want =
      (static_cast<long long>(hp) * wp + kThreads * kStatsItems - 1) /
      (kThreads * kStatsItems);
  return static_cast<int>(want < 1 ? 1
                          : want > kMaxStatsBlocks ? kMaxStatsBlocks
                                                   : want);
}

template <bool kNative>
__global__ void __launch_bounds__(kThreads)
    photometric_stats(const float* __restrict__ x,
                      const float* __restrict__ params, int hp, int wp,
                      float* __restrict__ partials) {
  const int b = blockIdx.y;
  const Params p = read_params<kNative>(params + 8 * b, hp, wp);
  const long long plane = static_cast<long long>(hp) * wp;
  const float* img = x + 3 * plane * b;
  int pre[2];
  int n_pre = 0;
  for (int k = 0; k < 2 && kOrders[p.order][k] != 1; ++k)
    pre[n_pre++] = kOrders[p.order][k];

  // Plane indices fit in int: launch() refuses hp * wp of 2^31 or more.
  float acc = 0.0f;
  const int n = p.h * p.w;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int y = i / p.w;
    const int at = y * wp + (i - y * p.w);
    float r = img[at], g = img[plane + at], bl = img[2 * plane + at];
    for (int k = 0; k < n_pre; ++k) apply_op(pre[k], p, 0.0f, r, g, bl);
    acc += gray(r, g, bl);
  }

  __shared__ float warp_partial[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  acc = warp_sum(acc);
  if (lane == 0) warp_partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kWarps ? warp_partial[lane] : 0.0f);
    if (lane == 0) partials[b * gridDim.x + blockIdx.x] = acc;
  }
}

template <bool kNative>
__global__ void __launch_bounds__(kThreads)
    photometric_apply(const float* __restrict__ x,
                      const float* __restrict__ params, int hp, int wp,
                      int n_partials, const float* __restrict__ partials,
                      float* __restrict__ out) {
  const int b = blockIdx.z;
  const Params p = read_params<kNative>(params + 8 * b, hp, wp);
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  if (y0 >= p.h || x0 >= p.w) return;  // wholly outside the native extent

  __shared__ float tile[3][kHaloH][kHaloW];
  __shared__ float rows[3][kTileH][kHaloW];
  __shared__ float mean_shared;
  const int tid = threadIdx.x;
  if (tid < 32) {
    float v = 0.0f;
    for (int k = tid; k < n_partials; k += 32) v += partials[b * n_partials + k];
    v = warp_sum(v);
    if (tid == 0) mean_shared = v / p.count;
  }
  __syncthreads();
  const float mean = mean_shared;

  const long long plane = static_cast<long long>(hp) * wp;
  const float* img = x + 3 * plane * b;
  const int* order = kOrders[p.order];
  for (int i = tid; i < kHaloH * kHaloW; i += kThreads) {
    const int ty = i / kHaloW;
    const int tx = i - ty * kHaloW;
    const int at =
        reflect(y0 - 1 + ty, p.h, hp) * wp + reflect(x0 - 1 + tx, p.w, wp);
    float r = img[at], g = img[plane + at], bl = img[2 * plane + at];
#pragma unroll
    for (int k = 0; k < 3; ++k) apply_op(order[k], p, mean, r, g, bl);
    tile[0][ty][tx] = r;
    tile[1][ty][tx] = g;
    tile[2][ty][tx] = bl;
  }
  __syncthreads();

  for (int i = tid; i < kTileH * kHaloW; i += kThreads) {
    const int ty = i / kHaloW;
    const int tx = i - ty * kHaloW;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rows[c][ty][tx] = tile[c][ty][tx] * p.k_edge +
                        tile[c][ty + 1][tx] * p.k_mid +
                        tile[c][ty + 2][tx] * p.k_edge;
  }
  __syncthreads();

  float* dst = out + 3 * plane * b;
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW;
    const int tx = i - ty * kTileW;
    const int y = y0 + ty;
    const int xc = x0 + tx;
    if (y >= p.h || xc >= p.w) continue;
    const int at =
        (p.flip_v ? hp - 1 - y : y) * wp + (p.flip_h ? wp - 1 - xc : xc);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      dst[c * plane + at] = rows[c][ty][tx] * p.k_edge +
                            rows[c][ty][tx + 1] * p.k_mid +
                            rows[c][ty][tx + 2] * p.k_edge;
  }
}

template <bool kNative>
int launch(const float* x, const float* params, int b, int hp, int wp,
           float* partials, float* out, void* stream) {
  if (b <= 0 || b > 65535 || hp <= 0 || wp <= 0 ||
      static_cast<long long>(hp) * wp >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_partials = stats_blocks(hp, wp);
  photometric_stats<kNative><<<dim3(n_partials, b), kThreads, 0, s>>>(
      x, params, hp, wp, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((wp + kTileW - 1) / kTileW, (hp + kTileH - 1) / kTileH, b);
  photometric_apply<kNative><<<grid, kThreads, 0, s>>>(
      x, params, hp, wp, n_partials, partials, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of scratch a call on (b, 3, hp, wp) images needs: one slot for
// each statistics block of each image.
int photometric_scratch_floats(int b, int hp, int wp) {
  return b * stats_blocks(hp, wp);
}

// x, out: (b, 3, hp, wp) float32, contiguous, on the device; params: (b, 8)
// float32 native rows; partials: photometric_scratch_floats(b, hp, wp)
// float32.  Two launches on `stream`; returns cudaGetLastError() (0 on
// success).
int photometric_native_f32(const float* x, const float* params, int b,
                           int hp, int wp, float* partials, float* out,
                           void* stream) {
  return launch<true>(x, params, b, hp, wp, partials, out, stream);
}

// As photometric_native_f32, with (b, 8) flip rows: full extent, flips
// applied.
int photometric_flip_f32(const float* x, const float* params, int b, int hp,
                         int wp, float* partials, float* out, void* stream) {
  return launch<false>(x, params, b, hp, wp, partials, out, stream);
}

}  // extern "C"
