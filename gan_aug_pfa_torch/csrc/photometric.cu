// Photometric augmentation (ColorJitter, then a 3x3 Gaussian blur) for
// Hopper (sm_90a), one launch a call.
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
// for 4 x 128 x 128 at 3.35 TB/s, 2.47 us for the in-extent pixels of the
// 4 x 392 x 400 padded native batch of the test tree, 120 us for
// 16 x 1024 x 1024.  About 30 float operations a pixel and channel are a
// smaller bound (0.35 us at 67 TFLOP/s for 4 x 128 x 128).
//
// The design: one launch a call, one thread-block cluster an image.  The
// TPU kernel holds a whole image in VMEM; a Hopper block has at most 227 KB
// of shared memory, and the contrast mean needs the whole image before any
// pixel after contrast can be written.  So each image's rows are split into
// bands, one for each block of its cluster (C <= 16 blocks; the native
// kernel splits its dynamic extent h, read on the device), and the mean goes
// through distributed shared memory:
//   1. each block applies the ops that precede contrast in the image's order
//      to its own rows and reduces their gray sum in fixed shuffle trees into
//      a shared slot;
//   2. cluster barrier; lane r of each block's first warp reads block r's
//      slot through map_shared_rank and one fixed shuffle tree sums them, so
//      every block gets the same mean bits with no second launch and no
//      float atomics, and a rerun gives the same bits.  A second cluster
//      barrier, split into an arrive here and a wait before the block exits,
//      keeps each slot alive while a peer may read it;
//   3. the block jitters its rows, blurs them and stores; the flips are
//      folded into the store index, reflect-101 into the row and column
//      indices.
// Two modes, chosen by ops/kernels/photometric.py's plan_launch from
// (B, Hp, Wp) and validated here:
//   resident  the band and a one-row halo above and below fit in shared
//             memory: bulk asynchronous copies (cp.async.bulk, one a row and
//             channel, completing on an mbarrier) bring them in once; step 1
//             sums there, step 3 jitters them in place and each warp walks
//             down a strip of rows for 32 float4 column groups, three rows
//             in registers, the row blur of the columns either side of a
//             lane's four taken from its neighbours by shuffle.  The image
//             is read once.  A batch of one to three images leaves most SMs
//             idle, so there an image takes `split` clusters (as many as the
//             card holds at once): each sums the whole image, all in the
//             same order, so all get the same mean, and each jitters,
//             blurs and stores part j of every band.  A block holds only
//             its part and reads the rest of its band for the sum from
//             device memory, where the image's other clusters bring it into
//             L2.
//   streamed  they do not (16 x 1024 x 1024): the band passes twice through
//             a ring of a few rows in shared memory, each row brought in by
//             bulk copies on its own mbarrier, so rows stay in flight while
//             earlier ones are used.  Step 1 runs down the band; step 3 runs
//             back up it, so its first rows are those still in the ring and
//             in L2.  Each row is jittered in place once, then the block
//             blurs one output row from three ring rows.  Apart from those,
//             the image is read twice.
// Rows that are not 16-byte aligned (a width that is not a multiple of 4)
// take scalar loads and stores instead of bulk copies and float4s.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;  // a block; the plan picks 32..512
constexpr int kMaxCluster = 16;
constexpr int kMaxSplit = 4;      // clusters an image (resident mode)
constexpr int kMaxSlots = 8;      // streamed mode's ring rows
constexpr int kMinSlots = 4;
// Shared memory a block may take on sm_90 (sharedMemPerBlockOptin).
constexpr int kMaxSharedBytes = 232448;

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

// The images and the launch plan, as the kernel reads them.
struct Geometry {
  int hp, wp;
  int stride;   // floats a shared row: wp rounded up to 4
  int cluster;  // blocks a cluster
  int split;    // clusters an image
  int slots;    // rows of 3 channels in shared memory
  int vec;      // 1: 16-byte rows and pointers (bulk copies, float4)
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

__device__ __forceinline__ float gray(float r, float g, float b) {
  return 0.2989f * r + 0.587f * g + 0.114f * b;
}

// One ColorJitter op on one pixel, clipped to [0, 1] (__saturatef: the
// multiply or multiply-add and its clip are one instruction).  `mean` is
// read by contrast only.
__device__ __forceinline__ void apply_op(int op, const Params& p, float mean,
                                         float& r, float& g, float& b) {
  if (op == 0) {
    const float f = p.factor[0];
    r = __saturatef(r * f);
    g = __saturatef(g * f);
    b = __saturatef(b * f);
  } else if (op == 1) {
    const float f = p.factor[1];
    const float m = mean * (1.0f - f);
    r = __saturatef(m + r * f);
    g = __saturatef(m + g * f);
    b = __saturatef(m + b * f);
  } else {
    const float f = p.factor[2];
    const float m = gray(r, g, b) * (1.0f - f);
    r = __saturatef(m + r * f);
    g = __saturatef(m + g * f);
    b = __saturatef(m + b * f);
  }
}

// Three channels of four pixels.
struct Px {
  float4 r, g, b;
};

// Ops order[0..n) on the four pixels of `x`.
__device__ __forceinline__ void apply_ops(const Params& p, int n, float mean,
                                          Px& x) {
  const int* order = kOrders[p.order];
  for (int k = 0; k < n; ++k) {
    const int op = order[k];
    apply_op(op, p, mean, x.r.x, x.g.x, x.b.x);
    apply_op(op, p, mean, x.r.y, x.g.y, x.b.y);
    apply_op(op, p, mean, x.r.z, x.g.z, x.b.z);
    apply_op(op, p, mean, x.r.w, x.g.w, x.b.w);
  }
}

// Gray sum of the four pixels at columns x0.. that lie before column w.
__device__ __forceinline__ float masked_gray(const Px& x, int x0, int w) {
  float s = 0.0f;
  if (x0 < w) s += gray(x.r.x, x.g.x, x.b.x);
  if (x0 + 1 < w) s += gray(x.r.y, x.g.y, x.b.y);
  if (x0 + 2 < w) s += gray(x.r.z, x.g.z, x.b.z);
  if (x0 + 3 < w) s += gray(x.r.w, x.g.w, x.b.w);
  return s;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

// -- mbarrier, bulk copy and cluster barrier (PTX) ---------------------------

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   shared_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          shared_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the barrier's phase of the given parity to complete.  A copy
// that never lands traps (the launch then fails) after 2^26 polls instead
// of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// Relaxed: the peers' slots this block read before arriving have been read
// (their values were used), which is all the arrival promises.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// -- one block's band --------------------------------------------------------

// One block's rows: [y0, y1) of the image's extent, which it jitters, blurs
// and stores; position k (0 .. y1 - y0 + 1) is image row y0 - 1 + k: the
// halo above, the rows, the halo below.  It sums the gray of [s0, s1), its
// band: the same rows where an image has one cluster, a band that holds
// [y0, y1) where it has several.
struct Band {
  const float* img;  // (3, hp, wp) input
  float* dst;        // (3, hp, wp) output
  float* ring;       // slots x 3 x stride floats, shared
  uint64_t* bars;    // an mbarrier a slot (resident: one for all)
  long long plane;
  int y0, y1;
  int s0, s1;
  int groups;        // float4 groups a row: ceil(w / 4)
};

// The image row that row `y` of the band's positions reads: reflect-101 at
// row 0 and at the dynamic bottom, as the TPU kernel's static top reflection
// and dynamic fix-up give (clamped to the buffer: a 1-row buffer reads
// row 0).
__device__ __forceinline__ int source_row(const Band& bd, const Params& p,
                                          int hp, int y) {
  if (y >= bd.y0 && y < bd.y1) return y;
  const int from = y < bd.y0 ? bd.y0 : bd.y1 - 1;  // the row it neighbours
  if (y >= bd.y1 && bd.y1 < p.h) return bd.y1;
  return from == 0 ? min(1, hp - 1) : from - 1;
}

// Shared row of ring slot s, channel 0 (channels follow at g.stride).
__device__ __forceinline__ float* slot_row(const Band& bd, const Geometry& g,
                                           int s) {
  return bd.ring + s * 3 * g.stride;
}

// Brings position k of the band into ring slot s: with `vec`, one bulk copy
// a channel from thread 0, completing on the slot's mbarrier `bar`; else
// scalar loads by every thread, seen after the next __syncthreads.
__device__ void fetch(const Band& bd, const Geometry& g, const Params& p,
                      int k, int s, uint64_t* bar) {
  float* dst = slot_row(bd, g, s);
  const float* src =
      bd.img +
      static_cast<long long>(source_row(bd, p, g.hp, bd.y0 - 1 + k)) * g.wp;
  if (g.vec) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = 16u * bd.groups;
      mbar_expect_tx(bar, 3u * bytes);
      for (int c = 0; c < 3; ++c)
        bulk_load(dst + c * g.stride, src + c * bd.plane, bytes, bar);
    }
  } else {
    const int cols = min(g.wp, 4 * bd.groups);
    for (int i = threadIdx.x; i < 3 * cols; i += blockDim.x) {
      const int c = i / cols;
      const int xc = i - c * cols;
      dst[c * g.stride + xc] = src[c * bd.plane + xc];
    }
  }
}

// Four pixels at columns x0.. of a row whose channels lie `channel` floats
// apart (16-byte aligned: a shared row, or a `vec` image row).
__device__ __forceinline__ Px read_px(const float* row, long long channel,
                                      int x0) {
  Px x;
  x.r = *reinterpret_cast<const float4*>(row + x0);
  x.g = *reinterpret_cast<const float4*>(row + channel + x0);
  x.b = *reinterpret_cast<const float4*>(row + 2 * channel + x0);
  return x;
}

// As read_px for an image row that is not 16-byte aligned: scalar loads of
// the columns before w, zeros from column w on.
__device__ __forceinline__ Px read_px_masked(const float* row,
                                             long long channel, int x0,
                                             int w) {
  float v[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int x = x0 + i % 4;
    v[i] = x < w ? row[(i / 4) * channel + x] : 0.0f;
  }
  return Px{make_float4(v[0], v[1], v[2], v[3]),
            make_float4(v[4], v[5], v[6], v[7]),
            make_float4(v[8], v[9], v[10], v[11])};
}

// This thread's share of the gray sum of shared row `row` after the ops
// before contrast (pixels before column w): groups gx0, gx0 + gstep, ...
__device__ __forceinline__ float row_sum(const Band& bd, const Geometry& g,
                                         const Params& p, const float* row,
                                         int gx0, int gstep, int n_pre) {
  float acc = 0.0f;
  for (int gx = gx0; gx < bd.groups; gx += gstep) {
    Px x = read_px(row, g.stride, 4 * gx);
    apply_ops(p, n_pre, 0.0f, x);
    acc += masked_gray(x, 4 * gx, p.w);
  }
  return acc;
}

// Threads sweep rows x float4 groups, consecutive threads on consecutive
// groups: this thread's first row offset and group, and the rows at once
// (a thread past them has row offset 1 << 30: no rows).
struct Sweep {
  int row, col, rows, cols;
};

__device__ __forceinline__ Sweep make_sweep(int groups) {
  Sweep sw;
  sw.cols = min(groups, static_cast<int>(blockDim.x));
  sw.rows = blockDim.x / sw.cols;
  sw.row = threadIdx.x / sw.cols;
  sw.col = threadIdx.x - sw.row * sw.cols;
  if (sw.row >= sw.rows) sw.row = 1 << 30;
  return sw;
}

// The three ops in place on ring slots s0 .. s0 + rows - 1.
__device__ void jitter_slots(const Band& bd, const Geometry& g,
                             const Params& p, float mean, int s0, int rows) {
  const Sweep sw = make_sweep(bd.groups);
  const int c4 = g.stride / 4;
  for (int r = sw.row; r < rows; r += sw.rows) {
    float4* row = reinterpret_cast<float4*>(slot_row(bd, g, s0 + r));
    for (int gx = sw.col; gx < bd.groups; gx += sw.cols) {
      Px x{row[gx], row[c4 + gx], row[2 * c4 + gx]};
      apply_ops(p, 3, mean, x);
      row[gx] = x.r;
      row[c4 + gx] = x.g;
      row[2 * c4 + gx] = x.b;
    }
  }
}

// The column blur of four outputs from v[j], the row blur at column
// x0 - 1 + j, and their store into output row `out` (channel c).  Column w
// reflects to column w - 2: the group holding column w - 1 takes v[e] for
// v[e + 2].
template <bool kNative>
__device__ __forceinline__ void blur_store(const Geometry& g, const Params& p,
                                           const float (&v)[6], int x0,
                                           float* dst) {
  const float ke = p.k_edge, km = p.k_mid;
  const int w = p.w;
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = v[k] * ke + v[k + 1] * km + v[k + 2] * ke;
  const int e = w - 1 - x0;
  if (e < 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k == e) o[k] = v[k] * ke + v[k + 1] * km + v[k] * ke;
  }
  if (!kNative && p.flip_h) {
    if (g.vec) {  // w == wp, a multiple of 4: the group stays aligned
      *reinterpret_cast<float4*>(dst + g.wp - 4 - x0) =
          make_float4(o[3], o[2], o[1], o[0]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x0 + k < w) dst[g.wp - 1 - x0 - k] = o[k];
    }
  } else if (g.vec && x0 + 3 < w) {
    *reinterpret_cast<float4*>(dst + x0) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (x0 + k < w) dst[x0 + k] = o[k];
  }
}

// Output row of band row y (flipped rows land at hp - 1 - y), channel 0.
template <bool kNative>
__device__ __forceinline__ float* out_row(const Band& bd, const Geometry& g,
                                          const Params& p, int y) {
  const int yo = (!kNative && p.flip_v) ? g.hp - 1 - y : y;
  return bd.dst + static_cast<long long>(yo) * g.wp;
}

// -- resident mode -----------------------------------------------------------

// Positions 0 .. n + 1 into ring slots 0 .. n + 1: with `vec`, bulk copies
// from warp 0 completing on one mbarrier, else scalar loads by every thread.
// Returns after the rows have landed.
__device__ void load_band(const Band& bd, const Geometry& g, const Params& p) {
  const int n = bd.y1 - bd.y0 + 2;
  if (g.vec) {
    if (threadIdx.x < 32) {
      const uint32_t bytes = 16u * bd.groups;
      if (threadIdx.x == 0) mbar_expect_tx(bd.bars, bytes * 3u * n);
      __syncwarp();
      for (int k = threadIdx.x; k < 3 * n; k += 32) {
        const int slot = k / 3;
        const int c = k - slot * 3;
        bulk_load(slot_row(bd, g, slot) + c * g.stride,
                  bd.img + c * bd.plane +
                      static_cast<long long>(
                          source_row(bd, p, g.hp, bd.y0 - 1 + slot)) *
                          g.wp,
                  bytes, bd.bars);
      }
    }
    mbar_wait(bd.bars, 0);
  } else {
    const int cols = min(g.wp, 4 * bd.groups);
    for (int i = threadIdx.x; i < 3 * n * cols; i += blockDim.x) {
      const int row = i / cols;
      const int xc = i - row * cols;
      const int c = row % 3;
      bd.ring[row * g.stride + xc] =
          bd.img[c * bd.plane +
                 static_cast<long long>(
                     source_row(bd, p, g.hp, bd.y0 - 1 + row / 3)) *
                     g.wp +
                 xc];
    }
    __syncthreads();
  }
}

// Step 1: this thread's share of the gray sum of the band [s0, s1): the
// held rows from shared memory, the others from device memory, where
// another cluster of the image holds them.  One loop body and one order
// for both, so that every cluster of the image gets the same bits.
__device__ float resident_sum(const Band& bd, const Geometry& g,
                              const Params& p, int n_pre) {
  const Sweep sw = make_sweep(bd.groups);
  float acc = 0.0f;
  for (int y = bd.s0 + sw.row; y < bd.s1; y += sw.rows) {
    const bool held = y >= bd.y0 && y < bd.y1;
    const float* row = held ? slot_row(bd, g, y - bd.y0 + 1)
                            : bd.img + static_cast<long long>(y) * g.wp;
    const long long channel = held ? g.stride : bd.plane;
    for (int gx = sw.col; gx < bd.groups; gx += sw.cols) {
      const int x0 = 4 * gx;
      Px x = held || g.vec ? read_px(row, channel, x0)
                           : read_px_masked(row, channel, x0, p.w);
      apply_ops(p, n_pre, 0.0f, x);
      acc += masked_gray(x, x0, p.w);
    }
  }
  return acc;
}

// One row of a warp's walk: a lane's four pixels and, on the first and last
// lanes, the pixel just outside the warp's columns.
struct WalkRow {
  Px x;
  float re, ge, be;
};

__device__ __forceinline__ WalkRow walk_row(const Band& bd, const Geometry& g,
                                            int k, int x0, int xe,
                                            bool edge) {
  const float* row = slot_row(bd, g, k);
  WalkRow r;
  r.x = read_px(row, g.stride, x0);
  r.re = r.ge = r.be = 0.0f;
  if (edge) {
    r.re = row[xe];
    r.ge = row[g.stride + xe];
    r.be = row[2 * g.stride + xe];
  }
  return r;
}

// Step 3 after the jitter: the blur and the store of the band.  A warp's
// unit is 32 float4 groups of a strip of rows, which it walks down with
// three jittered rows in registers; the band's rows are split into as many
// strips as there are warps for each column chunk.  The row blur of the
// columns either side of a lane's four comes from the neighbouring lanes by
// shuffle; the first and last lanes read the column beyond the warp
// themselves.  All lanes of a warp run the same iterations, so each shuffle
// has the whole warp.
template <bool kNative>
__device__ void walk_band(const Band& bd, const Geometry& g, const Params& p) {
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int chunks = (bd.groups + 31) / 32;
  const int strips = max(1, warps / chunks);
  const int n = bd.y1 - bd.y0;
  const int strip_rows = (n + strips - 1) / strips;
  const int w = p.w;
  const float ke = p.k_edge, km = p.k_mid;
  for (int unit = threadIdx.x / 32; unit < chunks * strips; unit += warps) {
    const int gx = (unit % chunks) * 32 + lane;
    const int ka = 1 + (unit / chunks) * strip_rows;  // positions ka .. kb-1
    const int kb = min(n + 1, ka + strip_rows);
    if (ka >= kb) continue;  // the whole warp: ka and kb are warp-uniform
    const bool live = gx < bd.groups;
    // Idle lanes read a live group and store nothing.
    const int x0 = 4 * min(gx, bd.groups - 1);
    const bool edge = live && ((lane == 0 && x0 > 0) ||
                               (lane == 31 && x0 + 4 < w));
    const int xe = !edge ? x0 : lane == 0 ? x0 - 1 : x0 + 4;

    WalkRow up = walk_row(bd, g, ka - 1, x0, xe, edge);
    WalkRow mid = walk_row(bd, g, ka, x0, xe, edge);
    for (int k = ka; k < kb; ++k) {
      const WalkRow dn = walk_row(bd, g, k + 1, x0, xe, edge);
      float* out = out_row<kNative>(bd, g, p, bd.y0 - 1 + k);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 u = c == 0 ? up.x.r : c == 1 ? up.x.g : up.x.b;
        const float4 m = c == 0 ? mid.x.r : c == 1 ? mid.x.g : mid.x.b;
        const float4 d = c == 0 ? dn.x.r : c == 1 ? dn.x.g : dn.x.b;
        float v[6];
        v[1] = u.x * ke + m.x * km + d.x * ke;
        v[2] = u.y * ke + m.y * km + d.y * ke;
        v[3] = u.z * ke + m.z * km + d.z * ke;
        v[4] = u.w * ke + m.w * km + d.w * ke;
        v[0] = __shfl_up_sync(0xffffffffu, v[4], 1);
        v[5] = __shfl_down_sync(0xffffffffu, v[1], 1);
        if (edge) {
          const float ve =
              (c == 0 ? up.re : c == 1 ? up.ge : up.be) * ke +
              (c == 0 ? mid.re : c == 1 ? mid.ge : mid.be) * km +
              (c == 0 ? dn.re : c == 1 ? dn.ge : dn.be) * ke;
          if (lane == 0)
            v[0] = ve;
          else
            v[5] = ve;
        }
        // Column -1 reflects to column 1 (column 0 in a 1-wide buffer).
        if (x0 == 0) v[0] = g.wp > 1 ? v[2] : v[1];
        if (live) blur_store<kNative>(g, p, v, x0, out + c * bd.plane);
      }
      up = mid;
      mid = dn;
    }
  }
}

// -- streamed mode -----------------------------------------------------------

// The band's positions pass through a ring of g.slots rows: position k in
// slot k % slots, each slot with its own mbarrier.  `parity` holds a bit a
// slot: the phase of its next wait (every thread waits on every fill, in
// the order of the fills).  Called by the whole block at once.
__device__ __forceinline__ void await_fill(const Band& bd, const Geometry& g,
                                           uint32_t& parity, int s) {
  if (!g.vec) {  // scalar fills by every thread
    __syncthreads();
    return;
  }
  mbar_wait(&bd.bars[s], (parity >> s) & 1u);
  parity ^= 1u << s;
}

// Step 1: positions first .. n + 1 down the band (the halo above only where
// the whole band fits the ring, `first` 0), slots refilled a ring ahead;
// this thread's share of the gray sum of positions 1 .. n.
__device__ float stream_sum(const Band& bd, const Geometry& g,
                            const Params& p, uint32_t& parity, int first,
                            int n_pre) {
  const int n = bd.y1 - bd.y0;
  for (int k = first; k < min(first + g.slots, n + 2); ++k)
    fetch(bd, g, p, k, k % g.slots, &bd.bars[k % g.slots]);
  float acc = 0.0f;
  for (int k = first; k <= n + 1; ++k) {
    const int s = k % g.slots;
    await_fill(bd, g, parity, s);
    if (k >= 1 && k <= n)
      acc += row_sum(bd, g, p, slot_row(bd, g, s), threadIdx.x, blockDim.x,
                     n_pre);
    __syncthreads();  // slot s is free
    if (k + g.slots <= n + 1) fetch(bd, g, p, k + g.slots, s, &bd.bars[s]);
  }
  return acc;
}

// Step 3: output rows from the bottom of the band up.  Positions from
// `held` up are still in the ring from step 1; the others are fetched
// again, g.slots - 3 rows ahead of their use, into the slot of a position
// that no later output reads.  Each position is jittered in place once,
// just before the first output that reads it.
template <bool kNative>
__device__ void stream_apply(const Band& bd, const Geometry& g,
                             const Params& p, uint32_t& parity, float mean,
                             int first) {
  const int n = bd.y1 - bd.y0;
  const int held = max(first, n + 2 - g.slots);
  jitter_slots(bd, g, p, mean, (n + 1) % g.slots, 1);
  jitter_slots(bd, g, p, mean, n % g.slots, 1);
  for (int k = n; k >= 1; --k) {
    const int s_up = (k - 1) % g.slots;
    if (k - 1 < held) await_fill(bd, g, parity, s_up);
    jitter_slots(bd, g, p, mean, s_up, 1);
    __syncthreads();  // positions k - 1 .. k + 1 jittered; k + 2 is free
    const int j = k + 2 - g.slots;
    if (j >= 0 && j < held)
      fetch(bd, g, p, j, j % g.slots, &bd.bars[j % g.slots]);
    const float* up = slot_row(bd, g, s_up);
    const float* mid = slot_row(bd, g, k % g.slots);
    const float* dn = slot_row(bd, g, (k + 1) % g.slots);
    float* out = out_row<kNative>(bd, g, p, bd.y0 - 1 + k);
    const float ke = p.k_edge, km = p.k_mid;
    for (int gx = threadIdx.x; gx < bd.groups; gx += blockDim.x) {
      const int x0 = 4 * gx;
      // Column -1 reflects to column 1 (column 0 in a 1-wide buffer);
      // column x0 + 4 is read only inside the extent.
      const int xl = x0 > 0 ? x0 - 1 : (g.wp > 1 ? 1 : 0);
      const bool right = x0 + 4 < p.w;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int o = c * g.stride;
        const float4 u = *reinterpret_cast<const float4*>(up + o + x0);
        const float4 m = *reinterpret_cast<const float4*>(mid + o + x0);
        const float4 d = *reinterpret_cast<const float4*>(dn + o + x0);
        float v[6];
        v[0] = up[o + xl] * ke + mid[o + xl] * km + dn[o + xl] * ke;
        v[1] = u.x * ke + m.x * km + d.x * ke;
        v[2] = u.y * ke + m.y * km + d.y * ke;
        v[3] = u.z * ke + m.z * km + d.z * ke;
        v[4] = u.w * ke + m.w * km + d.w * ke;
        v[5] = right ? up[o + x0 + 4] * ke + mid[o + x0 + 4] * km +
                           dn[o + x0 + 4] * ke
                     : 0.0f;
        blur_store<kNative>(g, p, v, x0, out + c * bd.plane);
      }
    }
  }
}

template <bool kNative, bool kResident>
__global__ void __launch_bounds__(kMaxThreads, kResident ? 1 : 2)
    photometric_kernel(const float* __restrict__ x,
                       const float* __restrict__ params, Geometry g,
                       float* __restrict__ out) {
  extern __shared__ float4 ring_storage[];
  __shared__ __align__(8) uint64_t bars[kMaxSlots];
  __shared__ float warp_sums[kMaxThreads / 32];
  __shared__ float block_sum;
  __shared__ float mean_shared;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int image = blockIdx.x / (g.cluster * g.split);
  const int part = (blockIdx.x / g.cluster) % g.split;
  const Params p = read_params<kNative>(params + 8 * image, g.hp, g.wp);
  const int tid = threadIdx.x;

  Band bd;
  bd.plane = static_cast<long long>(g.hp) * g.wp;
  bd.img = x + 3 * bd.plane * image;
  bd.dst = out + 3 * bd.plane * image;
  bd.ring = reinterpret_cast<float*>(ring_storage);
  bd.bars = bars;
  const int per = (p.h + g.cluster - 1) / g.cluster;
  bd.s0 = min(p.h, rank * per);
  bd.s1 = min(p.h, bd.s0 + per);
  // This cluster's part of the band.
  bd.y0 = bd.s0 + (bd.s1 - bd.s0) * part / g.split;
  bd.y1 = bd.s0 + (bd.s1 - bd.s0) * (part + 1) / g.split;
  // Column 1 is read by reflect-101 even when w is 1.
  bd.groups = (min(g.wp, max(p.w, 2)) + 3) / 4;
  const bool busy = bd.y1 > bd.y0;  // an empty part still joins the barriers
  // Streamed: the halo above joins step 1 where the whole band fits.
  const int first = bd.y1 - bd.y0 + 2 <= g.slots ? 0 : 1;
  uint32_t parity = 0;

  // The ops before contrast in this image's order.
  const int* order = kOrders[p.order];
  const int n_pre = order[0] == 1 ? 0 : order[1] == 1 ? 1 : 2;

  // 1. This band's gray sum after the ops before contrast.
  float acc = 0.0f;
  if (busy) {
    if (tid == 0) {
      for (int s = 0; s < (kResident ? 1 : g.slots); ++s) mbar_init(&bars[s]);
      mbar_init_fence();
    }
    __syncthreads();
    if (kResident) {
      load_band(bd, g, p);
    } else {
      acc = stream_sum(bd, g, p, parity, first, n_pre);
    }
  }
  if (kResident && bd.s1 > bd.s0) acc = resident_sum(bd, g, p, n_pre);
  // Fixed shuffle trees: warps, then the block's warp sums in warp 0.
  acc = warp_sum(acc);
  if (tid % 32 == 0) warp_sums[tid / 32] = acc;
  __syncthreads();
  if (tid < 32) {
    acc = warp_sum(tid < static_cast<int>(blockDim.x) / 32 ? warp_sums[tid]
                                                           : 0.0f);
    if (tid == 0) block_sum = acc;
  }

  // 2. The image's mean, the same bits in every block of the cluster.
  cluster.sync();
  if (tid < 32) {
    acc = warp_sum(tid < g.cluster ? *cluster.map_shared_rank(&block_sum, tid)
                                   : 0.0f);
    if (tid == 0) mean_shared = acc / p.count;
  }
  __syncthreads();
  cluster_arrive();  // done reading the peers' slots
  const float mean = mean_shared;

  // 3. The jitter, the blur and the store.
  if (busy) {
    if (kResident) {
      jitter_slots(bd, g, p, mean, 0, bd.y1 - bd.y0 + 2);
      __syncthreads();
      walk_band<kNative>(bd, g, p);
    } else {
      stream_apply<kNative>(bd, g, p, parity, mean, first);
    }
  }
  cluster_wait();  // no peer reads this block's slot any more
}

// -- the host side -----------------------------------------------------------

// Per kernel, device and plan: whether the attributes are set and the
// cluster can be scheduled (cudaOccupancyMaxActiveClusters >= 1), so that a
// call pays for the query once.
struct Prepared {
  const void* fn;
  int device, threads, cluster, smem, active;
};
std::mutex g_prepared_mutex;
Prepared g_prepared[64];
int g_n_prepared = 0;

cudaError_t max_active_clusters(const void* fn, cudaLaunchConfig_t* cfg,
                                int* active) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int threads = cfg->blockDim.x;
  const int cluster = cfg->attrs[0].val.clusterDim.x;
  const int smem = static_cast<int>(cfg->dynamicSmemBytes);
  std::lock_guard<std::mutex> lock(g_prepared_mutex);
  for (int i = 0; i < g_n_prepared; ++i) {
    const Prepared& e = g_prepared[i];
    if (e.fn == fn && e.device == device && e.threads == threads &&
        e.cluster == cluster && e.smem == smem) {
      *active = e.active;
      return cudaSuccess;
    }
  }
  int optin = 0;
  cudaFuncAttributes attrs;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
          cudaSuccess ||
      (err = cudaFuncGetAttributes(&attrs, fn)) != cudaSuccess)
    return err;
  const int static_bytes = static_cast<int>(attrs.sharedSizeBytes);
  if (smem + static_bytes > optin) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(fn,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin - static_bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveClusters(active, fn, cfg)) != cudaSuccess)
    return err;
  if (g_n_prepared < 64)
    g_prepared[g_n_prepared++] = {fn, device, threads, cluster, smem, *active};
  return cudaSuccess;
}

struct Plan {
  int threads, cluster, split, band_rows, resident, smem_bytes;
};

// Checks the plan against the images and fills the geometry; 0 or a CUDA
// error code.  The shared memory holds `slots` rows of 3 channels: the
// band and its halo rows (resident), or a ring of kMinSlots..kMaxSlots
// (streamed).
int check_plan(int b, int hp, int wp, const Plan& plan, Geometry* g) {
  g->hp = hp;
  g->wp = wp;
  g->stride = (wp + 3) / 4 * 4;
  g->cluster = plan.cluster;
  g->split = plan.split;
  const long long row_bytes = 3LL * 4 * g->stride;
  g->slots = static_cast<int>(
      plan.smem_bytes > 0 ? plan.smem_bytes / row_bytes : 0);
  const bool ok =
      b > 0 && hp > 0 && wp > 0 &&
      static_cast<long long>(hp) * wp < (1LL << 31) && plan.threads >= 32 &&
      plan.threads <= kMaxThreads && plan.threads % 32 == 0 &&
      plan.cluster >= 1 && plan.cluster <= kMaxCluster && plan.split >= 1 &&
      plan.split <= (plan.resident ? kMaxSplit : 1) &&
      static_cast<long long>(b) * plan.split * plan.cluster <= 0x7fffffffLL &&
      plan.band_rows >= 1 &&
      static_cast<long long>(plan.band_rows) * plan.cluster >= hp &&
      plan.smem_bytes >= 0 && plan.smem_bytes <= kMaxSharedBytes &&
      (plan.resident ? g->slots >= (plan.band_rows + plan.split - 1) /
                                           plan.split + 2
                     : g->slots >= kMinSlots && g->slots <= kMaxSlots);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

void fill_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int b,
                 const Plan& plan, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(b * plan.split * plan.cluster);
  cfg->blockDim = dim3(plan.threads);
  cfg->dynamicSmemBytes = plan.smem_bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = plan.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <bool kNative>
const void* kernel_for(bool resident) {
  return resident
             ? reinterpret_cast<const void*>(&photometric_kernel<kNative, true>)
             : reinterpret_cast<const void*>(
                   &photometric_kernel<kNative, false>);
}

template <bool kNative>
int launch(const float* x, const float* params, int b, int hp, int wp,
           const Plan& plan, float* out, void* stream) {
  Geometry g;
  if (const int bad = check_plan(b, hp, wp, plan, &g)) return bad;
  g.vec = wp % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config(&cfg, &attr, b, plan, static_cast<cudaStream_t>(stream));
  int active = 0;
  cudaError_t err =
      max_active_clusters(kernel_for<kNative>(plan.resident), &cfg, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = plan.resident
            ? cudaLaunchKernelEx(&cfg, photometric_kernel<kNative, true>, x,
                                 params, g, out)
            : cudaLaunchKernelEx(&cfg, photometric_kernel<kNative, false>, x,
                                 params, g, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: (b, 3, hp, wp) float32, contiguous, on the device; params: (b, 8)
// float32 native rows.  The plan (threads, cluster, split, band_rows,
// resident, smem_bytes) is ops/kernels/photometric.py's
// plan_launch(b, hp, wp).  One launch on `stream`; returns 0, or a CUDA error code if the plan does not
// fit the images, cannot be scheduled, or the launch is refused.
int photometric_native_f32(const float* x, const float* params, int b,
                           int hp, int wp, int threads, int cluster,
                           int split, int band_rows, int resident,
                           int smem_bytes, float* out, void* stream) {
  return launch<true>(
      x, params, b, hp, wp,
      {threads, cluster, split, band_rows, resident, smem_bytes}, out,
      stream);
}

// As photometric_native_f32, with (b, 8) flip rows: full extent, flips
// applied.
int photometric_flip_f32(const float* x, const float* params, int b, int hp,
                         int wp, int threads, int cluster, int split,
                         int band_rows, int resident, int smem_bytes,
                         float* out, void* stream) {
  return launch<false>(
      x, params, b, hp, wp,
      {threads, cluster, split, band_rows, resident, smem_bytes}, out,
      stream);
}

// How many clusters of the plan the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int photometric_active_clusters(int native, int b, int hp, int wp,
                                int threads, int cluster, int split,
                                int band_rows, int resident, int smem_bytes) {
  const Plan plan{threads, cluster, split, band_rows, resident, smem_bytes};
  Geometry g;
  if (const int bad = check_plan(b, hp, wp, plan, &g)) return -bad;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill_config(&cfg, &attr, b, plan, nullptr);
  int active = 0;
  const cudaError_t err = max_active_clusters(
      native ? kernel_for<true>(resident) : kernel_for<false>(resident), &cfg,
      &active);
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

}  // extern "C"
