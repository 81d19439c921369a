// Per-sample confusion counts for binary change maps, for Hopper (sm_90a).
//
// Replaces the TPU kernel gan_aug_pfa_tpu/ops/pallas_kernels/metrics.py:
// confusion_counts_batch.  For each sample b of a (B, H*W) pair of float32
// maps it counts, in one pass,
//   counts[b][0] = #{p > thr and t > 0.5}   (tp)
//   counts[b][1] = #{p > thr}               (sum of predictions)
//   counts[b][2] = #{t > 0.5}               (sum of targets)
// and the Python wrapper derives fp, fn and tn from them, as the TPU kernel
// does.  Targets are binary by contract.
//
// Bound: bytes.  It reads 8*B*H*W bytes and writes 12*B; at the evaluation
// shape (B=2, 128x128) that is 262 KB, about 78 ns at 3.35 TB/s, so in
// practice a launch costs more than the work.  The design keeps each launch
// short and deterministic:
//   * grid = (tiles of the H*W plane, B): many blocks per sample, since
//     blocks on Hopper run in parallel, not in order as the TPU grid does;
//   * each thread reads 16-byte float4 vectors (neighbouring threads on
//     neighbouring addresses) with a scalar head and tail where a tile's
//     ends are not 4-aligned, and counts in int registers;
//   * warp shuffles, then one shared-memory step, reduce the three counts;
//     one int32 atomicAdd per block and count adds them across tiles.
//     Integer atomics give the same result in any order.
// Exact while H*W < 2^24 (the wrapper checks), so the float32 counts the
// wrapper returns are exact too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Elements per block: 8 float4 vectors for each thread.
constexpr long long kTile = kThreads * 4 * 8;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ void count(float p, float t, float thr, int& tp,
                                      int& np, int& nt) {
  const int pp = p > thr;
  const int tt = t > 0.5f;
  tp += pp & tt;
  np += pp;
  nt += tt;
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
    confusion_counts_kernel(const float* __restrict__ probs,
                            const float* __restrict__ targets, float thr,
                            long long hw, int* __restrict__ counts) {
  const long long b = blockIdx.y;
  const long long lo = b * hw + blockIdx.x * kTile;
  const long long hi = b * hw + min(hw, (blockIdx.x + 1) * kTile);
  int tp = 0, np = 0, nt = 0;
  if (kVector) {
    // [lo, vlo) scalar head, [vlo, vhi) float4 body, [vhi, hi) scalar tail.
    long long vlo = (lo + 3) & ~3LL;
    long long vhi = hi & ~3LL;
    if (vlo > hi) vlo = vhi = hi;
    for (long long i = lo + threadIdx.x; i < vlo; i += kThreads)
      count(probs[i], targets[i], thr, tp, np, nt);
    const float4* p4 = reinterpret_cast<const float4*>(probs);
    const float4* t4 = reinterpret_cast<const float4*>(targets);
    for (long long v = vlo / 4 + threadIdx.x; v < vhi / 4; v += kThreads) {
      const float4 p = p4[v];
      const float4 t = t4[v];
      count(p.x, t.x, thr, tp, np, nt);
      count(p.y, t.y, thr, tp, np, nt);
      count(p.z, t.z, thr, tp, np, nt);
      count(p.w, t.w, thr, tp, np, nt);
    }
    for (long long i = vhi + threadIdx.x; i < hi; i += kThreads)
      count(probs[i], targets[i], thr, tp, np, nt);
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      count(probs[i], targets[i], thr, tp, np, nt);
  }

  __shared__ int partial[3][kWarps];
  tp = warp_sum(tp);
  np = warp_sum(np);
  nt = warp_sum(nt);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    partial[0][warp] = tp;
    partial[1][warp] = np;
    partial[2][warp] = nt;
  }
  __syncthreads();
  if (warp == 0) {
    tp = lane < kWarps ? partial[0][lane] : 0;
    np = lane < kWarps ? partial[1][lane] : 0;
    nt = lane < kWarps ? partial[2][lane] : 0;
    tp = warp_sum(tp);
    np = warp_sum(np);
    nt = warp_sum(nt);
    if (lane == 0) {
      atomicAdd(&counts[b * 3 + 0], tp);
      atomicAdd(&counts[b * 3 + 1], np);
      atomicAdd(&counts[b * 3 + 2], nt);
    }
  }
}

}  // namespace

extern "C" {

// probs, targets: (B, HW) float32, contiguous, on the device.
// counts: (B, 3) int32, zeroed by the caller.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int confusion_counts_f32(const float* probs, const float* targets, float thr,
                         int B, int HW, int* counts, void* stream) {
  if (B <= 0 || HW <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>((HW + kTile - 1) / kTile),
                  static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(probs) |
        reinterpret_cast<uintptr_t>(targets)) & 15u) == 0;
  if (aligned)
    confusion_counts_kernel<true><<<grid, kThreads, 0, s>>>(
        probs, targets, thr, HW, counts);
  else
    confusion_counts_kernel<false><<<grid, kThreads, 0, s>>>(
        probs, targets, thr, HW, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
