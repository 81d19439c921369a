// Per-sample confusion counts for binary change maps, for Hopper (sm_90a).
//
// Replaces the TPU kernel gan_aug_pfa_tpu/ops/pallas_kernels/metrics.py:
// confusion_counts_batch (its pallas_call at :46).  For each sample b of a
// (B, H*W) pair of float32 maps, probabilities p and binary targets t, it
// writes the TPU kernel's (B, 4) float32 row
//   [tp, fp, fn, tn] = [tp, P - tp, T - tp, H*W - P - T + tp],
//   tp = #{p > thr and t > 0.5},  P = #{p > thr},  T = #{t > 0.5},
// itself, in one launch, with nothing else on the stream.
//
// Bound: bytes.  It reads 8*B*H*W bytes and writes 16*B: 262 KB at the
// evaluation shape (B=2, 128x128), 0.078 us at 3.35 TB/s; 40.07 us at
// 16x1024x1024.  Counting takes a few integer instructions an element, far
// under the card's issue rate.  At the evaluation shape the bound cannot be
// reached: a launch replayed from a CUDA graph costs about 2 us by itself,
// so the kernel's time there is the launch, one round trip to memory and
// the meeting of the blocks.  The design keeps that to one launch and one
// wave there, and stays near the byte bound at large shapes:
//   * one launch a call.  Each block counts its part of one sample in int
//     registers, sums them over each warp with __reduce_add_sync (one
//     instruction on sm_80 and later) and over the warps in one
//     shared-memory step; thread 0 adds the block's three counts to the
//     sample's slot of a persistent int32 workspace (kSlotInts ints a
//     sample: tp, P, T and a ticket) and, after __threadfence(), takes the
//     sample's ticket.  The block that draws the last ticket reads the
//     three sums with atomicExch, which also resets them, writes the row
//     and puts the ticket back to 0, so the next launch needs no fill.
//     That is three round trips to L2 after a block's count; where the
//     counts and the ticket fit one 64-bit word (3 * bits(H*W) +
//     bits(blocks a sample) <= 64: 128x128 maps, not 1024x1024), one
//     atomicAdd with return carries them all and is the only round trip.
//     Integer sums are exact in any order: equal inputs give equal bits
//     without an ordered sum;
//   * a grid that fills the card at the evaluation shapes: (blocks a
//     sample, B) blocks of 32 to 256 threads, 128 blocks at 2x128x128 and
//     at 16x128x128, 4 blocks of 256 an SM from about 2^21 elements on
//     (the plan: ops/kernels/confusion_counts.py plan_launch);
//   * each thread issues all its 16-byte loads of an iteration (kUnroll
//     float4 of p and as many of t) before it counts any of them;
//   * a view that does not start on a 16-byte boundary takes its first
//     `head` elements one at a time, then aligned groups of 4, then a
//     scalar tail; where p and t cannot both be aligned, or where the
//     samples do not share one alignment (H*W not a multiple of 4, B > 1),
//     every element takes the scalar path.  The entry point checks the
//     plan and returns an error for one it does not take.
// Exact while H*W < 2^24 (the wrapper checks), where float32 holds every
// count.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBlocksPerSM = 4;
// The most blocks a sample takes: kBlocksPerSM resident blocks on each of
// the H100's 132 SMs.
constexpr int kMaxBlocks = 132 * kBlocksPerSM;
constexpr int kVec = 4;       // floats in a 16-byte group
constexpr int kUnroll = 2;    // groups a thread loads before it counts
constexpr int kSlotInts = 4;  // a sample's workspace slot: tp, P, T, ticket
constexpr int kMaxBatch = 65535;  // gridDim.y

using u64 = unsigned long long;

struct Counts {
  int tp, np, nt;
};

__device__ __forceinline__ void count(float p, float t, float thr,
                                      Counts& c) {
  const int pp = p > thr;
  const int tt = t > 0.5f;
  c.tp += pp & tt;
  c.np += pp;
  c.nt += tt;
}

__device__ __forceinline__ void count4(const float4& p, const float4& t,
                                       float thr, Counts& c) {
  count(p.x, t.x, thr, c);
  count(p.y, t.y, thr, c);
  count(p.z, t.z, thr, c);
  count(p.w, t.w, thr, c);
}

// Grid (blocks a sample, B).  Sample b's elements [0, head) and
// [head + kVec*groups, hw) one at a time, its groups of kVec from p + head
// and t + head, both 16-byte aligned; every loop strides over the sample's
// blocks.
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
    confusion_counts_kernel(const float* __restrict__ probs,
                            const float* __restrict__ targets, float thr,
                            long long hw, long long head, long long groups,
                            int field_bits, int* __restrict__ workspace,
                            float* __restrict__ out) {
  const long long b = blockIdx.y;
  const float* p = probs + b * hw;
  const float* t = targets + b * hw;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  Counts c{0, 0, 0};
  for (long long i = gid; i < head; i += stride)
    count(__ldg(p + i), __ldg(t + i), thr, c);
  const float4* p4 = reinterpret_cast<const float4*>(p + head);
  const float4* t4 = reinterpret_cast<const float4*>(t + head);
#pragma unroll 1
  for (long long j = gid; j < groups; j += kUnroll * stride) {
    float4 pv[kUnroll], tv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = j + u * stride;
      if (k < groups) {
        pv[u] = __ldg(p4 + k);
        tv[u] = __ldg(t4 + k);
      } else {  // counts nothing: -inf > thr and 0 > 0.5 are false
        pv[u] = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        tv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count4(pv[u], tv[u], thr, c);
  }
  for (long long i = head + groups * kVec + gid; i < hw; i += stride)
    count(__ldg(p + i), __ldg(t + i), thr, c);

  __shared__ int partial[3][kMaxThreads / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  c.tp = __reduce_add_sync(0xffffffffu, c.tp);
  c.np = __reduce_add_sync(0xffffffffu, c.np);
  c.nt = __reduce_add_sync(0xffffffffu, c.nt);
  if (lane == 0) {
    partial[0][warp] = c.tp;
    partial[1][warp] = c.np;
    partial[2][warp] = c.nt;
  }
  __syncthreads();
  if (warp != 0) return;
  const bool has = lane < static_cast<int>(blockDim.x / 32);
  c.tp = __reduce_add_sync(0xffffffffu, has ? partial[0][lane] : 0);
  c.np = __reduce_add_sync(0xffffffffu, has ? partial[1][lane] : 0);
  c.nt = __reduce_add_sync(0xffffffffu, has ? partial[2][lane] : 0);
  if (lane != 0) return;

  int* slot = workspace + b * kSlotInts;
  long long tp, np, nt;
  if (field_bits) {
    // One atomic carries the counts and the ticket: the slot's first 8
    // bytes as [ticket | tp | P | T], field_bits bits a count.  The block
    // that sees every other block's ticket in the sum it gets back has
    // every count in it too: no fence, no second read.
    u64* word = reinterpret_cast<u64*>(slot);
    const int f = field_bits;
    const u64 add = (1ull << (3 * f)) | (static_cast<u64>(c.tp) << (2 * f)) |
                    (static_cast<u64>(c.np) << f) | static_cast<u64>(c.nt);
    const u64 sum = atomicAdd(word, add) + add;
    if ((sum >> (3 * f)) != gridDim.x) return;
    *word = 0ull;
    const u64 mask = (1ull << f) - 1;
    tp = static_cast<long long>((sum >> (2 * f)) & mask);
    np = static_cast<long long>((sum >> f) & mask);
    nt = static_cast<long long>(sum & mask);
  } else {
    atomicAdd(slot + 0, c.tp);
    atomicAdd(slot + 1, c.np);
    atomicAdd(slot + 2, c.nt);
    __threadfence();
    if (atomicAdd(slot + 3, 1) != static_cast<int>(gridDim.x) - 1) return;
    // The sample's last block: every block's counts are in the slot.
    __threadfence();
    tp = atomicExch(slot + 0, 0);
    np = atomicExch(slot + 1, 0);
    nt = atomicExch(slot + 2, 0);
    slot[3] = 0;
  }
  float* row = out + b * 4;
  row[0] = static_cast<float>(tp);
  row[1] = static_cast<float>(np - tp);
  row[2] = static_cast<float>(nt - tp);
  row[3] = static_cast<float>(hw - np - nt + tp);
}

bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int bit_length(long long v) {
  int n = 0;
  for (; v > 0; v >>= 1) ++n;
  return n;
}

}  // namespace

extern "C" {

// Ints of a sample's workspace slot.
int confusion_counts_slot_ints() { return kSlotInts; }

// probs, targets: (b, hw) float32, each sample's rows contiguous, on the
// device; the plan (threads, blocks a sample, head, groups, field_bits:
// 0 for three int32 counts and a ticket a slot, else the width of each
// count in one 64-bit word with the ticket above them); out: (b, 4)
// float32, written with [tp, fp, fn, tn]; workspace: workspace_ints int32,
// zeros before the first launch (the kernel leaves them at 0), at least
// kSlotInts * b.  Launches on `stream` and returns a CUDA error code (0 on
// success; cudaErrorInvalidValue for a plan the kernel does not take).
int confusion_counts(const float* probs, const float* targets, float thr,
                     int b, long long hw, int threads, int blocks,
                     long long head, long long groups, int field_bits,
                     float* out,
                     int* workspace, long long workspace_ints,
                     void* stream) {
  const bool ok =
      b >= 1 && b <= kMaxBatch && hw >= 1 && threads >= 32 &&
      threads <= kMaxThreads && threads % 32 == 0 && blocks >= 1 &&
      blocks <= kMaxBlocks && head >= 0 && groups >= 0 &&
      head + groups * kVec <= hw &&
      workspace_ints >= static_cast<long long>(kSlotInts) * b &&
      (field_bits == 0 ||
       (field_bits > 0 && field_bits <= 21 && (1LL << field_bits) > hw &&
        3 * field_bits + bit_length(blocks) <= 64)) &&
      (groups == 0 || (aligned16(probs + head) && aligned16(targets + head) &&
                       (b == 1 || hw % kVec == 0)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  confusion_counts_kernel<<<dim3(blocks, b), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      probs, targets, thr, hw, head, groups, field_bits, workspace, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
