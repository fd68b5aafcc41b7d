// Greedy non-maximum suppression for NVIDIA Hopper (sm_90a): P independent
// problems of up to N boxes each in one launch, a block per problem.
//
// Not a TPU kernel.  It replaces the lax.fori_loop of
// mass_tpu/ops/detection.py (nms), which XLA runs inside one jitted
// program: each iteration picks the highest-scoring live box, records it
// and kills every live box whose IoU with it reaches the threshold,
//
//   best   = argmax(where(alive, score, -inf))      (lowest index on ties)
//   keep_i = alive[best] ? best : -1
//   alive &= !(alive[best] && iou(best, .) >= threshold)
//
// for min(max_outputs, N) iterations, alive starting as score > -inf.
// Eager PyTorch would issue six to eight small ops an iteration: at 224^2
// the detector runs 963 RPN iterations and 64 class-aware ones a frame,
// thousands of launches.  Here the loop runs inside one block.
//
// Bound: latency, not bytes or operations.  A problem's iterations form a
// dependent chain (each pick needs the previous suppression), so the
// least time is the longest problem's iterations times one block-wide
// argmax round: the RPN's 256 iterations at roughly 0.1-0.2 us a round
// (a warp shuffle tree, one barrier, a second shuffle tree).  The bytes
// (20 B a box) are a few microseconds at most.
//
// Design: one block of up to 512 threads per problem, each thread owning
// up to two boxes (N <= 1024), its boxes' alive flags and 64-bit keys in
// registers, every box in shared memory.  A key is the score mapped to an
// unsigned order (with -0 read as +0, as a float compare does) in the
// high word and ~index in the low word, so the maximum key is the highest
// score and, among equal scores, the lowest index; a dead box has key 0.
// An iteration is a warp max by shuffles, one barrier, and every warp
// reducing the warps' maxima itself (partials double-buffered by the
// iteration's parity, so one barrier an iteration suffices).  The IoU row
// of the pick is computed on the fly, in the fp32 operation order of
// box_iou, with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (no FMA):
//
//   area  = max(x1 - x0, 0) * max(y1 - y0, 0)
//   inter = max(min(x1) - max(x0), 0) * max(min(y1) - max(y0), 0)
//   iou   = inter / max((area_a + area_b) - inter, 1e-9)
//
// A live box of zero area has IoU 0 with itself, does not suppress
// itself, and is picked again on the next iteration, as the loop does.
// When nothing is left alive, the rest of the row is -1.  The keep
// indices equal the plain PyTorch loop (ops/detection.py:
// nms_reference) exactly.
//
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPer = 2;              // boxes a thread owns
constexpr int kMaxThreads = 512;
constexpr int kMaxBoxes = kPer * kMaxThreads;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCounts = 64;       // iteration counts passed by value
constexpr unsigned kAll = 0xffffffffu;

struct Counts {
  int n[kMaxCounts];                 // problem p runs n[p % period]
};

__device__ __forceinline__ uint64_t score_key(float s, int index) {
  if (!(s > -INFINITY)) return 0;    // -inf and NaN start dead
  if (s == 0.0f) s = 0.0f;           // -0 ties with +0
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) |
         static_cast<uint64_t>(~static_cast<unsigned>(index));
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ uint64_t warp_max(uint64_t key) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const uint64_t other = __shfl_xor_sync(kAll, key, offset);
    key = other > key ? other : key;
  }
  return key;
}

__global__ void __launch_bounds__(kMaxThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           int n, int outputs, Counts counts, int period, float threshold,
           int* __restrict__ keep) {
  __shared__ float4 box_s[kMaxBoxes];
  __shared__ uint64_t partial[2][kMaxWarps];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const float4* pb = boxes + static_cast<int64_t>(p) * n;
  const float* ps = scores + static_cast<int64_t>(p) * n;
  int* out = keep + static_cast<int64_t>(p) * outputs;

  uint64_t key[kPer];
  float4 mine[kPer];
  float mine_area[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = tid + k * blockDim.x;
    key[k] = 0;
    if (j < n) {
      mine[k] = pb[j];
      mine_area[k] = area(mine[k]);
      box_s[j] = mine[k];
      key[k] = score_key(ps[j], j);
    }
  }
  for (int i = tid; i < outputs; i += blockDim.x) out[i] = -1;
  const int iterations = min(counts.n[p % period], n);
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    uint64_t best = key[0] > key[1] ? key[0] : key[1];
    best = warp_max(best);
    uint64_t* slot = partial[it & 1];
    if (lane == 0) slot[tid >> 5] = best;
    __syncthreads();
    best = warp_max(lane < warps ? slot[lane] : 0);
    if (best == 0) break;            // nothing alive: the row stays -1
    const int pick = static_cast<int>(~static_cast<unsigned>(best));
    if (tid == 0) out[it] = pick;
    const float4 b = box_s[pick];
    const float b_area = area(b);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (key[k] == 0) continue;
      const float4 a = mine[k];
      const float w = fmaxf(__fsub_rn(fminf(b.z, a.z), fmaxf(b.x, a.x)),
                            0.0f);
      const float h = fmaxf(__fsub_rn(fminf(b.w, a.w), fmaxf(b.y, a.y)),
                            0.0f);
      const float inter = __fmul_rn(w, h);
      const float uni = __fsub_rn(__fadd_rn(b_area, mine_area[k]), inter);
      const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
      if (iou >= threshold) key[k] = 0;
    }
  }
}

}  // namespace

extern "C" int nms_max_boxes() { return kMaxBoxes; }

extern "C" int nms_max_counts() { return kMaxCounts; }

// boxes [problems, n, 4] (x0, y0, x1, y1) and scores [problems, n] float32,
// contiguous; keep [problems, outputs] int32.  Problem p runs
// min(counts[p % period], n) iterations; counts is a host array.
extern "C" int nms_launch(const float* boxes, const float* scores,
                          int problems, int n, const int* counts, int period,
                          float threshold, int outputs, int* keep,
                          cudaStream_t stream) {
  if (problems < 0 || n < 1 || n > kMaxBoxes || outputs < 0 ||
      period < 1 || period > kMaxCounts)
    return static_cast<int>(cudaErrorInvalidValue);
  if (problems == 0 || outputs == 0) return static_cast<int>(cudaSuccess);
  Counts c;
  for (int k = 0; k < period; ++k) {
    if (counts[k] < 0 || counts[k] > outputs)
      return static_cast<int>(cudaErrorInvalidValue);
    c.n[k] = counts[k];
  }
  int threads = ((n + kPer - 1) / kPer + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads;
  nms_kernel<<<problems, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, n, outputs, c, period,
      threshold, keep);
  return static_cast<int>(cudaGetLastError());
}
