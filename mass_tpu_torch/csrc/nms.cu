// Greedy non-maximum suppression for NVIDIA Hopper (sm_90a): P independent
// problems of up to N boxes each in one launch, a thread-block cluster per
// problem.
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
//
// The loop as a scan.  Give every live box a key: the score mapped to an
// unsigned order (-0 read as +0, as a float compare does) over ~index,
// so the largest key is the highest score and, among equal scores, the
// lowest index.  The keys never change
// and the alive set only shrinks, so each iteration's pick is the first
// alive box in key order, and it can only kill boxes after it.  With the
// live boxes at their sorted positions 0..L-1 and the bit (r, c), r <= c,
// set where iou(box r, box c) >= threshold (the pick first), the loop is
// a walk along the positions: take the first position not yet removed,
// record it, OR its row into the removed set.  A taken box whose own bit
// is clear (zero area: IoU 0 with itself; a NaN IoU) stays the first
// free position and is taken again at every step, as the loop picks it
// again.  When no position is left, the rest of the row is -1.  The keep
// indices equal the plain PyTorch loop (ops/detection.py: nms_reference)
// exactly.
//
// Bound.  The bytes (20 B a box, 4 B a slot) and the fp32 operations of
// the live pairs (L(L+1)/2 IoU tests of about 14 operations) are both
// under a microsecond at the detector's shapes.  What cannot be made
// parallel is the greedy chain: each taken box waits on the boxes taken
// before it, at least one dependent integer operation each (a taken box
// must be known before the next free position is).  The kernel's time
// goes to latency around that: the cluster's barriers, the loads of the
// rank and row phases, a shared-memory load and 32 register steps for
// every word of 32 positions the walk crosses.
//
// Design: a cluster of kCluster blocks per problem (cudaLaunchKernelEx
// with a cluster dimension), kThreads threads a block.
//   1. Every block reads all N scores and boxes (one load each, all in
//      flight together) and forms the keys' high words, the score's
//      order bits; dead boxes (score -inf or NaN) get 0 and no position,
//      so padding costs nothing.  Each live box j is ranked by one warp
//      of the cluster, its lanes counting the boxes i with a larger
//      score, or an equal one and i < j, and __reduce_add_sync adding
//      them; the leader gets j at that position over distributed shared
//      memory.  Cluster barrier; every block gathers the boxes in sorted
//      order from the leader's index.
//   2. Each sorted row r goes to one warp of the cluster (in a snake
//      order that evens out the rows' lengths): lane l of a pass computes
//      the bits (r, 32w + l) and (r, 32w + 32 + l), two ballots make
//      words w and w + 1 (position 32w + b at bit 31 - b); lane w keeps
//      its word, and the row's words (0 left of the diagonal) go to the
//      leader's shared memory in one store.  The IoU's parts keep
//      box_iou's fp32 operation order with __fmul_rn / __fadd_rn /
//      __fsub_rn (no FMA), the areas computed once a box:
//
//        area  = max(x1 - x0, 0) * max(y1 - y0, 0)
//        inter = max(min(x1) - max(x0), 0) * max(min(y1) - max(y0), 0)
//        iou   = inter / max((area_a + area_b) - inter, 1e-9)
//
//      and the test iou >= threshold is decided exactly without the
//      division (Threshold, below).  A pass has no branch: columns past
//      L read the last box and are masked.  Cluster barrier.  N = 1024
//      takes 128 KB of rows (dynamic shared memory, allowed with
//      cudaFuncSetAttribute above 48 KB).
//   3. One warp of the leader walks 32 positions at a time: lane w holds
//      word w of the removed set (N <= 1024: 32 words).  For word w, lane
//      b loads word w of row 32w + b (the rows' own word), and the greedy
//      loop runs over the 32 positions in registers, each row word
//      broadcast by a shuffle that does not wait on the loop: a position
//      not yet removed is taken and ORs its word in, a predicated step of
//      two integer operations.  A taken box its own row leaves free
//      stops the walk and fills the rest to the cap.  Then each lane ORs
//      word w' > w of every taken row into its word, 32 predicated loads
//      that do not wait on each other.  The taken positions become box
//      indices in one coalesced pass at the end.
//
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry returns the error of the launch (a refused
// cluster or shared-memory size included).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;          // blocks a problem (portable size)
constexpr int kMaxBoxes = 2 * kThreads;
constexpr int kMaxCounts = 64;       // output caps passed by value
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kStaticSharedLimit = 48 * 1024;
static_assert(kMaxBoxes <= 32 * 32, "the walk keeps a word a lane");

struct Counts {
  int n[kMaxCounts];                 // problem p takes n[p % period]
};

// dynamic shared memory of one block for n boxes: the boxes sorted and in
// index order, the sorted boxes' areas, the keys, the sorted order and the
// suppression rows (n rows of ceil(n/32) words; only the leader's are
// filled)
__host__ __device__ inline size_t shared_bytes(int n) {
  const size_t words = (n + 31) / 32;
  return static_cast<size_t>(n) * (2 * sizeof(float4) + sizeof(float) +
                                   sizeof(uint32_t) + sizeof(int) +
                                   words * sizeof(uint32_t));
}

// the score's bits in an unsigned order (-0 read as +0), at least
// 0x00800000 for a live box; 0 for a dead one (-inf or NaN)
__device__ __forceinline__ uint32_t score_order(float s) {
  if (!(s > -INFINITY)) return 0;
  if (s == 0.0f) s = 0.0f;
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// The IoU test without the division.  The float quotient q =
// __fdiv_rn(inter, d) rounds the real inter / d to nearest, a monotone
// map, so q >= t > 0 exactly when inter / d lies above m, the midpoint
// between t and the float below it, or on m where a tie rounds to t (its
// last significand bit even).  m needs 25 significant bits and d has 24,
// so m * d is exact in double, and comparing inter with it decides the
// test for every inter >= 0 and d >= 1e-9 (a tie needs a denormal t).
// Every q reaches t <= 0 (m = -inf); none reaches a NaN t (m = NaN).
struct Threshold {
  double midpoint;
  int ties_reach;
};

Threshold threshold_midpoint(float t) {
  if (isnan(t)) return {NAN, 0};
  if (t <= 0.0f) return {-INFINITY, 1};
  const double above = isinf(t) ? ldexp(1.0, 128) : static_cast<double>(t);
  uint32_t bits;
  memcpy(&bits, &t, sizeof(bits));
  return {0.5 * (static_cast<double>(nextafterf(t, 0.0f)) + above),
          (bits & 1u) == 0};
}

// iou(b, a) >= threshold, b the pick
__device__ __forceinline__ bool suppresses(float4 b, float b_area, float4 a,
                                           float a_area, Threshold t) {
  const float w = fmaxf(__fsub_rn(fminf(b.z, a.z), fmaxf(b.x, a.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(b.w, a.w), fmaxf(b.y, a.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(b_area, a_area), inter);
  const double num = inter;
  const double product =
      __dmul_rn(t.midpoint, static_cast<double>(fmaxf(uni, 1e-9f)));
  return (num > product) | ((num == product) & (t.ties_reach != 0));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           int n, int outputs, Counts counts, int period, Threshold threshold,
           int* __restrict__ keep) {
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int block = static_cast<int>(cluster.block_rank());
  const int p = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = (n + 31) >> 5;
  float4* box_s = smem;              // sorted
  float4* raw_s = box_s + n;         // in index order
  float* area_s = reinterpret_cast<float*>(raw_s + n);   // sorted
  uint32_t* key_s = reinterpret_cast<uint32_t*>(area_s + n);
  int* order_s = reinterpret_cast<int*>(key_s + n);
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(order_s + n);
  const float4* pb = boxes + static_cast<int64_t>(p) * n;
  const float* ps = scores + static_cast<int64_t>(p) * n;

  // every block of the cluster must be running before another writes
  // into its shared memory: arrive now, wait once the keys are formed
  cluster_arrive();
  int live = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = tid + k * kThreads;
    const uint32_t key = j < n ? score_order(ps[j]) : 0;
    if (j < n) {
      key_s[j] = key;
      raw_s[j] = pb[j];
    }
    live += __syncthreads_count(key != 0);
  }
  cluster_wait();

  // 1. rank: a warp per live box, its position the count of larger keys;
  // the leader gets the sorted order, every block gathers its boxes
  const int cluster_warp = block * kWarps + warp;
  constexpr int kClusterWarps = kCluster * kWarps;
  int* leader_order = cluster.map_shared_rank(order_s, 0);
  for (int j = cluster_warp; j < n; j += kClusterWarps) {
    const uint32_t kj = key_s[j];
    if (kj == 0) continue;           // dead: no position
    int larger = 0;
    for (int i = lane; i < n; i += 32) {
      const uint32_t ki = key_s[i];
      larger += (ki > kj) | ((ki == kj) & (i < j));
    }
    const int pos = __reduce_add_sync(kAll, larger);
    if (lane == 0) leader_order[pos] = j;
  }
  cluster.sync();
  for (int c = tid; c < live; c += kThreads) {
    const float4 b = raw_s[leader_order[c]];
    box_s[c] = b;
    area_s[c] = area(b);
  }
  __syncthreads();

  // 2. suppression rows: a warp per sorted row, into the leader's memory;
  // position 32w + b is bit 31 - b of word w.  Row r has words r / 32 to
  // the last, so the warps take rows in a snake order (g, 2G - 1 - g, 2G
  // + g, ...) that gives each about as many words; two words a pass keep
  // two independent chains in flight.
  const int live_words = (live + 31) >> 5;
  uint32_t* leader_rows = cluster.map_shared_rank(rows_s, 0);
  for (int k = 0;; ++k) {
    const int r = (k & 1) ? (k + 1) * kClusterWarps - 1 - cluster_warp
                          : k * kClusterWarps + cluster_warp;
    if (r >= live) break;
    const float4 b = box_s[r];
    const float b_area = area_s[r];
    uint32_t mine = 0;
    for (int w = r >> 5; w < live_words; w += 2) {
      const int c0 = (w << 5) + lane;
      const int c1 = c0 + 32;
      const int a0 = min(c0, live - 1);
      const int a1 = min(c1, live - 1);
      const bool bit0 = (c0 < live) & suppresses(b, b_area, box_s[a0],
                                                 area_s[a0], threshold);
      const bool bit1 = (c1 < live) & suppresses(b, b_area, box_s[a1],
                                                 area_s[a1], threshold);
      const uint32_t word0 = __brev(__ballot_sync(kAll, bit0));
      const uint32_t word1 = __brev(__ballot_sync(kAll, bit1));
      if (lane == w) mine = word0;
      if (lane == w + 1) mine = word1;
    }
    if (lane < live_words) leader_rows[r * words + lane] = mine;
  }
  cluster.sync();
  if (block != 0 || warp != 0) return;

  // 3. the walk, a word of 32 positions at a time: lane w holds word w
  // of the removed positions; the taken positions go to shared memory
  // (over the keys) and become box indices at the end
  const int cap = min(counts.n[p % period], n);
  uint32_t removed = kAll;           // past the live positions
  if (lane < live_words) {
    const int left = live - (lane << 5);
    removed = left >= 32 ? 0u : kAll >> left;
  }
  uint32_t* taken_s = key_s;
  const uint32_t lane_bit = 0x80000000u >> lane;
  int slot = 0;
  int stuck = -1;
  for (int wi = 0; wi < live_words && slot < cap; ++wi) {
    // lane b holds word wi of row 32 wi + b, the rows' own word
    const int own = (wi << 5) + lane;
    const uint32_t diagonal = own < live ? rows_s[own * words + wi] : 0u;
    const uint32_t frees_itself = __brev(__ballot_sync(
        kAll, own < live && !(diagonal & lane_bit)));
    // the greedy loop over the word's positions in registers: a free
    // position is taken and its row's word removes the ones it kills
    uint32_t cur = __shfl_sync(kAll, removed, wi);
    uint32_t taken = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t row = __shfl_sync(kAll, diagonal, b);
      const uint32_t bit = 0x80000000u >> b;
      if (!(cur & bit)) {
        cur |= row;
        taken |= bit;
      }
    }
    // a box its own IoU does not suppress (zero area) stays the first
    // free position, and the loop takes it again to the cap
    const uint32_t stuck_bits = taken & frees_itself;
    if (stuck_bits) taken &= kAll << (31 - __clz(stuck_bits));
    int count = __popc(taken);
    while (count > cap - slot) {
      taken &= taken - 1;            // the word's last taken position
      --count;
    }
    if (stuck_bits && (taken & stuck_bits))
      stuck = (wi << 5) + __clz(stuck_bits);
    if (taken & lane_bit)
      taken_s[slot + __popc(taken & ~(kAll >> lane))] = own;
    slot += count;
    if (stuck >= 0) break;
    // the taken rows' later words join the removed set: 32 loads that do
    // not wait on each other
    if (lane > wi && lane < live_words) {
      const uint32_t* column = rows_s + (wi << 5) * words + lane;
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if (taken & (0x80000000u >> b)) removed |= column[b * words];
    }
  }
  if (stuck >= 0) {
    for (int k = slot + lane; k < cap; k += 32) taken_s[k] = stuck;
    slot = cap;
  }
  __syncwarp();
  int* out = keep + static_cast<int64_t>(p) * outputs;
  for (int s = lane; s < outputs; s += 32)
    out[s] = s < slot ? order_s[taken_s[s]] : -1;
}

// one warp's dependent chains: a cycle through shared memory, a load a
// step, then logic operations, each on the last one's result
__global__ void step_probe_kernel(int steps, long long* __restrict__ out) {
  __shared__ int next[1024];
  for (int i = threadIdx.x; i < 1024; i += 32) next[i] = (i * 37 + 11) & 1023;
  __syncwarp();
  int x = 0;
  unsigned long long t0, t1, t2;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  for (int s = 0; s < steps; ++s) x = next[x];
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  uint32_t y = static_cast<uint32_t>(x);
  for (int s = 0; s < steps; ++s)
    asm volatile("lop3.b32 %0, %0, %1, %2, 0x1e;" : "+r"(y) : "r"(s), "r"(x));
  const long long c2 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t2));
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = static_cast<long long>(t1 - t0);
    out[2] = c2 - c1;
    out[3] = static_cast<long long>(t2 - t1);
    out[4] = x + y;
  }
}

cudaLaunchConfig_t launch_config(int problems, int n, cudaStream_t stream,
                                 cudaLaunchAttribute* attribute) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(problems * kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = shared_bytes(n);
  config.stream = stream;
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = kCluster;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

// the kernel's dynamic shared memory limit raised to what n boxes take
cudaError_t allow_shared(int n) {
  const size_t bytes = shared_bytes(n);
  if (bytes <= kStaticSharedLimit) return cudaSuccess;
  return cudaFuncSetAttribute(nms_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int nms_max_boxes() { return kMaxBoxes; }

extern "C" int nms_max_counts() { return kMaxCounts; }

// boxes [problems, n, 4] (x0, y0, x1, y1) and scores [problems, n] float32,
// contiguous, boxes 16-byte aligned; keep [problems, outputs] int32.
// Problem p fills min(counts[p % period], n) slots; counts is a host
// array.
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
  cudaError_t err = allow_shared(n);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config =
      launch_config(problems, n, stream, &attribute);
  err = cudaLaunchKernelEx(&config, nms_kernel,
                           reinterpret_cast<const float4*>(boxes), scores, n,
                           outputs, c, period, threshold_midpoint(threshold),
                           keep);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The built kernel's shape for n boxes: threads a block, blocks a
// cluster, registers and spilled bytes a thread, dynamic shared memory a
// block, and clusters of it that can be resident at once.
extern "C" int nms_config(int n, int* out) {
  if (n < 1 || n > kMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attributes;
  cudaError_t err = cudaFuncGetAttributes(&attributes, nms_kernel);
  if (err == cudaSuccess) err = allow_shared(n);
  int clusters = 0;
  if (err == cudaSuccess) {
    cudaLaunchAttribute attribute;
    const cudaLaunchConfig_t config = launch_config(1, n, 0, &attribute);
    err = cudaOccupancyMaxActiveClusters(&clusters, nms_kernel, &config);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = kCluster;
  out[2] = attributes.numRegs;
  out[3] = static_cast<int>(attributes.localSizeBytes);
  out[4] = static_cast<int>(shared_bytes(n));
  out[5] = clusters;
  return static_cast<int>(cudaSuccess);
}

// One warp's chains of `steps` dependent shared-memory loads and of as
// many dependent logic operations: out (5 int64 on the device) gets the
// SM cycles and nanoseconds of each, and a value that keeps them live.
extern "C" int nms_step_probe(int steps, long long* out,
                              cudaStream_t stream) {
  step_probe_kernel<<<1, 32, 0, stream>>>(steps, out);
  return static_cast<int>(cudaGetLastError());
}
