// One-hot trilinear splat for NVIDIA Hopper (sm_90a): one frame into one
// to four maps of one grid, or T frames into one map in frame order.
//
// Replaces the three TPU kernels of mass_tpu/ops/pallas_splat.py with one
// body templated on the map count M and a frames flag:
//   splat_onehot_cmajor (_kernel + _accumulate_and_blend)
//       -> splat_onehot_launch, M = 1;
//   splat_onehot_multi_cmajor (_multi_kernel)
//       -> splat_onehot_multi_launch, M = 2..4 (one map is refused: it
//          goes through splat_onehot_launch);
//   splat_onehot_frames_cmajor (_frames_kernel)
//       -> splat_onehot_frames_launch, M = 1, T frames in one launch.
// The TPU kernels walked fixed voxel-id spans in order and reduced each
// span with one-hot matmuls (the frames kernel streamed a span through
// VMEM once while every frame's blend applied in turn).  Here the records
// arrive stable-sorted by voxel id (ops/splat.py: sorted_records[_multi]
// for one frame, sorted_frame_records for T frames flattened frame-major,
// which adds the int32 frame of each record) and the kernel finds the
// runs of equal ids itself, so the host never learns their number:
//
//   W  = sum w,   S2 = sum w*w            (once, shared by the maps)
//   T_m[f] = sum w*w*[cls_m == f]         (per map)
//   row_m[f] = row_m[f] * (1 - iw_m*S2/W) + (iw_m/W) * T_m[f]
//
// For T frames a voxel's run keeps its records in frame order, and a
// sub-run ends where the frame changes: there the lanes blend the row in
// registers and start new sums, so the row is read once and written once
// for all T frames.  A frame that does not touch the voxel has no sub-run
// and no blend, which is what a single-map update does for it (W = 0).
//
// Every sum runs over a (sub-)run's records in sorted record order, with
// round-to-nearest intrinsics (no FMA contraction), no atomics and no
// tensor cores, and each touched row is read once and written once by
// the lanes that sum its run: the maps equal the plain PyTorch version on the CPU bit for
// bit, map m of a group equals the single-map update on its own classes,
// T frames equal T single-map updates in a row, and two runs give the
// same bits.  A class outside [0, F_m) is dropped for map m only (its
// weight still counts in W and S2).
//
// Design:
// - Persistent grid: at most as many blocks as fit on the card at once
//   (SMs x resident blocks, per instance); block b walks tiles b,
//   b + grid, ... of kTile records.
// - Each tile's ids, weights, classes (and frames) are staged into shared
//   memory with cp.async (16 B per thread), double-buffered: tile i + grid
//   loads while tile i is summed.  The staged ids carry the previous
//   record's id, so a run start is a compare on shared memory; warp
//   ballots and one warp's scan of their counts compact the starts in
//   record order.
// - A run is owned by the tile that holds its first record.  A group of
//   lanes sums one run: each lane reads every record's (w, class, frame)
//   from shared memory as a broadcast and keeps its share of every map's
//   classes in registers.  Only a tile's last run can go on past the
//   tile; a whole warp finishes it from global memory, 128 records per
//   load, frame changes included, so runs and sub-runs of any length are
//   right.
// - A group loads the rows of its next run (every map's, the F = 1
//   occupancy row included, one predicated load each) before it sums the
//   current one, so row latency overlaps the sums; each row is then
//   written once.
// - One frame: a group is the whole warp.  T frames: one group of 8
//   bench.py frames touches about 1.3M voxels with about 2.2 records
//   each, so the rows are the bytes, but row latency is not what limits:
//   three runs ahead measured no faster than one.  The per-run work (the
//   row's address, the blend's two IEEE divides, the loop) is issued once
//   per run by every lane of its group, so where F is even and the map
//   8-byte aligned, 8 lanes sum a run (16 for F > 64), each with a float2
//   of neighbouring classes in each of 4 slots, and a warp sums four runs
//   at once.  The tile's last run goes to a whole warp first, which
//   reads on past the tile 128 records per load.  F odd takes the whole
//   warp, a float per lane and slot.
//
// Bound: memory.  The work is a few operations per byte: per valid
// record its int32 id, weight, M classes and (T frames) its frame, per
// touched voxel each map's row read and written once (2 * 4 * F_m B).  A
// run is serial by its definition (sorted-order sums), so records that
// crowd into few voxels are bounded by the longest run instead.
//
// Where the time goes (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): for one
// frame the per-record sums are more than half of the kernel.  Each
// record costs every lane of its warp about ten issued instructions (two
// shared loads, w*w, two adds, and a compare and a predicated add per
// class slot and map), the price of summing in record order with no
// atomics.  Smaller tiles, more threads per block, handing runs to warps
// through a counter, and staging records after a tile for the runs that
// cross its end all measured slower or no faster for one frame, and so
// did giving each warp the runs that start in its share of the tile
// instead of every kWarps-th run.  For 8 bench.py frames (bound 0.178 ms)
// one run measured 0.467 ms with a warp per run, 0.358 ms with 16 lanes
// and 0.296 ms with 8; the kernel as built took 0.280 ms.  The per-run
// work issued sets the time, not the rows in flight: more runs ahead, or
// fewer registers for more resident blocks, measured no faster.  Records
// that crowd into few voxels stay serial per run: 8 frames of a wall
// 0.3 m ahead, runs of up to 9,430 records, take 1.9 ms.
//
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entries return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;                // records per tile
constexpr int kPasses = kTile / kThreads;  // records per thread
constexpr int kBallots = kPasses * kWarps;  // = kTile / 32
constexpr int kHalo = 4;                   // id words staged before a tile
constexpr int kMaxMaps = 4;
constexpr int kMaxSlots = 4;               // F_m <= 32 * kMaxSlots
constexpr int kChunks = 4;  // 32-record chunks per read past a tile
constexpr int kFramesSlots = 4;  // float2 slots per lane, T frames, F even
constexpr int kMaxDevices = 16;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kTile % kThreads == 0 && kBallots <= 32,
              "one warp scans the tile's ballots");

struct Maps {
  float* data[kMaxMaps];
  int features[kMaxMaps];
  float iw[kMaxMaps];
};

// words of one stage: ids (after kHalo words), weights, M class rows,
// frames
__host__ __device__ constexpr int stage_words(int M, bool frames) {
  return kHalo + (2 + M + (frames ? 1 : 0)) * kTile;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all copy groups but the newest have landed
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the next four 4-byte words, or the `count` < 4 that are left
__device__ __forceinline__ void stage4(int* dst, const void* src,
                                       int count) {
  if (count >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
  } else {
    for (int k = 0; k < count && k < 4; ++k)
      cp_async4(dst + k, static_cast<const int*>(src) + k);
  }
}

template <int M, bool FRAMES>
__device__ __forceinline__ void load_tile(int* stage, int64_t tile,
                                          const int* ids,
                                          const float* weights,
                                          const int* classes,
                                          const int* frames, int64_t R) {
  const int64_t base = tile * kTile;
  const int64_t left = R - base;
  const int n = left < kTile ? (int)left : kTile;
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
    stage4(stage + kHalo + i, ids + base + i, n - i);
    stage4(stage + kHalo + kTile + i, weights + base + i, n - i);
#pragma unroll
    for (int m = 0; m < M; ++m)
      stage4(stage + kHalo + (2 + m) * kTile + i, classes + m * R + base + i,
             n - i);
    if (FRAMES)
      stage4(stage + kHalo + (2 + M) * kTile + i, frames + base + i, n - i);
  }
  if (threadIdx.x == 0 && base > 0)  // the previous record's id
    cp_async4(stage + kHalo - 1, ids + base - 1);
}

// A run is summed by a group of G lanes (the warp, or a part of it that
// sums its own run beside the others).  Lane g of the group holds, in slot s and
// element j, class L * (g + G s) + j of each of M rows (L = 2: a float2
// of neighbouring classes).
template <int M, int S, int L>
using Rows = float[M][S][L];

// the sums of one run (one frame) or sub-run (T frames)
template <int M, int S, int L>
struct Sums {
  float w, s2, t[M][S][L];

  __device__ __forceinline__ void clear() {
    w = s2 = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int j = 0; j < L; ++j) t[m][s][j] = 0.f;
  }

  // one record; first = L * g, so a class outside [0, G L S) matches no
  // slot
  template <int G>
  __device__ __forceinline__ void add(float wr, const int (&c)[M],
                                      unsigned first) {
    const float w2 = __fmul_rn(wr, wr);
    w = __fadd_rn(w, wr);
    s2 = __fadd_rn(s2, w2);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const unsigned d = (unsigned)c[m] - first;
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int j = 0; j < L; ++j)
          if (d == (unsigned)(G * L * s + j))
            t[m][s][j] = __fadd_rn(t[m][s][j], w2);
    }
  }
};

// row_m <- row_m * (1 - iw_m S2 / W) + (iw_m / W) T_m, in registers
template <int M, int S, int L>
__device__ __forceinline__ void blend(const Maps& maps,
                                      const Sums<M, S, L>& sums,
                                      Rows<M, S, L>& row) {
  const float safe_w = fmaxf(sums.w, 1e-30f);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float iw = maps.iw[m];
    const float mult =
        sums.w > 0.f
            ? __fsub_rn(1.f, __fdiv_rn(__fmul_rn(iw, sums.s2), safe_w))
            : 1.f;
    const float scale = __fdiv_rn(iw, safe_w);
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < L; ++j)
        row[m][s][j] = __fadd_rn(__fmul_rn(row[m][s][j], mult),
                                 __fmul_rn(scale, sums.t[m][s][j]));
  }
}

// voxel v's rows (v < 0: none, zeros); g: the lane in its group
template <int M, int S, int L, int G>
__device__ __forceinline__ void load_rows(const Maps& maps, int v, int g,
                                          Rows<M, S, L>& row) {
  static_assert(L == 1 || L == 2, "one class or a float2 per slot");
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int F = maps.features[m];
    const float* src = maps.data[m] + (int64_t)v * F;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int e = g + G * s;
      const bool in = v >= 0 && L * e < F;
      if constexpr (L == 1) {
        row[m][s][0] = in ? src[e] : 0.f;
      } else {
        const float2 x = in ? reinterpret_cast<const float2*>(src)[e]
                            : make_float2(0.f, 0.f);
        row[m][s][0] = x.x;
        row[m][s][1] = x.y;
      }
    }
  }
}

template <int M, int S, int L, int G>
__device__ __forceinline__ void store_rows(const Maps& maps, int v, int g,
                                           const Rows<M, S, L>& row) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int F = maps.features[m];
    float* dst = maps.data[m] + (int64_t)v * F;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int e = g + G * s;
      if (L * e >= F) continue;
      if constexpr (L == 1)
        dst[e] = row[m][s][0];
      else
        reinterpret_cast<float2*>(dst)[e] =
            make_float2(row[m][s][0], row[m][s][1]);
    }
  }
}

// The tile's staged records and the stream they come from.
struct Tile {
  const int* sid;      // sid[-1]: the previous record's id
  const float* sw;
  const int* scls;
  const int* sfr;      // T frames only
  int64_t base;        // the tile's first record
  int n;               // its records
  const int* ids;      // the whole stream
  const float* weights;
  const int* classes;
  const int* frames;
  int64_t R;
};

// A frame change inside a run ends a sub-run: blend the row, start anew.
template <int M, int S, int L>
__device__ __forceinline__ void next_frame(const Maps& maps, int f,
                                           int& frame, Sums<M, S, L>& sums,
                                           Rows<M, S, L>& row) {
  if (f != frame) {
    blend<M, S, L>(maps, sums, row);
    sums.clear();
    frame = f;
  }
}

// The rest of voxel v's run from record r on, read by the whole warp from
// global memory, 128 records per load.
template <int M, int S, int L, bool FRAMES>
__device__ void sum_past_tile(const Maps& maps, const Tile& t, int v,
                              int64_t r, int lane, Sums<M, S, L>& sums,
                              Rows<M, S, L>& row, int& frame) {
  for (;; r += 32 * kChunks) {
    int id[kChunks], c[kChunks][M], fr[kChunks];
    float w[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int64_t x = r + 32 * q + lane;
      const bool in = x < t.R;
      id[q] = in ? t.ids[x] : -1;
      w[q] = in ? t.weights[x] : 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) c[q][m] = in ? t.classes[m * t.R + x] : -1;
      fr[q] = FRAMES && in ? t.frames[x] : 0;
    }
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      // ids are sorted: the run ends at the first record of another id
      const unsigned stop = __ballot_sync(kAll, id[q] != v);
      const int count = stop ? __ffs(stop) - 1 : 32;
      for (int k = 0; k < count; ++k) {
        if (FRAMES)
          next_frame<M, S, L>(maps, __shfl_sync(kAll, fr[q], k), frame,
                              sums, row);
        int ck[M];
#pragma unroll
        for (int m = 0; m < M; ++m) ck[m] = __shfl_sync(kAll, c[q][m], k);
        sums.template add<32>(__shfl_sync(kAll, w[q], k), ck, L * lane);
      }
      if (stop) return;
    }
  }
}

// Voxel v's run, records begin..end of the tile, summed by a group of G
// lanes (g: the lane in it) into its rows, then blended and stored.  A
// whole warp also sums what goes on past the tile.
template <int M, int S, int L, int G, bool FRAMES>
__device__ __forceinline__ void sum_run(const Maps& maps, const Tile& t,
                                        int begin, int end, int v, int g,
                                        Rows<M, S, L>& row) {
  Sums<M, S, L> sums;
  sums.clear();
  int frame = FRAMES ? t.sfr[begin] : 0;
#pragma unroll 4
  for (int k = begin; k < end; ++k) {
    if (FRAMES) next_frame<M, S, L>(maps, t.sfr[k], frame, sums, row);
    int c[M];
#pragma unroll
    for (int m = 0; m < M; ++m) c[m] = t.scls[m * kTile + k];
    sums.template add<G>(t.sw[k], c, L * g);
  }
  if constexpr (G == 32)
    if (end == t.n && t.base + t.n < t.R)
      sum_past_tile<M, S, L, FRAMES>(maps, t, v, t.base + t.n, g, sums, row,
                                     frame);
  blend<M, S, L>(maps, sums, row);
  store_rows<M, S, L, G>(maps, v, g, row);
}

template <int M, int S, int L, int G, bool FRAMES>
__global__ void __launch_bounds__(kThreads)
    splat_onehot_kernel(Maps maps, int V, const int* __restrict__ ids,
                        const float* __restrict__ weights,
                        const int* __restrict__ classes,
                        const int* __restrict__ frames, int64_t R) {
  constexpr int kStage = stage_words(M, FRAMES);
  constexpr int kGroups = kWarps * (32 / G);  // runs summed at once
  constexpr int S32 = S * G / 32;             // slots of a whole warp
  static_assert(32 % G == 0 && S * G % 32 == 0, "groups tile the warp");
  extern __shared__ __align__(16) int smem[];
  __shared__ int starts[kTile];
  __shared__ unsigned ballots[kBallots];
  __shared__ int offsets[32];
  __shared__ int num_runs;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane % G;             // lane in its group
  const int group = threadIdx.x / G;
  const int first = warp * (32 / G);  // the warp's first group
  const int64_t num_tiles = (R + kTile - 1) / kTile;

  int64_t tile = blockIdx.x;
  if (tile < num_tiles)
    load_tile<M, FRAMES>(smem, tile, ids, weights, classes, frames, R);
  cp_async_commit();
  for (int it = 0; tile < num_tiles; ++it, tile += gridDim.x) {
    const int* stage = smem + (it & 1) * kStage;
    const int64_t next = tile + gridDim.x;
    if (next < num_tiles)
      load_tile<M, FRAMES>(smem + ((it + 1) & 1) * kStage, next, ids,
                           weights, classes, frames, R);
    cp_async_commit();  // an empty group keeps the count in step
    cp_async_wait_all_but_newest();
    __syncthreads();

    const int64_t base = tile * kTile;
    const int64_t left = R - base;
    const int n = left < kTile ? (int)left : kTile;
    const Tile t = {stage + kHalo,
                    reinterpret_cast<const float*>(stage + kHalo + kTile),
                    stage + kHalo + 2 * kTile,
                    stage + kHalo + (2 + M) * kTile,
                    base, n, ids, weights, classes, frames, R};
    const int* sid = t.sid;

    // 1. run starts: a record whose id differs from the one before it
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int i = p * kThreads + threadIdx.x;
      const bool start =
          i < n && (i > 0 ? sid[i] != sid[i - 1]
                          : (base == 0 || sid[0] != sid[-1]));
      const unsigned ballot = __ballot_sync(kAll, start);
      if (lane == 0) ballots[p * kWarps + warp] = ballot;
    }
    __syncthreads();
    if (warp == 0) {
      const int count = lane < kBallots ? __popc(ballots[lane]) : 0;
      int total = count;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(kAll, total, d);
        if (lane >= d) total += x;
      }
      offsets[lane] = total - count;
      if (lane == 31) num_runs = total;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const unsigned ballot = ballots[p * kWarps + warp];
      if ((ballot >> lane) & 1u)
        starts[offsets[p * kWarps + warp] +
               __popc(ballot & ((1u << lane) - 1u))] =
            p * kThreads + threadIdx.x;
    }
    __syncthreads();
    const int runs = num_runs;
    auto voxel = [&](int r) {  // -1: the discard id or a negative id
      const int v = sid[starts[r]];
      return v >= 0 && v < V ? v : -1;
    };

    // 2. With groups smaller than a warp, the tile's last run, which may
    // go on past the tile, is summed first by the last warp as a whole;
    // the groups take the others.
    int group_runs = runs;
    if constexpr (G < 32) {
      if (runs > 0 && base + n < R) {
        group_runs = runs - 1;
        const int v = voxel(runs - 1);
        if (warp == kWarps - 1 && v >= 0) {
          float row[M][S32][L];
          load_rows<M, S32, L, 32>(maps, v, lane, row);
          sum_run<M, S32, L, 32, FRAMES>(maps, t, starts[runs - 1], n, v,
                                         lane, row);
        }
      }
    }

    // 3. one group per run, every kGroups-th run, the rows of the next in
    // flight: a ring of two row buffers and their voxels, indexed by
    // constants once unrolled (no register move waits on a row in flight);
    // the loop bounds are the warp's, so its groups stay in step
    auto voxel_of = [&](int r) { return r < group_runs ? voxel(r) : -1; };
    auto run_end = [&](int r) { return r + 1 < runs ? starts[r + 1] : n; };
    float rows[2][M][S][L];
    int voxels[2];
    voxels[0] = voxel_of(group);
    load_rows<M, S, L, G>(maps, voxels[0], g, rows[0]);
    for (int r0 = first; r0 < group_runs; r0 += 2 * kGroups) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = r0 + (group - first) + k * kGroups;
        voxels[k ^ 1] = voxel_of(r + kGroups);
        load_rows<M, S, L, G>(maps, voxels[k ^ 1], g, rows[k ^ 1]);
        if (voxels[k] >= 0)
          sum_run<M, S, L, G, FRAMES>(maps, t, starts[r], run_end(r),
                                      voxels[k], g, rows[k]);
      }
    }
    __syncthreads();  // the stage and starts are reused
  }
}

template <int M, int S, int L, int G, bool FRAMES>
int launch(const Maps& maps, int V, const void* ids, const void* weights,
           const void* classes, const void* frames, int64_t R,
           cudaStream_t stream) {
  const auto kernel = splat_onehot_kernel<M, S, L, G, FRAMES>;
  const int smem = 2 * stage_words(M, FRAMES) * (int)sizeof(int);
  static int grid_limit[kMaxDevices] = {};  // one table per instance
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int limit = device < kMaxDevices ? grid_limit[device] : 0;
  if (limit == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    limit = sms * (per_sm > 0 ? per_sm : 1);
    if (device < kMaxDevices) grid_limit[device] = limit;
  }
  const int64_t tiles = (R + kTile - 1) / kTile;
  const int grid = tiles < 1 ? 1 : tiles < limit ? (int)tiles : limit;
  kernel<<<grid, kThreads, smem, stream>>>(
      maps, V, (const int*)ids, (const float*)weights, (const int*)classes,
      (const int*)frames, R);
  return (int)cudaGetLastError();
}

bool valid_sizes(const Maps& maps, int num_maps, int64_t V, int64_t R) {
  for (int m = 0; m < num_maps; ++m)
    if (maps.features[m] < 1 || maps.features[m] > 32 * kMaxSlots)
      return false;
  return V >= 0 && V <= INT32_MAX && R >= 0;
}

template <int M>
int launch_maps(const Maps& maps, int64_t V, const void* ids,
                const void* weights, const void* classes, int64_t R,
                void* stream) {
  if (!valid_sizes(maps, M, V, R)) return (int)cudaErrorInvalidValue;
  int widest = 0;
  for (int m = 0; m < M; ++m)
    if (maps.features[m] > widest) widest = maps.features[m];
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((widest + 31) / 32) {
    case 1:
      return launch<M, 1, 1, 32, false>(maps, (int)V, ids, weights, classes,
                                    nullptr, R, s);
    case 2:
      return launch<M, 2, 1, 32, false>(maps, (int)V, ids, weights, classes,
                                    nullptr, R, s);
    case 3:
      return launch<M, 3, 1, 32, false>(maps, (int)V, ids, weights, classes,
                                    nullptr, R, s);
    default:
      return launch<M, 4, 1, 32, false>(maps, (int)V, ids, weights, classes,
                                    nullptr, R, s);
  }
}

}  // namespace

extern "C" int splat_onehot_max_features() { return 32 * kMaxSlots; }

extern "C" int splat_onehot_tile() { return kTile; }

extern "C" int splat_onehot_launch(void* data, int F, int64_t V,
                                   const void* ids, const void* weights,
                                   const void* classes, int64_t R, float iw,
                                   void* stream) {
  Maps maps = {};
  maps.data[0] = (float*)data;
  maps.features[0] = F;
  maps.iw[0] = iw;
  return launch_maps<1>(maps, V, ids, weights, classes, R, stream);
}

extern "C" int splat_onehot_multi_launch(int num_maps, void* const* datas,
                                         const int* features,
                                         const float* iws, int64_t V,
                                         const void* ids, const void* weights,
                                         const void* classes, int64_t R,
                                         void* stream) {
  if (num_maps < 2 || num_maps > kMaxMaps) return (int)cudaErrorInvalidValue;
  Maps maps = {};
  for (int m = 0; m < num_maps; ++m) {
    maps.data[m] = (float*)datas[m];
    maps.features[m] = features[m];
    maps.iw[m] = iws[m];
  }
  switch (num_maps) {
    case 2: return launch_maps<2>(maps, V, ids, weights, classes, R, stream);
    case 3: return launch_maps<3>(maps, V, ids, weights, classes, R, stream);
    default: return launch_maps<4>(maps, V, ids, weights, classes, R, stream);
  }
}

extern "C" int splat_onehot_frames_launch(void* data, int F, int64_t V,
                                          const void* ids,
                                          const void* weights,
                                          const void* classes,
                                          const void* frames, int64_t R,
                                          float iw, void* stream) {
  Maps maps = {};
  maps.data[0] = (float*)data;
  maps.features[0] = F;
  maps.iw[0] = iw;
  if (!valid_sizes(maps, 1, V, R)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int v = (int)V;
  constexpr int S = kFramesSlots;
  if (F % 2 == 0 && (reinterpret_cast<uintptr_t>(data) & 7) == 0) {
    // every row 8-byte aligned: a float2 per lane and slot, 8 lanes for
    // up to 64 classes, 16 for up to 128
    if (F <= 2 * S * 8)
      return launch<1, S, 2, 8, true>(maps, v, ids, weights, classes, frames,
                                      R, s);
    return launch<1, S, 2, 16, true>(maps, v, ids, weights, classes, frames,
                                     R, s);
  }
  return launch<1, kMaxSlots, 1, 32, true>(maps, v, ids, weights, classes,
                                           frames, R, s);
}
