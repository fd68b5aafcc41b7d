// One-hot trilinear splat into one to four maps of one grid, for NVIDIA
// Hopper (sm_90a).
//
// Replaces two TPU kernels of mass_tpu/ops/pallas_splat.py with one body
// templated on the map count M:
//   splat_onehot_cmajor (_kernel + _accumulate_and_blend)
//       -> splat_onehot_launch, M = 1;
//   splat_onehot_multi_cmajor (_multi_kernel)
//       -> splat_onehot_multi_launch, M = 2..4 (one map is refused: it
//          goes through splat_onehot_launch).
// The TPU kernels walked fixed voxel-id spans in order and reduced each
// span with one-hot matmuls.  Here one frame's records arrive stable-
// sorted by voxel id (ops/splat.py:sorted_records[_multi]: ids int32
// [R], weights [R], classes [M, R]) and the kernel finds the runs of
// equal ids itself, so the host never learns their number:
//
//   W  = sum w,   S2 = sum w*w            (once, shared by the maps)
//   T_m[f] = sum w*w*[cls_m == f]         (per map)
//   row_m[f] = row_m[f] * (1 - iw_m*S2/W) + (iw_m/W) * T_m[f]
//
// Every sum runs over a voxel's records in sorted record order, with
// round-to-nearest intrinsics (no FMA contraction), no atomics and no
// tensor cores, and each touched row is read once and written once by
// one warp: the maps equal the plain PyTorch version on the CPU bit for
// bit, map m of a group equals the single-map update on its own classes,
// and two runs give the same bits.  A class outside [0, F_m) is dropped
// for map m only (its weight still counts in W and S2).
//
// Design:
// - Persistent grid: at most as many blocks as fit on the card at once
//   (SMs x resident blocks); block b walks tiles b, b + grid, ... of
//   kTile records.
// - Each tile's ids, weights and classes are staged into shared memory
//   with cp.async (16 B per thread), double-buffered: tile i + grid
//   loads while tile i is summed.  The staged ids carry the previous
//   record's id, so a run start is a compare on shared memory; warp
//   ballots and one warp's scan of their counts compact the starts in
//   record order.
// - A run is owned by the tile that holds its first record.  One warp
//   sums one run: each lane reads every record's (w, class) from shared
//   memory as a broadcast and keeps the classes lane, lane + 32, ... of
//   every map in registers.  A run that reaches the tile's end is
//   finished by its owner from global memory, 128 records per load, so
//   runs of any length are right.
// - A warp loads the rows of its next run (every map's, the F = 1
//   occupancy row included, one predicated load each) before it sums
//   the current one, so the row latency overlaps the sums; each row is
//   then written once.  Packing the F = 1 row into the idle lanes of the
//   54-class row was not needed: with the prefetch it costs one
//   predicated load and one store per run and no latency of its own.
//
// Bound: memory.  The work is a few operations per byte: per valid
// record its int32 id, weight and M classes (8 + 4M B), per touched
// voxel each map's row read and written once (2 * 4 * F_m B).  A run is
// serial by its definition (sorted-order sums), so a frame whose records
// crowd into few voxels is bounded by its longest run instead.
//
// Where the time goes (PERF.md): on a full 224x224 frame the per-record
// sums are more than half of the kernel.  Each record costs every lane
// of its warp about ten issued instructions (two shared loads, w*w, two
// adds, and a compare and a predicated add per class slot and map), the
// price of summing in record order with no atomics.  Smaller tiles, more
// threads per block, handing runs to warps through a counter, and
// staging records after a tile for the runs that cross its end all
// measured slower or no faster, and so did giving each warp the runs
// that start in its share of the tile instead of every kWarps-th run.
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
constexpr int kMaxDevices = 16;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kTile % kThreads == 0 && kBallots <= 32,
              "one warp scans the tile's ballots");

struct Maps {
  float* data[kMaxMaps];
  int features[kMaxMaps];
  float iw[kMaxMaps];
};

// words of one stage: ids (after kHalo words), weights, M class rows
__host__ __device__ constexpr int stage_words(int M) {
  return kHalo + (2 + M) * kTile;
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

template <int M>
__device__ __forceinline__ void load_tile(int* stage, int64_t tile,
                                          const int* ids,
                                          const float* weights,
                                          const int* classes, int64_t R) {
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
  }
  if (threadIdx.x == 0 && base > 0)  // the previous record's id
    cp_async4(stage + kHalo - 1, ids + base - 1);
}

// one record into the sums; lane holds class lane + 32 s of each map in
// slot s, so a class outside [0, 32 S) matches no slot
template <int M, int S>
__device__ __forceinline__ void add_record(float w, const int (&c)[M],
                                           int lane, float& w_sum,
                                           float& s2_sum, float (&t)[M][S]) {
  const float w2 = __fmul_rn(w, w);
  w_sum = __fadd_rn(w_sum, w);
  s2_sum = __fadd_rn(s2_sum, w2);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const unsigned d = (unsigned)c[m] - (unsigned)lane;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (d == 32u * s) t[m][s] = __fadd_rn(t[m][s], w2);
  }
}

// the rest of voxel v's run from record r on, read from global memory
template <int M, int S>
__device__ void sum_past_tile(int v, int64_t r, const int* ids,
                              const float* weights, const int* classes,
                              int64_t R, int lane, float& w_sum,
                              float& s2_sum, float (&t)[M][S]) {
  for (;; r += 32 * kChunks) {
    int id[kChunks], c[kChunks][M];
    float w[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int64_t x = r + 32 * q + lane;
      const bool in = x < R;
      id[q] = in ? ids[x] : -1;
      w[q] = in ? weights[x] : 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) c[q][m] = in ? classes[m * R + x] : -1;
    }
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      // ids are sorted: the run ends at the first record of another id
      const unsigned stop = __ballot_sync(kAll, id[q] != v);
      const int count = stop ? __ffs(stop) - 1 : 32;
      for (int k = 0; k < count; ++k) {
        int ck[M];
#pragma unroll
        for (int m = 0; m < M; ++m) ck[m] = __shfl_sync(kAll, c[q][m], k);
        add_record<M, S>(__shfl_sync(kAll, w[q], k), ck, lane, w_sum, s2_sum,
                         t);
      }
      if (stop) return;
    }
  }
}

template <int M, int S>
__global__ void __launch_bounds__(kThreads)
    splat_onehot_kernel(Maps maps, int V, const int* __restrict__ ids,
                        const float* __restrict__ weights,
                        const int* __restrict__ classes, int64_t R) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int starts[kTile];
  __shared__ unsigned ballots[kBallots];
  __shared__ int offsets[32];
  __shared__ int num_runs;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t num_tiles = (R + kTile - 1) / kTile;

  int64_t tile = blockIdx.x;
  if (tile < num_tiles) load_tile<M>(smem, tile, ids, weights, classes, R);
  cp_async_commit();
  for (int it = 0; tile < num_tiles; ++it, tile += gridDim.x) {
    const int* stage = smem + (it & 1) * stage_words(M);
    const int64_t next = tile + gridDim.x;
    if (next < num_tiles)
      load_tile<M>(smem + ((it + 1) & 1) * stage_words(M), next, ids,
                   weights, classes, R);
    cp_async_commit();  // an empty group keeps the count in step
    cp_async_wait_all_but_newest();
    __syncthreads();

    const int64_t base = tile * kTile;
    const int64_t left = R - base;
    const int n = left < kTile ? (int)left : kTile;
    const int* sid = stage + kHalo;  // sid[-1]: the previous record's id
    const float* sw = reinterpret_cast<const float*>(stage + kHalo + kTile);
    const int* scls = stage + kHalo + 2 * kTile;

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

    // 2. one warp per run, rows loaded one run ahead
    auto voxel_of = [&](int r) {
      if (r >= runs) return -1;
      const int v = sid[starts[r]];
      return v >= 0 && v < V ? v : -1;  // -1: none, or the discard id
    };
    auto load_rows = [&](int v, float (&row)[M][S]) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int F = maps.features[m];
        const float* src = maps.data[m] + (int64_t)v * F;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int f = lane + 32 * s;
          row[m][s] = v >= 0 && f < F ? src[f] : 0.f;
        }
      }
    };
    float row[M][S], row_next[M][S];
    int v = voxel_of(warp);
    load_rows(v, row);
    for (int r = warp; r < runs; r += kWarps) {
      const int v_next = voxel_of(r + kWarps);
      load_rows(v_next, row_next);
      if (v >= 0) {
        float w_sum = 0.f, s2_sum = 0.f, t[M][S];
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int s = 0; s < S; ++s) t[m][s] = 0.f;
        const int end = r + 1 < runs ? starts[r + 1] : n;
#pragma unroll 4
        for (int k = starts[r]; k < end; ++k) {
          int c[M];
#pragma unroll
          for (int m = 0; m < M; ++m) c[m] = scls[m * kTile + k];
          add_record<M, S>(sw[k], c, lane, w_sum, s2_sum, t);
        }
        // the tile's last run may go on past the tile
        if (end == n && base + n < R)
          sum_past_tile<M, S>(v, base + n, ids, weights, classes, R, lane,
                              w_sum, s2_sum, t);

        const float safe_w = fmaxf(w_sum, 1e-30f);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float iw = maps.iw[m];
          const int F = maps.features[m];
          const float mult =
              w_sum > 0.f
                  ? __fsub_rn(1.f, __fdiv_rn(__fmul_rn(iw, s2_sum), safe_w))
                  : 1.f;
          const float scale = __fdiv_rn(iw, safe_w);
          float* dst = maps.data[m] + (int64_t)v * F;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int f = lane + 32 * s;
            if (f < F)
              dst[f] = __fadd_rn(__fmul_rn(row[m][s], mult),
                                 __fmul_rn(scale, t[m][s]));
          }
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int s = 0; s < S; ++s) row[m][s] = row_next[m][s];
      v = v_next;
    }
    __syncthreads();  // the stage and starts are reused
  }
}

template <int M, int S>
int launch(const Maps& maps, int V, const void* ids, const void* weights,
           const void* classes, int64_t R, cudaStream_t stream) {
  const auto kernel = splat_onehot_kernel<M, S>;
  const int smem = 2 * stage_words(M) * (int)sizeof(int);
  static int grid_limit[kMaxDevices] = {};
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
      R);
  return (int)cudaGetLastError();
}

template <int M>
int launch_maps(const Maps& maps, int64_t V, const void* ids,
                const void* weights, const void* classes, int64_t R,
                void* stream) {
  int widest = 0;
  for (int m = 0; m < M; ++m) {
    if (maps.features[m] < 1 || maps.features[m] > 32 * kMaxSlots)
      return (int)cudaErrorInvalidValue;
    if (maps.features[m] > widest) widest = maps.features[m];
  }
  if (V < 0 || V > INT32_MAX || R < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((widest + 31) / 32) {
    case 1: return launch<M, 1>(maps, (int)V, ids, weights, classes, R, s);
    case 2: return launch<M, 2>(maps, (int)V, ids, weights, classes, R, s);
    case 3: return launch<M, 3>(maps, (int)V, ids, weights, classes, R, s);
    default: return launch<M, 4>(maps, (int)V, ids, weights, classes, R, s);
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
