// Dense-row trilinear splat for NVIDIA Hopper (sm_90a): one frame's (or
// one fleet tick's) corner records of dense per-pixel features into one
// voxel-major [V, F] map, in place.
//
// Not a TPU kernel.  It replaces XLA's scatter in mass_tpu/ops/scatter.py
// (apply_dense_rows with _blend_fields), which VoxelMap.update
// (mass_tpu/core/voxelmap.py) runs for the FeatureMap and ClipMap layers
// and FleetMaps.update_dense for the fleet's feature slabs.  JAX computes
//
//   W_v  = sum w,   S2_v = sum w*w          over the records of voxel v
//   mult_v  = 1 - iw*S2_v/W_v               where W_v > 0, else 1
//   scale_p = iw*w_p*w_p / W_v
//   row_v   = row_v*mult_v + sum_p scale_p * feat[pixel_p]
//
// as a multiply of the whole map plus a row scatter-add.  Neither plain
// PyTorch form serves: the multiply reads and writes every row (13.5 GiB
// at 384x384x96x256) to change a few thousand, and index_add_ sums with
// float atomics on CUDA, whose order changes from run to run.
//
// The records arrive stable-sorted by voxel id (ops/splat.py:
// sorted_dense_records), each with its weight and its pixel (order % n for
// one frame, order % (B*n) for a fleet), so a voxel's records keep their
// original order, which is the order XLA's scatter adds them in.  The
// discard id V (invalid pixels), and any id outside [0, V), is skipped.
//
// Bound: memory.  Per valid record its int32 id, weight and int32 pixel
// (12 B); each pixel's feature row read once (4F B); each touched row
// read and written once (2 * 4F B).  A full-width room frame (224x224
// camera at stride 4: 3,136 pixels, 25,088 records on 15,565 voxels of
// 256 features) is 35.4 MB, 10.6 us at 3.35 TB/s.  What the bound hides:
// every row is a chain of dependent loads (the ids, then the row and the
// records' feature rows, then the fold), so the card must keep megabytes
// in flight, and a record reads its pixel's whole feature row (eight
// records a pixel: 25.7 MB of gathers a frame, mostly from L2), which
// paces a run of a hundred records (a camera against a wall).
//
// Design: a warp per (window of 32 records, slice of 128 channels).
// - Lane j holds records base + j and base + 32 + j (id, weight, pixel:
//   coalesced loads, indices clamped so that they need no branch) and
//   four channels of every row the warp touches (one float4; one float
//   where F % 4 != 0 or a pointer is not 16-byte aligned).  A 256-wide
//   frame of 25,088 records is 1,568 warps, all resident at once.
// - The warp owns the runs of equal ids that start in its window (ballots
//   find starts and ends; no host sync between the sort and the launch).
//   It takes them kStep records at a time: the step's row lines (where a
//   run starts) and feature lines are requested together, 16 float4 a
//   lane in flight, then folded.  The first step's lines fly while the
//   sums run.  Every such load is a predicated load into zeroed registers
//   (Vec::row, Vec::feature): a select after a load made the next load
//   wait for it, one round trip a line.
// - W and S2 are summed in record order: lane j reads record k's weight
//   by shuffle, each lane keeps its own run's sums.  The window's last run
//   may go on past it (its tail): the next 32 records are already in the
//   registers, then its ids and weights come 128 records a load.  The
//   tail is folded after the window, 16 feature lines a load.
// - The fold is in record order, four channels a lane:
//   row = row*mult, then + scale*feature for each record, then one store.
//   Arithmetic is __fmul_rn / __fadd_rn / __fdiv_rn / __fsub_rn: no FMA
//   contraction, no atomics, no tensor cores.  The map equals the plain
//   PyTorch version on the CPU (splat_dense_reference) bit for bit, and
//   two runs give the same bits.
//
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 32;   // records a warp owns runs in (a lane each)
constexpr int kStep = 8;      // window records whose lines one load brings
constexpr int kTailStep = 16;  // tail records whose features one load brings
constexpr int kAhead = 4;     // chunks of 32 records one tail load spans
constexpr int kMaxFeatures = 1024;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ bool bit(unsigned mask, int k) {
  return (mask >> k) & 1u;
}

// a lane's channels of one row: four floats, or one where F % 4 != 0 or
// a pointer is not 16-byte aligned.  feature() and row() load a line
// where ``p`` holds, else give zeros, as one predicated load into
// registers that already hold the zeros: a select after the load would
// make the next load wait for this one's data, and a step's loads must
// all be in flight together.  Feature lines are read-only and reread
// (ld.global.nc), row lines are read once (ld.global.cg, L2 only).
template <int kVec>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T feature(bool p, const T* src) {
    T d = zero();
    asm("{\n.reg .pred q;\nsetp.ne.b32 q, %4, 0;\n"
        "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%5];\n}\n"
        : "+f"(d.x), "+f"(d.y), "+f"(d.z), "+f"(d.w)
        : "r"(static_cast<int>(p)), "l"(src));
    return d;
  }
  __device__ static T row(bool p, const T* src) {
    T d = zero();
    asm("{\n.reg .pred q;\nsetp.ne.b32 q, %4, 0;\n"
        "@q ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%5];\n}\n"
        : "+f"(d.x), "+f"(d.y), "+f"(d.z), "+f"(d.w)
        : "r"(static_cast<int>(p)), "l"(src));
    return d;
  }
  __device__ static T mul(T a, float m) {
    return make_float4(__fmul_rn(a.x, m), __fmul_rn(a.y, m),
                       __fmul_rn(a.z, m), __fmul_rn(a.w, m));
  }
  // acc + s * f, channel by channel, rounded after each operation
  __device__ static T fold(T acc, float s, T f) {
    return make_float4(__fadd_rn(acc.x, __fmul_rn(s, f.x)),
                       __fadd_rn(acc.y, __fmul_rn(s, f.y)),
                       __fadd_rn(acc.z, __fmul_rn(s, f.z)),
                       __fadd_rn(acc.w, __fmul_rn(s, f.w)));
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T feature(bool p, const T* src) {
    T d = 0.f;
    asm("{\n.reg .pred q;\nsetp.ne.b32 q, %1, 0;\n"
        "@q ld.global.nc.f32 %0, [%2];\n}\n"
        : "+f"(d)
        : "r"(static_cast<int>(p)), "l"(src));
    return d;
  }
  __device__ static T row(bool p, const T* src) {
    T d = 0.f;
    asm("{\n.reg .pred q;\nsetp.ne.b32 q, %1, 0;\n"
        "@q ld.global.cg.f32 %0, [%2];\n}\n"
        : "+f"(d)
        : "r"(static_cast<int>(p)), "l"(src));
    return d;
  }
  __device__ static T mul(T a, float m) { return __fmul_rn(a, m); }
  __device__ static T fold(T acc, float s, T f) {
    return __fadd_rn(acc, __fmul_rn(s, f));
  }
};

// Folds the tail records [off, end) (at most kChunks * 32 of them) into
// ``acc`` in order, kTailStep feature lines a load; lane j of chunk q
// holds record off + 32q + j's pixel ``qp[q]`` and scale ``qs[q]``.
template <int kVec, int kChunks>
__device__ __forceinline__ void fold_tail(typename Vec<kVec>::T& acc,
                                          const int (&qp)[kChunks],
                                          const float (&qs)[kChunks],
                                          int64_t off, int64_t end,
                                          const typename Vec<kVec>::T* fvec,
                                          int width, int v, bool has_v) {
  using V = Vec<kVec>;
  using T = typename V::T;
#pragma unroll
  for (int h = 0; h < kChunks * 32 / kTailStep; ++h) {
    const int64_t at = off + h * kTailStep;
    if (at >= end) break;
    T feat[kTailStep];
#pragma unroll
    for (int u = 0; u < kTailStep; ++u) {
      const int r = h * kTailStep + u;
      const int pk = __shfl_sync(kAll, qp[r / 32], r % 32);
      feat[u] = V::feature(has_v && at + u < end,
                           fvec + static_cast<size_t>(pk) * width + v);
    }
#pragma unroll
    for (int u = 0; u < kTailStep; ++u) {
      const int r = h * kTailStep + u;
      const float sk = __shfl_sync(kAll, qs[r / 32], r % 32);
      if (at + u < end) acc = V::fold(acc, sk, feat[u]);
    }
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    splat_dense_kernel(float* __restrict__ data, int features,
                       int64_t voxels, const int* __restrict__ ids,
                       const float* __restrict__ weights,
                       const int* __restrict__ pixels,
                       const float* __restrict__ feats, int64_t records,
                       float iw) {
  using V = Vec<kVec>;
  using T = typename V::T;
  const int lane = threadIdx.x & 31;
  const int width = features / kVec;  // vectors a row
  const int slices = (width + 31) / 32;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t base = warp / slices * kWindow;
  if (base >= records) return;  // the whole warp leaves together
  const int v = static_cast<int>(warp % slices) * 32 + lane;
  const bool has_v = v < width;
  T* const rows = reinterpret_cast<T*>(data);
  const T* const fvec = reinterpret_cast<const T*>(feats);

  // the window's records and the next 32, a lane each, and the id
  // before (indices clamped, so the loads need no branch and fly together)
  const int64_t i = base + lane, i2 = i + kWindow;
  const bool in = i < records, in2 = i2 < records;
  const int64_t ic = in ? i : records - 1, i2c = in2 ? i2 : records - 1;
  const int id_at = ids[ic], id2_at = ids[i2c], pix_at = pixels[ic],
            pix2_at = pixels[i2c], before = ids[base > 0 ? base - 1 : 0];
  const float w_at = weights[ic], w2_at = weights[i2c];
  const int id = in ? id_at : 0, id2 = in2 ? id2_at : 0;
  const int pix = in ? pix_at : 0, pix2 = in2 ? pix2_at : 0;
  const float w = in ? w_at : 0.f, w2 = in2 ? w2_at : 0.f;
  int prev = __shfl_up_sync(kAll, id, 1);
  int next = __shfl_down_sync(kAll, id, 1);
  const int after = __shfl_sync(kAll, id2, 0);
  if (lane == 0) prev = base > 0 ? before : 0;
  if (lane == 31) next = after;
  const bool first = in && (i == 0 || prev != id);
  const bool last = in && (i + 1 == records || next != id);
  const unsigned starts = __ballot_sync(kAll, first);
  const unsigned ends = __ballot_sync(kAll, last);
  // a record is ours when its id is a voxel and its run starts here
  const bool valid = in && id >= 0 && id < voxels;
  const unsigned owned = __ballot_sync(
      kAll, valid && (starts & ((2u << lane) - 1u)) != 0);
  if (!owned) return;
  const bool tail = bit(owned, 31) && !bit(ends, 31);
  const int lo = __ffs(owned) - 1, hi = 31 - __clz(owned);

  // the fold takes the window kStep records at a time: the step's row
  // lines (where a run starts) and feature lines are requested together,
  // then folded in record order; a run's row is stored where it ends
  T row[kStep], feat[kStep];
  auto request = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      const int k = (k0 + u) & 31;
      const int idk = __shfl_sync(kAll, id, k);
      const int pk = __shfl_sync(kAll, pix, k);
      const bool use = has_v && k0 + u <= hi && bit(owned, k);
      row[u] = V::row(use && bit(starts, k),
                      rows + static_cast<size_t>(idk) * width + v);
      feat[u] = V::feature(use, fvec + static_cast<size_t>(pk) * width + v);
    }
  };
  request(lo);  // the first step's lines fly while the sums run

  // W and S2 of each run in record order; a lane keeps its own run's
  // (its run ends at the first end at or after it, kWindow: the tail)
  const unsigned ends_from = ends & ~((1u << lane) - 1u);
  const int my_end = ends_from ? __ffs(ends_from) - 1 : kWindow;
  float run_w = 0.f, run_s2 = 0.f, my_w = 0.f, my_s2 = 0.f;
  auto sum = [&](float wk) {
    run_w = __fadd_rn(run_w, wk);
    run_s2 = __fadd_rn(run_s2, __fmul_rn(wk, wk));
  };
#pragma unroll
  for (int k = 0; k < kWindow; ++k) {
    const float wk = __shfl_sync(kAll, w, k);
    if (bit(starts, k)) run_w = run_s2 = 0.f;
    sum(wk);
    if (k == my_end) {
      my_w = run_w;
      my_s2 = run_s2;
    }
  }

  // the tail run: its end, from the next 32 records or else 128 records
  // a load past them, and the rest of its sums
  const int tail_id = __shfl_sync(kAll, id, 31);
  int64_t tail_end = base + kWindow;
  if (tail) {
    unsigned hit = __ballot_sync(kAll, !in2 || id2 != tail_id);
    const int n = hit ? __ffs(hit) - 1 : 32;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float wk = __shfl_sync(kAll, w2, k);
      if (k < n) sum(wk);
    }
    tail_end += n;
    for (int64_t off = base + 2 * kWindow; !hit; off += kAhead * 32) {
      bool other[kAhead];
      float qw[kAhead];
      int qid[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int64_t j = off + q * 32 + lane;
        const int64_t jc = j < records ? j : records - 1;
        qid[q] = ids[jc];
        qw[q] = weights[jc];
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const bool inj = off + q * 32 + lane < records;
        other[q] = !inj || qid[q] != tail_id;
        if (!inj) qw[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        if (hit) break;
        hit = __ballot_sync(kAll, other[q]);
        const int m = hit ? __ffs(hit) - 1 : 32;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const float wk = __shfl_sync(kAll, qw[q], k);
          if (k < m) sum(wk);
        }
        tail_end = off + q * 32 + m;
      }
    }
    if (my_end == kWindow) {
      my_w = run_w;
      my_s2 = run_s2;
    }
  }

  // each lane's record: its run's mult (used where the run starts) and
  // its own scale, in JAX's _blend_fields order
  const float safe_w = fmaxf(my_w, 1e-30f);
  const float mult =
      my_w > 0.f ? __fsub_rn(1.f, __fdiv_rn(__fmul_rn(iw, my_s2), safe_w))
                 : 1.f;
  const float scale = __fdiv_rn(__fmul_rn(__fmul_rn(iw, w), w), safe_w);

  T acc = V::zero();
  for (int k0 = lo;;) {
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      const int k = (k0 + u) & 31;
      const float mk = __shfl_sync(kAll, mult, k);
      const float sk = __shfl_sync(kAll, scale, k);
      const int idk = __shfl_sync(kAll, id, k);
      if (k0 + u <= hi && bit(owned, k)) {
        if (bit(starts, k)) acc = V::mul(row[u], mk);
        acc = V::fold(acc, sk, feat[u]);
        if (bit(ends, k) && has_v)
          rows[static_cast<size_t>(idk) * width + v] = acc;
      }
    }
    k0 += kStep;
    if (k0 > hi) break;
    request(k0);
  }
  if (!tail) return;

  // the tail run's records past the window, in order: the next 32 from
  // the registers, the rest 128 records' weights and pixels a load
  const float tail_safe = __shfl_sync(kAll, safe_w, 31);
  auto scale_of = [&](float wj) {
    return __fdiv_rn(__fmul_rn(__fmul_rn(iw, wj), wj), tail_safe);
  };
  {
    const int qp[1] = {pix2};
    const float qs[1] = {scale_of(w2)};
    fold_tail<kVec, 1>(acc, qp, qs, base + kWindow, tail_end, fvec, width, v,
                       has_v);
  }
  for (int64_t off = base + 2 * kWindow; off < tail_end;
       off += kAhead * 32) {
    float qs[kAhead];
    int qp[kAhead];
    float qw[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int64_t j = off + q * 32 + lane;
      const int64_t jc = j < tail_end ? j : tail_end - 1;
      qp[q] = pixels[jc];
      qw[q] = weights[jc];
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      qs[q] = scale_of(off + q * 32 + lane < tail_end ? qw[q] : 0.f);
    fold_tail<kVec, kAhead>(acc, qp, qs, off, tail_end, fvec, width, v,
                            has_v);
  }
  if (has_v) rows[static_cast<size_t>(tail_id) * width + v] = acc;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int splat_dense_max_features() { return kMaxFeatures; }

// The float4 kernel's shape as built: out[0..8] = threads a block,
// records a warp's window, channels a warp, window records a load brings,
// tail records a load brings, records a tail load of ids spans,
// registers a thread, local (spilled) bytes a thread, resident blocks an
// SM.
extern "C" int splat_dense_config(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, splat_dense_kernel<4>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, splat_dense_kernel<4>, kThreads, 0);
  const int shape[] = {kThreads, kWindow, 32 * 4, kStep, kTailStep,
                       kAhead * 32};
  for (int k = 0; k < 6; ++k) out[k] = shape[k];
  out[6] = err == cudaSuccess ? attr.numRegs : 0;
  out[7] = err == cudaSuccess ? static_cast<int>(attr.localSizeBytes) : 0;
  out[8] = blocks;
  return static_cast<int>(err);
}

// data [voxels, features] float32 (updated in place); ids, weights and
// pixels [records] (int32, float32, int32), stable-sorted by id; feats
// [pixels, features] float32; every pixel index below the number of
// feature rows.
extern "C" int splat_dense_launch(float* data, int features, int64_t voxels,
                                  const int* ids, const float* weights,
                                  const int* pixels, const float* feats,
                                  int64_t records, float iw,
                                  cudaStream_t stream) {
  if (features < 1 || features > kMaxFeatures || records < 0 || voxels < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (records == 0) return static_cast<int>(cudaSuccess);
  const bool vec = features % 4 == 0 && aligned(data) && aligned(feats);
  const int64_t slices = (features / (vec ? 4 : 1) + 31) / 32;
  const int64_t warps = (records + kWindow - 1) / kWindow * slices;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec) {
    splat_dense_kernel<4><<<grid, kThreads, 0, stream>>>(
        data, features, voxels, ids, weights, pixels, feats, records, iw);
  } else {
    splat_dense_kernel<1><<<grid, kThreads, 0, stream>>>(
        data, features, voxels, ids, weights, pixels, feats, records, iw);
  }
  return static_cast<int>(cudaGetLastError());
}
