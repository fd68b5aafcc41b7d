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
// Design (simple first):
// - A warp takes 32 consecutive records and owns the runs of equal ids
//   that start among them; a ballot finds the starts, and the warp walks
//   them in order.  A run may go on past the 32 records: a ballot over the
//   next 32 ids at a time finds its end.  No host sync between the sort
//   and the launch: the kernel finds the runs itself.
// - The row is loaded first (F = 256: a lane owns 8 channels, two float4;
//   any F <= 1024, float4 where F % 4 == 0 and the pointers are 16-byte
//   aligned, else one float per lane and slot), then W and S2 are summed
//   over the run's records in order (every lane the same sums, from
//   broadcast loads), the row multiplied, and each record's
//   scale * feature row folded in, in run order.  The row is written once.
// - Arithmetic is __fmul_rn / __fadd_rn / __fdiv_rn / __fsub_rn: no FMA
//   contraction, no atomics, no tensor cores.  The map equals the plain
//   PyTorch version on the CPU (splat_dense_reference) bit for bit, and
//   two runs give the same bits.
//
// Bound: memory.  Per valid record its int32 id, weight and int32 pixel
// (12 B); each pixel's feature row read once (4F B); each touched row
// read and written once (2 * 4F B).  A full-width frame (224x224 camera
// at stride 4: 3,136 pixels, 25,088 records, about 10k touched voxels)
// is about 24 MB, 7 us at 3.35 TB/s.  This kernel reads a pixel's row
// once per record that uses it (8 times, mostly from L2) and sums each
// run serially, so long runs (a camera against a wall) are bounded by
// the longest run instead.
//
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFeatures = 1024;
constexpr int kVecSlots = kMaxFeatures / 128;    // float4 per lane
constexpr int kScalarSlots = kMaxFeatures / 32;  // float per lane
constexpr unsigned kAll = 0xffffffffu;

// one past the last record of the run of ``id`` that starts at ``s``
__device__ __forceinline__ int64_t run_end(const int* __restrict__ ids,
                                           int64_t records, int64_t s,
                                           int id, int lane) {
  for (int64_t off = s + 1;; off += 32) {
    const int64_t j = off + lane;
    const bool other = j >= records || ids[j] != id;
    const unsigned hit = __ballot_sync(kAll, other);
    if (hit) return off + __ffs(hit) - 1;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    splat_dense_kernel(float* __restrict__ data, int features,
                       int64_t voxels, const int* __restrict__ ids,
                       const float* __restrict__ weights,
                       const int* __restrict__ pixels,
                       const float* __restrict__ feats, int64_t records,
                       float iw) {
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32;
  if (base >= records) return;  // the whole warp leaves together
  const int64_t i = base + lane;
  int id = -1;
  bool start = false;
  if (i < records) {
    id = ids[i];
    start = id >= 0 && id < voxels && (i == 0 || ids[i - 1] != id);
  }
  unsigned starts = __ballot_sync(kAll, start);
  constexpr int kSlots = kVec ? kVecSlots : kScalarSlots;
  const int width = kVec ? features / 4 : features;  // vectors per row
  while (starts) {
    const int first = __ffs(starts) - 1;
    starts &= starts - 1;
    const int64_t s = base + first;
    const int run_id = __shfl_sync(kAll, id, first);
    float* row = data + static_cast<size_t>(run_id) * features;

    // the row, loaded before the sums so its latency overlaps them
    float4 acc4[kVec ? kSlots : 1];
    float acc1[kVec ? 1 : kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = lane + 32 * k;
      if (j < width) {
        if constexpr (kVec) {
          acc4[k] = reinterpret_cast<const float4*>(row)[j];
        } else {
          acc1[k] = row[j];
        }
      }
    }

    const int64_t e = run_end(ids, records, s, run_id, lane);
    float w_sum = 0.f, s2_sum = 0.f;
    for (int64_t p = s; p < e; ++p) {
      const float w = weights[p];
      w_sum = __fadd_rn(w_sum, w);
      s2_sum = __fadd_rn(s2_sum, __fmul_rn(w, w));
    }
    const float safe_w = fmaxf(w_sum, 1e-30f);
    const float mult =
        w_sum > 0.f ? __fsub_rn(1.f, __fdiv_rn(__fmul_rn(iw, s2_sum), safe_w))
                    : 1.f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (lane + 32 * k < width) {
        if constexpr (kVec) {
          acc4[k].x = __fmul_rn(acc4[k].x, mult);
          acc4[k].y = __fmul_rn(acc4[k].y, mult);
          acc4[k].z = __fmul_rn(acc4[k].z, mult);
          acc4[k].w = __fmul_rn(acc4[k].w, mult);
        } else {
          acc1[k] = __fmul_rn(acc1[k], mult);
        }
      }
    }

    for (int64_t p = s; p < e; ++p) {
      const float w = weights[p];
      const float scale = __fdiv_rn(__fmul_rn(__fmul_rn(iw, w), w), safe_w);
      const float* f = feats + static_cast<size_t>(pixels[p]) * features;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = lane + 32 * k;
        if (j < width) {
          if constexpr (kVec) {
            const float4 v = reinterpret_cast<const float4*>(f)[j];
            acc4[k].x = __fadd_rn(acc4[k].x, __fmul_rn(scale, v.x));
            acc4[k].y = __fadd_rn(acc4[k].y, __fmul_rn(scale, v.y));
            acc4[k].z = __fadd_rn(acc4[k].z, __fmul_rn(scale, v.z));
            acc4[k].w = __fadd_rn(acc4[k].w, __fmul_rn(scale, v.w));
          } else {
            acc1[k] = __fadd_rn(acc1[k], __fmul_rn(scale, f[j]));
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = lane + 32 * k;
      if (j < width) {
        if constexpr (kVec) {
          reinterpret_cast<float4*>(row)[j] = acc4[k];
        } else {
          row[j] = acc1[k];
        }
      }
    }
  }
}

}  // namespace

extern "C" int splat_dense_max_features() { return kMaxFeatures; }

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
  const int64_t warps = (records + 31) / 32;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  const bool vec = features % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  if (vec) {
    splat_dense_kernel<true><<<blocks, kThreads, 0, stream>>>(
        data, features, voxels, ids, weights, pixels, feats, records, iw);
  } else {
    splat_dense_kernel<false><<<blocks, kThreads, 0, stream>>>(
        data, features, voxels, ids, weights, pixels, feats, records, iw);
  }
  return static_cast<int>(cudaGetLastError());
}
