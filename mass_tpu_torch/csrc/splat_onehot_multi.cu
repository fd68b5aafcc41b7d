// Multi-map one-hot trilinear splat for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mass_tpu/ops/pallas_splat.py:
// splat_onehot_multi_cmajor (_multi_kernel).  That kernel packed every
// map's class id 8 bits apiece into one sort payload and reduced each
// voxel-id span for all maps with one augmented one-hot matmul.  Here
// the records are sorted once per frame for the whole group
// (ops/splat.py:sorted_runs_multi: one stable sort by voxel id, each
// map's classes gathered in the same order into classes [M, R]), and
// one warp owns one touched voxel's run for all M maps:
//
//   W  = sum w,   S2 = sum w*w            (once, shared by the maps)
//   T_m[f] = sum w*w*[cls_m == f]         (per map)
//   row_m[f] = row_m[f] * (1 - iw_m*S2/W) + (iw_m/W) * T_m[f]
//
// The warp loads 32 records at a time (lane k holds record base+k and
// its M classes) and broadcasts them in record order with shuffles, as
// splat_onehot.cu does: the sums run in sorted order with no float
// atomics, each touched row of each map is read and written once by one
// warp, and every multiply and add is a round-to-nearest intrinsic, so
// map m equals the single-map kernel applied to it with the same runs,
// and the plain PyTorch version on the CPU, bit for bit.  A class
// outside [0, F_m) is dropped for map m only.
//
// Limits: 2 <= M <= 4 maps (one map goes through splat_onehot.cu), each
// F_m <= 128 (lanes cover classes f, f+32, f+64, f+96).  Voxel ids and
// row offsets are int64.
//
// Bound: memory.  Per valid record the kernel must read its weight and
// map 0's class (8 B) and 4 B of class for each further map; per run its
// int64 id and start (16 B); per touched voxel each map's row, read and
// written once (sum over m of 2*4*F_m B).  At chip_smoke.py's full
// 224x224 room frame (20,770 touched voxels, 401,408 records) into
// occupancy (F=1) and a 54-class semantic map that is 14,288,024 B, a
// bound of 0.0043 ms at the H100's 3.35 TB/s; the kernel measured
// 0.0497 ms there (NVIDIA H100 80GB HBM3, 700.00 W): one warp per voxel
// is latency-bound at this size, as the single-map kernel is.
//
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; splat_onehot_multi_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxSlots = 4;  // classes per lane: F_m <= 32 * kMaxSlots
constexpr int kMinMaps = 2;
constexpr int kMaxMaps = 4;

struct Maps {
  float* data[kMaxMaps];
  int features[kMaxMaps];
  float iw[kMaxMaps];
};

template <int M>
__global__ void splat_onehot_multi_kernel(Maps maps, int64_t V,
                                          const int64_t* __restrict__ run_ids,
                                          const int64_t* __restrict__ run_starts,
                                          const float* __restrict__ weights,
                                          const int32_t* __restrict__ classes,
                                          int64_t num_records,
                                          int64_t num_runs) {
  const int lane = threadIdx.x & 31;
  const int64_t run =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (run >= num_runs) return;
  const int64_t v = run_ids[run];
  if (v < 0 || v >= V) return;  // discard run (invalid pixels)
  const int64_t begin = run_starts[run];
  const int64_t end = run_starts[run + 1];

  float w_sum = 0.f, s2_sum = 0.f;
  float t[M][kMaxSlots];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) t[m][s] = 0.f;

  for (int64_t base = begin; base < end; base += 32) {
    const int64_t r = base + lane;
    const float my_w = r < end ? weights[r] : 0.f;
    int my_c[M];
#pragma unroll
    for (int m = 0; m < M; ++m)
      my_c[m] = r < end ? classes[m * num_records + r] : -1;
    const int64_t rem = end - base;
    const int n = rem < 32 ? (int)rem : 32;
    for (int k = 0; k < n; ++k) {
      const float w = __shfl_sync(0xffffffffu, my_w, k);
      const float w2 = __fmul_rn(w, w);
      w_sum = __fadd_rn(w_sum, w);
      s2_sum = __fadd_rn(s2_sum, w2);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int c = __shfl_sync(0xffffffffu, my_c[m], k);
        if (c >= 0 && c < maps.features[m] && (c & 31) == lane) {
          const int slot = c >> 5;
#pragma unroll
          for (int s = 0; s < kMaxSlots; ++s)
            if (s == slot) t[m][s] = __fadd_rn(t[m][s], w2);
        }
      }
    }
  }

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
    float* row = maps.data[m] + v * (int64_t)F;
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      const int f = lane + 32 * s;
      if (f < F)
        row[f] =
            __fadd_rn(__fmul_rn(row[f], mult), __fmul_rn(scale, t[m][s]));
    }
  }
}

template <int M>
void launch(const Maps& maps, int64_t V, const void* run_ids,
            const void* run_starts, const void* weights,
            const void* classes, int64_t num_records, int64_t num_runs,
            cudaStream_t stream) {
  int64_t blocks = (num_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1) blocks = 1;
  splat_onehot_multi_kernel<M>
      <<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, stream>>>(
          maps, V, (const int64_t*)run_ids, (const int64_t*)run_starts,
          (const float*)weights, (const int32_t*)classes, num_records,
          num_runs);
}

}  // namespace

extern "C" int splat_onehot_multi_max_features() { return 32 * kMaxSlots; }

extern "C" int splat_onehot_multi_launch(
    int num_maps, void* const* datas, const int* features, const float* iws,
    int64_t V, const void* run_ids, const void* run_starts,
    const void* weights, const void* classes, int64_t num_records,
    int64_t num_runs, void* stream) {
  if (num_maps < kMinMaps || num_maps > kMaxMaps)
    return (int)cudaErrorInvalidValue;
  Maps maps = {};
  for (int m = 0; m < num_maps; ++m) {
    if (features[m] < 1 || features[m] > 32 * kMaxSlots)
      return (int)cudaErrorInvalidValue;
    maps.data[m] = (float*)datas[m];
    maps.features[m] = features[m];
    maps.iw[m] = iws[m];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_maps) {
    case 2: launch<2>(maps, V, run_ids, run_starts, weights, classes,
                      num_records, num_runs, s); break;
    case 3: launch<3>(maps, V, run_ids, run_starts, weights, classes,
                      num_records, num_runs, s); break;
    default: launch<4>(maps, V, run_ids, run_starts, weights, classes,
                       num_records, num_runs, s); break;
  }
  return (int)cudaGetLastError();
}
