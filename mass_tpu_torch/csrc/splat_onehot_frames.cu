// T-frame one-hot trilinear splat for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mass_tpu/ops/pallas_splat.py:
// splat_onehot_frames_cmajor (_frames_kernel).  That kernel streamed
// each voxel-id span through VMEM once while every frame's EMA blend
// applied in order, so the map crossed HBM once per T frames.  Here the
// T frames' records are sorted together once (ops/splat.py:frame_runs:
// flattened frame-major, stable-sorted by voxel id), cut into one run
// per touched voxel and, inside it, one sub-run per frame that touched
// the voxel, in frame order.  One warp owns one voxel:
//
//   load row into registers
//   for each sub-run (frame order):
//     W = sum w, S2 = sum w*w, T[f] = sum w*w*[cls == f]
//     row[f] = row[f] * (1 - iw*S2/W) + (iw/W) * T[f]      (in registers)
//   store row
//
// A frame that does not touch the voxel has no sub-run and no blend,
// which is what the single-map kernel does for it (W = 0).  Each sub-run
// is summed as splat_onehot.cu sums a run (32 records per load,
// broadcast in record order by shuffles, no float atomics) with every
// multiply and add written as a round-to-nearest intrinsic, so the
// result equals T launches of the single-map kernel in a row, and the
// plain PyTorch version on the CPU, bit for bit.
//
// Bound: memory.  The kernel must read each valid record's weight and
// class (8 B), each run's int64 id and sub-run start (16 B), each
// sub-run's int64 record start (8 B; its frame index is not read), and
// read and write each touched voxel's row (2*4*F B) once for all T
// frames.  On bench.py's random frames, 8 per launch into a
// 384x384x96x54 map, that is about 608 MB, a bound of 0.18 ms at the
// H100's 3.35 TB/s; the kernel measured 0.665 ms per launch there
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py).  F <= 128 (lanes
// cover classes f, f+32, f+64, f+96).  Voxel ids and row offsets are
// int64.
//
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; splat_onehot_frames_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxSlots = 4;  // classes per lane: F <= 32 * kMaxSlots

__global__ void splat_onehot_frames_kernel(
    float* __restrict__ data, int F, int64_t V,
    const int64_t* __restrict__ run_ids,
    const int64_t* __restrict__ run_sub_starts,
    const int64_t* __restrict__ sub_starts,
    const float* __restrict__ weights, const int32_t* __restrict__ classes,
    int64_t num_runs, float iw) {
  const int lane = threadIdx.x & 31;
  const int64_t run =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (run >= num_runs) return;
  const int64_t v = run_ids[run];
  if (v < 0 || v >= V) return;  // discard run (invalid pixels)

  float* row = data + v * (int64_t)F;
  float x[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    const int f = lane + 32 * s;
    x[s] = f < F ? row[f] : 0.f;
  }

  const int64_t sub_end = run_sub_starts[run + 1];
  for (int64_t sub = run_sub_starts[run]; sub < sub_end; ++sub) {
    const int64_t begin = sub_starts[sub];
    const int64_t end = sub_starts[sub + 1];
    float w_sum = 0.f, s2_sum = 0.f;
    float t[kMaxSlots] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t base = begin; base < end; base += 32) {
      const int64_t r = base + lane;
      const float my_w = r < end ? weights[r] : 0.f;
      const int my_c = r < end ? classes[r] : -1;
      const int64_t rem = end - base;
      const int n = rem < 32 ? (int)rem : 32;
      for (int k = 0; k < n; ++k) {
        const float w = __shfl_sync(0xffffffffu, my_w, k);
        const int c = __shfl_sync(0xffffffffu, my_c, k);
        const float w2 = __fmul_rn(w, w);
        w_sum = __fadd_rn(w_sum, w);
        s2_sum = __fadd_rn(s2_sum, w2);
        if (c >= 0 && c < F && (c & 31) == lane) {
          const int slot = c >> 5;
#pragma unroll
          for (int s = 0; s < kMaxSlots; ++s)
            if (s == slot) t[s] = __fadd_rn(t[s], w2);
        }
      }
    }
    const float safe_w = fmaxf(w_sum, 1e-30f);
    const float mult =
        w_sum > 0.f
            ? __fsub_rn(1.f, __fdiv_rn(__fmul_rn(iw, s2_sum), safe_w))
            : 1.f;
    const float scale = __fdiv_rn(iw, safe_w);
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s)
      x[s] = __fadd_rn(__fmul_rn(x[s], mult), __fmul_rn(scale, t[s]));
  }

#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    const int f = lane + 32 * s;
    if (f < F) row[f] = x[s];
  }
}

}  // namespace

extern "C" int splat_onehot_frames_max_features() { return 32 * kMaxSlots; }

extern "C" int splat_onehot_frames_launch(void* data, int F, int64_t V,
                                          const void* run_ids,
                                          const void* run_sub_starts,
                                          const void* sub_starts,
                                          const void* weights,
                                          const void* classes,
                                          int64_t num_runs, float iw,
                                          void* stream) {
  int64_t blocks = (num_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1) blocks = 1;
  splat_onehot_frames_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                               (cudaStream_t)stream>>>(
      (float*)data, F, V, (const int64_t*)run_ids,
      (const int64_t*)run_sub_starts, (const int64_t*)sub_starts,
      (const float*)weights, (const int32_t*)classes, num_runs, iw);
  return (int)cudaGetLastError();
}
