// Single-map one-hot trilinear splat for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mass_tpu/ops/pallas_splat.py:splat_onehot_cmajor
// (_kernel + _accumulate_and_blend).  That kernel walked fixed voxel-id
// spans in order and reduced each span's records with one-hot matmuls
// on the MXU; here the records arrive already sorted by voxel id and cut
// into runs (one run per touched voxel, ops/splat.py:sorted_runs), and
// one warp owns one run:
//
//   W  = sum w,   S2 = sum w*w,   T[f] = sum w*w*[cls == f]
//   row[f] = row[f] * (1 - iw*S2/W) + (iw/W) * T[f]
//
// The warp loads 32 records at a time (lane k holds record base+k) and
// broadcasts them in record order with shuffles, so every sum runs in
// the sorted order and no float atomics are used: each touched row is
// written by exactly one warp, and two runs give bit-identical maps.
// Every multiply and add is written as a round-to-nearest intrinsic so
// that nvcc cannot contract it into an FMA: the kernel then computes the
// same float32 values as the plain PyTorch version on the CPU.
//
// Bound: memory.  The work is a few flops per byte; the kernel must
// read each valid record's weight and class (8 B) once, each run's id
// and start (int64: 16 B) once, and read and write each touched voxel
// row (F floats: 216 B at F = 54) once, at the H100's 3.35 TB/s.  Each
// lane covers classes lane, lane+32, ...; a row is 216 contiguous
// bytes, so a warp's row access is two coalesced passes.
//
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; splat_onehot_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxSlots = 4;  // classes per lane: F <= 32 * kMaxSlots

__global__ void splat_onehot_kernel(float* __restrict__ data, int F,
                                    int64_t V,
                                    const int64_t* __restrict__ run_ids,
                                    const int64_t* __restrict__ run_starts,
                                    const float* __restrict__ weights,
                                    const int32_t* __restrict__ classes,
                                    int64_t num_runs, float iw) {
  const int lane = threadIdx.x & 31;
  const int64_t run =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (run >= num_runs) return;
  const int64_t v = run_ids[run];
  if (v < 0 || v >= V) return;  // discard run (invalid pixels)
  const int64_t begin = run_starts[run];
  const int64_t end = run_starts[run + 1];

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
      if ((c & 31) == lane) {
        const int slot = c >> 5;
#pragma unroll
        for (int s = 0; s < kMaxSlots; ++s)
          if (s == slot) t[s] = __fadd_rn(t[s], w2);
      }
    }
  }

  const float safe_w = fmaxf(w_sum, 1e-30f);
  const float mult =
      w_sum > 0.f ? __fsub_rn(1.f, __fdiv_rn(__fmul_rn(iw, s2_sum), safe_w))
                  : 1.f;
  const float scale = __fdiv_rn(iw, safe_w);
  float* row = data + v * (int64_t)F;
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    const int f = lane + 32 * s;
    if (f < F)
      row[f] = __fadd_rn(__fmul_rn(row[f], mult), __fmul_rn(scale, t[s]));
  }
}

}  // namespace

extern "C" int splat_onehot_max_features() { return 32 * kMaxSlots; }

extern "C" int splat_onehot_launch(void* data, int F, int64_t V,
                                   const void* run_ids,
                                   const void* run_starts,
                                   const void* weights, const void* classes,
                                   int64_t num_runs, float iw,
                                   void* stream) {
  int64_t blocks = (num_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1) blocks = 1;
  splat_onehot_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                        (cudaStream_t)stream>>>(
      (float*)data, F, V, (const int64_t*)run_ids,
      (const int64_t*)run_starts, (const float*)weights,
      (const int32_t*)classes, num_runs, iw);
  return (int)cudaGetLastError();
}
