"""Where the time goes inside the NMS kernel, phase by phase, on one card.

    python -m mass_tpu_torch.profile_nms

Builds a copy of ``csrc/nms.cu`` into ``build/nms_phases/`` in which
thread 0 of every block writes the global nanosecond timer at the ends of
the kernel's phases (keys formed, cluster wait, rank, gather, rows, the
barrier after them, walk), and runs it on seeded problems of the
detector's shapes: the RPN's five levels of one frame (500 boxes each,
caps 256/256/256/147/48, threshold 0.7), the class-aware NMS (512
candidates in 54 class islands, cap 64, threshold 0.5) and the RPN of
eight frames.  Each case runs 12 times
after a 64 MB L2 flush; it prints, per case, the median over the last 10
of each phase's end in microseconds after the first block started (the
latest block's, so a phase includes the wait for the slowest block),
and of the leader's walk per problem.  The timer ticks in steps of a few
hundred nanoseconds on the H100, so read the phases to about 0.3 us.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from mass_tpu_torch.ops import splat

PHASES = ("start", "keys", "wait", "rank", "gather", "rows", "synced",
          "walk")
STAMP = ("if (tid == 0 && g_trace) {{ unsigned long long t; asm volatile("
         "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
         "g_trace[(p * 8 + block) * 8 + {k}] = (long long)t; }}\n")
# (text in csrc/nms.cu, where the stamp goes: before or after it)
MARKS = (("  cluster_arrive();\n", "before"),
         ("  cluster_wait();\n", "before"),
         ("  cluster_wait();\n", "after"),
         ("  cluster.sync();\n  for (int c = tid", "before"),
         ("\n  // 2. suppression rows", "before"),
         ("  cluster.sync();\n  if (block != 0", "before"),
         ("  if (block != 0 || warp != 0) return;\n", "before"),
         ("    out[s] = s < slot ? order_s[taken_s[s]] : -1;\n", "after"))


def instrumented_source() -> str:
    with open(splat._paths("nms")[0]) as f:
        text = f.read()
    text = text.replace("__global__ void __launch_bounds__(kThreads)\nnms_",
                        "__device__ long long* g_trace;\n"
                        "__global__ void __launch_bounds__(kThreads)\nnms_",
                        1)
    for k, (mark, where) in enumerate(MARKS):
        if text.count(mark) != 1:
            raise RuntimeError(f"profile_nms: {mark!r} is not in nms.cu once")
        stamp = "  " + STAMP.format(k=k)
        text = text.replace(mark, stamp + mark if where == "before"
                            else mark + stamp)
    return text + ('\nextern "C" int nms_set_trace(long long* p) {\n'
                   "  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));"
                   "\n}\n")


def build() -> ctypes.CDLL:
    out = os.path.join(os.path.dirname(splat.BUILD_DIR), "nms_phases")
    os.makedirs(out, exist_ok=True)
    source = os.path.join(out, "nms_phases.cu")
    with open(source, "w") as f:
        f.write(instrumented_source())
    library = os.path.join(out, "libnms_phases.so")
    subprocess.run([splat.nvcc(), *splat.NVCC_FLAGS, "-o", library, source],
                   check=True)
    lib = ctypes.CDLL(library)
    lib.nms_launch.argtypes = splat._ENTRIES["nms"][1]
    lib.nms_set_trace.argtypes = [ctypes.c_void_p]
    return lib


def problems(rng):
    """The three cases: (boxes [P, N, 4], scores [P, N], threshold,
    caps)."""
    def boxes(n, size, scale):
        xy = rng.uniform(0, size - 4, (n, 2))
        wh = rng.uniform(1.0, scale, (n, 2))
        return np.concatenate([xy, np.minimum(xy + wh, size)], 1)

    def rpn(frames):
        return (np.stack([boxes(500, 224.0, 120.0)
                          for _ in range(5 * frames)]),
                rng.randn(5 * frames, 500), 0.7, [256, 256, 256, 147, 48])

    classes = rng.randint(0, 54, 512)
    islands = boxes(512, 224.0, 60.0) + (classes * 226.0)[:, None]
    return {"rpn_b1": rpn(1),
            "detection_b1": (islands[None], rng.rand(1, 512), 0.5, [64]),
            "rpn_b8": rpn(8)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_nms: no CUDA device")
    lib = build()
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for name, (b, s, threshold, caps) in problems(
            np.random.RandomState(0)).items():
        P, n = s.shape
        boxes = torch.from_numpy(b.astype(np.float32)).to(dev)
        scores = torch.from_numpy(s.astype(np.float32)).to(dev)
        keep = torch.empty((P, max(caps)), dtype=torch.int32, device=dev)
        trace = torch.zeros((P, 8, 8), dtype=torch.int64, device=dev)
        splat._raise_on(lib.nms_set_trace(trace.data_ptr()), "nms trace")
        ends, walks = [], []
        for _ in range(12):
            flush.zero_()
            splat._raise_on(lib.nms_launch(
                boxes.data_ptr(), scores.data_ptr(), P, n,
                (ctypes.c_int * len(caps))(*caps), len(caps), threshold,
                max(caps), keep.data_ptr(), stream), "nms")
            torch.cuda.synchronize()
            t = trace.cpu().numpy().astype(np.float64)
            t0 = t[:, :, 0].min()
            ends.append([(t[:, :, k] - t0).max() for k in range(7)]
                        + [(t[:, 0, 7] - t0).max()])
            walks.append(t[:, 0, 7] - t[:, 0, 6])
        print(json.dumps({"case": name, "problems": P, "phase_end_us": dict(
            zip(PHASES, np.round(np.median(ends[2:], 0) / 1e3, 2).tolist())),
            "walk_us": np.round(np.median(walks[2:], 0) / 1e3,
                                2).tolist()[:5]}))


if __name__ == "__main__":
    main()
