"""The control of ``correct``: the plain reference put in the program's
place, one precision below what the configuration states, run through a
cell's whole run and judged by the same comparison.  It has to come out
not correct.

  * the detector with TF32 on (the configuration states fp32, TF32 off);
  * the maps in bfloat16, sums and blend (the configuration states
    float32), dense feature maps too;
  * the stage-1 backbone with TF32 on (the configuration states fp32,
    TF32 off);
  * the planner as the reference's, on those maps.

    python3 -m portbench.control --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--system port] [--world-from-seed]

prints each seed's compared numbers beside their limits, one JSON line a
seed, all seeds in one process.  ``--system port`` runs the program
itself instead (the sound runs that the limits' lower readings come
from); ``--world-from-seed`` draws each seed's houses and walks from the
seed, so that the readings cover many worlds.  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict

import numpy as np
import torch

from portbench import check
from portbench.bench import Bench
from portbench.reference import maskrcnn as RM
from portbench.reference import planner as RP
from portbench.reference import resnet as RR
from portbench.reference import voxel as RV
from portbench.system import FEATURE_TICKS, Schedule, Spans


class ControlSystem:
    """The reference in lower precision, with the port's system's face:
    ``tick``, ``map``, ``mesh``, ``release`` and the records the check
    reads."""

    DTYPE = torch.bfloat16

    def __init__(self, config: Dict, traffic: Dict, inputs, device):
        self.config, self.traffic, self.inputs = config, traffic, inputs
        self.device = device
        self.schedule = Schedule(config, traffic, inputs)
        self.spans = Spans()
        self.batch = traffic["batch"]
        self.g = check.geometry(config)
        self.rays = RV.camera_rays(config["camera_size"],
                                   config["vertical_fov"], device)
        self.bins = RV.grid_edges(inputs.origin, self.g, device)
        self.maps = {(name, e): torch.zeros(self.g.voxels, self.g.classes,
                                            dtype=self.DTYPE, device=device)
                     for name in config["families"]
                     for e in range(self.batch)}
        self.rides_with = config.get("dense_rides_with", {})
        if self.rides_with:
            stride = config["backbone"]["stride"]
            self.dense_rays = RV.camera_rays(
                config["camera_size"] // stride, config["vertical_fov"],
                device)
        for name, channels in config.get("dense_families", {}).items():
            for e in range(self.batch):
                self.maps[name, e] = torch.zeros(
                    self.g.voxels, channels, dtype=self.DTYPE, device=device)
        step = config["step_size"]
        self.edges = [(self.bins[0][e].cpu().numpy(),
                       self.bins[1][e].cpu().numpy())
                      for e in range(self.batch)]
        self.offsets = [RP.origin_offsets(*self.edges[e],
                                          config["grid_resolution"], step)
                        for e in range(self.batch)]
        self.current = [None] * self.batch
        setup = traffic["setup_family"]
        for f in range(max(traffic["setup_frames"])):
            feats = self._features(f) if self.rides_with else None
            for e in range(self.batch):
                if f < traffic["setup_frames"][e]:
                    self._fold(setup, e, f, inputs.classes[f, e])
                    if feats is not None:
                        self._fold_dense(setup, e, f, feats[e])
        self.detector = (check.detector_config(config)
                         if config.get("sensor") else None)
        self.log = []
        self.classes, self.plans, self.meshes, self.detections = {}, {}, {}, {}
        self.features = {}

    def _fold(self, family, e, f, classes) -> None:
        inputs = self.inputs
        _, ids, w, cls = RV.records(
            self.rays, tuple(b[e:e + 1] for b in self.bins), self.g,
            inputs.position[f, e:e + 1], inputs.yaw[f, e:e + 1],
            inputs.elevation[f, e:e + 1],
            torch.from_numpy(inputs.depth[f, e:e + 1]).to(self.device),
            torch.as_tensor(np.asarray(classes)[None], device=self.device))
        RV.fold(self.maps[family, e], ids, w, cls, self.g)

    def _features(self, f: int) -> torch.Tensor:
        """Frame f's ``[B, h/4, w/4, F]`` features, TF32 on."""
        return RR.forward(self.inputs.backbone,
                          check.rgb(self.inputs.rgb[f], self.device),
                          tf32=True)

    def _fold_dense(self, family, e, f, feats) -> None:
        """Episode e's frame f into the dense families riding with
        ``family``."""
        for name, rides in self.rides_with.items():
            if rides != family:
                continue
            _, ids, w, pix = check.dense_records(
                self.config, self.g, self.dense_rays, self.bins, self.inputs,
                [f], e, self.device)
            RV.fold_dense(self.maps[name, e], ids, w, pix,
                          feats.reshape(-1, feats.shape[-1]), self.g)

    def tick(self, t: int) -> None:
        cfg, inputs, s = self.config, self.inputs, self.schedule
        f = s.frame(t)
        classes = inputs.classes[f]
        if self.detector is not None:
            with self.spans("sensor"):
                rgb = torch.from_numpy(inputs.rgb[f].astype(np.float32)
                                       / np.float32(255)).to(self.device)
                det = RM.detect(inputs.weights, self.detector, rgb, tf32=True)
                classes = det.semantic.cpu().numpy()
            self.classes[t] = classes
            if s.checked(t):
                self.detections[t] = (det.scores, det.classes)
        with self.spans("mapping"):
            for e in range(self.batch):
                self._fold(self.traffic["families"][e], e, f, classes[e])
        if self.rides_with:
            with self.spans("dense"):
                feats = self._features(f)
                if s.checked(t) and len(self.features) < FEATURE_TICKS:
                    self.features[t] = feats
                for e in range(self.batch):
                    self._fold_dense(self.traffic["families"][e], e, f,
                                     feats[e])
        step = cfg["step_size"]
        refresh = s.refresh(t)
        with self.spans("planning"):
            out = []
            for e in range(self.batch):
                if refresh[e]:
                    occ = RV.occupied(
                        self.maps[cfg["navigation_map_name"], e], self.g,
                        cfg["map_slice_start"], cfg["map_slice_stop"],
                        cfg["obstacle_threshold"]).cpu().numpy()
                    self.current[e] = RP.mesh(
                        RP.navigable(occ, cfg["obstacle_padding"]),
                        *self.offsets[e], step)
                m = self.current[e]
                agent = RP.cell_of(*self.edges[e], inputs.position[f, e])
                dist, tgt = RP.plan(
                    m, agent, RP.cell_of(*self.edges[e], s.goals(t)[e]), step)
                out.append((dist, tgt, agent, m.right, m.down))
        if s.checked(t):
            self.plans[t] = out
        if refresh.any():
            self.meshes[t] = {e: (self.current[e].alive,
                                  self.current[e].right,
                                  self.current[e].down)
                              for e in np.flatnonzero(refresh)}
        self.log.append(t)

    def map(self, family: str, e: int) -> torch.Tensor:
        return self.maps[family, e]

    def mesh(self, t: int, e: int):
        return self.meshes[t][e]

    def release(self) -> None:
        pass


def main(argv=None) -> int:
    from portbench.run import ROOT, _plain, run_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--system", choices=("control", "port"),
                   default="control")
    p.add_argument("--world-from-seed", action="store_true")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    bench = Bench(ROOT)
    system_class = ControlSystem if args.system == "control" else None
    for seed in args.seeds:
        result, checks = run_cell(
            bench, args.workload, seed, args.seconds, False, args.device,
            system_class=system_class,
            world_seed=seed if args.world_from_seed else None)
        print(json.dumps({"seed": seed, "system": args.system,
                          "world_from_seed": args.world_from_seed,
                          "correct": result["correct"],
                          "counts": result["counts"], "checks": checks},
                         default=_plain))
        sys.stdout.flush()
        del result
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
