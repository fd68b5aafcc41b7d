"""The system under test: the device half of the port's lockstep fleet
tick (``mass_tpu_torch/parallel/evaluator.FleetEvaluator.tick``), driven
from the benchmark's frames.  This is the one module of the benchmark
that imports the port.

Each tick, for the B episodes in lockstep: the learned sensor on the B
RGB frames in one call (learned configurations), one batched map update
(``FleetMaps.update_batch``, each episode into its phase's family), one
batched plan for the episodes whose mesh refreshes this tick (a
mission's first plan and every ``graph_update_interval`` plans after) and
one for the rest (``nav.grid.plan_batch``, as the fleet's ``_plan_group``),
and after each the one copy of its plans that the host backtrack reads
(``nav.grid.plan_to_host``).  Configurations with ``dense_families`` add,
after the map update, one dense update (``FleetMaps.update_dense``: the B
RGB frames through the ``backbone`` in one call, one dense splat a
family), each dense family updated by the episodes whose phase map it
rides with (``dense_rides_with``), as ``FleetEvaluator.tick`` pairs them.
Frames arrive as host arrays, as a simulator hands them over; their
upload is part of the tick.

What the check reads is kept as the tick makes it, by reference: the
class images, the sampled ticks' plans and detections, the first sampled
ticks' backbone features, and each refreshed mesh.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

# the sampled ticks whose backbone features the check keeps on the card,
# the first of a run's: with a cap the card's peak does not grow with the
# ticks a window holds (6.4 MB a full-width fleet2 tick)
FEATURE_TICKS = 16


class Schedule:
    """What tick t asks of every episode: the frame, the missions' goals,
    which episodes' plans refresh their mesh (a mission's first plan and
    every ``graph_update_interval`` plans after, as the fleet's
    ``_wants_refresh``), whether the check samples the tick."""

    def __init__(self, config: Dict, traffic: Dict, inputs):
        self.frames = traffic["frames_per_episode"]
        self.interval = config["graph_update_interval"]
        self.inputs = inputs

    def frame(self, t: int) -> int:
        return t % self.frames

    def goals(self, t: int) -> np.ndarray:
        return np.ascontiguousarray(self.inputs.goals[self.frame(t)])

    def refresh(self, t: int) -> np.ndarray:
        """``[B]`` bool."""
        return self.inputs.calls[self.frame(t)] % self.interval == 0

    def checked(self, t: int) -> bool:
        return bool(self.inputs.checked[t])


class Spans:
    """Host-clock time of each layer call in a tick, and a profiler range
    of the same name around it."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        with record_function(f"portbench.{name}"):
            start = time.perf_counter()
            yield
            self.seconds.setdefault(name, []).append(
                time.perf_counter() - start)


class PortSystem:
    """``mass_tpu_torch``'s fleet on ``device`` over the traffic's B
    episodes, with set-up's folds done."""

    def __init__(self, config: Dict, traffic: Dict, inputs, device):
        from mass_tpu_torch.config import CameraConfig, MapGeometry
        from mass_tpu_torch.core import geometry as G
        from mass_tpu_torch.nav import grid as NG
        from mass_tpu_torch.parallel.fleet import FleetMaps

        self.NG, self.G = NG, G
        self.config, self.traffic, self.inputs = config, traffic, inputs
        self.device = torch.device(device)
        self.schedule = Schedule(config, traffic, inputs)
        self.spans = Spans()
        B = self.batch = traffic["batch"]
        C = config["num_classes"]
        self.families = traffic["families"]
        self.active = {name: np.asarray([f == name for f in self.families])
                       for name in config["families"]}
        self.rides_with = config.get("dense_rides_with", {})
        self.dense_active = {name: self.active[family]
                             for name, family in self.rides_with.items()}
        self.features: Dict[int, torch.Tensor] = {}
        self._tick = -1
        self.fleet = FleetMaps(
            B, CameraConfig(height=config["camera_size"],
                            width=config["camera_size"],
                            vertical_fov_degrees=config["vertical_fov"]),
            MapGeometry(map_height=config["map_height"],
                        map_width=config["map_width"],
                        map_depth=config["map_depth"],
                        grid_resolution=config["grid_resolution"],
                        interpolation_weight=config["interpolation_weight"]),
            {name: C for name in config["families"]}, device=self.device,
            **self._dense())
        for e in range(B):
            self.fleet.reset(e, tuple(float(v) for v in inputs.origin[e]))
        self._setup_folds()
        self.grids = [self._first_grid(e) for e in range(B)]
        self.sensor = self._sensor() if config.get("sensor") else None
        # what the check reads, kept by reference as the ticks make it
        self.log: List[int] = []
        self.classes: Dict[int, np.ndarray] = {}
        self.plans: Dict[int, tuple] = {}
        self.meshes: Dict[int, list] = {}
        self.detections: Dict[int, tuple] = {}

    # -------------------------------------------------------- set-up

    def _dense(self) -> Dict:
        """The fleet's dense families and the backbone that feeds them,
        loaded as the CLI's ``--backbone-checkpoint`` loads one; the first
        ``FEATURE_TICKS`` sampled ticks' features are kept for the
        check."""
        if not self.config.get("dense_families"):
            return {}
        from mass_tpu_torch.perception import resnet

        backbone = resnet.make_backbone(resnet.from_state_dict(
            self.inputs.backbone, self.device))

        def recording(rgb):
            feats = backbone(rgb)
            if self._tick >= 0 and self.schedule.checked(self._tick) \
                    and len(self.features) < FEATURE_TICKS:
                self.features[self._tick] = feats
            return feats

        return {"dense_sizes": self.config["dense_families"],
                "backbone": recording,
                "stride": self.config["backbone"]["stride"]}

    def _setup_folds(self) -> None:
        """Fold each episode's first ``setup_frames`` frames into its
        ``setup_family`` (the walkthrough map an unshuffle plans on), with
        the frames' own classes, and into the dense families that ride
        with it."""
        inputs, counts = self.inputs, self.traffic["setup_frames"]
        family = self.traffic["setup_family"]
        for f in range(max(counts)):
            active = {name: np.zeros(self.batch, bool)
                      for name in self.config["families"]}
            active[family] = np.asarray([f < n for n in counts])
            self.fleet.update_batch(
                inputs.position[f], inputs.yaw[f], inputs.elevation[f],
                inputs.depth[f][..., None], {family: inputs.classes[f]},
                active=active)
            if self.rides_with:
                self.fleet.update_dense(
                    inputs.position[f], inputs.yaw[f], inputs.elevation[f],
                    inputs.depth[f][..., None], self._rgb(f),
                    active={name: active[with_]
                            for name, with_ in self.rides_with.items()})

    def _rgb(self, f: int) -> np.ndarray:
        """Frame f's ``[B, h, w, 3]`` RGB in 0-1, as the sensor takes it."""
        return self.inputs.rgb[f].astype(np.float32) / np.float32(255)

    def _first_grid(self, e: int):
        """The controller's first mesh (``reset_navigation_grid``): nodes
        offset so the map's centre cell owns one."""
        cfg, NG = self.config, self.NG
        vm = self.fleet.view(cfg["navigation_map_name"], e)
        half = float(np.float32(cfg["grid_resolution"] / 2))
        centre = torch.stack([(vm.bins_x[0] + vm.bins_x[-1]) / 2 + half,
                              (vm.bins_y[0] + vm.bins_y[-1]) / 2 + half])
        cell = vm.world_to_map(centre).cpu().numpy()
        step = cfg["step_size"]
        nav = NG.navigable_area(vm, cfg["obstacle_padding"],
                                cfg["map_slice_start"], cfg["map_slice_stop"],
                                cfg["obstacle_threshold"])
        return NG.build_nav_grid(nav, int(cell[0]) % step,
                                 int(cell[1]) % step, step=step)

    def _sensor(self):
        from mass_tpu_torch.perception import maskrcnn as MR
        from mass_tpu_torch.perception.segmentation import (
            DetectorSegmentation, make_batched_sensor)

        s = self.config["sensor"]
        cfg = MR.MaskRCNNConfig(
            num_classes=self.config["num_classes"],
            image_size=s["image_size"],
            anchor_sizes=tuple(s["anchor_sizes"]),
            anchor_ratios=tuple(s["anchor_ratios"]),
            pre_nms_topk=s["pre_nms_topk"], post_nms_topk=s["post_nms_topk"],
            rpn_nms_threshold=s["rpn_nms_threshold"],
            score_threshold=s["score_threshold"],
            nms_threshold=s["nms_threshold"],
            max_detections=s["max_detections"],
            candidate_pool=s["candidate_pool"],
            pixel_mean=tuple(s["pixel_mean"]))
        with torch.device(self.device):
            model = MR.MaskRCNN(cfg)
        model.load_state_dict(self.inputs.weights, strict=True)
        detector = MR.make_detector(model)

        def recording(rgb):
            det = detector(rgb)
            if self.schedule.checked(self._tick):
                self.detections[self._tick] = (det.scores, det.classes)
            return det

        return make_batched_sensor(DetectorSegmentation(
            recording, self.config["detection_threshold"],
            self.config["num_classes"]))

    # ---------------------------------------------------------- tick

    def tick(self, t: int) -> None:
        inputs, s = self.inputs, self.schedule
        f = s.frame(t)
        self._tick = t
        if self.sensor is not None:
            with self.spans("sensor"):
                classes = self.sensor(self._rgb(f))[..., 0]
            self.classes[t] = classes
        else:
            classes = inputs.classes[f]
        with self.spans("mapping"):
            self.fleet.update_batch(
                inputs.position[f], inputs.yaw[f], inputs.elevation[f],
                inputs.depth[f][..., None],
                {name: classes for name in self.config["families"]},
                active=self.active)
        if self.rides_with:
            # outside the mapping span: mapping_roofline divides one-hot
            # bytes by one-hot launches
            with self.spans("dense"):
                self.fleet.update_dense(
                    inputs.position[f], inputs.yaw[f], inputs.elevation[f],
                    inputs.depth[f][..., None], self._rgb(f),
                    active=self.dense_active)
        refresh = s.refresh(t)
        with self.spans("planning"):
            host = self._plan(inputs.position[f], s.goals(t), refresh)
        if s.checked(t):
            self.plans[t] = host
        if refresh.any():
            self.meshes[t] = {e: (self.grids[e].alive,
                                  self.grids[e].edge_right,
                                  self.grids[e].edge_down)
                              for e in np.flatnonzero(refresh)}
        self.log.append(t)

    def _plan(self, positions: np.ndarray, goals: np.ndarray,
              refresh: np.ndarray) -> List[tuple]:
        """One batched plan for the episodes that refresh, one for the
        rest; each episode's host arrays (distance field, target, agent
        cell, edges)."""
        cfg, NG, G = self.config, self.NG, self.G

        def put(array):
            return G.to_device(torch.from_numpy(array), self.device)

        host: List[tuple] = [()] * self.batch
        for flag in (True, False):
            group = np.flatnonzero(refresh == flag)
            if not group.size:
                continue
            views = [self.fleet.view(cfg["navigation_map_name"], int(e))
                     for e in group]
            grid, dist, tgt, agent_cell, _ = NG.plan_batch(
                NG.stack_grids([self.grids[e] for e in group]), views,
                put(np.ascontiguousarray(positions[group])),
                put(np.ascontiguousarray(goals[group])),
                step=cfg["step_size"], padding=cfg["obstacle_padding"],
                z_start=cfg["map_slice_start"], z_stop=cfg["map_slice_stop"],
                threshold=cfg["obstacle_threshold"], refresh=bool(flag))
            arrays = NG.plan_to_host(grid, dist, tgt, agent_cell)
            for k, e in enumerate(group):
                old = self.grids[e]
                self.grids[e] = NG.NavGrid(
                    alive=grid.alive[k], edge_right=grid.edge_right[k],
                    edge_down=grid.edge_down[k], off_x=old.off_x,
                    off_y=old.off_y, pruned=grid.pruned[k])
                host[e] = tuple(a[k] for a in arrays)
        return host

    def traced(self, first: int, count: int, logdir: str):
        """``count`` ticks from ``first`` under the port's trace
        (``utils/profiling.trace``, every launch matched to its device
        record), run on from where they stopped where the trace lost a
        launch.  Returns (the parsed trace, the next tick, the tries)."""
        from mass_tpu_torch.utils import profiling

        next_tick = [first]

        def window():
            with profiling.trace(logdir, self.device) as handle:
                with record_function("portbench.ticks"):
                    for _ in range(count):
                        self.tick(next_tick[0])
                        next_tick[0] += 1
            return handle

        handle, tries = profiling.retried(window)
        return handle.data, next_tick[0], tries

    # ---------------------------------------------------------- check

    def map(self, family: str, e: int) -> torch.Tensor:
        """Episode e's ``[V, F]`` map of a family (a view)."""
        return self.fleet.view(family, e).data

    def mesh(self, t: int, e: int):
        """(alive, right, down) of episode e's mesh refreshed at tick t."""
        return tuple(m.cpu().numpy() for m in self.meshes[t][e])

    def release(self) -> None:
        """Drop what the check does not read (the detector)."""
        self.sensor = None
