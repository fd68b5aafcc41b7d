"""The comparison that decides ``correct``: what the timed path produced,
at the timed sizes, against the plain reference (``portbench.reference``)
worked out again from the benchmark's own inputs.

Numbers (each held against its limit in ``limits/<workload>.json``):

  * ``map_gap``: the largest gap between a voxel channel of any map of
    the run and the reference's float64 replay of every fold of set-up
    and of every tick run, in order (zero for a map, or the part of one,
    that no frame reaches);
  * ``plan_mismatch``: plans of the sampled ticks (distance field,
    target, agent cell, edges) and meshes of every refresh, per episode,
    that differ from the reference's NumPy mesh and BFS on its own maps;
    an exact comparison;
  * learned sensors, on the sampled ticks' B frames through the reference
    detector: ``score_gap``, the largest gap between the k-th best
    detection scores of a frame, and ``class_pixels``, the pixels whose
    fused class differs from the reference's;
  * dense feature families: ``feature_gap``, the largest gap between the
    backbone's features of the first sampled ticks (``FEATURE_TICKS`` of
    ``system.py``) and the reference backbone's (``reference/resnet.py``)
    on the same frames, and ``feature_map_gap``, the largest gap between
    a channel of any dense map and the reference's float64 replay, one
    map at a time, of every dense fold of set-up and of the ticks run,
    with the reference backbone's features.

The map replay folds the class images the program's sensor produced (it
can only follow the program's sensor there); the sensor stage itself is
held against the reference detector on the sampled ticks.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import maskrcnn as RM
from portbench.reference import planner as RP
from portbench.reference import resnet as RR
from portbench.reference import voxel as RV


def geometry(config: Dict) -> RV.Geometry:
    return RV.Geometry(config["map_height"], config["map_width"],
                       config["map_depth"], config["num_classes"],
                       config["grid_resolution"],
                       config["interpolation_weight"])


def detector_config(config: Dict) -> RM.Config:
    s = config["sensor"]
    return RM.Config(
        image_size=s["image_size"], num_classes=config["num_classes"],
        anchor_sizes=tuple(s["anchor_sizes"]),
        anchor_ratios=tuple(s["anchor_ratios"]),
        pre_nms_topk=s["pre_nms_topk"], post_nms_topk=s["post_nms_topk"],
        rpn_nms_threshold=s["rpn_nms_threshold"],
        score_threshold=s["score_threshold"],
        nms_threshold=s["nms_threshold"],
        max_detections=s["max_detections"],
        candidate_pool=s["candidate_pool"],
        pixel_mean=tuple(s["pixel_mean"]),
        detection_threshold=config["detection_threshold"])


class SparseMaps:
    """Every (family, episode) map of a run, kept only at the voxels some
    record reached: sorted keys ``slot * V + voxel id`` and their ``[n,
    F]`` rows, grown as folds reach new voxels, so that a tick's frames
    fold in one call and a run's maps take the room their surfaces do."""

    def __init__(self, g: RV.Geometry, slots, dtype, device):
        self.g = g
        self.slots = {slot: k for k, slot in enumerate(slots)}
        self.keys = torch.empty(0, dtype=torch.int64, device=device)
        self.data = torch.zeros(0, g.classes, dtype=dtype, device=device)

    def rows(self, keys: torch.Tensor) -> torch.Tensor:
        """The rows of ``keys``, made (zero) for keys not seen before."""
        new = torch.unique(keys)
        if self.keys.numel():
            at = torch.searchsorted(self.keys, new).clamp_max(
                self.keys.numel() - 1)
            new = new[self.keys[at] != new]
        if new.numel():
            keys_all, order = torch.sort(torch.cat([self.keys, new]))
            place = torch.empty_like(order)
            place[order] = torch.arange(order.numel(), device=order.device)
            data = self.data.new_zeros(keys_all.numel(), self.g.classes)
            data[place[:self.keys.numel()]] = self.data
            self.keys, self.data = keys_all, data
        return torch.searchsorted(self.keys, keys)

    def fold(self, slots, frames, ids, weights, classes) -> None:
        """One fold of a batch's records (``frames`` indexes ``slots``,
        one a frame)."""
        slot = torch.tensor([self.slots[s] for s in slots], device=ids.device)
        rows = self.rows(slot[frames] * self.g.voxels + ids)
        RV.fold(self.data, rows, weights, classes, self.g)

    def _slot(self, slot):
        """(voxel ids, rows) of a slot's reached voxels."""
        k = self.slots.get(slot)
        if k is None:
            empty = self.keys[:0]
            return empty, empty
        lo, hi = (int(torch.searchsorted(self.keys, k * self.g.voxels + d))
                  for d in (0, self.g.voxels))
        return (self.keys[lo:hi] - k * self.g.voxels,
                torch.arange(lo, hi, device=self.keys.device))

    def occupied(self, slot, z_start, z_stop, threshold) -> np.ndarray:
        """``[H, W]`` occupancy of a slot's map."""
        g = self.g
        ids, rows = self._slot(slot)
        z = ids % g.depth
        hit = ((z >= z_start) & (z < z_stop)
               & (self.data[rows].abs().sum(-1) > threshold))
        out = torch.zeros(g.height * g.width, dtype=torch.bool,
                          device=ids.device)
        out[ids[hit] // g.depth] = True
        return out.view(g.height, g.width).cpu().numpy()

    def gap(self, port: torch.Tensor, slot, rows: int = 16) -> float:
        """Largest |port - reference| over a ``[V, F]`` port map (the
        reference zero where no record reached), in blocks of map rows."""
        ids, at = self._slot(slot)
        return sparse_gap(port, ids, self.data[at], self.g, rows)


def sparse_gap(port: torch.Tensor, ids: torch.Tensor, data: torch.Tensor,
               g: RV.Geometry, rows: int) -> float:
    """Largest |port - reference| over a ``[V, F]`` port map against the
    reference's rows ``data`` at the sorted voxel ``ids`` (zero
    elsewhere), in blocks of ``rows`` map rows."""
    block_voxels = rows * g.width * g.depth
    gap = 0.0
    for lo in range(0, g.voxels, block_voxels):
        hi = min(lo + block_voxels, g.voxels)
        block = port[lo:hi].to(torch.float64)
        a, b = (int(torch.searchsorted(ids, v)) for v in (lo, hi))
        block[ids[a:b] - lo] -= data[a:b].to(torch.float64)
        gap = max(gap, float(block.abs().max()))
    return gap


def sensor_numbers(config: Dict, inputs, system, device) -> Dict:
    """Reference detections of the sampled ticks' frames against what the
    program's sensor returned."""
    cfg = detector_config(config)
    score_gap, pixels, frames = 0.0, 0, 0
    for t in sorted(system.detections):
        f = system.schedule.frame(t)
        rgb = torch.from_numpy(
            inputs.rgb[f].astype(np.float32) / np.float32(255)).to(device)
        ref = RM.detect(inputs.weights, cfg, rgb)
        scores, _ = system.detections[t]
        mine = torch.sort(scores.to(device), -1, descending=True).values
        theirs = torch.sort(ref.scores, -1, descending=True).values
        score_gap = max(score_gap, float((mine - theirs).abs().max()))
        port_cls = torch.from_numpy(np.asarray(system.classes[t])).to(device)
        pixels += int((port_cls != ref.semantic).sum())
        frames += rgb.shape[0]
    return {"score_gap": score_gap, "class_pixels": pixels,
            "frames": frames}


def map_and_plan_numbers(config: Dict, traffic: Dict, inputs, system,
                         device, dtype=torch.float64) -> Dict:
    """Replay every fold of set-up and of the ticks run, in order, all
    episodes of a tick in one fold, and compare the maps, every refreshed
    mesh and the sampled ticks' plans."""
    g = geometry(config)
    rays = RV.camera_rays(config["camera_size"], config["vertical_fov"],
                          device)
    s = system.schedule
    B = traffic["batch"]
    step, pad = config["step_size"], config["obstacle_padding"]
    z0, z1 = config["map_slice_start"], config["map_slice_stop"]
    nav_name = config["navigation_map_name"]
    families, setup = traffic["families"], traffic["setup_frames"]
    bins = RV.grid_edges(inputs.origin, g, device)
    slots = sorted({(families[e], e) for e in range(B)}
                   | {(traffic["setup_family"], e) for e in range(B)
                      if setup[e]})
    maps = SparseMaps(g, slots, dtype, device)

    def fold(f, episodes, classes, slot_of):
        es = list(episodes)
        frames, ids, weights, cls = RV.records(
            rays, tuple(b[es] for b in bins), g, inputs.position[f, es],
            inputs.yaw[f, es], inputs.elevation[f, es],
            torch.from_numpy(inputs.depth[f, es]).to(device),
            torch.from_numpy(np.asarray(classes)[es]).to(device))
        maps.fold([slot_of(e) for e in es], frames, ids, weights, cls)

    for f in range(max(setup)):
        fold(f, [e for e in range(B) if f < setup[e]], inputs.classes[f],
             lambda e: (traffic["setup_family"], e))
    edges = [(bins[0][e].cpu().numpy(), bins[1][e].cpu().numpy())
             for e in range(B)]
    offsets = [RP.origin_offsets(*edges[e], config["grid_resolution"], step)
               for e in range(B)]
    meshes = [None] * B
    mismatches, plans, refreshed = 0, 0, 0
    for t in system.log:
        f = s.frame(t)
        fold(f, range(B), system.classes.get(t, inputs.classes[f]),
             lambda e: (families[e], e))
        refresh = s.refresh(t)
        for e in range(B):
            if refresh[e]:
                occ = maps.occupied((nav_name, e), z0, z1,
                                    config["obstacle_threshold"])
                meshes[e] = m = RP.mesh(RP.navigable(occ, pad), *offsets[e],
                                        step)
                alive, right, down = system.mesh(t, e)
                refreshed += 1
                mismatches += int(not (np.array_equal(alive, m.alive)
                                       and np.array_equal(right, m.right)
                                       and np.array_equal(down, m.down)))
            if t in system.plans:
                dist_h, tgt_h, agent_h, er, ed = system.plans[t][e]
                agent = RP.cell_of(*edges[e], inputs.position[f, e])
                goal = RP.cell_of(*edges[e], s.goals(t)[e])
                m = meshes[e]
                dist, tgt = RP.plan(m, agent, goal, step)
                plans += 1
                mismatches += int(not (
                    np.array_equal(dist_h, dist) and np.array_equal(tgt_h, tgt)
                    and np.array_equal(agent_h, agent)
                    and np.array_equal(er, m.right)
                    and np.array_equal(ed, m.down)))
    gap = max(maps.gap(system.map(name, e), (name, e))
              for name in config["families"] for e in range(B))
    return {"map_gap": gap, "plan_mismatch": mismatches, "plans": plans,
            "meshes": refreshed, "reference_voxels": int(maps.keys.numel())}


def dense_folds(config: Dict, traffic: Dict, system, name: str,
                e: int) -> List[int]:
    """The frames episode e folded into dense family ``name``, in order:
    set-up's, then the ticks'."""
    rides = config["dense_rides_with"][name]
    frames = []
    if rides == traffic["setup_family"]:
        frames += list(range(traffic["setup_frames"][e]))
    if rides == traffic["families"][e]:
        frames += [system.schedule.frame(t) for t in system.log]
    return frames


def dense_records(config: Dict, g: RV.Geometry, rays, bins, inputs,
                  frames, e: int, device):
    """The 8 corner records of episode e's ``frames`` on the feature
    camera, depth taken at the stride's pixel centres: ``(frame [R],
    ids [R], weights [R], pixel [R])``, the pixel row-major in the
    feature image."""
    k = config["backbone"]["stride"]
    depth = torch.from_numpy(np.ascontiguousarray(
        inputs.depth[frames, e][:, k // 2::k, k // 2::k])).to(device)
    n = len(frames)
    pixels = torch.arange(depth[0].numel(), device=device).view(
        depth.shape[1:]).expand(depth.shape)
    return RV.records(rays, tuple(b[[e] * n] for b in bins), g,
                      inputs.position[frames, e], inputs.yaw[frames, e],
                      inputs.elevation[frames, e], depth, pixels)


def rgb(frames: np.ndarray, device) -> torch.Tensor:
    """uint8 RGB frames ``[..., h, w, 3]`` in 0-1, as the program takes
    them."""
    return torch.from_numpy(frames.astype(np.float32)
                            / np.float32(255)).to(device)


def replay_dense(config: Dict, g: RV.Geometry, rays, bins, inputs, frames,
                 e: int, device, chunk: int = 32):
    """Episode e's ``frames`` folded in order into one float64 dense map
    of ``g.classes`` channels, with the reference backbone's features:
    ``(voxel ids, rows)``, the map kept only at the voxels some record
    reached."""
    keys = [torch.empty(0, dtype=torch.int64, device=device)]
    for lo in range(0, len(frames), chunk):
        _, ids, _, _ = dense_records(config, g, rays, bins, inputs,
                                     frames[lo:lo + chunk], e, device)
        keys.append(torch.unique(ids))
    keys = torch.unique(torch.cat(keys))
    data = torch.zeros(keys.numel(), g.classes, dtype=torch.float64,
                       device=device)
    for lo in range(0, len(frames), chunk):
        part = frames[lo:lo + chunk]
        feats = RR.forward(inputs.backbone,
                           rgb(inputs.rgb[part, e], device))
        feats = feats.reshape(len(part), -1, feats.shape[-1])
        frame, ids, w, pix = dense_records(config, g, rays, bins, inputs,
                                           part, e, device)
        order = torch.argsort(frame, stable=True)
        counts = torch.bincount(frame, minlength=len(part)).tolist()
        for k, (ids_k, w_k, pix_k) in enumerate(zip(
                *(x[order].split(counts) for x in (ids, w, pix)))):
            RV.fold_dense(data, torch.searchsorted(keys, ids_k), w_k,
                          pix_k, feats[k], g)
    return keys, data


def feature_numbers(config: Dict, traffic: Dict, inputs, system,
                    device) -> Dict:
    """The sampled ticks' backbone features against the reference
    backbone's, and every dense map against its reference replay."""
    s = system.schedule
    feature_gap = 0.0
    for t in sorted(system.features):
        ref = RR.forward(inputs.backbone, rgb(inputs.rgb[s.frame(t)], device))
        feature_gap = max(feature_gap, float(
            (system.features[t].to(device) - ref).abs().max()))
    stride = config["backbone"]["stride"]
    g = geometry(config)
    rays = RV.camera_rays(config["camera_size"] // stride,
                          config["vertical_fov"], device)
    bins = RV.grid_edges(inputs.origin, g, device)
    gap, voxels = 0.0, 0
    for name, channels in config["dense_families"].items():
        dense = g._replace(classes=channels)
        for e in range(traffic["batch"]):
            frames = dense_folds(config, traffic, system, name, e)
            keys, data = replay_dense(config, dense, rays, bins, inputs,
                                      frames, e, device)
            gap = max(gap, sparse_gap(system.map(name, e), keys, data,
                                      dense, rows=4))
            voxels += int(keys.numel())
            del keys, data      # freed before the next map's replay
    return {"feature_gap": feature_gap, "feature_map_gap": gap,
            "feature_frames": len(system.features) * traffic["batch"],
            "reference_feature_voxels": voxels}


def judge(config: Dict, traffic: Dict, inputs, system, device) -> Dict:
    """Every number of the cell, and the counts of what was compared."""
    out = map_and_plan_numbers(config, traffic, inputs, system, device)
    if config.get("sensor"):
        out.update(sensor_numbers(config, inputs, system, device))
    if config.get("dense_families"):
        out.update(feature_numbers(config, traffic, inputs, system, device))
    return out
