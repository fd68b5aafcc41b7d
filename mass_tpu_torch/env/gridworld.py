"""Procedural rearrangement world: a simulator-free stand-in for THOR.

A rectangular room with axis-aligned box objects, an analytic RGB-D +
semantic renderer, THOR-compatible discrete actions, two-phase episodes
(walkthrough at goal poses, unshuffle with some objects displaced or
opened), pose metadata, and challenge metrics.  It implements the same
observation / action / pose contract as the THOR gateway (env/thor.py),
so the full agent, tests, and benchmarks run closed-loop with no Unity
process (the reference has no such capability and cannot be tested
without the simulator; see SURVEY.md §4).

Conventions match THOR where the framework touches them (reference:
mass/navigation_policy.py:78-132): y is up, rotation is clockwise
degrees with 0 facing +z, horizon positive looks down, depth images are
planar (distance along the camera axis).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from mass_tpu_torch import taxonomy
from mass_tpu_torch.config import CameraConfig
from mass_tpu_torch.env.protocol import AgentPose

_SNAKE = re.compile(r"(?<!^)(?=[A-Z])")


def snake_case(name: str) -> str:
    return _SNAKE.sub("_", name).lower()


@dataclasses.dataclass
class ObjectInstance:
    name: str
    class_id: int
    position: np.ndarray       # (x, y_base, z) meters
    size: np.ndarray           # (sx, sy, sz) meters
    openness: Optional[float] = None
    broken: bool = False
    # per-instance RGB modulation of the class color (THOR objects of
    # one class differ in texture/material; this is the grid-world
    # analogue that gives appearance-based matching something the
    # semantic channel cannot see)
    tint: Optional[np.ndarray] = None

    @property
    def aabb(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.asarray([self.position[0] - self.size[0] / 2,
                         self.position[1],
                         self.position[2] - self.size[2] / 2])
        hi = lo + np.asarray([self.size[0], self.size[1], self.size[2]])
        return lo, hi

    def pose_dict(self) -> Dict:
        lo, hi = self.aabb
        corners = np.stack(np.meshgrid(*zip(lo, hi), indexing="ij"),
                           axis=-1).reshape(8, 3)
        return dict(
            name=self.name,
            type=taxonomy.CLASS_NAMES[self.class_id],
            position=dict(x=float(self.position[0]),
                          y=float(self.position[1]),
                          z=float(self.position[2])),
            bounding_box=corners.tolist(),
            openness=self.openness,
            broken=self.broken)


def _ray_aabb_planar(origin, dirs, lo, hi):
    """Planar-depth intersection of unnormalized rays with one AABB.

    ``dirs [N, 3]`` have unit length along the camera axis, so the hit
    parameter t IS the planar depth.  Returns t (+inf on miss).
    """
    inv = 1.0 / np.where(np.abs(dirs) < 1e-9,
                         np.where(dirs < 0, -1e-9, 1e-9), dirs)
    t0 = (lo[None] - origin[None]) * inv
    t1 = (hi[None] - origin[None]) * inv
    tmin = np.minimum(t0, t1).max(axis=1)
    tmax = np.maximum(t0, t1).min(axis=1)
    hit = (tmax >= np.maximum(tmin, 1e-6))
    return np.where(hit, np.maximum(tmin, 1e-6), np.inf)


_NATIVE_RENDER = "unset"


def _native_renderer():
    """ctypes handle to the C++ render core (or None -> numpy path)."""
    global _NATIVE_RENDER
    if _NATIVE_RENDER == "unset":
        import ctypes

        from mass_tpu_torch import native

        lib = native.load("gridworld_render")
        if lib is None:
            _NATIVE_RENDER = None
        else:
            f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
            f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
            i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
            fn = lib.gridworld_render
            fn.restype = None
            fn.argtypes = [ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_double, f64, ctypes.c_double,
                           ctypes.c_double, ctypes.c_int32, f64, f64,
                           i32, i32, f32, i32, i32]
            _NATIVE_RENDER = fn
    return _NATIVE_RENDER


class GridWorld:
    """One room state (a set of object instances + geometry).

    ``walls`` are interior wall segments — (lo, hi) sim-frame AABBs,
    rendered and collided like the perimeter (class 0 OccupiedSpace).
    Multi-room layouts (walls with doorway gaps) create the occluded-
    exploration regime where one vantage point no longer reveals the
    scene and directed semantic search can beat random goal sampling
    (the reference's core claim; reference: agent.py:744-770)."""

    WALL_THICKNESS = 0.05

    def __init__(self, room_size=(6.0, 2.5, 6.0),
                 objects: Optional[List[ObjectInstance]] = None,
                 walls: Optional[List[Tuple[np.ndarray,
                                            np.ndarray]]] = None):
        self.room_size = np.asarray(room_size, np.float64)
        self.objects: List[ObjectInstance] = objects or []
        self.walls: List[Tuple[np.ndarray, np.ndarray]] = walls or []

    def clone(self) -> "GridWorld":
        return GridWorld(tuple(self.room_size),
                         [dataclasses.replace(
                             o, position=o.position.copy(),
                             size=o.size.copy(),
                             tint=(None if o.tint is None
                                   else o.tint.copy()))
                          for o in self.objects],
                         [(lo.copy(), hi.copy())
                          for lo, hi in self.walls])

    def static_boxes(self):
        """Floor, ceiling and four walls as (lo, hi, class 0)."""
        sx, sy, sz = self.room_size
        t = self.WALL_THICKNESS
        boxes = [
            (np.asarray([0, -t, 0.]), np.asarray([sx, 0, sz])),      # floor
            (np.asarray([-t, 0, 0.]), np.asarray([0, sy, sz])),      # x=0
            (np.asarray([sx, 0, 0.]), np.asarray([sx + t, sy, sz])),
            (np.asarray([0, 0, -t]), np.asarray([sx, sy, 0])),       # z=0
            (np.asarray([0, 0, sz]), np.asarray([sx, sy, sz + t])),
        ]
        boxes += [(np.asarray(lo, np.float64), np.asarray(hi, np.float64))
                  for lo, hi in self.walls]
        return boxes

    def _world_boxes(self):
        """All render boxes (statics first, then objects — render
        priority order under the strict '<' closest-hit rule) as world
        frame (x, z_sim, y_up) arrays: lo [n,3], hi [n,3], class ids
        [n], object indices [n] (-1 for statics)."""
        los, his, cls, idx = [], [], [], []
        for lo_sim, hi_sim in self.static_boxes():
            los.append([lo_sim[0], lo_sim[2], lo_sim[1]])
            his.append([hi_sim[0], hi_sim[2], hi_sim[1]])
            cls.append(0)
            idx.append(-1)
        for k, obj in enumerate(self.objects):
            lo_sim, hi_sim = obj.aabb
            los.append([lo_sim[0], lo_sim[2], lo_sim[1]])
            his.append([hi_sim[0], hi_sim[2], hi_sim[1]])
            cls.append(obj.class_id)
            idx.append(k)
        return (np.asarray(los, np.float64), np.asarray(his, np.float64),
                np.asarray(cls, np.int32), np.asarray(idx, np.int32))

    def render(self, camera: CameraConfig, pose: AgentPose,
               camera_height_m: float = 1.575,
               crouch_offset: float = 0.675):
        """Analytic RGB-D + semantic render.

        Returns (rgb [h, w, 3] in 0-1, depth [h, w, 1] planar meters,
        semantic [h, w, 1] int32 class ids).

        The ray-vs-boxes core runs in the native C++ engine when
        available (mass_tpu_torch/native — the analogue of the reference's
        native Unity renderer, SURVEY.md §2.2 L0) with this numpy
        implementation as the always-correct fallback; parity between
        the two is pinned by tests/test_native_render.py.
        """
        h, w = camera.height, camera.width
        f = camera.focal_length
        yaw = np.pi / 2 - np.radians(pose.rotation_degrees)
        elev = -np.radians(pose.horizon_degrees)
        # world frame here: (wx, wy, wz) = (sim x, sim z, sim y-up)
        cam_y = pose.y + (camera_height_m if pose.standing
                          else camera_height_m - crouch_offset)
        origin = np.asarray([pose.x, pose.z, cam_y])
        box_lo, box_hi, box_cls, box_idx = self._world_boxes()

        native = _native_renderer()
        if native is not None:
            depth = np.empty((h, w), np.float32)
            best_cls = np.empty((h, w), np.int32)
            best_obj = np.empty((h, w), np.int32)
            native(h, w, float(f), origin, float(yaw), float(elev),
                   len(box_cls), box_lo, box_hi, box_cls, box_idx,
                   depth, best_cls, best_obj)
            depth = depth.reshape(h, w, 1)
            semantic = best_cls.reshape(h, w, 1)
            best_obj = best_obj.reshape(-1)
        else:
            ys, xs = np.meshgrid(np.arange(h), np.arange(w),
                                 indexing="ij")
            rx = (xs - 0.5 * (w - 1)) / f
            ry = -(ys - 0.5 * (h - 1)) / f
            cam_dirs = np.stack([rx, ry, -np.ones_like(rx)],
                                axis=-1).reshape(-1, 3)

            def sph(a, b):
                return np.asarray([np.cos(a) * np.cos(b),
                                   np.sin(a) * np.cos(b), np.sin(b)])
            eye = sph(yaw, elev)
            up = sph(yaw, elev + np.pi / 2)
            rot = np.stack([np.cross(eye, up), up, -eye], axis=-1)
            world_dirs = cam_dirs @ rot.T   # (x, z_sim, y_up) frame

            best_t = np.full(world_dirs.shape[0], np.inf)
            best_cls = np.zeros(world_dirs.shape[0], np.int32)
            best_obj = np.full(world_dirs.shape[0], -1, np.int32)
            for b in range(len(box_cls)):
                t = _ray_aabb_planar(origin, world_dirs,
                                     box_lo[b], box_hi[b])
                closer = t < best_t
                best_t = np.where(closer, t, best_t)
                best_cls = np.where(closer, box_cls[b], best_cls)
                best_obj = np.where(closer, box_idx[b], best_obj)

            depth = np.where(np.isfinite(best_t), best_t, 0.0)
            depth = depth.reshape(h, w, 1).astype(np.float32)
            semantic = best_cls.reshape(h, w, 1).astype(np.int32)
        colors = taxonomy.class_colors_array()
        rgb = colors[semantic[..., 0]].astype(np.float32)
        # per-instance appearance: modulate the class color by the
        # instance tint (semantic ids stay class-level, so only
        # RGB-derived features can tell same-class instances apart)
        tints = np.ones((len(self.objects) + 1, 3), np.float32)
        for k, obj in enumerate(self.objects):
            if obj.tint is not None:
                tints[k] = obj.tint
        rgb = rgb * tints[best_obj.reshape(h, w)]
        return rgb, depth, semantic

    # -------------------------------------------------------- physics

    def blocked(self, x: float, z: float, agent_radius: float = 0.2,
                ignore: Optional[str] = None) -> bool:
        sx, _, sz = self.room_size
        if not (agent_radius <= x <= sx - agent_radius and
                agent_radius <= z <= sz - agent_radius):
            return True
        for lo, hi in self.walls:     # interior walls span full height
            if (lo[0] - agent_radius <= x <= hi[0] + agent_radius and
                    lo[2] - agent_radius <= z <= hi[2] + agent_radius):
                return True
        for obj in self.objects:
            if ignore is not None and obj.name == ignore:
                continue
            lo, hi = obj.aabb
            if (lo[0] - agent_radius <= x <= hi[0] + agent_radius and
                    lo[2] - agent_radius <= z <= hi[2] + agent_radius):
                return True
        return False

    def nearest_of_class(self, class_id: int, x: float, z: float,
                         max_distance: float = 1.5,
                         ) -> Optional[ObjectInstance]:
        best, best_d = None, max_distance
        for obj in self.objects:
            if obj.class_id != class_id:
                continue
            d = float(np.hypot(obj.position[0] - x, obj.position[2] - z))
            if d <= best_d:
                best, best_d = obj, d
        return best
