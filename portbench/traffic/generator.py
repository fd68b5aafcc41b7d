"""The one traffic generator: everything a cell feeds the agent, made from
``--seed`` and a traffic file's parameters.

  * houses: the grid world's rearrangement scene
    (``env/rearrange.generate_episode`` with ``num_rooms``): a closed
    room of ``room`` metres (floor, ceiling, perimeter walls: class 0)
    cut into ``rooms`` connected rooms by interior walls with doorways
    (class 0), and ``objects`` pickable plus ``opened`` openable
    axis-aligned boxes of distinct classes, kept clear of the doors;
  * trajectories: an agent that looks down once and then pursues one
    mission after another, as the agent's navigation does: each mission's
    goal is drawn among the places it can reach, and every step follows
    the breadth-first field to the goal (``reference/planner.distances``)
    over the lattice of THOR poses (0.25 m moves, 90 degree turns): it
    turns toward the next pose or moves to it, and ends the mission on
    arrival or after ``max_goal_steps`` plans, one frame a plan;
  * the houses and walks are the traffic's own (``world_seed``); the seed
    deals them to the episodes of each phase in another order, so that
    every seed runs the same work (correctness runs may draw the world
    from the seed instead: ``generate(..., world_seed=seed)``);
  * frames: planar-depth renders of the walks on the card (the grid
    world's analytic renderer: a ray's hit parameter is its planar depth),
    kept on the host as a simulator hands them over: uint8 RGB, float32
    depth, int32 class images, and each frame's pose, mission goal and
    the mission's count of plans so far;
  * the ticks whose outputs the check samples;
  * detector weights: a detectron2-layout Mask R-CNN R50-FPN state dict
    of random weights on the card, output layers tempered so that the
    heads score detections of moderate confidence;
  * backbone weights: a torchvision-layout stage-1 ResNet-50 state dict
    of random weights on the card (configurations with a ``backbone``).

World frame: (x, z, up) of THOR's (x, y-up, z); the map's camera sits at
``camera_height`` metres; yaw = pi/2 - rotation, elevation = -horizon.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from portbench.reference import planner
from portbench.reference import voxel

# detectron2's R50 stages and the output layers' tempering: each scaled
# weight matrix (rows centred first where listed) with a zero bias keeps
# the random heads' logits small enough that boxes stay near their
# anchors and class scores near the detection threshold
BLOCKS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
HEAD_SCALES = {"proposal_generator.rpn_head.anchor_deltas": 1e-7,
               "roi_heads.box_predictor.bbox_pred": 3e-6,
               "roi_heads.box_predictor.cls_score": 2e-5,
               "roi_heads.mask_head.predictor": 5e-6}
CENTRED = ("roi_heads.box_predictor.bbox_pred",
           "roi_heads.box_predictor.cls_score")
MOVE = 0.25                  # metres a THOR move
# a step toward (dj, di) on the lattice (x, z), tried in this order
STEPS = ((1, 0), (-1, 0), (0, 1), (0, -1))


class Inputs(NamedTuple):
    # frame-major: frame f of every episode is one contiguous block, as
    # a simulator's step hands the fleet its B observations
    rgb: np.ndarray          # [T, B, h, w, 3] uint8
    depth: np.ndarray        # [T, B, h, w] float32, planar metres
    classes: np.ndarray      # [T, B, h, w] int32
    position: np.ndarray     # [T, B, 3] float32 world
    yaw: np.ndarray          # [T, B] float32
    elevation: np.ndarray    # [T, B] float32
    origin: np.ndarray       # [B, 3] float32: each map's centre
    goals: np.ndarray        # [T, B, 2] float32 world (x, y): the mission's
    calls: np.ndarray        # [T, B] int32: the mission's plans before this
    checked: np.ndarray      # [max_ticks] bool: ticks the check samples
    backbone: Optional[Dict[str, torch.Tensor]]
    weights: Optional[Dict[str, torch.Tensor]]


def _streams(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, k])


class House(NamedTuple):
    lo: np.ndarray           # [n, 3] world boxes: statics, then objects
    hi: np.ndarray
    cls: np.ndarray          # [n]
    tint: np.ndarray         # [n, 3]
    solid_lo: np.ndarray     # [m, 2] (x, z) footprints that block moves
    solid_hi: np.ndarray


def _blocked(house: House, room, x, z, radius: float) -> np.ndarray:
    """Whether an agent of ``radius`` at ``(x, z)`` (arrays) collides with
    the perimeter, a wall or an object (``GridWorld.blocked``)."""
    x, z = np.asarray(x, np.float64), np.asarray(z, np.float64)
    out = ~((radius <= x) & (x <= room[0] - radius)
            & (radius <= z) & (z <= room[2] - radius))
    for (lx, lz), (hx, hz) in zip(house.solid_lo, house.solid_hi):
        out |= ((lx - radius <= x) & (x <= hx + radius)
                & (lz - radius <= z) & (z <= hz + radius))
    return out


def _house(rng, traffic, classes: int) -> House:
    """One scene of ``generate_episode`` (goal world): interior walls of
    ``interior_wall_layout``, then the objects placed clear of walls,
    objects and doors."""
    sx, sy, sz = traffic["room"]
    door, t = traffic["door_width"], traffic["wall_thickness"]
    walls, doors = [], []          # sim-frame (x, z) footprints

    def wall_x(wx, z0, z1):
        gap = rng.uniform(z0 + 0.4, max(z0 + 0.4, z1 - 0.4 - door))
        walls.extend([((wx - t / 2, z0), (wx + t / 2, gap)),
                      ((wx - t / 2, gap + door), (wx + t / 2, z1))])
        doors.append((wx, gap + door / 2))

    def wall_z(wz, x0, x1):
        gap = rng.uniform(x0 + 0.4, max(x0 + 0.4, x1 - 0.4 - door))
        walls.extend([((x0, wz - t / 2), (gap, wz + t / 2)),
                      ((gap + door, wz - t / 2), (x1, wz + t / 2))])
        doors.append((gap + door / 2, wz))

    rooms = traffic["rooms"]
    if rooms >= 2:
        wx = sx * rng.uniform(0.4, 0.6)
        wall_x(wx, 0.0, sz)
        if rooms >= 3:
            wz = sz * rng.uniform(0.4, 0.6)
            halves = [(0.0, wx - t / 2), (wx + t / 2, sx)]
            order = rng.permutation(2)
            wall_z(wz, *halves[order[0]])
            if rooms >= 4:
                wall_z(sz * rng.uniform(0.4, 0.6), *halves[order[1]])
    e = 0.05
    lo = [[0, 0, -e], [0, 0, sy], [-e, 0, 0], [sx, 0, 0], [0, -e, 0],
          [0, sz, 0]]
    hi = [[sx, sz, 0], [sx, sz, sy + e], [0, sz, sy], [sx + e, sz, sy],
          [sx, 0, sy], [sx, sz + e, sy]]
    lo += [[a[0], a[1], 0.0] for a, _ in walls]
    hi += [[b[0], b[1], sy] for _, b in walls]
    cls = [0] * len(lo)
    tint = [[1.0, 1.0, 1.0]] * len(lo)
    house = House(None, None, None, None,
                  np.asarray([a for a, _ in walls], np.float64).reshape(-1, 2),
                  np.asarray([b for _, b in walls], np.float64).reshape(-1, 2))
    n_pick, n_open = traffic["objects"], traffic["opened"]
    picks = rng.choice(np.arange(1, classes), n_pick + n_open, replace=False)
    for k, c in enumerate(picks):
        size = rng.uniform(*traffic["object_size" if k < n_pick
                                     else "opened_size"], 3)
        for _ in range(200):
            x, z = rng.uniform(0.8, sx - 0.8), rng.uniform(0.8, sz - 0.8)
            if not _blocked(house, traffic["room"], x, z, 0.45) and all(
                    math.hypot(x - dx, z - dz) > 0.9 for dx, dz in doors):
                break
        else:
            raise RuntimeError("could not place an object")
        box_lo = (x - size[0] / 2, z - size[2] / 2)
        box_hi = (box_lo[0] + size[0], box_lo[1] + size[2])
        house = house._replace(
            solid_lo=np.concatenate([house.solid_lo, [box_lo]]),
            solid_hi=np.concatenate([house.solid_hi, [box_hi]]))
        lo.append([box_lo[0], box_lo[1], 0.0])
        hi.append([box_hi[0], box_hi[1], size[1]])
        cls.append(int(c))
        tint.append(list(rng.uniform(0.7, 1.0, 3)))
    return house._replace(lo=np.asarray(lo, np.float64),
                          hi=np.asarray(hi, np.float64),
                          cls=np.asarray(cls, np.int64),
                          tint=np.asarray(tint, np.float32))


def _lattice(house: House, room, x0: float, z0: float, radius: float):
    """The THOR poses reachable by moves from ``(x0, z0)``: node ``(i,
    j)`` at ``(x0 + j * MOVE, z0 + i * MOVE)`` over the room, as a
    planner mesh whose edges join free neighbours.  Returns the mesh and
    the start's node."""
    j = np.arange(-int(x0 // MOVE), int((room[0] - x0) // MOVE) + 1)
    i = np.arange(-int(z0 // MOVE), int((room[2] - z0) // MOVE) + 1)
    xs, zs = x0 + j * MOVE, z0 + i * MOVE
    free = ~_blocked(house, room, xs[None, :], zs[:, None], radius)
    right = np.zeros_like(free)
    right[:, :-1] = free[:, :-1] & free[:, 1:]
    down = np.zeros_like(free)
    down[:-1] = free[:-1] & free[1:]
    mesh = planner.Mesh(free, right, down, 0, 0)
    return mesh, (xs, zs), (int(np.flatnonzero(i == 0)[0]),
                            int(np.flatnonzero(j == 0)[0]))


def _walk(rng, traffic, house: House):
    """``[T, 4]`` poses (x, z, rotation degrees, horizon degrees), ``[T,
    2]`` mission goals (x, z) and ``[T]`` the mission's plans so far."""
    room = traffic["room"]
    for _ in range(200):
        x, z = rng.uniform(0.6, room[0] - 0.6), rng.uniform(0.6, room[2] - 0.6)
        if not _blocked(house, room, x, z, 0.3):
            break
    else:
        raise RuntimeError("could not place the agent")
    rot, horizon = 90.0 * rng.integers(4), traffic["horizon"]
    mesh, (xs, zs), (ai, aj) = _lattice(house, room, x, z,
                                        traffic["agent_radius"])
    poses, goals, calls = [], [], []
    field, goal, k = None, None, 0
    for _ in range(traffic["frames_per_episode"]):
        if field is None:
            # a new mission: a goal among the places the agent reaches
            here = np.zeros_like(mesh.alive)
            here[ai, aj] = True
            reach = planner.distances(mesh, here)
            gi, gj = np.argwhere((reach > 0) & (reach < planner.INF))[
                rng.integers(int(((reach > 0) & (reach < planner.INF)).sum()))]
            seed = np.zeros_like(mesh.alive)
            seed[gi, gj] = True
            field = planner.distances(mesh, seed)
            goal = (xs[gj] + rng.uniform(-0.1, 0.1),
                    zs[gi] + rng.uniform(-0.1, 0.1))
            k = 0
        poses.append((xs[aj], zs[ai], rot, horizon))
        goals.append(goal)
        calls.append(k)
        k += 1
        d = field[ai, aj]
        if d == 0 or k >= traffic["max_goal_steps"]:
            field = None           # arrived or out of plans: no step
            continue
        dj, di = next((dj, di) for dj, di in STEPS
                      if 0 <= ai + di < field.shape[0]
                      and 0 <= aj + dj < field.shape[1]
                      and field[ai + di, aj + dj] == d - 1
                      and (mesh.right if di == 0 else mesh.down)[
                          ai + min(di, 0), aj + min(dj, 0)])
        h = math.radians(rot)
        fwd = (round(math.sin(h)), round(math.cos(h)))
        if fwd == (dj, di):
            ai, aj = ai + di, aj + dj                       # move_ahead
        else:
            h = math.radians(rot + 90.0)
            right = (round(math.sin(h)), round(math.cos(h)))
            rot = (rot + (90.0 if right == (dj, di) else -90.0)) % 360
    return (np.asarray(poses, np.float64), np.asarray(goals, np.float64),
            np.asarray(calls, np.int32))


def _render(rays, origins, rotations, lo, hi, cls, tint, palette):
    """Frames of one room: ``origins [F, 3]``, ``rotations [F, 3, 3]``
    -> (rgb uint8, depth, classes), on the rays' device."""
    dev = rays.device
    cam = rays.reshape(-1, 3)
    rot = torch.as_tensor(rotations, device=dev)
    dirs = torch.einsum("pj,fij->fpi", cam.double(), rot.double()).float()
    o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    safe = torch.where(dirs.abs() < 1e-9,
                       torch.where(dirs < 0, -1e-9, 1e-9), dirs)
    inv = (1.0 / safe)[:, :, None, :]                     # [F, P, 1, 3]
    t0 = (lo[None, None] - o[:, None, None]) * inv
    t1 = (hi[None, None] - o[:, None, None]) * inv
    near = torch.minimum(t0, t1)
    tmin, face = near.max(-1)
    tmax = torch.maximum(t0, t1).min(-1).values
    hit = tmax >= tmin.clamp_min(1e-6)
    t = torch.where(hit, tmin.clamp_min(1e-6),
                    torch.full_like(tmin, float("inf")))
    depth, box = t.min(-1)                                # first on ties
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    face = torch.gather(face, 2, box[..., None])[..., 0]
    shade = torch.tensor([0.8, 0.9, 1.0], device=dev)[face]
    cls_t = torch.as_tensor(cls, device=dev)[box]
    color = (torch.as_tensor(palette, device=dev)[cls_t]
             * torch.as_tensor(tint, device=dev)[box] * shade[..., None])
    rgb = (color * 255.0).round().clamp(0, 255).to(torch.uint8)
    shape = (origins.shape[0],) + tuple(rays.shape[:2])
    return (rgb.view(*shape, 3), depth.view(shape),
            cls_t.to(torch.int32).view(shape))


def generate(traffic: Dict, config: Dict, seed: int, device,
             world_seed: Optional[int] = None) -> Inputs:
    """The cell's inputs from ``seed``: the same seed, the same inputs.
    ``world_seed`` replaces the traffic's own world (houses and walks)."""
    B, T = traffic["batch"], traffic["frames_per_episode"]
    size, classes = config["camera_size"], config["num_classes"]
    cam_h = traffic["camera_height"]
    palette = np.random.default_rng(traffic["palette_seed"]).uniform(
        0.15, 1.0, (classes, 3)).astype(np.float32)
    rays = voxel.camera_rays(size, config["vertical_fov"], device)
    # every seed runs the same houses and walks (the traffic's world),
    # dealt to other episodes of the same phase: the same work in another
    # order, so that the seed does not change how much a window holds
    world = _streams(traffic["world_seed"] if world_seed is None
                     else world_seed, 0)
    houses = [_house(world, traffic, classes) for _ in range(B)]
    walks = [_walk(world, traffic, house) for house in houses]
    order = _streams(seed, 4)
    slots = np.arange(B)
    for family in sorted(set(traffic["families"])):
        group = [e for e in range(B) if traffic["families"][e] == family]
        slots[group] = order.permutation(group)
    rgb = np.empty((T, B, size, size, 3), np.uint8)
    depth = np.empty((T, B, size, size), np.float32)
    cls = np.empty((T, B, size, size), np.int32)
    position = np.empty((T, B, 3), np.float32)
    yaw = np.empty((T, B), np.float32)
    elevation = np.empty((T, B), np.float32)
    goals = np.empty((T, B, 2), np.float32)
    calls = np.empty((T, B), np.int32)
    chunk = traffic["render_chunk"]
    for e in range(B):
        house = houses[slots[e]]
        poses, goals[:, e], calls[:, e] = walks[slots[e]]
        position[:, e] = np.stack([poses[:, 0], poses[:, 1],
                                   np.full(T, cam_h)], -1)
        yaw[:, e] = np.pi / 2 - np.radians(poses[:, 2])
        elevation[:, e] = -np.radians(poses[:, 3])
        rotations = np.stack([voxel.rotation(y, el)
                              for y, el in zip(yaw[:, e], elevation[:, e])])
        for s in range(0, T, chunk):
            out = _render(rays, position[s:s + chunk, e],
                          rotations[s:s + chunk], house.lo, house.hi,
                          house.cls, house.tint, palette)
            for dst, src in zip((rgb, depth, cls), out):
                dst[s:s + chunk, e] = src.cpu().numpy()
    checked = _streams(seed, 2).random(traffic["max_ticks"]) \
        < traffic["check_rate"]
    weights = None
    if config.get("sensor"):
        weights = detector_weights(config["num_classes"],
                                   int(_streams(seed, 3).integers(2 ** 62)),
                                   device)
    backbone = None
    if config.get("backbone"):
        backbone = backbone_weights(int(_streams(seed, 5).integers(2 ** 62)),
                                    device)
    return Inputs(rgb, depth, cls, position, yaw, elevation,
                  position[0].copy(), goals, calls, checked, backbone,
                  weights)


def _layout(num_classes: int):
    """``(key, shape, draw, scale)`` of every detectron2 tensor: ``draw``
    is ``normal`` (mean 0, std ``scale``), ``uniform`` (on ``scale``, a
    pair) or ``zeros``."""
    out = []

    def conv(key, cout, cin, k, bias=False, norm=True):
        out.append((f"{key}.weight", (cout, cin, k, k), "normal",
                    math.sqrt(2.0 / (cin * k * k))))
        if bias:
            out.append((f"{key}.bias", (cout,), "normal", 0.01))
        if norm:
            out.append((f"{key}.norm.weight", (cout,), "uniform", (0.9, 1.1)))
            out.append((f"{key}.norm.bias", (cout,), "normal", 0.01))
            out.append((f"{key}.norm.running_mean", (cout,), "normal", 0.01))
            out.append((f"{key}.norm.running_var", (cout,), "uniform",
                        (0.5, 1.5)))

    def dense(key, cout, cin):
        out.append((f"{key}.weight", (cout, cin), "normal",
                    math.sqrt(1.0 / cin)))
        out.append((f"{key}.bias", (cout,), "normal", 0.01))

    conv("backbone.bottom_up.stem.conv1", 64, 3, 7)
    cin = 64
    for s in range(4):
        w = WIDTHS[s]
        for b in range(BLOCKS[s]):
            pre = f"backbone.bottom_up.res{s + 2}.{b}"
            conv(f"{pre}.conv1", w, cin if b == 0 else w * 4, 1)
            conv(f"{pre}.conv2", w, w, 3)
            conv(f"{pre}.conv3", w * 4, w, 1)
            if b == 0:
                conv(f"{pre}.shortcut", w * 4, cin, 1)
                cin = w * 4
    for i in range(4):
        conv(f"backbone.fpn_lateral{i + 2}", 256, WIDTHS[i] * 4, 1,
             bias=True, norm=False)
        conv(f"backbone.fpn_output{i + 2}", 256, 256, 3, bias=True,
             norm=False)
    rpn = "proposal_generator.rpn_head"
    conv(f"{rpn}.conv", 256, 256, 3, bias=True, norm=False)
    conv(f"{rpn}.objectness_logits", 3, 256, 1, bias=True, norm=False)
    conv(f"{rpn}.anchor_deltas", 12, 256, 1, bias=True, norm=False)
    dense("roi_heads.box_head.fc1", 1024, 256 * 7 * 7)
    dense("roi_heads.box_head.fc2", 1024, 1024)
    dense("roi_heads.box_predictor.cls_score", num_classes + 1, 1024)
    dense("roi_heads.box_predictor.bbox_pred", num_classes * 4, 1024)
    for i in range(4):
        conv(f"roi_heads.mask_head.mask_fcn{i + 1}", 256, 256, 3,
             bias=True, norm=False)
    out.append(("roi_heads.mask_head.deconv.weight", (256, 256, 2, 2),
                "normal", math.sqrt(2.0 / 256)))
    out.append(("roi_heads.mask_head.deconv.bias", (256,), "normal", 0.01))
    conv("roi_heads.mask_head.predictor", num_classes, 256, 1, bias=True,
         norm=False)
    return out


def _draw(layout, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict of ``layout``'s tensors, drawn on ``device`` by one
    generator in two calls (all normal draws, all uniform draws)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = {kind: sum(math.prod(shape) for _, shape, d, _ in layout
                        if d == kind) for kind in ("normal", "uniform")}
    normal = torch.randn(counts["normal"], generator=gen, device=device)
    uniform = torch.rand(counts["uniform"], generator=gen, device=device)
    taken = {"normal": 0, "uniform": 0}
    sd = {}
    for key, shape, kind, scale in layout:
        n = math.prod(shape)
        draw = (normal if kind == "normal" else uniform)[
            taken[kind]:taken[kind] + n].view(shape)
        taken[kind] += n
        sd[key] = (draw * scale if kind == "normal"
                   else scale[0] + draw * (scale[1] - scale[0]))
    return sd


def detector_weights(num_classes: int, seed: int,
                     device) -> Dict[str, torch.Tensor]:
    """Random detectron2-layout weights, output layers tempered."""
    sd = _draw(_layout(num_classes), seed, device)
    for key, scale in HEAD_SCALES.items():
        w = sd[f"{key}.weight"]
        if key in CENTRED:
            w = w - w.mean(1, keepdim=True)
        sd[f"{key}.weight"] = w * scale
        sd[f"{key}.bias"] = torch.zeros_like(sd[f"{key}.bias"])
    return sd


def backbone_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """Random weights of torchvision's resnet50 stem and ``layer1`` (the
    stage-1 feature extractor), batch norm's step counters included."""
    layout = []

    def conv(key, bn, cout, cin, k):
        layout.append((f"{key}.weight", (cout, cin, k, k), "normal",
                       math.sqrt(2.0 / (cin * k * k))))
        layout.append((f"{bn}.weight", (cout,), "uniform", (0.9, 1.1)))
        layout.append((f"{bn}.bias", (cout,), "normal", 0.01))
        layout.append((f"{bn}.running_mean", (cout,), "normal", 0.01))
        layout.append((f"{bn}.running_var", (cout,), "uniform", (0.5, 1.5)))

    conv("conv1", "bn1", 64, 3, 7)
    for b in range(3):
        pre = f"layer1.{b}"
        conv(f"{pre}.conv1", f"{pre}.bn1", 64, 64 if b == 0 else 256, 1)
        conv(f"{pre}.conv2", f"{pre}.bn2", 64, 64, 3)
        conv(f"{pre}.conv3", f"{pre}.bn3", 256, 64, 1)
        if b == 0:
            conv(f"{pre}.downsample.0", f"{pre}.downsample.1", 256, 64, 1)
    sd = _draw(layout, seed, device)
    for key, *_ in layout:
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64, device=device)
    return sd
