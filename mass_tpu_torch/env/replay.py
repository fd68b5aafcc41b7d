"""Recorded-trajectory environment: serialize and replay episodes (port
of ``mass_tpu.env.replay``).

The Task seam means a stream of recorded (rgb, depth, semantic, pose)
frames is a complete environment (SURVEY.md §4.2; the observation
contract mirrors the reference's projection-layer input, reference:
mass/nn/base_projection_layer.py:282-306).  Recording a live episode and
replaying it bit-identically removes the simulator from parity runs:
the only path to numeric comparison against real THOR captures on hosts
with no Unity.  Captures are the JAX package's files, so either package
replays the other's.

    rec = TrajectoryRecorder(task)
    ... drive rec like the task ...
    rec.save("episode.npz")
    replayed = ReplayTask("episode.npz")

One-command capture on any host (every ``agent.cli`` backend and sensor
flag passes through), then replay through the mapping pipeline and diff
against another host's capture:

    python -m mass_tpu_torch.env.replay capture --out ep.npz --frames 40 \
        --backend thor --stage val --camera-size 224
    python -m mass_tpu_torch.env.replay verify ep.npz --digest d.json
    python -m mass_tpu_torch.env.replay diff ep.npz other.npz

``capture`` drives a deterministic scripted sweep (seeded choice over
the movement/rotation actions), so two captures of the same scene on
two hosts are comparable frame by frame; ``verify`` replays the frames
through an occupancy and a semantic map at the configured geometry on
``--device`` (default ``cuda``; each map updated on its own, one
single-map splat a map and frame) and prints a JSON digest (per-stream
checksums and final map statistics, the JAX package's keys) that can be
committed as a parity fixture.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from mass_tpu_torch.env.protocol import AgentPose, StepResult

_POSE_FIELDS = ("x", "y", "z", "rotation_degrees", "horizon_degrees",
                "standing")


def _pose_row(pose: AgentPose) -> List[float]:
    return [pose.x, pose.y, pose.z, pose.rotation_degrees,
            pose.horizon_degrees, float(pose.standing)]


class TrajectoryRecorder:
    """Task decorator that captures everything the pipeline consumes.

    Frames are fetched lazily (one render per timestep, repeated
    ``get_observations`` calls within a step return the same frame, as
    live simulators do for an unchanged state)."""

    def __init__(self, task):
        self._task = task
        self.frames: List[Dict[str, np.ndarray]] = []
        self.poses: List[List[float]] = []
        self.actions: List[int] = []
        self.success: List[bool] = []
        self.done: List[bool] = []
        self._t = 0

    def get_observations(self) -> Dict[str, Any]:
        if len(self.frames) <= self._t:
            obs = self._task.get_observations()
            self.frames.append({
                k: np.asarray(v) for k, v in obs.items()
                if isinstance(v, (np.ndarray, list)) or hasattr(
                    v, "__array__")})
            self.poses.append(_pose_row(self._task.agent_location()))
        return dict(self.frames[self._t])

    def step(self, action: int) -> StepResult:
        self.get_observations()          # ensure pre-step frame exists
        result = self._task.step(action)
        self.actions.append(int(action))
        self.success.append(bool(result.action_success))
        self.done.append(bool(self._task.is_done()))
        self._t += 1
        return result

    def __getattr__(self, name):
        return getattr(self._task, name)

    def save(self, path: str) -> str:
        self.get_observations()          # final frame
        keys = sorted(self.frames[0])
        arrays = {f"frame_{k}": np.stack([f[k] for f in self.frames])
                  for k in keys}
        meta = dict(action_names=self._task.action_names(),
                    frame_keys=keys)
        np.savez_compressed(
            path, poses=np.asarray(self.poses, np.float64),
            actions=np.asarray(self.actions, np.int64),
            success=np.asarray(self.success, bool),
            done=np.asarray(self.done, bool),
            meta=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8),
            **arrays)
        return path


class ReplayTask:
    """Task-protocol playback of a recorded episode.

    ``strict`` asserts the caller takes exactly the recorded actions —
    a deterministic agent replayed on its own trajectory must agree;
    disagreement means the pipeline drifted."""

    def __init__(self, path: str, strict: bool = True):
        data = np.load(path)
        meta = json.loads(bytes(data["meta"]).decode())
        self._action_names = meta["action_names"]
        self._frames = {k: data[f"frame_{k}"]
                        for k in meta["frame_keys"]}
        self._poses = data["poses"]
        self._actions = data["actions"]
        self._success = data["success"]
        self._done = data["done"]
        self.strict = strict
        self._t = 0

    def __len__(self) -> int:
        return int(self._actions.shape[0])

    def get_observations(self) -> Dict[str, Any]:
        t = min(self._t, self._poses.shape[0] - 1)
        return {k: v[t] for k, v in self._frames.items()}

    def step(self, action: int) -> StepResult:
        t = self._t
        if t >= self._actions.shape[0]:
            return StepResult(action_success=False,
                              info=dict(exhausted=True))
        if self.strict and int(action) != int(self._actions[t]):
            raise ValueError(
                f"replay divergence at step {t}: recorded action "
                f"{self._action_names[self._actions[t]]}, got "
                f"{self._action_names[action]}")
        self._t += 1
        return StepResult(action_success=bool(self._success[t]))

    def is_done(self) -> bool:
        if self._t == 0:
            return False
        if self._t > self._actions.shape[0]:
            return True
        return bool(self._done[min(self._t, len(self._done)) - 1])

    def action_names(self) -> List[str]:
        return list(self._action_names)

    def agent_location(self) -> AgentPose:
        t = min(self._t, self._poses.shape[0] - 1)
        row = self._poses[t]
        return AgentPose(x=float(row[0]), y=float(row[1]),
                         z=float(row[2]), rotation_degrees=float(row[3]),
                         horizon_degrees=float(row[4]),
                         standing=bool(row[5]))


def record_episode(task, path: str, actions: Optional[List[int]] = None,
                   max_steps: int = 100) -> TrajectoryRecorder:
    """Drive ``task`` with an explicit action list (or until done) while
    recording; convenience for building replay fixtures."""
    rec = TrajectoryRecorder(task)
    for i in range(max_steps if actions is None else len(actions)):
        rec.get_observations()
        if rec.is_done():
            break
        a = actions[i] if actions is not None else 0
        rec.step(a)
    rec.save(path)
    return rec


# --------------------------------------------------------------- CLI

def scripted_actions(action_names: List[str], n: int,
                     seed: int = 0) -> List[int]:
    """Deterministic pose sweep: seeded uniform choice over the
    movement/rotation/look actions (never ``done`` or manipulation), so
    a capture exercises the full obs/pose contract and two hosts
    capturing the same scene stay comparable."""
    movers = [i for i, name in enumerate(action_names)
              if any(k in name.lower() for k in
                     ("ahead", "back", "left", "right", "rotate",
                      "look", "stand", "crouch"))]
    if not movers:
        movers = list(range(len(action_names)))
    rng = np.random.RandomState(seed)
    return [movers[rng.randint(len(movers))] for _ in range(n)]


def pose_to_map_args(pose: AgentPose):
    """(position, yaw, elevation) for map updates from a recorded pose
    — the same THOR-convention transform the agent applies live
    (nav/controller.py process_position/yaw/elevation; parity pinned by
    tests/test_torch_replay.py)."""
    from mass_tpu_torch.nav.controller import CROUCH_HEIGHT_OFFSET
    dy = 0.0 if pose.standing else CROUCH_HEIGHT_OFFSET
    position = np.asarray([pose.x, pose.z, pose.y - dy], np.float32)
    yaw = float(np.pi / 2 - np.radians(pose.rotation_degrees))
    elevation = float(-np.radians(pose.horizon_degrees))
    return position, yaw, elevation


def replay_digest(path: str, cli_args: Optional[List[str]] = None
                  ) -> Dict[str, Any]:
    """Replay a capture through the mapping pipeline and digest it.

    Streams every recorded frame into an occupancy and a semantic map
    built at the ``agent.cli`` geometry on ``--device`` (override with the
    usual flags in ``cli_args``), each map updated on its own as the JAX
    package does, and returns JSON-serializable checksums: per-stream
    sums and shapes plus final map statistics.  Two hosts that disagree
    anywhere in the observation contract or the map math produce
    different digests: this is the THOR-parity fixture format (SURVEY.md
    §4.2).  The map statistics are reduced on the host in float64, chunk
    by chunk, so the card's digest equals the CPU's.
    """
    from mass_tpu_torch import taxonomy
    from mass_tpu_torch.agent import cli as agent_cli
    from mass_tpu_torch.maps.layers import MapSet, OccupancyMap, SemanticMap

    args = agent_cli.build_parser().parse_args(cli_args or [])
    config = agent_cli.config_from_args(args)
    device = agent_cli.resolve_device_flags(args)

    task = ReplayTask(path, strict=False)
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())

    geo_kw = dict(map_height=config.map_height,
                  map_width=config.map_width,
                  map_depth=config.map_depth,
                  grid_resolution=config.grid_resolution)
    maps = MapSet(
        occupancy=OccupancyMap(config.camera, device=device, **geo_kw),
        semantic=SemanticMap(config.camera, taxonomy.NUM_CLASSES,
                             device=device, **geo_kw))

    digest: Dict[str, Any] = {
        "frames": len(task) + 1,
        "frame_keys": meta["frame_keys"],
        "streams": {},
    }
    for key in meta["frame_keys"]:
        arr = np.asarray(data[f"frame_{key}"], np.float64)
        digest["streams"][key] = {
            "shape": list(arr.shape),
            "sum": float(arr.sum()),
            "mean": float(arr.mean()),
        }
    digest["poses_sum"] = float(np.asarray(data["poses"]).sum())
    digest["actions"] = [int(a) for a in data["actions"]]

    n_frames = int(np.asarray(data["poses"]).shape[0])
    for t in range(n_frames):
        task._t = t
        obs = task.get_observations()
        position, yaw, elevation = pose_to_map_args(
            task.agent_location())
        frame = dict(obs, position=position, yaw=yaw,
                     elevation=elevation)
        maps.update_group(["occupancy"], frame)
        if "semantic" in frame:
            maps.update_group(["semantic"], frame)

    for name, layer in maps.items():
        grid = layer.voxel_map.grid()      # a sharded map gathers
        digest[f"map_{name}"] = map_statistics(
            grid.reshape(-1, grid.shape[-1]))
    return digest


def map_statistics(data, rows: int = 1 << 20) -> Dict[str, Any]:
    """Sum (accumulated in float64), non-zero count and max of a map's
    values, on the host, ``rows`` rows at a time: the same order on
    every device."""
    if data.numel() == 0:
        return {"sum": 0.0, "nonzero": 0, "max": 0.0}
    total, nonzero, peak = 0.0, 0, -np.inf
    for chunk in data.split(rows):
        vals = chunk.cpu().numpy()
        total += float(vals.sum(dtype=np.float64))
        nonzero += int(np.count_nonzero(vals))
        peak = max(peak, float(vals.max()))
    return {"sum": total, "nonzero": nonzero, "max": peak}


def diff_captures(path_a: str, path_b: str, rtol: float = 0.0
                  ) -> List[str]:
    """Frame-stream comparison of two captures; returns human-readable
    divergence lines (empty = identical within ``rtol``)."""
    a, b = np.load(path_a), np.load(path_b)
    meta_a = json.loads(bytes(a["meta"]).decode())
    meta_b = json.loads(bytes(b["meta"]).decode())
    out = []
    if meta_a["frame_keys"] != meta_b["frame_keys"]:
        out.append(f"frame keys differ: {meta_a['frame_keys']} vs "
                   f"{meta_b['frame_keys']}")
    for name in ("poses", "actions", "success", "done"):
        va, vb = np.asarray(a[name]), np.asarray(b[name])
        if va.shape != vb.shape:
            out.append(f"{name}: shape {va.shape} vs {vb.shape}")
        elif not np.allclose(va.astype(np.float64),
                             vb.astype(np.float64), rtol=rtol, atol=0):
            idx = int(np.argmax(~np.isclose(
                va.astype(np.float64), vb.astype(np.float64),
                rtol=rtol, atol=0).reshape(va.shape[0], -1).all(1)))
            out.append(f"{name}: first divergence at step {idx}")
    for key in meta_a["frame_keys"]:
        ka = f"frame_{key}"
        if ka not in b:
            continue
        va, vb = np.asarray(a[ka]), np.asarray(b[ka])
        if va.shape != vb.shape:
            out.append(f"{key}: shape {va.shape} vs {vb.shape}")
            continue
        close = np.isclose(va.astype(np.float64),
                           vb.astype(np.float64), rtol=rtol, atol=0)
        if not close.all():
            per_frame = close.reshape(close.shape[0], -1).all(1)
            idx = int(np.argmax(~per_frame))
            frac = float(1.0 - close.mean())
            out.append(f"{key}: first divergence at frame {idx} "
                       f"({frac:.2%} of elements differ)")
    return out


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    import sys
    p = argparse.ArgumentParser(
        "mass_tpu_torch replay capture/verify/diff",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    cap = sub.add_parser("capture", help="record a scripted episode "
                         "from any backend (agent.cli flags pass "
                         "through: --backend thor --stage val ...)")
    cap.add_argument("--out", required=True)
    cap.add_argument("--frames", type=int, default=40)
    cap.add_argument("--script-seed", type=int, default=0)

    ver = sub.add_parser("verify", help="replay a capture through the "
                         "mapping pipeline; print a JSON digest "
                         "(agent.cli geometry and --device flags pass "
                         "through)")
    ver.add_argument("path")
    ver.add_argument("--digest", default=None,
                     help="also write the digest JSON here")

    dif = sub.add_parser("diff", help="compare two captures")
    dif.add_argument("path_a")
    dif.add_argument("path_b")
    dif.add_argument("--rtol", type=float, default=0.0)

    args, passthrough = p.parse_known_args(argv)

    if args.cmd == "capture":
        from mass_tpu_torch.agent import cli as agent_cli
        cli_args = agent_cli.build_parser().parse_args(passthrough)
        config = agent_cli.config_from_args(cli_args)
        sensor = agent_cli.load_segmentation_sensor(
            cli_args, agent_cli.resolve_device_flags(cli_args))
        sampler = agent_cli.make_sampler(cli_args, config, sensor=sensor)
        task = sampler.next_task()
        actions = scripted_actions(task.action_names(), args.frames,
                                   args.script_seed)
        rec = record_episode(task, args.out, actions=actions,
                             max_steps=args.frames)
        print(json.dumps({"out": args.out,
                          "frames": len(rec.frames),
                          "actions": len(rec.actions)}))
    elif args.cmd == "verify":
        digest = replay_digest(args.path, passthrough)
        text = json.dumps(digest, indent=2, sort_keys=True)
        if args.digest:
            with open(args.digest, "w") as f:
                f.write(text + "\n")
        print(text)
    else:
        lines = diff_captures(args.path_a, args.path_b, args.rtol)
        for line in lines:
            print(line)
        print("IDENTICAL" if not lines else
              f"DIVERGED ({len(lines)} streams)")
        if lines:
            sys.exit(1)


if __name__ == "__main__":
    main()
