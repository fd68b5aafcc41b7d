"""Two-phase rearrangement episodes over the procedural grid world.

Mirrors the external ``RearrangeTaskSampler`` contract the reference
drives (walkthrough task, then unshuffle task, per episode; ``env.poses``
-> (start, goal, current) pose lists; challenge metrics
``unshuffle/prop_fixed_strict`` etc.; reference: agent.py:149-203 usage
and the allenai rearrangement package it wraps), implemented standalone
so the full agent loop runs and is testable without Unity.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from mass_tpu_torch import taxonomy
from mass_tpu_torch.config import CameraConfig
from mass_tpu_torch.env.gridworld import GridWorld, ObjectInstance, snake_case
from mass_tpu_torch.env.protocol import AgentPose, StepResult

MOVE_MAGNITUDE = 0.25
ROTATE_DEGREES = 90.0
LOOK_DEGREES = 30.0
POSITION_TOLERANCE = 0.35
OPENNESS_TOLERANCE = 0.2
# reported agent y is camera-aligned, like THOR's agent location (the
# mapper subtracts only the crouch offset; reference:
# mass/navigation_policy.py:92-96)
CAMERA_HEIGHT = 1.575


def action_names() -> List[str]:
    names = ["done", "move_ahead", "move_back", "move_left",
             "move_right", "rotate_left", "rotate_right", "look_up",
             "look_down", "stand", "crouch",
             "drop_held_object_with_snap"]
    names += [f"pickup_{snake_case(n)}"
              for n, p in zip(taxonomy.CLASS_NAMES,
                              taxonomy.ID_TO_PICKABLE) if p]
    names += [f"open_by_type_{snake_case(n)}"
              for n, o in zip(taxonomy.CLASS_NAMES,
                              taxonomy.ID_TO_OPENABLE) if o]
    return names


def are_poses_equal(a: Dict, b: Dict,
                    position_tolerance: float = POSITION_TOLERANCE,
                    openness_tolerance: float = OPENNESS_TOLERANCE,
                    ) -> bool:
    """Simplified pose-equality criterion (the reference delegates to
    THOR's IoU/openness test, rearrange.environment)."""
    if a["openness"] is not None and b["openness"] is not None:
        if abs(a["openness"] - b["openness"]) > openness_tolerance:
            return False
    pa, pb = a["position"], b["position"]
    d = np.hypot(pa["x"] - pb["x"], pa["z"] - pb["z"])
    return bool(d <= position_tolerance)


class _Env:
    """The ``task.env`` facade: pose lists + equality test."""

    def __init__(self, episode: "RearrangeEpisode"):
        self._episode = episode

    @property
    def poses(self) -> Tuple[List[Dict], List[Dict], List[Dict]]:
        ep = self._episode
        order = [o.name for o in ep.goal_world.objects]

        def by_name(world):
            table = {o.name: o for o in world.objects}
            out = []
            for name in order:
                if name in table:
                    out.append(table[name].pose_dict())
                else:  # held by the agent: report at agent position
                    held = ep.held
                    d = held.pose_dict()
                    d["position"] = dict(x=ep.pose.x, y=0.0, z=ep.pose.z)
                    out.append(d)
            return out

        return (by_name(ep.start_world), by_name(ep.goal_world),
                by_name(ep.world))

    def are_poses_equal(self, a, b) -> bool:
        return are_poses_equal(a, b)

    def get_agent_location(self):
        pose = self._episode.pose
        return dataclasses.replace(
            pose, y=pose.y + CAMERA_HEIGHT).as_location_dict()


class RearrangeEpisode:
    """Scene triple (start / goal / current) + agent + phase machinery."""

    def __init__(self, goal_world: GridWorld, start_world: GridWorld,
                 agent_start: AgentPose, max_steps: int = 250,
                 camera: CameraConfig = CameraConfig(),
                 task_id: int = 0):
        self.goal_world = goal_world           # walkthrough poses
        self.start_world = start_world         # unshuffle initial poses
        self.world = start_world.clone()       # mutated during unshuffle
        self.agent_start = dataclasses.replace(agent_start)
        self.pose = dataclasses.replace(agent_start)
        self.max_steps = max_steps
        self.camera = camera
        self.task_id = task_id
        self.held: Optional[ObjectInstance] = None
        self.env = _Env(self)

    # agents see the goal scene during walkthrough, the live scene after
    def active_world(self, walkthrough: bool) -> GridWorld:
        return self.goal_world if walkthrough else self.world


class Phase:
    """One task phase (walkthrough or unshuffle) satisfying the Task
    protocol.

    ``one_phase`` mirrors the reference's one-phase task variant
    (reference: mass/thor/segmentation_config.py:484-598,
    OnePhaseSegmentationConfig with dual semantic sensors): a single
    unshuffle-phase task whose observations additionally carry the GOAL
    world's rendering from the same pose (``goal_semantic`` /
    ``goal_depth``), so agents can diff states without a walkthrough.
    """

    def __init__(self, episode: RearrangeEpisode, walkthrough: bool,
                 one_phase: bool = False):
        self.episode = episode
        self.walkthrough = walkthrough
        self.one_phase = one_phase
        self.steps_taken = 0
        self._done = False
        self._names = action_names()
        self.env = episode.env
        episode.pose = dataclasses.replace(episode.agent_start)

    # ------------------------------------------------------- protocol

    def action_names(self) -> List[str]:
        return self._names

    def is_done(self) -> bool:
        return self._done or self.steps_taken >= self.episode.max_steps

    def agent_location(self) -> AgentPose:
        pose = self.episode.pose
        return dataclasses.replace(pose, y=pose.y + CAMERA_HEIGHT)

    def get_observations(self) -> Dict:
        ep = self.episode
        rgb, depth, semantic = ep.active_world(self.walkthrough).render(
            ep.camera, ep.pose)
        obs = dict(rgb=rgb, depth=depth, semantic=semantic)
        if self.one_phase:
            gr, gd, gs = ep.goal_world.render(ep.camera, ep.pose)
            obs["goal_rgb"] = gr
            obs["goal_depth"] = gd
            obs["goal_semantic"] = gs
        return obs

    def step(self, action: int) -> StepResult:
        self.steps_taken += 1
        name = self._names[action]
        ok = self._apply(name)
        return StepResult(action_success=ok)

    # -------------------------------------------------------- actions

    def _apply(self, name: str) -> bool:
        ep = self.episode
        pose = ep.pose
        world = ep.active_world(self.walkthrough)
        if name == "done":
            self._done = True
            return True
        if name in ("move_ahead", "move_back", "move_left",
                    "move_right"):
            heading = np.radians(pose.rotation_degrees)
            fwd = np.asarray([np.sin(heading), np.cos(heading)])
            right = np.asarray([np.cos(heading), -np.sin(heading)])
            delta = {"move_ahead": fwd, "move_back": -fwd,
                     "move_left": -right, "move_right": right}[name]
            nx = pose.x + MOVE_MAGNITUDE * float(delta[0])
            nz = pose.z + MOVE_MAGNITUDE * float(delta[1])
            if world.blocked(nx, nz):
                return False
            pose.x, pose.z = nx, nz
            return True
        if name == "rotate_left":
            pose.rotation_degrees = (pose.rotation_degrees -
                                     ROTATE_DEGREES) % 360
            return True
        if name == "rotate_right":
            pose.rotation_degrees = (pose.rotation_degrees +
                                     ROTATE_DEGREES) % 360
            return True
        if name == "look_up":
            if pose.horizon_degrees <= -30:
                return False
            pose.horizon_degrees -= LOOK_DEGREES
            return True
        if name == "look_down":
            if pose.horizon_degrees >= 60:
                return False
            pose.horizon_degrees += LOOK_DEGREES
            return True
        if name == "stand":
            pose.standing = True
            return True
        if name == "crouch":
            pose.standing = False
            return True

        if self.walkthrough:
            return False  # manipulation is unshuffle-only

        if name.startswith("pickup_"):
            if ep.held is not None:
                return False
            cls = _class_of_action(name, "pickup_")
            obj = ep.world.nearest_of_class(cls, pose.x, pose.z)
            if obj is None:
                return False
            ep.held = obj
            ep.world.objects.remove(obj)
            return True
        if name == "drop_held_object_with_snap":
            if ep.held is None:
                return False
            heading = np.radians(pose.rotation_degrees)
            drop = np.asarray([
                pose.x + 0.5 * np.sin(heading), 0.0,
                pose.z + 0.5 * np.cos(heading)])
            sx, _, sz = ep.world.room_size
            drop[0] = float(np.clip(drop[0], 0.1, sx - 0.1))
            drop[2] = float(np.clip(drop[2], 0.1, sz - 0.1))
            # snap: if the goal pose of the held object is nearby, place
            # exactly there (THOR's drop_held_object_with_snap semantics)
            goal = next((o for o in ep.goal_world.objects
                         if o.name == ep.held.name), None)
            if goal is not None and np.hypot(
                    goal.position[0] - drop[0],
                    goal.position[2] - drop[2]) < 1.0:
                drop = goal.position.copy()
            ep.held.position = np.asarray(
                [drop[0], ep.held.position[1] * 0.0, drop[2]])
            ep.world.objects.append(ep.held)
            ep.held = None
            return True
        if name.startswith("open_by_type_"):
            cls = _class_of_action(name, "open_by_type_")
            obj = ep.world.nearest_of_class(cls, pose.x, pose.z)
            if obj is None or obj.openness is None:
                return False
            goal = next((o for o in ep.goal_world.objects
                         if o.name == obj.name), None)
            obj.openness = goal.openness if goal is not None else 1.0
            return True
        return False

    # -------------------------------------------------------- metrics

    def metrics(self) -> Dict:
        ep = self.episode
        start, goal, current = ep.env.poses
        init_misplaced = [not are_poses_equal(s, g)
                          for s, g in zip(start, goal)]
        now_correct = [are_poses_equal(c, g)
                       for c, g in zip(current, goal)]
        num_init = sum(init_misplaced)
        num_fixed = sum(1 for m, c in zip(init_misplaced, now_correct)
                        if m and c)
        num_newly = sum(1 for m, c in zip(init_misplaced, now_correct)
                        if not m and not c)
        num_misplaced = sum(1 for c in now_correct if not c)
        prop = num_fixed / num_init if num_init else 1.0
        strict = prop if num_newly == 0 else 0.0
        return {
            "unshuffle/num_initially_misplaced": num_init,
            "unshuffle/num_fixed": num_fixed,
            "unshuffle/num_newly_misplaced": num_newly,
            "unshuffle/num_misplaced": num_misplaced,
            "unshuffle/prop_fixed": prop,
            "unshuffle/prop_fixed_strict": strict,
            "unshuffle/success": float(num_misplaced == 0),
            "unshuffle/ep_length": self.steps_taken,
            "task_id": ep.task_id,
        }


def _class_of_action(name: str, prefix: str) -> int:
    snake = name[len(prefix):]
    for i, cname in enumerate(taxonomy.CLASS_NAMES):
        if snake_case(cname) == snake:
            return i
    raise ValueError(name)


# --------------------------------------------------------------- sampler

def interior_wall_layout(rng: np.random.RandomState,
                         room: Tuple[float, float, float],
                         num_rooms: int,
                         door_width: float = 1.2,
                         thickness: float = 0.1):
    """Random interior walls partitioning the room into ``num_rooms``
    connected rooms (each wall carries one doorway gap, floor to
    ceiling).  Returns ``(walls, door_centers)`` — walls as sim-frame
    (lo, hi) AABBs, door centers as (x, z) for keep-clear checks.

    Layouts: 2 rooms = one full-span wall parallel to z; 3/4 rooms =
    that wall plus a perpendicular wall across one/both halves.  This
    creates the occluded-exploration regime of multi-room THOR scenes
    (SURVEY.md §6 notes search matters when one goal cannot reveal the
    scene; reference: agent.py:744-770)."""
    sx, sy, sz = room
    walls, doors = [], []
    if num_rooms <= 1:
        return walls, doors
    t = thickness

    def wall_x(wx, z0, z1):
        """Wall at constant x spanning [z0, z1] with a door gap."""
        gap = rng.uniform(z0 + 0.4, max(z0 + 0.4, z1 - 0.4 - door_width))
        walls.extend([
            (np.asarray([wx - t / 2, 0.0, z0]),
             np.asarray([wx + t / 2, sy, gap])),
            (np.asarray([wx - t / 2, 0.0, gap + door_width]),
             np.asarray([wx + t / 2, sy, z1]))])
        doors.append((wx, gap + door_width / 2))

    def wall_z(wz, x0, x1):
        gap = rng.uniform(x0 + 0.4, max(x0 + 0.4, x1 - 0.4 - door_width))
        walls.extend([
            (np.asarray([x0, 0.0, wz - t / 2]),
             np.asarray([gap, sy, wz + t / 2])),
            (np.asarray([gap + door_width, 0.0, wz - t / 2]),
             np.asarray([x1, sy, wz + t / 2]))])
        doors.append((gap + door_width / 2, wz))

    wx = sx * rng.uniform(0.4, 0.6)
    wall_x(wx, 0.0, sz)
    if num_rooms >= 3:
        wz = sz * rng.uniform(0.4, 0.6)
        halves = [(0.0, wx - t / 2), (wx + t / 2, sx)]
        order = rng.permutation(2)
        wall_z(wz, *halves[order[0]])
        if num_rooms >= 4:
            wall_z(sz * rng.uniform(0.4, 0.6), *halves[order[1]])
    return walls, doors


def generate_episode(seed: int, num_objects: int = 5,
                     num_misplaced: int = 2, num_opened: int = 1,
                     room: Tuple[float, float, float] = (6.0, 2.5, 6.0),
                     camera: CameraConfig = CameraConfig(),
                     max_steps: int = 250,
                     duplicate_class_pairs: int = 0,
                     num_rooms: int = 1,
                     ) -> RearrangeEpisode:
    """Random solvable episode: objects on the floor, a subset displaced
    (and/or openness-changed) in the unshuffle phase.

    ``duplicate_class_pairs`` adds K pairs of SAME-class, SAME-size
    objects with distinct per-instance tints, one member of each pair
    misplaced — the scenario where size-based instance matching is
    ambiguous and only appearance features can pair instances across
    phases (the reference's ``--use-feature-matching`` win,
    reference: README.md:39, mass/utils/experimentation.py:261-273).

    ``num_rooms`` >= 2 partitions the scene with interior walls +
    doorways (``interior_wall_layout``), so objects can be occluded in
    side rooms the agent must discover — the regime where semantic
    search matters."""
    rng = np.random.RandomState(seed)
    sx, _, sz = room

    pickable_ids = [i for i, p in enumerate(taxonomy.ID_TO_PICKABLE)
                    if p]
    openable_ids = [i for i, o in enumerate(taxonomy.ID_TO_OPENABLE)
                    if o]
    classes = list(rng.choice(pickable_ids, num_objects, replace=False))
    classes += list(rng.choice(openable_ids, num_opened, replace=False))

    walls, doors = interior_wall_layout(rng, room, num_rooms)

    def door_clear(x, z, clearance=0.9):
        return all(np.hypot(x - dx, z - dz) > clearance
                   for dx, dz in doors)

    def random_spot(world, size):
        for _ in range(200):
            x = rng.uniform(0.8, sx - 0.8)
            z = rng.uniform(0.8, sz - 0.8)
            # keep doorways passable: an object at a door gap plus the
            # planner's obstacle erosion could seal the only corridor
            if not world.blocked(x, z, agent_radius=0.45) and \
                    door_clear(x, z):
                return np.asarray([x, 0.0, z])
        raise RuntimeError("could not place object")

    goal_world = GridWorld(room, walls=walls)
    for k, cls in enumerate(classes):
        openable = taxonomy.ID_TO_OPENABLE[cls]
        size = rng.uniform(0.25, 0.55, 3) if not openable else \
            rng.uniform(0.5, 0.9, 3)
        pos = random_spot(goal_world, size)
        goal_world.objects.append(ObjectInstance(
            name=f"{taxonomy.CLASS_NAMES[cls]}_{k}", class_id=cls,
            position=pos, size=np.asarray(size),
            openness=0.0 if openable else None))

    # ambiguous same-class pairs: identical size, distinct tints
    dup_start = len(classes)
    if duplicate_class_pairs:
        remaining = [c for c in pickable_ids if c not in classes]
        dup_classes = rng.choice(remaining, duplicate_class_pairs,
                                 replace=False)
        for j, cls in enumerate(dup_classes):
            size = rng.uniform(0.3, 0.5, 3)
            for member in range(2):
                tint = np.full(3, 0.35 + 0.6 * member, np.float32)
                pos = random_spot(goal_world, size)
                goal_world.objects.append(ObjectInstance(
                    name=(f"{taxonomy.CLASS_NAMES[int(cls)]}_dup"
                          f"{j}_{member}"),
                    class_id=int(cls), position=pos,
                    size=size.copy(), tint=tint))

    start_world = goal_world.clone()
    moved = rng.choice(num_objects, min(num_misplaced, num_objects),
                       replace=False)
    for idx in moved:
        obj = start_world.objects[int(idx)]
        obj.position = random_spot(start_world, obj.size)
    for obj in start_world.objects[num_objects:dup_start]:
        obj.openness = 1.0  # openables start open; goal is closed
    # misplace one member of each duplicate pair (rng-chosen)
    for j in range(duplicate_class_pairs):
        obj = start_world.objects[dup_start + 2 * j + int(rng.randint(2))]
        obj.position = random_spot(start_world, obj.size)

    # agent start: any free cell
    for _ in range(200):
        ax, az = rng.uniform(0.6, sx - 0.6), rng.uniform(0.6, sz - 0.6)
        if not start_world.blocked(ax, az, agent_radius=0.3) and \
                not goal_world.blocked(ax, az, agent_radius=0.3):
            break
    agent = AgentPose(x=float(ax), y=0.0, z=float(az),
                      rotation_degrees=float(
                          rng.choice([0, 90, 180, 270])),
                      horizon_degrees=0.0)
    return RearrangeEpisode(goal_world, start_world, agent,
                            max_steps=max_steps, camera=camera,
                            task_id=seed)


class GridWorldTaskSampler:
    """Walkthrough/unshuffle task alternation over seeded episodes —
    the contract of the reference's RearrangeTaskSampler (reference:
    agent.py:140-203, 300-358: next_task() yields walkthrough, then the
    paired unshuffle, then the next episode's walkthrough...)."""

    def __init__(self, seeds, camera: CameraConfig = CameraConfig(),
                 max_steps: int = 250, one_phase: bool = False,
                 **episode_kwargs):
        self._seeds = list(seeds)
        self._camera = camera
        self._max_steps = max_steps
        self._one_phase = one_phase
        self._kwargs = episode_kwargs
        self._cursor = 0
        self._phase_is_walkthrough = True
        self.current_episode: Optional[RearrangeEpisode] = None

    def __len__(self):
        return len(self._seeds) if self._one_phase else \
            2 * len(self._seeds)

    def next_task(self) -> Phase:
        if self._one_phase:
            seed = self._seeds[self._cursor]
            self._cursor += 1
            self.current_episode = generate_episode(
                seed, camera=self._camera, max_steps=self._max_steps,
                **self._kwargs)
            return Phase(self.current_episode, walkthrough=False,
                         one_phase=True)
        if self._phase_is_walkthrough:
            seed = self._seeds[self._cursor]
            self.current_episode = generate_episode(
                seed, camera=self._camera, max_steps=self._max_steps,
                **self._kwargs)
            self._phase_is_walkthrough = False
            return Phase(self.current_episode, walkthrough=True)
        self._phase_is_walkthrough = True
        self._cursor += 1
        return Phase(self.current_episode, walkthrough=False)

    def skip_task(self) -> None:
        if not self._phase_is_walkthrough:
            self._phase_is_walkthrough = True
            self._cursor += 1
        else:
            self._cursor += 1

    def reset(self) -> None:
        self._cursor = 0
        self._phase_is_walkthrough = True
