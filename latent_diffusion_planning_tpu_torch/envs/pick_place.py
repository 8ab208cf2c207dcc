"""Can (pick-place) and Square (nut assembly), batched over envs: the
kinematic variants and what they share with the contact-physics ones.

Counterpart of ``latent_diffusion_planning_tpu/envs/pick_place.py``:

- **CanEnv**: pick the can from the source region and place it into the
  bin; success = can inside the bin region resting on its floor, not held
  (robosuite PickPlaceCan's ``_check_success``).
- **SquareEnv**: pick the square nut and drop it over the square peg;
  success = nut centred on the peg below its top, not held (robosuite
  NutAssemblySquare).

Both run the Panda arm (``envs/robosuite_arm.py``): OSC-style eef deltas
resolve through IK and rate-limited joint servos, ``robot0_eef_pos/quat``
come from forward kinematics. Here the object attaches kinematically to a
closed gripper near it; ``envs/pick_place_physics.py`` holds the contact
variants, the configs' default envs. Both share ``PandaTask``: the arm,
the seeded spawns (xy uniform in [``spawn_lo``, ``spawn_hi``], yaw in
±30°, drawn through ``reset_draws`` from the engine's per-episode
uniforms), the 14-dim robosuite ``object`` observation (xyzw quaternions)
and the arm-link prims of the scene. Every state field leads with the env
axis; images go through the ray-cast kernel (its plain twin on the CPU).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..ops import render as R
from ..ops import rotations as rot
from ..ops.kernels import raycast
from . import robosuite_arm as ra
from .lift import (EEF_SPEED, GRASP_RADIUS, GRAVITY_DZ, GRIPPER_SPEED,
                   TABLE_Z, WORK_HI, WORK_LO)
from .physics import kinematics as K

PANDA_CHAIN = ra.panda_chain(base_pos=(-0.56, 0.0, TABLE_Z))
START_EEF = (0.0, 0.0, TABLE_Z + 0.25)
# fk rows each arm-link box spans, and its half-width
LINK_SEGMENTS = ((1, 3, 0.045), (3, 5, 0.035), (5, 7, 0.03))
LINK_COLORS = ((0.65, 0.65, 0.7), (0.6, 0.6, 0.68), (0.55, 0.55, 0.65))
SPAWN_UNIFORMS = 3       # uniforms a reset draws per env: x, y, yaw

BIN_CENTER = (0.17, 0.15, TABLE_Z)
BIN_HALF = 0.055
BIN_WALL_H = 0.03
BIN_COLOR = (0.55, 0.45, 0.25)
# the bin's four walls: (centre, half-extents)
BIN_WALLS = (
    ((BIN_CENTER[0], BIN_CENTER[1] - BIN_HALF, TABLE_Z + BIN_WALL_H / 2),
     (BIN_HALF, 0.005, BIN_WALL_H / 2)),
    ((BIN_CENTER[0], BIN_CENTER[1] + BIN_HALF, TABLE_Z + BIN_WALL_H / 2),
     (BIN_HALF, 0.005, BIN_WALL_H / 2)),
    ((BIN_CENTER[0] - BIN_HALF, BIN_CENTER[1], TABLE_Z + BIN_WALL_H / 2),
     (0.005, BIN_HALF, BIN_WALL_H / 2)),
    ((BIN_CENTER[0] + BIN_HALF, BIN_CENTER[1], TABLE_Z + BIN_WALL_H / 2),
     (0.005, BIN_HALF, BIN_WALL_H / 2)),
)

PEG_X = 0.12
PEG_Y = 0.12
PEG_POS = (PEG_X, PEG_Y, TABLE_Z)
PEG_HALF_XY = 0.012
PEG_HALF_Z = 0.05
PEG_HALF = (PEG_HALF_XY, PEG_HALF_XY, PEG_HALF_Z)
PEG_COLOR = (0.4, 0.4, 0.45)
NUT_TOL = 0.02


class PandaTask:
    """What the pick-and-place envs share: the Panda arm under OSC-style
    deltas, the seeded spawn, the robosuite observation and the camera.
    Subclasses set ``spawn_lo``/``spawn_hi`` and ``obj_color``."""

    obs_keys = ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos",
                "object", "agentview_image")
    action_dim = 7
    max_reward = 1.0
    reset_uniforms = SPAWN_UNIFORMS

    spawn_lo: tuple
    spawn_hi: tuple
    obj_color: tuple

    def __init__(self, image_size: int = 64, render_images: bool = True,
                 episode_len: int = 400):
        self.image_size = image_size
        self.render_images = render_images
        self.episode_len = episode_len
        self.camera = R.look_at(pos=(0.55, 0.0, 1.25),
                                lookat=(0.0, 0.0, TABLE_Z + 0.05))
        self._consts: dict = {}

    def _const(self, dev) -> dict:
        """Device constants, made once per device: nothing in a step builds
        a tensor from Python data (a CUDA graph replays the physics step)."""
        dev = torch.device(dev)
        if dev not in self._consts:
            t = lambda v, **kw: torch.tensor(v, device=dev, **kw)
            lo, hi = ra.panda_limits(dev)
            c = dict(
                chain=PANDA_CHAIN.to(dev), lo=lo, hi=hi,
                work_lo=t(WORK_LO), work_hi=t(WORK_HI),
                spawn_lo=t(self.spawn_lo), spawn_hi=t(self.spawn_hi),
                eye=torch.eye(3, device=dev)[None],
                link_width=t([[[w] for _, _, w in LINK_SEGMENTS]]),
                plane_z=t([TABLE_Z]), plane_color=t([R.PLANE_COLOR]),
                rays=R.camera_rays(self.camera, self.image_size,
                                   self.image_size, dev))
            # settle the home pose onto the start target: the same for
            # every env and every reset
            qpos = ra.PANDA_HOME.to(dev)[None]
            eef = t([START_EEF])
            for _ in range(8):
                qpos = ra.arm_track(c["chain"], qpos, eef, lo=lo, hi=hi)
            c.update(home_qpos=qpos, start_eef=eef,
                     home_eef=K.eef_pose(c["chain"], qpos)[0])
            c.update(self._task_const(t, dev))
            self._consts[dev] = c
        return self._consts[dev]

    def _task_const(self, t, dev) -> dict:
        """The subclass's own device constants."""
        return {}

    # ------------------------------------------------------------------
    def reset_draws(self, u: torch.Tensor) -> dict:
        """(n, 3) uniforms in [0, 1) → a reset's ``obj_xy`` (n, 2), uniform
        in [``spawn_lo``, ``spawn_hi``], and ``obj_yaw`` (n,), uniform in
        ±30°."""
        c = self._const(u.device)
        return {"obj_xy": c["spawn_lo"] + u[:, :2] * (c["spawn_hi"]
                                                      - c["spawn_lo"]),
                "obj_yaw": u[:, 2] * (math.pi / 3) - math.pi / 6}

    def _spawn(self, n: int, generator: torch.Generator, obj_xy, obj_yaw):
        """(xy (n, 2), yaw (n,)) on the generator's device: the handed-in
        draws, or the generator's."""
        dev = generator.device
        if obj_xy is None or obj_yaw is None:
            drawn = self.reset_draws(torch.rand(n, SPAWN_UNIFORMS,
                                                generator=generator,
                                                device=dev))
            obj_xy = drawn["obj_xy"] if obj_xy is None else obj_xy
            obj_yaw = drawn["obj_yaw"] if obj_yaw is None else obj_yaw
        return obj_xy.to(dev), obj_yaw.to(dev)

    def reset(self, n: int, generator: torch.Generator, **draws):
        state = self.reset_state(n, generator, **draws)
        return state, self.obs(state)

    def reset_to(self, state):
        """Deterministic state-injection reset."""
        return state, self.obs(state)

    def step(self, state, action: torch.Tensor):
        new_state, reward, success = self.transition(state, action)
        return new_state, self.obs(new_state), reward, success

    # ------------------------------------------------------------------
    def _arm(self, state, action: torch.Tensor, c: dict):
        """The arm's half of a control step → (action clipped, eef target,
        qpos, eef position, gripper)."""
        action = torch.clamp(action, -1.0, 1.0)
        eef_target = torch.minimum(torch.maximum(
            state.eef_target + action[:, :3] * EEF_SPEED, c["work_lo"]),
            c["work_hi"])
        qpos = ra.arm_track(c["chain"], state.qpos, eef_target, lo=c["lo"],
                            hi=c["hi"])
        eef, _ = K.eef_pose(c["chain"], qpos)
        target = 1.0 - (action[:, 6] > 0).to(action.dtype)
        grip = state.gripper + torch.clamp(target - state.gripper,
                                           -GRIPPER_SPEED, GRIPPER_SPEED)
        return action, eef_target, qpos, eef, grip

    @staticmethod
    def _reward(obj: torch.Tensor, eef: torch.Tensor, grasped: torch.Tensor,
                success: torch.Tensor) -> torch.Tensor:
        reach = 1.0 - torch.tanh(10.0 * torch.linalg.norm(obj - eef, dim=-1))
        return torch.where(success, torch.ones_like(reach),
                           0.25 * reach + 0.25 * grasped.to(reach.dtype))

    def _robot_obs(self, state, obj: torch.Tensor, obj_quat: torch.Tensor,
                   positions: torch.Tensor, quats: torch.Tensor) -> dict:
        """The observation from fk's frames: robot0_* and robosuite's
        14-dim object-state (pos, quat xyzw, pos relative to the eef, quat
        relative to the eef xyzw)."""
        eef, eef_quat = positions[:, -1], quats[:, -1]
        g = state.gripper
        rel_quat = rot.quat_mul(obj_quat, rot.quat_conj(eef_quat))
        return {
            "robot0_eef_pos": eef,
            "robot0_eef_quat": rot.quat_wxyz_to_xyzw(eef_quat),
            "robot0_joint_pos": state.qpos,
            "robot0_gripper_qpos": torch.stack([0.020 + 0.024 * g,
                                                -0.020 - 0.024 * g], -1),
            "object": torch.cat([obj, rot.quat_wxyz_to_xyzw(obj_quat),
                                 obj - eef, rot.quat_wxyz_to_xyzw(rel_quat)],
                                -1),
        }

    def _links(self, positions: torch.Tensor, c: dict):
        """The three arm-link boxes (shoulder → elbow → wrist → eef):
        (pos (N, 3, 3), rot (N, 3, 3, 3), half (N, 3, 3))."""
        starts = torch.stack([positions[:, a] for a, _, _ in LINK_SEGMENTS], 1)
        ends = torch.stack([positions[:, b] for _, b, _ in LINK_SEGMENTS], 1)
        return R.link_frame(starts, ends, c["link_width"])

    def _scene(self, pos, rots, size, color, kind, c: dict) -> R.Scene:
        n = pos.shape[0]
        return R.Scene(pos=pos, rot=rots, size=size,
                       color=color.expand(n, *color.shape[1:]),
                       kind=kind.expand(n, kind.shape[1]),
                       plane_z=c["plane_z"].expand(n),
                       plane_color=c["plane_color"].expand(n, 3))

    def render_scene(self, scene: R.Scene) -> torch.Tensor:
        """(N, H, W, 3) float32 in [0, 255] through the ray-cast kernel."""
        return raycast.render_batch_cuda(
            scene, self.camera, self.image_size, self.image_size,
            rays=self._const(scene.pos.device)["rays"])

    def render(self, state, positions: torch.Tensor | None = None
               ) -> torch.Tensor:
        return self.render_scene(self.scene(state, positions))


# ---------------------------------------------------------------------------
# the kinematic variants
# ---------------------------------------------------------------------------

@dataclass
class PickPlaceState:
    qpos: torch.Tensor         # (N, 7) Panda joints
    eef_target: torch.Tensor   # (N, 3) integrated OSC Cartesian target
    gripper: torch.Tensor      # (N,) in [0 closed, 1 open]
    obj_pos: torch.Tensor      # (N, 3)
    obj_yaw: torch.Tensor      # (N,) spawn yaw (kinematic attach: constant)
    grasped: torch.Tensor      # (N,) bool
    t: torch.Tensor            # (N,) int32

    def map(self, fn, *others: "PickPlaceState") -> "PickPlaceState":
        """Apply ``fn`` field by field (to this state and ``others``)."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name), *(getattr(o, f.name)
                                                for o in others))
            for f in dataclasses.fields(self)})


def _yaw_quat(yaw: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(yaw)
    return torch.stack([torch.cos(yaw / 2), zero, zero, torch.sin(yaw / 2)],
                       -1)


class _PickPlaceBase(PandaTask):
    """Kinematic pick-and-place: a closed gripper near the object carries
    it; a free object falls ``GRAVITY_DZ`` a step to its rest height."""

    obj_half: float

    def reset_state(self, n: int, generator: torch.Generator,
                    obj_xy: torch.Tensor | None = None,
                    obj_yaw: torch.Tensor | None = None) -> PickPlaceState:
        """n seeded initial states on the generator's device; ``obj_xy``
        (n, 2) and ``obj_yaw`` (n,) replace the draws."""
        c = self._const(generator.device)
        xy, yaw = self._spawn(n, generator, obj_xy, obj_yaw)
        dev = xy.device
        return PickPlaceState(
            qpos=c["home_qpos"].expand(n, 7).clone(),
            eef_target=c["start_eef"].expand(n, 3).clone(),
            gripper=torch.ones(n, device=dev),
            obj_pos=torch.cat([xy, torch.full((n, 1), self.rest_z(),
                                              device=dev)], -1),
            obj_yaw=yaw, grasped=torch.zeros(n, dtype=torch.bool, device=dev),
            t=torch.zeros(n, dtype=torch.int32, device=dev))

    def rest_z(self) -> float:
        return TABLE_Z + self.obj_half

    def min_free_z(self, obj_pos: torch.Tensor) -> torch.Tensor:
        return torch.full_like(obj_pos[:, 2], self.rest_z())

    def transition(self, state: PickPlaceState, action: torch.Tensor):
        """``step`` without the observation → (state, reward, success)."""
        c = self._const(action.device)
        action, eef_target, qpos, eef, grip = self._arm(state, action, c)
        near = torch.linalg.norm(state.obj_pos - eef, dim=-1) < GRASP_RADIUS
        closing = grip < 0.4
        grasped = torch.where(state.grasped, closing, near & closing)
        free_z = torch.maximum(state.obj_pos[:, 2] - GRAVITY_DZ,
                               self.min_free_z(state.obj_pos))
        free = torch.cat([state.obj_pos[:, :2], free_z[:, None]], -1)
        obj = torch.where(grasped[:, None], eef, free)
        new_state = PickPlaceState(qpos=qpos, eef_target=eef_target,
                                   gripper=grip, obj_pos=obj,
                                   obj_yaw=state.obj_yaw, grasped=grasped,
                                   t=state.t + 1)
        success = self.check_success(new_state)
        return new_state, self._reward(obj, eef, grasped, success), success

    def obs(self, state: PickPlaceState) -> dict:
        c = self._const(state.qpos.device)
        positions, quats = K.fk(c["chain"], state.qpos)
        obs = self._robot_obs(state, state.obj_pos, _yaw_quat(state.obj_yaw),
                              positions, quats)
        if self.render_images:
            obs["agentview_image"] = self.render(state, positions)
        return obs

    def scripted_action(self, state: PickPlaceState,
                        generator: torch.Generator | None = None,
                        noise: float = 0.0) -> torch.Tensor:
        """Waypoint expert: reach above → descend → close → carry above the
        goal → lower → release."""
        c = self._const(state.qpos.device)
        obj = state.obj_pos
        eef, _ = K.eef_pose(c["chain"], state.qpos)
        goal = c["goal"]
        over_goal = torch.linalg.norm(obj[:, :2] - goal[:, :2], dim=-1) < 0.01
        above_obj = obj + c["above_obj"]
        above_goal = torch.cat([goal[:, :2], c["carry_z"]], -1)
        lower_goal = goal + c["drop"]
        xy_near = torch.linalg.norm(obj[:, :2] - eef[:, :2], dim=-1) < 0.01
        z_near = (obj[:, 2] - eef[:, 2]).abs() < 0.012
        reach_target = torch.where(xy_near[:, None], obj, above_obj)
        low = (eef[:, 2] - lower_goal[:, 2]).abs() < 0.02
        carry_target = torch.where(over_goal[:, None], lower_goal,
                                   above_goal).expand_as(eef)
        target = torch.where(state.grasped[:, None], carry_target,
                             reach_target)
        delta = torch.clamp((target - eef) / EEF_SPEED, -1.0, 1.0)
        release = state.grasped & over_goal & low
        close = torch.where(release, -1.0,
                            torch.where(state.grasped | (xy_near & z_near),
                                        1.0, -1.0))
        act = torch.cat([delta, torch.zeros_like(delta), close[:, None]], -1)
        if noise > 0.0 and generator is not None:
            act = act + noise * torch.randn(act.shape, generator=generator,
                                            device=act.device)
        return torch.clamp(act, -1.0, 1.0)

    def _task_const(self, t, dev) -> dict:
        return dict(goal=t([self.goal_pos()]), above_obj=t([[0.0, 0.0, 0.08]]),
                    carry_z=t([[TABLE_Z + 0.18]]),
                    drop=t([[0.0, 0.0, self.drop_height()]]),
                    **self._scene_const(t, dev))

    # subclass hooks ------------------------------------------------------
    def goal_pos(self) -> tuple:
        raise NotImplementedError

    def drop_height(self) -> float:
        raise NotImplementedError

    def check_success(self, state: PickPlaceState) -> torch.Tensor:
        raise NotImplementedError

    def _scene_const(self, t, dev) -> dict:
        raise NotImplementedError


def _statics_const(t, statics, n_front: int, front_colors, dev) -> dict:
    """Constant prims of a kinematic scene: ``statics`` (centre, half,
    colour) after ``n_front`` moving prims, then the three arm links."""
    return dict(
        static_pos=t([[p for p, _, _ in statics]]),
        static_size=t([[h for _, h, _ in statics]]),
        color=t([[*front_colors, *(col for _, _, col in statics),
                  *LINK_COLORS]]),
        kind=torch.zeros((1, n_front + len(statics) + 3), dtype=torch.int32,
                         device=dev))


class CanEnv(_PickPlaceBase):
    """Pick the can and place it in the bin (robosuite PickPlaceCan)."""

    spawn_lo = (-0.12, -0.18)
    spawn_hi = (0.02, -0.02)
    obj_half = 0.025
    obj_color = (0.8, 0.25, 0.2)

    def goal_pos(self) -> tuple:
        return (BIN_CENTER[0], BIN_CENTER[1],
                BIN_CENTER[2] + self.obj_half + 0.06)

    def drop_height(self) -> float:
        return 0.09

    def check_success(self, state: PickPlaceState) -> torch.Tensor:
        c = self._const(state.obj_pos.device)
        o = state.obj_pos
        in_bin = ((o[:, :2] - c["bin_xy"]).abs() < BIN_HALF).all(-1)
        settled = o[:, 2] < TABLE_Z + self.obj_half + 0.02
        return in_bin & settled & ~state.grasped

    def _scene_const(self, t, dev) -> dict:
        return dict(bin_xy=t([BIN_CENTER[:2]]),
                    obj_size=t([[self.obj_half] * 3]),
                    **_statics_const(t, [(p, h, BIN_COLOR)
                                         for p, h in BIN_WALLS],
                                     1, [self.obj_color], dev))

    def scene(self, state: PickPlaceState,
              positions: torch.Tensor | None = None) -> R.Scene:
        """8 boxes: the can (drawn unrotated), four bin walls, three arm
        links."""
        c = self._const(state.qpos.device)
        n = state.qpos.shape[0]
        if positions is None:
            positions, _ = K.fk(c["chain"], state.qpos)
        lp, lr, lh = self._links(positions, c)
        return self._scene(
            torch.cat([state.obj_pos[:, None],
                       c["static_pos"].expand(n, 4, 3), lp], 1),
            torch.cat([c["eye"].expand(n, 3, 3)[:, None].expand(n, 5, 3, 3),
                       lr], 1),
            torch.cat([c["obj_size"].expand(n, 3)[:, None],
                       c["static_size"].expand(n, 4, 3), lh], 1),
            c["color"], c["kind"], c)


class SquareEnv(_PickPlaceBase):
    """Place the square nut over the peg (robosuite NutAssemblySquare)."""

    spawn_lo = (-0.13, -0.15)
    spawn_hi = (-0.01, 0.0)
    obj_half = 0.02
    obj_color = (0.75, 0.65, 0.15)

    def goal_pos(self) -> tuple:
        return (PEG_X, PEG_Y, TABLE_Z + 2 * PEG_HALF_Z + 0.02)

    def drop_height(self) -> float:
        return 2 * PEG_HALF_Z + 0.035

    def _on_peg(self, obj_pos: torch.Tensor) -> torch.Tensor:
        c = self._const(obj_pos.device)
        return ((obj_pos[:, :2] - c["peg_xy"]).abs() < NUT_TOL).all(-1)

    def min_free_z(self, obj_pos: torch.Tensor) -> torch.Tensor:
        # the nut slides down the peg when aligned; else it rests on the
        # table
        return torch.where(self._on_peg(obj_pos),
                           torch.full_like(obj_pos[:, 2], TABLE_Z + 0.008),
                           torch.full_like(obj_pos[:, 2], self.rest_z()))

    def check_success(self, state: PickPlaceState) -> torch.Tensor:
        o = state.obj_pos
        below_top = o[:, 2] < TABLE_Z + 2 * PEG_HALF_Z - 0.01
        return self._on_peg(o) & below_top & ~state.grasped

    def _scene_const(self, t, dev) -> dict:
        peg = ((PEG_X, PEG_Y, TABLE_Z + PEG_HALF_Z), PEG_HALF, PEG_COLOR)
        return dict(peg_xy=t([[PEG_X, PEG_Y]]),
                    obj_size=t([[self.obj_half, self.obj_half, 0.01]]),
                    **_statics_const(t, [peg], 1, [self.obj_color], dev))

    def scene(self, state: PickPlaceState,
              positions: torch.Tensor | None = None) -> R.Scene:
        """5 boxes: the nut (a flat unrotated box), the peg, three arm
        links."""
        c = self._const(state.qpos.device)
        n = state.qpos.shape[0]
        if positions is None:
            positions, _ = K.fk(c["chain"], state.qpos)
        lp, lr, lh = self._links(positions, c)
        return self._scene(
            torch.cat([state.obj_pos[:, None],
                       c["static_pos"].expand(n, 1, 3), lp], 1),
            torch.cat([c["eye"].expand(n, 3, 3)[:, None].expand(n, 2, 3, 3),
                       lr], 1),
            torch.cat([c["obj_size"].expand(n, 3)[:, None],
                       c["static_size"].expand(n, 1, 3), lh], 1),
            c["color"], c["kind"], c)
