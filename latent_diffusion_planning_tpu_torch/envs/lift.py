"""Kinematic Lift task, batched over envs: grasp a cube and raise it.

Counterpart of ``latent_diffusion_planning_tpu/envs/lift.py`` (``LiftEnv``):
point-mass end-effector servo, quasi-static cube with a kinematic grasp,
success when the cube is 4 cm above the table, robosuite observation keys
and a 64×64 ``agentview_image`` from the ray-cast kernel. Every state field
leads with the env axis.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..ops import render as R
from ..ops import rotations as rot
from ..ops.kernels import raycast

TABLE_Z = 0.8            # table top height
CUBE_HALF = 0.02
EEF_SPEED = 0.05         # max eef translation per control step (m)
GRIPPER_SPEED = 0.30     # gripper open/close fraction per step
GRASP_RADIUS = 0.028     # eef-cube distance for a grasp to engage
LIFT_SUCCESS = 0.04      # robosuite Lift: cube 4 cm above table
GRAVITY_DZ = 0.025       # cube fall per step when free (quasi-static)
WORK_LO = (-0.25, -0.25, TABLE_Z + 0.005)
WORK_HI = (0.25, 0.25, TABLE_Z + 0.40)
SPAWN_UNIFORMS = 3       # uniforms a reset draws per env: cube x, y, yaw


def spawn_draws(u: torch.Tensor) -> dict:
    """(n, 3) uniforms in [0, 1) → a reset's ``cube_xy`` (n, 2), uniform in
    ±10 cm, and ``cube_yaw`` (n,), uniform in ±30°."""
    return {"cube_xy": u[:, :2] * 0.2 - 0.1,
            "cube_yaw": u[:, 2] * (math.pi / 3) - math.pi / 6}


@dataclass
class LiftState:
    eef_pos: torch.Tensor      # (N, 3)
    gripper: torch.Tensor      # (N,) in [0 closed, 1 open]
    cube_pos: torch.Tensor     # (N, 3)
    cube_yaw: torch.Tensor     # (N,)
    grasped: torch.Tensor      # (N,) bool
    t: torch.Tensor            # (N,) int32 step counter

    def map(self, fn, *others: "LiftState") -> "LiftState":
        """Apply ``fn`` field by field (to this state and ``others``)."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name), *(getattr(o, f.name)
                                                for o in others))
            for f in dataclasses.fields(self)})


class LiftEnv:
    obs_keys = ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos",
                "object", "agentview_image")
    action_dim = 7           # dx dy dz (drx dry drz ignored) gripper
    max_reward = 1.0

    def __init__(self, image_size: int = 64, render_images: bool = True,
                 episode_len: int = 400):
        self.image_size = image_size
        self.render_images = render_images
        self.episode_len = episode_len
        self.camera = R.look_at(pos=(0.55, 0.0, 1.25),
                                lookat=(0.0, 0.0, TABLE_Z + 0.05))
        self._rays: dict = {}
        self._consts: dict = {}

    def _const(self, dev) -> dict:
        """Device constants, made once per device (a tensor built from
        Python lists on the card is a copy from pageable memory that waits
        for the stream, so none is built per call)."""
        if dev not in self._consts:
            t = lambda v, **kw: torch.tensor(v, device=dev, **kw)
            self._consts[dev] = dict(
                lo=t(WORK_LO), hi=t(WORK_HI),
                eef_quat=t([[0.0, 0.0, 0.0, 1.0]]),
                above=t([[0.0, 0.0, 0.08]]),
                eye=torch.eye(3, device=dev)[None],
                wrist_offset=t([[0.0, 0.0, 0.04]]),
                cube_size=t([[CUBE_HALF] * 3]),
                wrist_size=t([[0.015, 0.015, 0.035]]),
                color=t([[[0.85, 0.1, 0.1],        # red cube
                          [0.65, 0.65, 0.7],       # wrist
                          [0.2, 0.2, 0.25]]]),     # fingers
                plane_color=t([R.PLANE_COLOR]))
        return self._consts[dev]

    # ------------------------------------------------------------------
    def reset(self, n: int, generator: torch.Generator, **draws):
        state = self.reset_state(n, generator, **draws)
        return state, self.obs(state)

    # what a reset draws, for callers that draw the uniforms themselves
    reset_uniforms = SPAWN_UNIFORMS
    reset_draws = staticmethod(spawn_draws)

    def reset_state(self, n: int, generator: torch.Generator,
                    cube_xy: torch.Tensor | None = None,
                    cube_yaw: torch.Tensor | None = None) -> LiftState:
        """n seeded initial states (no observation), on the generator's
        device: cube xy uniform in ±10 cm, yaw in ±30°. ``cube_xy`` (n, 2)
        and ``cube_yaw`` (n,) replace the generator's draws."""
        device = generator.device
        if cube_xy is None or cube_yaw is None:
            drawn = spawn_draws(torch.rand(n, SPAWN_UNIFORMS,
                                           generator=generator, device=device))
            cube_xy = drawn["cube_xy"] if cube_xy is None else cube_xy
            cube_yaw = drawn["cube_yaw"] if cube_yaw is None else cube_yaw
        cube_xy, yaw = cube_xy.to(device), cube_yaw.to(device)
        return LiftState(
            eef_pos=torch.tensor([0.0, 0.0, TABLE_Z + 0.25],
                                 device=device).expand(n, 3).clone(),
            gripper=torch.ones(n, device=device),
            cube_pos=torch.cat([cube_xy, torch.full((n, 1), TABLE_Z + CUBE_HALF,
                                                    device=device)], -1),
            cube_yaw=yaw,
            grasped=torch.zeros(n, dtype=torch.bool, device=device),
            t=torch.zeros(n, dtype=torch.int32, device=device))

    def reset_to(self, state: LiftState):
        """Deterministic state-injection reset."""
        return state, self.obs(state)

    # ------------------------------------------------------------------
    def step(self, state: LiftState, action: torch.Tensor):
        new_state, reward, success = self.transition(state, action)
        return new_state, self.obs(new_state), reward, success

    def transition(self, state: LiftState, action: torch.Tensor):
        """``step`` without the observation → (state, reward, success); the
        eval engine steps with this and renders only at decisions."""
        c = self._const(action.device)
        action = torch.clamp(action, -1.0, 1.0)
        eef = torch.minimum(torch.maximum(
            state.eef_pos + action[:, :3] * EEF_SPEED, c["lo"]), c["hi"])

        # gripper: action[6] > 0 means close (robosuite convention)
        target = 1.0 - (action[:, 6] > 0).float()
        grip = state.gripper + torch.clamp(target - state.gripper,
                                           -GRIPPER_SPEED, GRIPPER_SPEED)
        near = torch.linalg.norm(state.cube_pos - eef, dim=-1) < GRASP_RADIUS
        closing = grip < 0.4
        grasped = torch.where(state.grasped, closing, near & closing)

        # cube: attached → follows the eef; free → falls to the table
        free_z = torch.clamp(state.cube_pos[:, 2] - GRAVITY_DZ,
                             min=TABLE_Z + CUBE_HALF)
        free_pos = torch.cat([state.cube_pos[:, :2], free_z[:, None]], -1)
        cube = torch.where(grasped[:, None], eef, free_pos)

        new_state = LiftState(eef_pos=eef, gripper=grip, cube_pos=cube,
                              cube_yaw=state.cube_yaw, grasped=grasped,
                              t=state.t + 1)
        success = cube[:, 2] > TABLE_Z + LIFT_SUCCESS
        dist = torch.linalg.norm(cube - eef, dim=-1)
        reach = 1.0 - torch.tanh(10.0 * dist)
        reward = torch.where(success, torch.ones_like(reach),
                             0.25 * reach + 0.25 * grasped.float())
        return new_state, reward, success

    # ------------------------------------------------------------------
    def obs(self, state: LiftState) -> dict:
        g = state.gripper
        n = g.shape[0]
        half_yaw = state.cube_yaw / 2.0
        zero = torch.zeros_like(half_yaw)
        cube_quat = torch.stack([torch.cos(half_yaw), zero, zero,
                                 torch.sin(half_yaw)], -1)
        obs = {
            "robot0_eef_pos": state.eef_pos,
            "robot0_eef_quat": self._const(g.device)["eef_quat"].expand(n, 4),
            "robot0_gripper_qpos": torch.stack([0.020 + 0.024 * g,
                                                -0.020 - 0.024 * g], -1),
            "object": torch.cat([state.cube_pos,
                                 rot.quat_wxyz_to_xyzw(cube_quat),
                                 state.cube_pos - state.eef_pos], -1),
        }
        if self.render_images:
            obs["agentview_image"] = self.render(state)
        return obs

    def scene(self, state: LiftState) -> R.Scene:
        n = state.gripper.shape[0]
        dev = state.gripper.device
        c = self._const(dev)
        grip_half = 0.008 + 0.006 * state.gripper
        eye = c["eye"].expand(n, 3, 3)
        return R.Scene(
            pos=torch.stack([state.cube_pos,
                             state.eef_pos + c["wrist_offset"],
                             state.eef_pos], 1),
            rot=torch.stack([R.euler_z(state.cube_yaw), eye, eye], 1),
            size=torch.stack([c["cube_size"].expand(n, 3),
                              c["wrist_size"].expand(n, 3),
                              torch.stack([grip_half,
                                           torch.full_like(grip_half, 0.02),
                                           torch.full_like(grip_half, 0.012)],
                                          -1)], 1),
            color=c["color"].expand(n, 3, 3),
            kind=torch.zeros((n, 3), dtype=torch.int32, device=dev),
            plane_z=torch.full((n,), TABLE_Z, device=dev),
            plane_color=c["plane_color"].expand(n, 3))

    def scripted_action(self, state: LiftState,
                        generator: torch.Generator | None = None,
                        noise: float = 0.0) -> torch.Tensor:
        """Waypoint expert: reach above the cube → descend → grasp → lift."""
        c = self._const(state.eef_pos.device)
        cube, eef = state.cube_pos, state.eef_pos
        lift_to = torch.cat([cube[:, :2],
                             torch.full_like(cube[:, :1], TABLE_Z + 0.18)], -1)
        xy_near = torch.linalg.norm(cube[:, :2] - eef[:, :2], dim=-1) < 0.01
        z_near = (cube[:, 2] - eef[:, 2]).abs() < 0.012
        target = torch.where(state.grasped[:, None], lift_to,
                             torch.where(xy_near[:, None], cube,
                                         cube + c["above"]))
        delta = torch.clamp((target - eef) / EEF_SPEED, -1.0, 1.0)
        close = torch.where(state.grasped | (xy_near & z_near), 1.0, -1.0)
        act = torch.cat([delta, torch.zeros_like(delta), close[:, None]], -1)
        if noise > 0.0 and generator is not None:
            act = act + noise * torch.randn(act.shape, generator=generator,
                                            device=act.device)
        return torch.clamp(act, -1.0, 1.0)

    def render(self, state: LiftState) -> torch.Tensor:
        """(N, H, W, 3) float32 in [0, 255] through the ray-cast kernel."""
        dev = state.gripper.device
        if dev not in self._rays:
            self._rays[dev] = R.camera_rays(self.camera, self.image_size,
                                            self.image_size, dev)
        return raycast.render_batch_cuda(self.scene(state), self.camera,
                                         self.image_size, self.image_size,
                                         rays=self._rays[dev])


LIFT_SHAPE_META = {
    "ac_dim": 7,
    "all_shapes": {
        "robot0_eef_pos": [3],
        "robot0_eef_quat": [4],
        "robot0_gripper_qpos": [2],
        "object": [10],
        "agentview_image": [64, 64, 3],
        "optimal": [1],
    },
    "use_images": True,
}

LIFT_OBS_STATS = {
    "obs": {
        "robot0_eef_pos": {"min": [-0.25, -0.25, 0.8], "max": [0.25, 0.25, 1.2]},
        "robot0_eef_quat": {"min": [-1.0, -1.0, -1.0, -1.0],
                            "max": [1.0, 1.0, 1.0, 1.0]},
        "robot0_gripper_qpos": {"min": [0.0, -0.05], "max": [0.05, 0.0]},
        "object": {"min": [-0.25, -0.25, 0.75, -1, -1, -1, -1,
                           -0.5, -0.5, -0.5],
                   "max": [0.25, 0.25, 1.25, 1, 1, 1, 1, 0.5, 0.5, 0.5]},
        "agentview_image": {"min": 0, "max": 255},
        "latent_agentview_image": {"min": -8.0, "max": 8.0},
        "optimal": {"min": 0, "max": 1},
    },
    "actions": {"clip_min": -1, "clip_max": 1},
}
