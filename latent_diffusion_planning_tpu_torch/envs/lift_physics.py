"""Lift task on the rigid-body physics core, batched over envs: Panda arm +
force grasping.

Counterpart of ``latent_diffusion_planning_tpu/envs/lift_physics.py``
(``LiftPhysicsEnv``): the cube is a free rigid body and the gripper two
kinematic sphere finger pads, so grasping emerges from penalty contacts and
Coulomb friction; a 7-DoF Panda carries the gripper, OSC-style eef deltas
resolving through IK and rate-limited joint servos. Control runs at 20 Hz
with ``n_substeps`` physics substeps of ``dt`` per control step. Same
interface as ``envs/lift.py`` (``reset_state``, ``obs``, ``transition``);
every state field leads with the env axis.

On the card one control step is a few thousand small launches, so
``transition`` replays it from a CUDA graph (captured at the first call for
each batch size; ``cuda_graph=False`` runs it eagerly): the counterpart of
the ``jit`` under which the JAX engine runs its scan. A capture that fails
raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops import render as R
from ..ops import rotations as rot
from ..ops.kernels import raycast
from . import physics as ph
from . import robosuite_arm as ra
from .lift import (CUBE_HALF, EEF_SPEED, GRIPPER_SPEED, LIFT_SUCCESS,
                   SPAWN_UNIFORMS, TABLE_Z, WORK_HI, WORK_LO, spawn_draws)
from .physics import kinematics as K

PANDA_CHAIN = ra.panda_chain(base_pos=(-0.56, 0.0, TABLE_Z))

CUBE_MASS = 0.05
PAD_RADIUS = 0.008
FINGER_MAX_HALFGAP = 0.045     # pad x-offset when fully open
FINGER_MIN_HALFGAP = CUBE_HALF + PAD_RADIUS - 0.0018  # slight squeeze closed
START_EEF = (0.0, 0.0, TABLE_Z + 0.25)
LINK_SEGMENTS = ((1, 3, 0.045), (3, 5, 0.035), (5, 7, 0.03))  # fk rows, width
COLORS = ((0.85, 0.1, 0.1), (0.2, 0.2, 0.25), (0.2, 0.2, 0.25),
          (0.65, 0.65, 0.7), (0.6, 0.6, 0.68), (0.55, 0.55, 0.65))
KINDS = (0, 1, 1, 0, 0, 0)


@dataclass
class LiftPhysState:
    bodies: ph.RigidBody       # [cube, left pad, right pad]
    qpos: torch.Tensor         # (N, 7) Panda joint angles
    eef_target: torch.Tensor   # (N, 3) integrated OSC Cartesian target
    gripper: torch.Tensor      # (N,) in [0 closed, 1 open]
    cube_yaw0: torch.Tensor    # (N,) render-only initial yaw
    t: torch.Tensor            # (N,) int32

    def map(self, fn, *others: "LiftPhysState") -> "LiftPhysState":
        """Apply ``fn`` leaf by leaf (to this state and ``others``)."""
        out = {}
        for f in dataclasses.fields(self):
            mine = getattr(self, f.name)
            theirs = [getattr(o, f.name) for o in others]
            out[f.name] = (mine.map(fn, *theirs) if f.name == "bodies"
                           else fn(mine, *theirs))
        return LiftPhysState(**out)


def _make_world() -> ph.World:
    geoms = ph.build_geoms([
        ph.make_box_geom([CUBE_HALF] * 3, body_id=0),
        ph.make_sphere_geom(PAD_RADIUS, body_id=1),
        ph.make_sphere_geom(PAD_RADIUS, body_id=2),
    ])
    inertia_cube = [CUBE_MASS * (2 * CUBE_HALF) ** 2 / 6.0] * 3
    return ph.World.create(
        mass=[CUBE_MASS, 1.0, 1.0],
        inertia=[inertia_cube, [1e-3] * 3, [1e-3] * 3],
        geoms=geoms, plane_z=TABLE_Z, kinematic=[False, True, True])


class _GraphedStep:
    """One control step captured in a CUDA graph over static buffers."""

    def __init__(self, env: "LiftPhysicsEnv", state: LiftPhysState,
                 action: torch.Tensor):
        self.state = state.map(torch.clone)
        self.action = action.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # warm up off the capturing stream
            for _ in range(2):
                env._step(self.state, self.action)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = env._step(self.state, self.action)

    def __call__(self, state: LiftPhysState, action: torch.Tensor):
        self.state.map(lambda dst, src: dst.copy_(src), state)
        self.action.copy_(action)
        self.graph.replay()
        new_state, reward, success = self.out
        return new_state.map(torch.clone), reward.clone(), success.clone()


class LiftPhysicsEnv:
    """robosuite-Lift-parity env over the contact engine."""

    obs_keys = ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos",
                "object", "agentview_image")
    action_dim = 7
    max_reward = 1.0

    def __init__(self, image_size: int = 64, render_images: bool = True,
                 episode_len: int = 400, n_substeps: int = 10,
                 dt: float = 0.002, cuda_graph: bool = True):
        self.image_size = image_size
        self.render_images = render_images
        self.episode_len = episode_len
        self.n_substeps = n_substeps
        self.cuda_graph = cuda_graph
        self.world = _make_world()
        self.params = ph.PhysicsParams(dt=dt, mu=1.5, kt=2000.0)
        self.camera = R.look_at(pos=(0.55, 0.0, 1.25),
                                lookat=(0.0, 0.0, TABLE_Z + 0.05))
        self._consts: dict = {}
        self._graphs: dict = {}

    def _const(self, dev) -> dict:
        """Device constants, made once per device."""
        dev = torch.device(dev)
        if dev not in self._consts:
            t = lambda v, **kw: torch.tensor(v, device=dev, **kw)
            c = dict(
                chain=PANDA_CHAIN.to(dev), lo=ra.panda_limits(dev)[0],
                hi=ra.panda_limits(dev)[1], work_lo=t(WORK_LO),
                work_hi=t(WORK_HI),
                pad_axis=t([[1.0, 0.0, 0.0]]),
                above=t([[0.0, 0.0, 0.10]]),
                eye=torch.eye(3, device=dev)[None],
                cube_size=t([[CUBE_HALF] * 3]),
                pad_size=t([[PAD_RADIUS] * 3]),
                color=t([COLORS]),
                kind=t([KINDS], dtype=torch.int32),
                plane_z=t([TABLE_Z]),
                plane_color=t([R.PLANE_COLOR]),
                identity_quat=t([[1.0, 0.0, 0.0, 0.0]]),
                link_width=t([[[w] for _, _, w in LINK_SEGMENTS]]),
                rays=R.camera_rays(self.camera, self.image_size,
                                   self.image_size, dev))
            # settle the home pose onto the start target: the same for
            # every env and every reset
            qpos = ra.PANDA_HOME.to(dev)[None]
            eef = t([START_EEF])
            for _ in range(8):
                qpos = ra.arm_track(c["chain"], qpos, eef, lo=c["lo"],
                                    hi=c["hi"])
            c.update(home_qpos=qpos, start_eef=eef,
                     home_eef=K.eef_pose(c["chain"], qpos)[0])
            self._consts[dev] = c
        return self._consts[dev]

    # ------------------------------------------------------------------
    def _pad_positions(self, eef: torch.Tensor, grip: torch.Tensor, c: dict):
        gap = FINGER_MIN_HALFGAP + grip * (FINGER_MAX_HALFGAP
                                           - FINGER_MIN_HALFGAP)
        offset = c["pad_axis"] * gap[:, None]
        return eef - offset, eef + offset

    def reset(self, n: int, generator: torch.Generator, **draws):
        state = self.reset_state(n, generator, **draws)
        return state, self.obs(state)

    # what a reset draws, for callers that draw the uniforms themselves
    reset_uniforms = SPAWN_UNIFORMS
    reset_draws = staticmethod(spawn_draws)

    def reset_state(self, n: int, generator: torch.Generator,
                    cube_xy: torch.Tensor | None = None,
                    cube_yaw: torch.Tensor | None = None) -> LiftPhysState:
        """n seeded initial states on the generator's device: cube xy
        uniform in ±10 cm, yaw in ±30°. ``cube_xy`` (n, 2) and ``cube_yaw``
        (n,) replace the draws (the eval engine's per-episode draws, or
        another framework's in a test)."""
        dev = generator.device
        c = self._const(dev)
        if cube_xy is None or cube_yaw is None:
            drawn = spawn_draws(torch.rand(n, SPAWN_UNIFORMS,
                                           generator=generator, device=dev))
            cube_xy = drawn["cube_xy"] if cube_xy is None else cube_xy
            cube_yaw = drawn["cube_yaw"] if cube_yaw is None else cube_yaw
        xy, yaw = cube_xy.to(dev), cube_yaw.to(dev)
        grip = torch.ones(n, device=dev)
        left, right = self._pad_positions(c["home_eef"].expand(n, 3), grip, c)
        cube_pos = torch.cat([xy, torch.full((n, 1), TABLE_Z + CUBE_HALF,
                                             device=dev)], -1)
        zero = torch.zeros_like(yaw)
        cube_quat = torch.stack([torch.cos(yaw / 2), zero, zero,
                                 torch.sin(yaw / 2)], -1)
        ident = c["identity_quat"].expand(n, 4)
        pos = torch.stack([cube_pos, left, right], 1)
        bodies = ph.RigidBody(pos=pos,
                              quat=torch.stack([cube_quat, ident, ident], 1),
                              linvel=torch.zeros_like(pos),
                              angvel=torch.zeros_like(pos))
        return LiftPhysState(
            bodies=bodies, qpos=c["home_qpos"].expand(n, 7).clone(),
            eef_target=c["start_eef"].expand(n, 3).clone(), gripper=grip,
            cube_yaw0=yaw, t=torch.zeros(n, dtype=torch.int32, device=dev))

    def reset_to(self, state: LiftPhysState):
        """Deterministic state-injection reset."""
        return state, self.obs(state)

    # ------------------------------------------------------------------
    def step(self, state: LiftPhysState, action: torch.Tensor):
        new_state, reward, success = self.transition(state, action)
        return new_state, self.obs(new_state), reward, success

    def transition(self, state: LiftPhysState, action: torch.Tensor):
        """``step`` without the observation → (state, reward, success). On
        the card with ``cuda_graph`` the control step replays from a CUDA
        graph captured for this batch size."""
        if action.device.type != "cuda" or not self.cuda_graph:
            return self._step(state, action)
        key = (action.device, action.shape[0])
        if key not in self._graphs:
            self._graphs[key] = _GraphedStep(self, state, action)
        return self._graphs[key](state, action)

    def _step(self, state: LiftPhysState, action: torch.Tensor):
        c = self._const(action.device)
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
        left, right = self._pad_positions(eef, grip, c)

        control_dt = self.params.dt * self.n_substeps
        old = state.bodies
        pads = torch.stack([left, right], 1)
        pad_vel = (pads - old.pos[:, 1:]) / control_dt
        bodies = ph.RigidBody(
            pos=torch.cat([old.pos[:, :1], pads], 1), quat=old.quat,
            linvel=torch.cat([old.linvel[:, :1], pad_vel], 1),
            angvel=old.angvel)
        bodies = ph.multi_step(self.world, bodies, self.params,
                               self.n_substeps)

        new_state = LiftPhysState(bodies=bodies, qpos=qpos,
                                  eef_target=eef_target, gripper=grip,
                                  cube_yaw0=state.cube_yaw0, t=state.t + 1)
        cube = bodies.pos[:, 0]
        success = cube[:, 2] > TABLE_Z + CUBE_HALF + LIFT_SUCCESS
        dist = torch.linalg.norm(cube - eef, dim=-1)
        reach = 1.0 - torch.tanh(10.0 * dist)
        grasped = (dist < 0.03).to(reach.dtype)
        reward = torch.where(success, torch.ones_like(reach),
                             0.25 * reach + 0.25 * grasped)
        return new_state, reward, success

    # ------------------------------------------------------------------
    def obs(self, state: LiftPhysState) -> dict:
        c = self._const(state.qpos.device)
        cube = state.bodies.pos[:, 0]
        g = state.gripper
        positions, quats = K.fk(c["chain"], state.qpos)
        eef = positions[:, -1]
        # object-state layout of robosuite Lift (cube_pos, cube_quat xyzw,
        # gripper_to_cube_pos); all quats are robosuite xyzw
        obs = {
            "robot0_eef_pos": eef,
            "robot0_eef_quat": rot.quat_wxyz_to_xyzw(quats[:, -1]),
            "robot0_joint_pos": state.qpos,
            "robot0_gripper_qpos": torch.stack([0.020 + 0.024 * g,
                                                -0.020 - 0.024 * g], -1),
            "object": torch.cat([
                cube, rot.quat_wxyz_to_xyzw(state.bodies.quat[:, 0]),
                cube - eef], -1),
        }
        if self.render_images:
            obs["agentview_image"] = self.render(state, positions)
        return obs

    def scene(self, state: LiftPhysState,
              positions: torch.Tensor | None = None) -> R.Scene:
        """6 prims: the cube, the two sphere pads, three arm-link boxes
        (shoulder→elbow→wrist→eef). ``positions`` are ``fk``'s, when the
        caller has them."""
        c = self._const(state.qpos.device)
        n = state.qpos.shape[0]
        if positions is None:
            positions, _ = K.fk(c["chain"], state.qpos)
        bodies = state.bodies
        # the three links in one call: segments (N, 3, 3) → frames
        starts = torch.stack([positions[:, a] for a, _, _ in LINK_SEGMENTS], 1)
        ends = torch.stack([positions[:, b] for _, b, _ in LINK_SEGMENTS], 1)
        link_pos, link_rot, link_half = R.link_frame(starts, ends,
                                                     c["link_width"])
        eye = c["eye"].expand(n, 3, 3)
        return R.Scene(
            pos=torch.cat([bodies.pos, link_pos], 1),
            rot=torch.cat([rot.quat_to_matrix(bodies.quat[:, :1]),
                           torch.stack([eye, eye], 1), link_rot], 1),
            size=torch.cat([c["cube_size"].expand(n, 3)[:, None],
                            c["pad_size"].expand(n, 2, 3),
                            link_half], 1),
            color=c["color"].expand(n, 6, 3),
            kind=c["kind"].expand(n, 6),
            plane_z=c["plane_z"].expand(n),
            plane_color=c["plane_color"].expand(n, 3))

    def render_scene(self, scene: R.Scene) -> torch.Tensor:
        """(N, H, W, 3) float32 in [0, 255] through the ray-cast kernel."""
        return raycast.render_batch_cuda(
            scene, self.camera, self.image_size, self.image_size,
            rays=self._const(scene.pos.device)["rays"])

    def render(self, state: LiftPhysState,
               positions: torch.Tensor | None = None) -> torch.Tensor:
        return self.render_scene(self.scene(state, positions))

    # ------------------------------------------------------------------
    def scripted_action(self, state: LiftPhysState,
                        generator: torch.Generator | None = None,
                        noise: float = 0.0) -> torch.Tensor:
        """Waypoint expert over the physical gripper: align → descend →
        squeeze → lift."""
        c = self._const(state.qpos.device)
        cube = state.bodies.pos[:, 0]
        eef, _ = K.eef_pose(c["chain"], state.qpos)
        closed = state.gripper < 0.25
        near = torch.linalg.norm(cube - eef, dim=-1) < 0.02
        holding = closed & near

        above = cube + c["above"]
        lift_to = torch.cat([eef[:, :2],
                             torch.full_like(eef[:, :1], TABLE_Z + 0.25)], -1)
        xy_near = torch.linalg.norm(cube[:, :2] - eef[:, :2], dim=-1) < 0.006
        z_near = (cube[:, 2] - eef[:, 2]).abs() < 0.006

        target = torch.where(holding[:, None], lift_to,
                             torch.where(xy_near[:, None], cube, above))
        delta = torch.clamp((target - eef) / EEF_SPEED, -1.0, 1.0)
        # stop moving while the gripper closes on the cube; transport slowly
        # once holding: friction can only accelerate the payload so fast
        delta = torch.where((xy_near & z_near & ~closed)[:, None],
                            torch.zeros_like(delta),
                            torch.where(holding[:, None],
                                        torch.clamp(delta, -0.2, 0.2), delta))
        close = torch.where(holding | (xy_near & z_near), 1.0, -1.0)
        act = torch.cat([delta, torch.zeros_like(delta), close[:, None]], -1)
        if noise > 0.0 and generator is not None:
            act = act + noise * torch.randn(act.shape, generator=generator,
                                            device=act.device)
        return torch.clamp(act, -1.0, 1.0)
