"""Bimanual ALOHA transfer-cube on the contact engine, batched over envs.

Counterpart of ``latent_diffusion_planning_tpu/envs/aloha_cube.py``
(``AlohaTransferCubeEnv``, the reference's dm_control bimanual ViperX
transfer-cube):

- action (14): [left arm joint targets (6, rad), left gripper (0..1), right
  arm joint targets (6), right gripper];
- obs: ``qpos``/``qvel`` (14 each, joint space), ``env_state`` = the cube's
  pose (7), ``wrist64_image`` from the camera on each env's right gripper;
- the staged contact reward 0–4 (touch-right → lifted → touch-left →
  transferred), success at 4;
- 400 steps at DT 0.02, cube spawn x ∈ [0, 0.2], y ∈ [0.4, 0.6].

Per-joint position servos over the MJCF ViperX chains (``aloha_base``)
carry two kinematic sphere pads per gripper; the cube is a free rigid body
of the penalty-contact engine, so grasp, handoff and fall come from contact
forces and Coulomb friction, and every reward stage and expert decision is
a contact event (``physics.pair_in_contact``), kept on the device. On the
card ``transition`` replays one control step from a CUDA graph captured per
batch size (``lift_physics.graphed_transition``; ``cuda_graph=False`` runs
it eagerly). ``mesh_mode`` "box" draws each arm as 4 boxes (13 prims);
"kdop" as 9 convex hulls of its STL links (18 hulls of 26 half-spaces, then
the cube and the pads).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..ops import render as R
from ..ops import rotations as rot
from . import aloha_base as B
from . import aloha_constants as C
from . import physics as ph

CUBE_HALF = 0.02
CUBE_MASS = 0.05
PAD_RADIUS = 0.008
# pad centres ride at the real ViperX finger slide + PAD_RADIUS (half-gap
# 0.01844 → 0.058 m); fully closed squeezes 3 mm past kissing contact
FINGER_MAX_HALFGAP = PAD_RADIUS + C.PUPPET_GRIPPER_POSITION_OPEN   # 0.066
FINGER_MIN_HALFGAP = CUBE_HALF + PAD_RADIUS - 0.003
GRIP_RATE = 0.25          # normalized grip travel per control step
MEET = (0.0, 0.5, 0.25)
MEET_TOL = 0.045
L_NEAR_TOL = 0.014
SPAWN_LO = (0.0, 0.4)
SPAWN_HI = (0.2, 0.6)
CUBE_COLOR = (0.85, 0.1, 0.1)
PAD_COLOR = (0.15, 0.15, 0.18)

# body indices in the physics world
CUBE, LPAD_A, LPAD_B, RPAD_A, RPAD_B = range(5)


def _make_world() -> ph.World:
    geoms = ph.build_geoms(
        [ph.make_box_geom([CUBE_HALF] * 3, body_id=CUBE)]
        + [ph.make_sphere_geom(PAD_RADIUS, body_id=b)
           for b in (LPAD_A, LPAD_B, RPAD_A, RPAD_B)])
    inertia_cube = [CUBE_MASS * (2 * CUBE_HALF) ** 2 / 6.0] * 3
    return ph.World.create(
        mass=[CUBE_MASS, 1.0, 1.0, 1.0, 1.0],
        inertia=[inertia_cube] + [[1e-3] * 3] * 4,
        geoms=geoms, plane_z=B.TABLE_Z,
        kinematic=[False, True, True, True, True])


@functools.cache
def _consts(device: torch.device) -> dict:
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return dict(
        spawn_lo=t(SPAWN_LO), spawn_hi=t(SPAWN_HI), meet=t(MEET),
        above=t([0.0, 0.0, 0.07]), retreat=t([0.3, 0.5, 0.3]),
        stage=t([-0.12, MEET[1], MEET[2]]), l_offset=t([-0.01, 0.0, 0.0]),
        l_hold=t([MEET[0], MEET[1], MEET[2] + 0.05]),
        cube_size=t([[CUBE_HALF] * 3]), pad_size=t([[PAD_RADIUS] * 3] * 4),
        cube_color=t([CUBE_COLOR]), pad_color=t([PAD_COLOR] * 4),
        plane_z=t([B.TABLE_Z]), plane_color=t([R.PLANE_COLOR]),
        identity=t([1.0, 0.0, 0.0, 0.0]),
        # kind "box": cube, 2 × 4 arm boxes, 4 pad spheres; "kdop": 18
        # hulls, cube, pads
        kind_box=torch.tensor([[0] * 9 + [1] * 4], dtype=torch.int32,
                              device=device),
        kind_kdop=torch.tensor([[2] * 18 + [0] + [1] * 4], dtype=torch.int32,
                               device=device),
        pad_rows=torch.cat([torch.zeros(5, 26, 3, device=device),
                            torch.ones(5, 26, 1, device=device)], -1))


def pad_positions(chain, arm: B.ArmState):
    """(pad_a, pad_b) world positions (N, 3) of one gripper's finger pads:
    they straddle the grasp point along the gripper y-axis (the finger
    slide, horizontal in every reachable pose) at the grip's half-gap."""
    c = B.consts(arm.qpos.device)
    tip, g_quat = B.eef(chain, arm)
    axis = rot.quat_rotate(g_quat, c["y_axis"].expand_as(tip))
    gap = FINGER_MIN_HALFGAP + torch.clamp(arm.grip, 0.0, 1.0) * (
        FINGER_MAX_HALFGAP - FINGER_MIN_HALFGAP)
    return tip - axis * gap[:, None], tip + axis * gap[:, None]


@dataclass
class AlohaCubeState:
    left: B.ArmState
    right: B.ArmState
    bodies: ph.RigidBody      # [cube, lpad_a, lpad_b, rpad_a, rpad_b]
    t: torch.Tensor           # (N,) int32

    @property
    def cube_pos(self) -> torch.Tensor:
        return self.bodies.pos[:, CUBE]

    def map(self, fn, *others) -> "AlohaCubeState":
        return B.map_state(self, fn, *others)


class AlohaTransferCubeEnv(B.AlohaTask):
    """Batched bimanual transfer-cube env (contact physics)."""

    reset_uniforms = 2        # cube x, y

    def __init__(self, image_size: int = 64, render_images: bool = True,
                 episode_len: int = 400, renderer: str = "xla",
                 camera_names: tuple = ("wrist64",), n_substeps: int = 10,
                 dt: float = 0.002, mesh_mode: str = "box",
                 cuda_graph: bool = True):
        super().__init__(image_size, render_images, episode_len, renderer,
                         camera_names, mesh_mode, cuda_graph)
        self.n_substeps = n_substeps
        self.world = _make_world()
        self.params = ph.PhysicsParams(dt=dt, mu=1.5, kt=2000.0)

    # ------------------------------------------------------------------
    def _bodies(self, left: B.ArmState, right: B.ArmState,
                cube_pos: torch.Tensor) -> ph.RigidBody:
        c = B.consts(cube_pos.device)
        la, lb = pad_positions(c["left"], left)
        ra, rb = pad_positions(c["right"], right)
        pos = torch.stack([cube_pos, la, lb, ra, rb], 1)
        quat = _consts(cube_pos.device)["identity"].expand(
            pos.shape[0], 5, 4).clone()
        return ph.RigidBody(pos=pos, quat=quat, linvel=torch.zeros_like(pos),
                            angvel=torch.zeros_like(pos))

    def reset_draws(self, u: torch.Tensor) -> dict:
        """(n, 2) uniforms in [0, 1) → ``cube_xy`` (n, 2) in the spawn box,
        as ``jax.random.uniform(key, minval, maxval)`` maps them."""
        c = _consts(u.device)
        return {"cube_xy": u * (c["spawn_hi"] - c["spawn_lo"]) + c["spawn_lo"]}

    def reset_state(self, n: int, generator: torch.Generator,
                    cube_xy: torch.Tensor | None = None) -> AlohaCubeState:
        """n seeded initial states on the generator's device; ``cube_xy``
        (n, 2) replaces the draw (the engine's per-episode draws, or the
        JAX package's in a test)."""
        dev = generator.device
        if cube_xy is None:
            cube_xy = self.reset_draws(torch.rand(
                n, self.reset_uniforms, generator=generator,
                device=dev))["cube_xy"]
        xy = cube_xy.to(dev, torch.float32)
        cube = torch.cat([xy, torch.full((n, 1), B.TABLE_Z + CUBE_HALF,
                                         device=dev)], -1)
        left, right = B.arm_reset(n, dev), B.arm_reset(n, dev)
        return AlohaCubeState(left=left, right=right,
                              bodies=self._bodies(left, right, cube),
                              t=torch.zeros(n, dtype=torch.int32, device=dev))

    # ------------------------------------------------------------------
    def _step(self, state: AlohaCubeState, action: torch.Tensor):
        c = B.consts(action.device)
        left = B.arm_step(state.left, action[:, 0:6], action[:, 6],
                          grip_rate=GRIP_RATE)
        right = B.arm_step(state.right, action[:, 7:13], action[:, 13],
                           grip_rate=GRIP_RATE)
        la, lb = pad_positions(c["left"], left)
        ra, rb = pad_positions(c["right"], right)
        control_dt = self.params.dt * self.n_substeps
        old = state.bodies
        pads = torch.stack([la, lb, ra, rb], 1)
        pad_vel = (pads - old.pos[:, 1:]) / control_dt
        bodies = ph.RigidBody(
            pos=torch.cat([old.pos[:, :1], pads], 1), quat=old.quat,
            linvel=torch.cat([old.linvel[:, :1], pad_vel], 1),
            angvel=old.angvel)
        bodies = ph.multi_step(self.world, bodies, self.params,
                               self.n_substeps)
        new_state = AlohaCubeState(left=left, right=right, bodies=bodies,
                                   t=state.t + 1)
        reward = self.reward(new_state)
        return new_state, reward, reward >= self.max_reward

    def contact_flags(self, state: AlohaCubeState) -> dict:
        """(N,) bool physical-contact predicates for the reward and the
        expert (the reference's geom-pair contact scans)."""
        contacts = ph.generate_contacts(self.world, state.bodies)
        pair = lambda j: ph.pair_in_contact(contacts, CUBE, j)
        la, lb, ra, rb = (pair(LPAD_A), pair(LPAD_B), pair(RPAD_A),
                          pair(RPAD_B))
        return {"touch_left": la | lb, "touch_right": ra | rb,
                "on_table": ph.pair_in_contact(contacts, CUBE, -1),
                "held_left": la & lb, "held_right": ra & rb}

    def reward(self, state: AlohaCubeState) -> torch.Tensor:
        """The staged ladder: every stage a contact event (touch = cube↔pad
        contact, lifted = no cube↔table contact)."""
        f = self.contact_flags(state)
        off_table = ~f["on_table"]
        zero = torch.zeros_like(state.bodies.pos[:, 0, 0])
        r = torch.where(f["touch_right"], 1.0, zero)
        r = torch.where(f["touch_right"] & off_table, 2.0, r)
        r = torch.where(f["touch_left"], 3.0, r)
        return torch.where(f["touch_left"] & off_table, 4.0, r)

    # ------------------------------------------------------------------
    def env_state(self, state: AlohaCubeState) -> torch.Tensor:
        """(N, 7): the cube's position and quaternion."""
        return torch.cat([state.bodies.pos[:, CUBE],
                          state.bodies.quat[:, CUBE]], -1)

    def scene(self, state: AlohaCubeState) -> R.Scene:
        c, k = B.consts(state.bodies.pos.device), _consts(
            state.bodies.pos.device)
        n = state.bodies.pos.shape[0]
        cube_rot = rot.quat_to_matrix(state.bodies.quat[:, CUBE])[:, None]
        pads = state.bodies.pos[:, 1:]
        pad_rot = c["eye"].expand(n, 4, 3, 3)
        plane = dict(plane_z=k["plane_z"].expand(n),
                     plane_color=k["plane_color"].expand(n, 3))
        if self.mesh_mode == "kdop":
            # 18 convex hulls first (the kernel's n_convex contract), then
            # the cube box and the pad spheres
            lp, lr, ls, lc, lpl = B.arm_scene_prims_kdop(
                c["left"], state.left, c["left_color"])
            rp, rr, rs, rc, rpl = B.arm_scene_prims_kdop(
                c["right"], state.right, c["right_color"])
            planes = torch.cat([lpl, rpl, k["pad_rows"]])
            return R.Scene(
                pos=torch.cat([lp, rp, state.bodies.pos[:, CUBE:CUBE + 1],
                               pads], 1),
                rot=torch.cat([lr, rr, cube_rot, pad_rot], 1),
                size=torch.cat([ls, rs, k["cube_size"].expand(n, 1, 3),
                                k["pad_size"].expand(n, 4, 3)], 1),
                color=torch.cat([lc, rc, k["cube_color"].expand(n, 1, 3),
                                 k["pad_color"].expand(n, 4, 3)], 1),
                kind=k["kind_kdop"].expand(n, 23),
                planes=planes.expand(n, *planes.shape), **plane)
        lp, lr, ls, lc = B.arm_scene_prims(c["left"], state.left,
                                           c["left_color"])
        rp, rr, rs, rc = B.arm_scene_prims(c["right"], state.right,
                                           c["right_color"])
        return R.Scene(
            pos=torch.cat([state.bodies.pos[:, CUBE:CUBE + 1], lp, rp, pads],
                          1),
            rot=torch.cat([cube_rot, lr, rr, pad_rot], 1),
            size=torch.cat([k["cube_size"].expand(n, 1, 3), ls, rs,
                            k["pad_size"].expand(n, 4, 3)], 1),
            color=torch.cat([k["cube_color"].expand(n, 1, 3), lc, rc,
                             k["pad_color"].expand(n, 4, 3)], 1),
            kind=k["kind_box"].expand(n, 13), **plane)

    # ------------------------------------------------------------------
    def scripted_action(self, state: AlohaCubeState,
                        generator: torch.Generator | None = None,
                        noise: float = 0.0) -> torch.Tensor:
        """Two-arm transfer expert in EE space solved through IK: the right
        arm picks the cube (align → descend → squeeze → lift) and carries it
        to the meet point; the left meets it and grasps, and the right
        releases and retreats. Every stage decision is a contact event."""
        c, k = B.consts(state.bodies.pos.device), _consts(
            state.bodies.pos.device)
        cube = state.bodies.pos[:, CUBE]
        f = self.contact_flags(state)
        # "has" = both finger pads in squeezing contact with the cube
        right_has, left_has = f["held_right"], f["held_left"]
        l_tip, _ = B.eef(c["left"], state.left)
        r_tip, _ = B.eef(c["right"], state.right)
        col = lambda b: b[:, None]

        at_meet = torch.linalg.norm(cube - k["meet"], dim=-1) < MEET_TOL

        # right arm: pick, carry to meet, release after the handoff
        above = cube + k["above"]
        r_xy_near = torch.linalg.norm(cube[:, :2] - r_tip[:, :2],
                                      dim=-1) < 0.012
        r_z_near = (cube[:, 2] - r_tip[:, 2]).abs() < 0.012
        r_aligned = r_xy_near & r_z_near
        r_grasping = r_aligned & ~right_has        # stop and squeeze
        r_target = torch.where(col(right_has), k["meet"].expand_as(cube),
                               torch.where(col(r_xy_near), cube, above))
        r_target = torch.where(col(left_has), k["retreat"].expand_as(cube),
                               r_target)
        one, zero = c["one"].expand_as(cube[:, 0]), c["zero"].expand_as(
            cube[:, 0])
        r_grip = torch.where(left_has, one,
                             torch.where(right_has | r_aligned, zero, one))
        # hold still while the fingers close; carry slowly: friction can
        # only accelerate the payload so fast
        r_speed = torch.where(r_grasping, zero,
                              torch.where(right_has & ~left_has,
                                          0.006 * one, 0.015 * one))

        # left arm: stage, meet, grasp, hold; the approach point sits 1 cm
        # to the cube's left so its pads close on cube faces
        l_approach = cube + k["l_offset"]
        l_near = torch.linalg.norm(l_approach - l_tip, dim=-1) < L_NEAR_TOL
        l_grasping = at_meet & l_near & ~left_has
        l_target = torch.where(col(left_has), k["l_hold"].expand_as(cube),
                               torch.where(col(at_meet & right_has),
                                           l_approach,
                                           k["stage"].expand_as(cube)))
        l_grip = torch.where(left_has | l_grasping, zero, one)
        l_speed = torch.where(l_grasping, zero,
                              torch.where(left_has, 0.004 * one, 0.015 * one))

        ql = B.scripted_arm_action(c["left"], state.left, l_target, l_speed)
        qr = B.scripted_arm_action(c["right"], state.right, r_target, r_speed)
        act = torch.cat([ql, l_grip[:, None], qr, r_grip[:, None]], -1)
        if noise > 0.0 and generator is not None:
            act = act + noise * torch.randn(act.shape, generator=generator,
                                            device=act.device)
        return act


ALOHA_SHAPE_META = {
    "ac_dim": 14,
    "all_shapes": {
        "qpos": [14],
        "qvel": [14],
        "env_state": [7],
        "wrist64_image": [64, 64, 3],
        "optimal": [1],
    },
    "use_images": True,
}

# normalization bounds of the task's motion (padded data ranges), not the
# full mechanical joint range
_ARM_LO = [-0.8, -1.86, 0.1, -0.8, -0.9, -0.8]
_ARM_HI = [0.8, 0.7, 1.61, 0.8, 0.4, 0.8]

ALOHA_OBS_STATS = {
    "obs": {
        "qpos": {"min": _ARM_LO + [0.0] + _ARM_LO + [0.0],
                 "max": _ARM_HI + [1.0] + _ARM_HI + [1.0]},
        "qvel": {"min": [-10.0] * 14, "max": [10.0] * 14},
        "env_state": {"min": [-0.5, 0.0, -0.1, -1, -1, -1, -1],
                      "max": [0.5, 1.0, 0.6, 1, 1, 1, 1]},
        "wrist64_image": {"min": 0, "max": 255},
        "latent_wrist64_image": {"min": -8.0, "max": 8.0},
        "optimal": {"min": 0, "max": 1},
    },
    # joint radians + normalized grip: per-dim bounds
    "actions": {"min": _ARM_LO + [0.0] + _ARM_LO + [0.0],
                "max": _ARM_HI + [1.0] + _ARM_HI + [1.0]},
}
