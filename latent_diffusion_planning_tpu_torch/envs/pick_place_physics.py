"""Can (pick-place) and Square (nut assembly) on the rigid-body contact
core, batched over envs.

Counterpart of ``latent_diffusion_planning_tpu/envs/pick_place_physics.py``
(the configs' default envs for ``data/can`` and ``data/square``): the
object is a free rigid body on the penalty-contact engine and the gripper
two kinematic sphere pads, so grasping, transport, the drop into the bin
and the nut sliding over the peg all come from contact forces and Coulomb
friction. The scene's statics (bin walls, peg) are engine geoms of the
static world (``body_id=-1``). ``holding`` is a contact event: both pads
touch the object (``physics.pair_in_contact``, robosuite's
``_check_grasp``).

The arm, the action surface, the observation and the seeded spawns are
``pick_place.PandaTask``'s. On the card ``transition`` replays one control
step from a CUDA graph captured per batch size (``cuda_graph=False`` runs
it eagerly), as ``LiftPhysicsEnv`` does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops import render as R
from ..ops import rotations as rot
from . import physics as ph
from .lift import EEF_SPEED, TABLE_Z
from .lift_physics import graphed_transition
from .physics import kinematics as K
from .pick_place import (BIN_CENTER, BIN_COLOR, BIN_HALF, BIN_WALLS,
                         LINK_COLORS, NUT_TOL, PEG_COLOR, PEG_HALF_XY,
                         PEG_HALF_Z, PEG_X, PEG_Y, PandaTask)

OBJ, PAD_L, PAD_R = 0, 1, 2
OBJ_MASS = 0.05
PAD_RADIUS = 0.008
PAD_COLOR = (0.2, 0.2, 0.25)


@dataclass
class PickPlacePhysState:
    bodies: ph.RigidBody       # [object, left pad, right pad]
    qpos: torch.Tensor         # (N, 7) Panda joints
    eef_target: torch.Tensor   # (N, 3) integrated OSC Cartesian target
    gripper: torch.Tensor      # (N,) in [0 closed, 1 open]
    t: torch.Tensor            # (N,) int32

    @property
    def obj_pos(self) -> torch.Tensor:
        return self.bodies.pos[:, OBJ]

    def map(self, fn, *others: "PickPlacePhysState") -> "PickPlacePhysState":
        """Apply ``fn`` leaf by leaf (to this state and ``others``)."""
        out = {}
        for f in dataclasses.fields(self):
            mine = getattr(self, f.name)
            theirs = [getattr(o, f.name) for o in others]
            out[f.name] = (mine.map(fn, *theirs) if f.name == "bodies"
                           else fn(mine, *theirs))
        return PickPlacePhysState(**out)


class _PickPlacePhysBase(PandaTask):
    """Kinematic pad spheres squeeze a free body (the ``LiftPhysicsEnv``
    pattern). Subclasses give the object's geoms and render prims, the
    static geoms, the goal and the success rule."""

    obj_half: float            # grasp half-width along the pad axis
    obj_top: float             # object half-height
    grasp_offset = (0.0, 0.0, 0.0)   # body-frame grasp point
    align_tol = 0.012          # xy alignment before lowering onto the goal
    release_z = TABLE_Z + 0.10  # eef height at which the gripper opens

    def __init__(self, image_size: int = 64, render_images: bool = True,
                 episode_len: int = 400, n_substeps: int = 10,
                 dt: float = 0.002, cuda_graph: bool = True):
        super().__init__(image_size, render_images, episode_len)
        self.n_substeps = n_substeps
        self.cuda_graph = cuda_graph
        self.world = self._make_world()
        self.params = ph.PhysicsParams(dt=dt, mu=1.5, kt=2000.0)
        # a slight squeeze past kissing contact makes the grip's normal force
        self._min_halfgap = self.obj_half + PAD_RADIUS - 0.0018
        self._max_halfgap = self.obj_half + PAD_RADIUS + 0.02
        self._graphs: dict = {}

    # subclass hooks ------------------------------------------------------
    def _obj_geoms(self) -> list[dict]:
        raise NotImplementedError

    def _static_geoms(self) -> list[tuple]:
        """(centre, half-extents, colour) of each static box."""
        raise NotImplementedError

    def _obj_inertia(self) -> list[float]:
        raise NotImplementedError

    def goal_pos(self) -> tuple:
        raise NotImplementedError

    def _in_goal(self, obj: torch.Tensor, c: dict) -> torch.Tensor:
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _make_world(self) -> ph.World:
        geoms = ph.build_geoms(
            self._obj_geoms()
            + [ph.make_sphere_geom(PAD_RADIUS, body_id=PAD_L),
               ph.make_sphere_geom(PAD_RADIUS, body_id=PAD_R)]
            + [ph.make_box_geom(list(half), body_id=-1, offset=list(pos))
               for pos, half, _ in self._static_geoms()])
        return ph.World.create(
            mass=[OBJ_MASS, 1.0, 1.0],
            inertia=[self._obj_inertia(), [1e-3] * 3, [1e-3] * 3],
            geoms=geoms, plane_z=TABLE_Z, kinematic=[False, True, True])

    def _task_const(self, t, dev) -> dict:
        statics = self._static_geoms()
        prims = [(off, half) for off, half in self._obj_prims()]
        n_obj, n_static = len(prims), len(statics)
        return dict(
            pad_axis=t([[1.0, 0.0, 0.0]]),
            identity_quat=t([[1.0, 0.0, 0.0, 0.0]]),
            goal=t([self.goal_pos()]),
            grasp_offset=t([self.grasp_offset]),
            above=t([[0.0, 0.0, 0.08]]),
            carry_z=t([[TABLE_Z + 0.20]]), release_z=t([[self.release_z]]),
            obj_offset=t([[off for off, _ in prims]]),
            obj_size=t([[half for _, half in prims]]),
            pad_size=t([[[PAD_RADIUS] * 3] * 2]),
            static_pos=t([[p for p, _, _ in statics]]),
            static_size=t([[h for _, h, _ in statics]]),
            color=t([[self.obj_color] * n_obj + [PAD_COLOR] * 2
                      + [col for _, _, col in statics] + list(LINK_COLORS)]),
            kind=t([[0] * n_obj + [1, 1] + [0] * (n_static + 3)],
                   dtype=torch.int32))

    def _obj_prims(self) -> list[tuple]:
        """(body-frame offset, half-extents) of each box drawn for the
        object: its collision boxes."""
        return [(tuple(float(v) for v in g["offset"]),
                 tuple(float(v) for v in g["size"]))
                for g in self._obj_geoms()]

    def _pad_positions(self, eef: torch.Tensor, grip: torch.Tensor, c: dict):
        gap = self._min_halfgap + grip * (self._max_halfgap
                                          - self._min_halfgap)
        offset = c["pad_axis"] * gap[:, None]
        return eef - offset, eef + offset

    def reset_state(self, n: int, generator: torch.Generator,
                    obj_xy: torch.Tensor | None = None,
                    obj_yaw: torch.Tensor | None = None
                    ) -> PickPlacePhysState:
        """n seeded initial states on the generator's device; ``obj_xy``
        (n, 2) and ``obj_yaw`` (n,) replace the draws (the eval engine's
        per-episode draws, or another framework's in a test)."""
        c = self._const(generator.device)
        xy, yaw = self._spawn(n, generator, obj_xy, obj_yaw)
        dev = xy.device
        grip = torch.ones(n, device=dev)
        left, right = self._pad_positions(c["home_eef"].expand(n, 3), grip, c)
        obj_pos = torch.cat([xy, torch.full((n, 1), TABLE_Z + self.obj_top,
                                            device=dev)], -1)
        zero = torch.zeros_like(yaw)
        obj_quat = torch.stack([torch.cos(yaw / 2), zero, zero,
                                torch.sin(yaw / 2)], -1)
        ident = c["identity_quat"].expand(n, 4)
        pos = torch.stack([obj_pos, left, right], 1)
        bodies = ph.RigidBody(pos=pos,
                              quat=torch.stack([obj_quat, ident, ident], 1),
                              linvel=torch.zeros_like(pos),
                              angvel=torch.zeros_like(pos))
        return PickPlacePhysState(
            bodies=bodies, qpos=c["home_qpos"].expand(n, 7).clone(),
            eef_target=c["start_eef"].expand(n, 3).clone(), gripper=grip,
            t=torch.zeros(n, dtype=torch.int32, device=dev))

    # ------------------------------------------------------------------
    def transition(self, state: PickPlacePhysState, action: torch.Tensor):
        """``step`` without the observation → (state, reward, success). On
        the card with ``cuda_graph`` the control step replays from a CUDA
        graph captured for this batch size."""
        return graphed_transition(self, state, action)

    def _step(self, state: PickPlacePhysState, action: torch.Tensor):
        c = self._const(action.device)
        action, eef_target, qpos, eef, grip = self._arm(state, action, c)
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

        new_state = PickPlacePhysState(bodies=bodies, qpos=qpos,
                                       eef_target=eef_target, gripper=grip,
                                       t=state.t + 1)
        held = self.holding(new_state)
        obj = bodies.pos[:, OBJ]
        success = self._in_goal(obj, c) & ~held
        return new_state, self._reward(obj, eef, held, success), success

    def holding(self, state: PickPlacePhysState) -> torch.Tensor:
        """(N,) bool: both finger pads in contact with the object."""
        contacts = ph.generate_contacts(self.world, state.bodies)
        return (ph.pair_in_contact(contacts, OBJ, PAD_L)
                & ph.pair_in_contact(contacts, OBJ, PAD_R))

    def check_success(self, state: PickPlacePhysState) -> torch.Tensor:
        c = self._const(state.qpos.device)
        return self._in_goal(state.obj_pos, c) & ~self.holding(state)

    # ------------------------------------------------------------------
    def obs(self, state: PickPlacePhysState) -> dict:
        c = self._const(state.qpos.device)
        positions, quats = K.fk(c["chain"], state.qpos)
        obs = self._robot_obs(state, state.bodies.pos[:, OBJ],
                              state.bodies.quat[:, OBJ], positions, quats)
        if self.render_images:
            obs["agentview_image"] = self.render(state, positions)
        return obs

    def scene(self, state: PickPlacePhysState,
              positions: torch.Tensor | None = None) -> R.Scene:
        """The object's boxes, the two sphere pads, the static boxes and
        three arm links (10 prims for Can and for Square)."""
        c = self._const(state.qpos.device)
        n = state.qpos.shape[0]
        if positions is None:
            positions, _ = K.fk(c["chain"], state.qpos)
        lp, lr, lh = self._links(positions, c)
        obj_rot = rot.quat_to_matrix(state.bodies.quat[:, OBJ])
        n_obj, n_static = c["obj_offset"].shape[1], c["static_pos"].shape[1]
        obj_pos = state.bodies.pos[:, OBJ, None] + rot.rotate(
            obj_rot[:, None], c["obj_offset"])
        eye = c["eye"].expand(n, 3, 3)[:, None]
        return self._scene(
            torch.cat([obj_pos, state.bodies.pos[:, PAD_L:],
                       c["static_pos"].expand(n, n_static, 3), lp], 1),
            torch.cat([obj_rot[:, None].expand(n, n_obj, 3, 3),
                       eye.expand(n, 2 + n_static, 3, 3), lr], 1),
            torch.cat([c["obj_size"].expand(n, n_obj, 3),
                       c["pad_size"].expand(n, 2, 3),
                       c["static_size"].expand(n, n_static, 3), lh], 1),
            c["color"], c["kind"], c)

    # ------------------------------------------------------------------
    def scripted_action(self, state: PickPlacePhysState,
                        generator: torch.Generator | None = None,
                        noise: float = 0.0) -> torch.Tensor:
        """Waypoint expert over the physical gripper: align → descend →
        squeeze → carry → lower → release (no kinematic attach)."""
        c = self._const(state.qpos.device)
        obj = state.bodies.pos[:, OBJ]
        obj_rot = rot.quat_to_matrix(state.bodies.quat[:, OBJ])
        eef, _ = K.eef_pose(c["chain"], state.qpos)
        offset = rot.rotate(obj_rot, c["grasp_offset"])
        grasp_at = obj + offset
        # a committed hold is the gripper closed at the grasp point: the
        # contact predicate chatters as the payload micro-bounces, and one
        # open frame unwinds the whole carry
        holding = (state.gripper < 0.25) & (
            torch.linalg.norm(grasp_at - eef, dim=-1) < 0.025)

        above_obj = grasp_at + c["above"]
        xy_near = torch.linalg.norm(grasp_at[:, :2] - eef[:, :2],
                                    dim=-1) < 0.006
        z_near = (grasp_at[:, 2] - eef[:, 2]).abs() < 0.006

        # while held, the eef leads the object by the rotated grasp offset
        goal = c["goal"]
        eef_goal = goal + offset
        over_goal = torch.linalg.norm(obj[:, :2] - goal[:, :2],
                                      dim=-1) < self.align_tol
        above_goal = torch.cat([eef_goal[:, :2],
                                c["carry_z"].expand(eef.shape[0], 1)], -1)
        lower_goal = torch.cat([eef_goal[:, :2],
                                c["release_z"].expand(eef.shape[0], 1)], -1)
        low = (eef[:, 2] - lower_goal[:, 2]).abs() < 0.012

        reach_target = torch.where(xy_near[:, None], grasp_at, above_obj)
        carry_target = torch.where(over_goal[:, None], lower_goal, above_goal)
        target = torch.where(holding[:, None], carry_target, reach_target)
        delta = torch.clamp((target - eef) / EEF_SPEED, -1.0, 1.0)
        # stop while the fingers squeeze; transport slowly once holding:
        # friction can only accelerate the payload so fast
        delta = torch.where((xy_near & z_near & ~holding)[:, None],
                            torch.zeros_like(delta),
                            torch.where(holding[:, None],
                                        torch.clamp(delta, -0.25, 0.25),
                                        delta))
        release = holding & over_goal & low
        close = torch.where(release, -1.0,
                            torch.where(holding | (xy_near & z_near),
                                        1.0, -1.0))
        act = torch.cat([delta, torch.zeros_like(delta), close[:, None]], -1)
        if noise > 0.0 and generator is not None:
            act = act + noise * torch.randn(act.shape, generator=generator,
                                            device=act.device)
        return torch.clamp(act, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Can: pick the can, drop it between the bin's walls
# ---------------------------------------------------------------------------

# squat proportions (z half = xy half): a tall box rocks on its corners on
# the penalty plane until it launches; the Lift cube's aspect is stable
CAN_HALF = (0.025, 0.025, 0.025)


class CanPhysicsEnv(_PickPlacePhysBase):
    """robosuite PickPlaceCan over the contact engine: a box can, four
    static bin walls."""

    spawn_lo = (-0.12, -0.18)
    spawn_hi = (0.02, -0.02)
    obj_half = CAN_HALF[0]
    obj_top = CAN_HALF[2]
    obj_color = (0.8, 0.25, 0.2)
    release_z = TABLE_Z + 0.10   # the can falls about 6 cm into the bin

    def _obj_geoms(self):
        return [ph.make_box_geom(list(CAN_HALF), body_id=OBJ)]

    def _static_geoms(self):
        return [(pos, half, BIN_COLOR) for pos, half in BIN_WALLS]

    def _obj_inertia(self):
        s = 2 * CAN_HALF[0]
        return [OBJ_MASS * s * s / 6.0] * 3

    def goal_pos(self) -> tuple:
        return (BIN_CENTER[0], BIN_CENTER[1],
                BIN_CENTER[2] + self.obj_top + 0.06)

    def _task_const(self, t, dev) -> dict:
        return dict(super()._task_const(t, dev), bin_xy=t([BIN_CENTER[:2]]))

    def _in_goal(self, obj: torch.Tensor, c: dict) -> torch.Tensor:
        in_bin = ((obj[:, :2] - c["bin_xy"]).abs() < BIN_HALF).all(-1)
        return in_bin & (obj[:, 2] < TABLE_Z + self.obj_top + 0.02)


# ---------------------------------------------------------------------------
# Square: a 4-bar nut frame slides down over the static peg
# ---------------------------------------------------------------------------

HOLE_HALF = 0.017            # half-width of the nut's square hole
BAR_W = 0.008                # bar half-thickness
BAR_H = 0.008                # bar half-height
BAR_LEN = HOLE_HALF + 2 * BAR_W
# two bars along x at y = ±(hole + w), two along y at x = ±(hole + w)
NUT_BARS = (
    ((0.0, -(HOLE_HALF + BAR_W), 0.0), (BAR_LEN, BAR_W, BAR_H)),
    ((0.0, HOLE_HALF + BAR_W, 0.0), (BAR_LEN, BAR_W, BAR_H)),
    ((-(HOLE_HALF + BAR_W), 0.0, 0.0), (BAR_W, BAR_LEN, BAR_H)),
    ((HOLE_HALF + BAR_W, 0.0, 0.0), (BAR_W, BAR_LEN, BAR_H)),
)
PEG_TOP = TABLE_Z + 2 * PEG_HALF_Z


class SquarePhysicsEnv(_PickPlacePhysBase):
    """robosuite NutAssemblySquare over the contact engine: the nut is a
    rigid 4-bar frame with an open centre, so it reaches the success region
    only if it drops over the peg through real contacts."""

    spawn_lo = (-0.13, -0.15)
    spawn_hi = (-0.01, 0.0)
    # the pads squeeze the whole frame across the outer ±x bar faces: a
    # centred grasp (an off-centre bar grasp pivots and the frame dangles)
    obj_half = HOLE_HALF + 2 * BAR_W
    obj_top = BAR_H
    obj_color = (0.75, 0.65, 0.15)
    # hole half 17 mm against peg half 12 mm: under 4 mm clears the peg top
    align_tol = 0.004
    release_z = TABLE_Z + BAR_H + 0.004   # nut seated, peg through the hole

    def _obj_geoms(self):
        return [ph.make_box_geom(list(half), body_id=OBJ, offset=list(off))
                for off, half in NUT_BARS]

    def _static_geoms(self):
        return [((PEG_X, PEG_Y, TABLE_Z + PEG_HALF_Z),
                 (PEG_HALF_XY, PEG_HALF_XY, PEG_HALF_Z), PEG_COLOR)]

    def _obj_inertia(self):
        s = 2 * BAR_LEN
        return [OBJ_MASS * s * s / 6.0] * 3

    def goal_pos(self) -> tuple:
        return (PEG_X, PEG_Y, TABLE_Z + BAR_H)

    def _task_const(self, t, dev) -> dict:
        return dict(super()._task_const(t, dev), peg_xy=t([[PEG_X, PEG_Y]]))

    def _in_goal(self, obj: torch.Tensor, c: dict) -> torch.Tensor:
        aligned = ((obj[:, :2] - c["peg_xy"]).abs() < NUT_TOL).all(-1)
        return aligned & (obj[:, 2] < PEG_TOP - 0.01)
