"""Bimanual ALOHA insertion, batched over envs (joint-space dynamics).

Counterpart of ``latent_diffusion_planning_tpu/envs/aloha_insertion.py``
(``AlohaInsertionEnv``, the reference's dm_control InsertionTask): the right
gripper carries the red peg, the left the socket; success is the peg in the
socket. The staged ladder:

  1 — both grippers touching their objects,
  2 — both objects grasped and off the table,
  3 — peg and socket touching (both off the table),
  4 — peg inserted (pin depth reached) → success.

The control and observation surface is ``aloha_base``'s (14-dim joint
targets and grippers; ``qpos``/``qvel``/``env_state``/``wrist64_image``).
Grasps are the kinematic ``holding`` latch; a released object falls 2 cm a
step to the table. On the card ``transition`` replays one control step from
a CUDA graph per batch size, as the transfer-cube env does.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..ops import render as R
from . import aloha_base as B

TABLE_Z = B.TABLE_Z
PEG_HALF = (0.03, 0.01, 0.01)
SOCKET_HALF = (0.03, 0.018, 0.018)
LIFT_EPS = 0.015
MEET_L = (-0.06, 0.5, 0.30)     # socket meet pose (left arm)
MEET_R = (0.06, 0.5, 0.30)      # peg meet pose (right arm)
INSERT_TOL_YZ = 0.012
INSERT_DEPTH = 0.035            # peg tip into the socket
PEG_SPAWN = ((0.1, 0.4), (0.2, 0.6))        # (lo, hi) of x, y
SOCKET_SPAWN = ((-0.2, 0.4), (-0.1, 0.6))
PEG_COLOR = (0.85, 0.1, 0.1)
SOCKET_COLOR = (0.2, 0.3, 0.8)


@functools.cache
def _consts(device: torch.device) -> dict:
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return dict(
        spawn_lo=t([PEG_SPAWN[0], SOCKET_SPAWN[0]]).reshape(4),
        spawn_hi=t([PEG_SPAWN[1], SOCKET_SPAWN[1]]).reshape(4),
        peg_z=t(TABLE_Z + PEG_HALF[2]), socket_z=t(TABLE_Z + SOCKET_HALF[2]),
        meet_l=t(MEET_L), above=t([0.0, 0.0, 0.07]),
        stage_r=t([MEET_R[0] + 0.06, MEET_R[1], MEET_R[2]]),
        insert=t([PEG_HALF[0] + SOCKET_HALF[0] - INSERT_DEPTH - 0.002, 0.0,
                  0.0]),
        identity=t([1.0, 0.0, 0.0, 0.0]),
        obj_size=t([PEG_HALF, SOCKET_HALF]),
        obj_color=t([PEG_COLOR, SOCKET_COLOR]),
        plane_z=t([TABLE_Z]), plane_color=t([R.PLANE_COLOR]),
        kind_box=torch.zeros(1, 10, dtype=torch.int32, device=device),
        kind_kdop=torch.tensor([[2] * 18 + [0, 0]], dtype=torch.int32,
                               device=device),
        obj_rows=torch.cat([torch.zeros(2, 26, 3, device=device),
                            torch.ones(2, 26, 1, device=device)], -1))


@dataclass
class AlohaInsertionState:
    left: B.ArmState
    right: B.ArmState
    peg_pos: torch.Tensor       # (N, 3)
    socket_pos: torch.Tensor    # (N, 3)
    peg_held: torch.Tensor      # (N,) bool
    socket_held: torch.Tensor   # (N,) bool
    t: torch.Tensor             # (N,) int32

    def map(self, fn, *others) -> "AlohaInsertionState":
        return B.map_state(self, fn, *others)


class AlohaInsertionEnv(B.AlohaTask):
    reset_uniforms = 4        # peg x, y, socket x, y

    # ------------------------------------------------------------------
    def reset_draws(self, u: torch.Tensor) -> dict:
        """(n, 4) uniforms in [0, 1) → ``peg_xy`` and ``socket_xy`` (n, 2):
        the peg on the right (x ∈ [0.1, 0.2]), the socket on the left
        (x ∈ [-0.2, -0.1]), y ∈ [0.4, 0.6]."""
        c = _consts(u.device)
        xy = u * (c["spawn_hi"] - c["spawn_lo"]) + c["spawn_lo"]
        return {"peg_xy": xy[:, :2], "socket_xy": xy[:, 2:]}

    def reset_state(self, n: int, generator: torch.Generator,
                    peg_xy: torch.Tensor | None = None,
                    socket_xy: torch.Tensor | None = None
                    ) -> AlohaInsertionState:
        dev = generator.device
        c = _consts(dev)
        if peg_xy is None or socket_xy is None:
            drawn = self.reset_draws(torch.rand(
                n, self.reset_uniforms, generator=generator, device=dev))
            peg_xy = drawn["peg_xy"] if peg_xy is None else peg_xy
            socket_xy = drawn["socket_xy"] if socket_xy is None else socket_xy
        peg = torch.cat([peg_xy.to(dev, torch.float32),
                         c["peg_z"].expand(n, 1)], -1)
        socket = torch.cat([socket_xy.to(dev, torch.float32),
                            c["socket_z"].expand(n, 1)], -1)
        no = torch.zeros(n, dtype=torch.bool, device=dev)
        return AlohaInsertionState(
            left=B.arm_reset(n, dev), right=B.arm_reset(n, dev), peg_pos=peg,
            socket_pos=socket, peg_held=no, socket_held=no.clone(),
            t=torch.zeros(n, dtype=torch.int32, device=dev))

    # ------------------------------------------------------------------
    def _step(self, state: AlohaInsertionState, action: torch.Tensor):
        c, k = B.consts(action.device), _consts(action.device)
        left = B.arm_step(state.left, action[:, 0:6], action[:, 6])
        right = B.arm_step(state.right, action[:, 7:13], action[:, 13])
        l_tip, _ = B.eef(c["left"], left)
        r_tip, _ = B.eef(c["right"], right)
        # the right arm handles the peg, the left the socket
        peg_held = B.holding(c["right"], right, state.peg_pos,
                             state.peg_held, tip=r_tip)
        socket_held = B.holding(c["left"], left, state.socket_pos,
                                state.socket_held, tip=l_tip)

        def fall(p, rest_z):
            z = torch.maximum(p[:, 2] - 0.02, rest_z)
            return torch.cat([p[:, :2], z[:, None]], -1)

        peg = torch.where(peg_held[:, None], r_tip,
                          fall(state.peg_pos, k["peg_z"]))
        socket = torch.where(socket_held[:, None], l_tip,
                             fall(state.socket_pos, k["socket_z"]))
        new_state = AlohaInsertionState(
            left=left, right=right, peg_pos=peg, socket_pos=socket,
            peg_held=peg_held, socket_held=socket_held, t=state.t + 1)
        reward = self.reward(new_state, l_tip, r_tip)
        return new_state, reward, reward >= self.max_reward

    def reward(self, state: AlohaInsertionState, l_tip=None,
               r_tip=None) -> torch.Tensor:
        """The ladder of ``alohasim_env.py:219-229``."""
        c = B.consts(state.peg_pos.device)
        touch_r = B.touching(c["right"], state.right, state.peg_pos, r_tip)
        touch_l = B.touching(c["left"], state.left, state.socket_pos, l_tip)
        peg_up = state.peg_pos[:, 2] > TABLE_Z + PEG_HALF[2] + LIFT_EPS
        sock_up = state.socket_pos[:, 2] > TABLE_Z + SOCKET_HALF[2] + LIFT_EPS
        delta = state.peg_pos - state.socket_pos
        # the peg approaches the socket's mouth from +x
        gap = delta[:, 0] - (PEG_HALF[0] + SOCKET_HALF[0])
        aligned = (delta[:, 1:].abs() < INSERT_TOL_YZ).all(-1)
        up = peg_up & sock_up
        touching = (gap < 0.005) & aligned & up
        inserted = (delta[:, 0] < PEG_HALF[0] + SOCKET_HALF[0]
                    - INSERT_DEPTH) & aligned & up
        zero = torch.zeros_like(delta[:, 0])
        r = torch.where(touch_l & touch_r, 1.0, zero)
        r = torch.where(touch_l & touch_r & up, 2.0, r)
        r = torch.where(touching, 3.0, r)
        return torch.where(inserted, 4.0, r)

    # ------------------------------------------------------------------
    def env_state(self, state: AlohaInsertionState) -> torch.Tensor:
        """(N, 14): the peg's and the socket's poses (identity rotations)."""
        ident = _consts(state.peg_pos.device)["identity"].expand(
            state.peg_pos.shape[0], 4)
        return torch.cat([state.peg_pos, ident, state.socket_pos, ident], -1)

    def scene(self, state: AlohaInsertionState) -> R.Scene:
        c, k = B.consts(state.peg_pos.device), _consts(state.peg_pos.device)
        n = state.peg_pos.shape[0]
        objs = torch.stack([state.peg_pos, state.socket_pos], 1)
        obj_rot = c["eye"].expand(n, 2, 3, 3)
        obj_size = k["obj_size"].expand(n, 2, 3)
        obj_color = k["obj_color"].expand(n, 2, 3)
        plane = dict(plane_z=k["plane_z"].expand(n),
                     plane_color=k["plane_color"].expand(n, 3))
        if self.mesh_mode == "kdop":
            lp, lr, ls, lc, lpl = B.arm_scene_prims_kdop(
                c["left"], state.left, c["left_color"])
            rp, rr, rs, rc, rpl = B.arm_scene_prims_kdop(
                c["right"], state.right, c["right_color"])
            planes = torch.cat([lpl, rpl, k["obj_rows"]])
            return R.Scene(
                pos=torch.cat([lp, rp, objs], 1),
                rot=torch.cat([lr, rr, obj_rot], 1),
                size=torch.cat([ls, rs, obj_size], 1),
                color=torch.cat([lc, rc, obj_color], 1),
                kind=k["kind_kdop"].expand(n, 20),
                planes=planes.expand(n, *planes.shape), **plane)
        lp, lr, ls, lc = B.arm_scene_prims(c["left"], state.left,
                                           c["left_color"])
        rp, rr, rs, rc = B.arm_scene_prims(c["right"], state.right,
                                           c["right_color"])
        return R.Scene(pos=torch.cat([objs, lp, rp], 1),
                       rot=torch.cat([obj_rot, lr, rr], 1),
                       size=torch.cat([obj_size, ls, rs], 1),
                       color=torch.cat([obj_color, lc, rc], 1),
                       kind=k["kind_box"].expand(n, 10), **plane)

    # ------------------------------------------------------------------
    def scripted_action(self, state: AlohaInsertionState,
                        generator: torch.Generator | None = None,
                        noise: float = 0.0) -> torch.Tensor:
        """Two-arm insertion expert: each arm grasps its object and lifts it
        to the meet height, then the right arm drives the peg in."""
        c, k = B.consts(state.peg_pos.device), _consts(state.peg_pos.device)
        peg, sock = state.peg_pos, state.socket_pos
        l_tip, _ = B.eef(c["left"], state.left)
        r_tip, _ = B.eef(c["right"], state.right)
        one, zero = c["one"].expand_as(peg[:, 0]), c["zero"].expand_as(
            peg[:, 0])

        def arm_plan(tip, obj, held, meet):
            above = obj + k["above"]
            xy_near = torch.linalg.norm(obj[:, :2] - tip[:, :2], dim=-1) < 0.015
            z_near = (obj[:, 2] - tip[:, 2]).abs() < 0.015
            target = torch.where(held[:, None], meet,
                                 torch.where(xy_near[:, None], obj, above))
            grip = torch.where(held | (xy_near & z_near), zero, one)
            return target, grip

        both_up = state.peg_held & state.socket_held
        sock_at_meet = torch.linalg.norm(sock - k["meet_l"], dim=-1) < 0.02
        # once both are held and the socket is placed, the peg drives in
        r_meet = torch.where((both_up & sock_at_meet)[:, None],
                             sock + k["insert"], k["stage_r"].expand_as(peg))
        l_target, l_grip = arm_plan(l_tip, sock, state.socket_held,
                                    k["meet_l"].expand_as(sock))
        r_target, r_grip = arm_plan(r_tip, peg, state.peg_held, r_meet)
        ql = B.scripted_arm_action(c["left"], state.left, l_target, 0.015)
        qr = B.scripted_arm_action(c["right"], state.right, r_target, 0.015)
        act = torch.cat([ql, l_grip[:, None], qr, r_grip[:, None]], -1)
        if noise > 0.0 and generator is not None:
            act = act + noise * torch.randn(act.shape, generator=generator,
                                            device=act.device)
        return act
