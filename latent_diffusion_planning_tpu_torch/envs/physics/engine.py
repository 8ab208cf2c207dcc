"""Rigid-body physics core, batched over envs: free bodies, kinematic
("mocap") bodies and a static world, soft penalty contacts with Coulomb
friction, semi-implicit Euler.

Counterpart of ``latent_diffusion_planning_tpu/envs/physics/engine.py``. The
JAX engine steps one env and is ``vmap``ped under ``jit``; here every state
tensor leads with the env axis N and one substep is eager tensor code, so
its cost on the card is its number of launches. The design follows from
that:

- The model is static (which geoms exist, which pairs can touch, which body
  each contact acts on), so ``World.create`` plans the contacts once
  (``ContactPlan``) and a step computes all contacts of one kind in one
  batched call (box corners on the plane, spheres on the plane, sphere-box,
  box-box corners, sphere-sphere) instead of looping over geoms and pairs.
- Forces are summed per body through a fixed signed (contacts × bodies)
  matrix and a plain reduction, never a scatter-add: ``index_add_`` on the
  card adds with atomics in no fixed order, and contact physics amplifies
  that noise over hundreds of substeps.
- One rotation matrix per body per substep serves the geom poses, the point
  velocities and the torque's body frame.

The contact list is the JAX engine's without its padding: a sphere on the
plane is one candidate here (the JAX engine emits eight and masks seven).
``ContactPlan.reference_index`` maps each contact to its row there.
Semantics that carry over unchanged: body id −1 is the static world,
``argmin`` ties take the first index, ``sign(0) = 0``, the guarded
divisions, and the per-body split of the impulse caps (which, for a contact
with the static world, reads body 0's count, as the JAX engine does).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ...ops import rotations as rot

GEOM_SPHERE = 0
GEOM_BOX = 1

_CORNER_SIGNS = np.asarray(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
     for sz in (-1.0, 1.0)], np.float32)  # (8, 3)


class PhysicsParams(NamedTuple):
    dt: float = 0.002
    gravity: float = -9.81
    kn: float = 8000.0        # contact normal stiffness (N/m per unit mass)
    cn: float = 60.0          # contact normal damping
    mu: float = 1.0           # Coulomb friction coefficient
    kt: float = 400.0         # tangential (stiction) velocity gain
    angular_damping: float = 0.05
    linear_damping: float = 0.01


@dataclass(frozen=True)
class Geom:
    """Collision geometry attached to a body (body_id −1: the static
    world). Static model data, kept as numpy."""

    kind: np.ndarray         # (G,) int32
    size: np.ndarray         # (G, 3): box half-extents / sphere radius in [0]
    offset: np.ndarray       # (G, 3) position in body frame
    body_id: np.ndarray      # (G,) int32


def make_box_geom(half_extents, body_id: int, offset=(0, 0, 0)) -> dict:
    return dict(kind=GEOM_BOX, size=np.asarray(half_extents, np.float32),
                offset=np.asarray(offset, np.float32), body_id=body_id)


def make_sphere_geom(radius: float, body_id: int, offset=(0, 0, 0)) -> dict:
    return dict(kind=GEOM_SPHERE,
                size=np.asarray([radius, 0.0, 0.0], np.float32),
                offset=np.asarray(offset, np.float32), body_id=body_id)


def build_geoms(specs: list[dict]) -> Geom:
    return Geom(kind=np.asarray([s["kind"] for s in specs], np.int32),
                size=np.stack([s["size"] for s in specs]),
                offset=np.stack([s["offset"] for s in specs]),
                body_id=np.asarray([s["body_id"] for s in specs], np.int32))


@dataclass
class RigidBody:
    """Dynamic-body state of N envs × NB bodies."""

    pos: torch.Tensor        # (N, NB, 3)
    quat: torch.Tensor       # (N, NB, 4) wxyz
    linvel: torch.Tensor     # (N, NB, 3)
    angvel: torch.Tensor     # (N, NB, 3) body frame

    @classmethod
    def create(cls, pos, quat=None, linvel=None, angvel=None) -> "RigidBody":
        pos = torch.as_tensor(pos, dtype=torch.float32)
        if pos.ndim == 2:
            pos = pos[None]
        f = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                      device=pos.device).expand(
                                          *pos.shape[:2], -1)
        return cls(pos=pos,
                   quat=f(quat if quat is not None else [1.0, 0.0, 0.0, 0.0]),
                   linvel=f(linvel) if linvel is not None
                   else torch.zeros_like(pos),
                   angvel=f(angvel) if angvel is not None
                   else torch.zeros_like(pos))

    def map(self, fn, *others: "RigidBody") -> "RigidBody":
        """Apply ``fn`` field by field (to this state and ``others``)."""
        return RigidBody(**{
            f.name: fn(getattr(self, f.name),
                       *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)})


@dataclass
class Contact:
    point: torch.Tensor      # (N, C, 3) world
    normal: torch.Tensor     # (N, C, 3) pointing from B into A
    depth: torch.Tensor      # (N, C)  > 0 when penetrating
    body_a: tuple            # C static ints (−1: the static world)
    body_b: tuple


def _selector(idx: list[int]):
    """A slice where the indices are a run, else the list (made a device
    tensor by ``World.on``)."""
    if idx and idx == list(range(idx[0], idx[0] + len(idx))):
        return slice(idx[0], idx[0] + len(idx))
    return list(idx)


class ContactPlan:
    """Which contacts exist, by kind, for a static geom soup: the JAX
    engine's pair loop (``generate_contacts``) run once over the model."""

    def __init__(self, geoms: Geom):
        kinds = [int(k) for k in geoms.kind]
        bids = [int(b) for b in geoms.body_id]
        G = len(kinds)
        self.plane_box = [g for g in range(G)
                          if bids[g] >= 0 and kinds[g] == GEOM_BOX]
        self.plane_sphere = [g for g in range(G)
                             if bids[g] >= 0 and kinds[g] == GEOM_SPHERE]
        self.sphere_box, self.box_box, self.sphere_sphere = [], [], []
        # rows of the JAX engine's contact list, in its order
        row = 8 * len([g for g in range(G) if bids[g] >= 0])
        ref_pair = {}
        for a in range(G):
            for b in range(G):
                if a == b or bids[a] == bids[b] or bids[a] < 0:
                    continue
                ka, kb = kinds[a], kinds[b]
                if ka == GEOM_SPHERE and kb == GEOM_BOX:
                    self.sphere_box.append((a, b))
                    ref_pair["sb", len(self.sphere_box) - 1] = row
                    row += 1
                elif ka == GEOM_BOX and kb == GEOM_SPHERE and bids[b] < 0:
                    self.sphere_box.append((b, a))
                    ref_pair["sb", len(self.sphere_box) - 1] = row
                    row += 1
                elif ka == GEOM_BOX and kb == GEOM_BOX and a < b:
                    for pair in ((a, b), (b, a)):
                        self.box_box.append(pair)
                        ref_pair["bb", len(self.box_box) - 1] = row
                        row += 8
                elif ka == GEOM_SPHERE and kb == GEOM_SPHERE and a < b:
                    self.sphere_sphere.append((a, b))
                    ref_pair["ss", len(self.sphere_sphere) - 1] = row
                    row += 1
        self.n_reference = row
        dyn = [g for g in range(G) if bids[g] >= 0]
        body_a, body_b, ref = [], [], []
        for g in self.plane_box:
            body_a += [bids[g]] * 8
            body_b += [-1] * 8
            ref += [8 * dyn.index(g) + i for i in range(8)]
        for g in self.plane_sphere:
            body_a.append(bids[g])
            body_b.append(-1)
            ref.append(8 * dyn.index(g))
        for i, (s, b) in enumerate(self.sphere_box):
            body_a.append(bids[s])
            body_b.append(bids[b])
            ref.append(ref_pair["sb", i])
        for i, (a, b) in enumerate(self.box_box):
            body_a += [bids[a]] * 8
            body_b += [bids[b]] * 8
            ref += [ref_pair["bb", i] + k for k in range(8)]
        for i, (a, b) in enumerate(self.sphere_sphere):
            body_a.append(bids[a])
            body_b.append(bids[b])
            ref.append(ref_pair["ss", i])
        self.body_a, self.body_b = tuple(body_a), tuple(body_b)
        self.reference_index = np.asarray(ref, np.int64)
        self.n_contacts = len(body_a)


class World:
    """Static model: masses/inertias per body + geom soup + ground plane +
    the contact plan. ``on(device)`` gives the model's constants as tensors
    on a device, made once."""

    def __init__(self, mass, inertia, geoms: Geom, plane_z: float, kinematic):
        self.mass = np.asarray(mass, np.float32)
        self.inertia = np.asarray(inertia, np.float32)
        self.geoms = geoms
        self.plane_z = float(plane_z)
        self.kinematic = np.asarray(kinematic, bool)
        self.geom_kinds = tuple(int(k) for k in geoms.kind)
        self.geom_body_ids = tuple(int(b) for b in geoms.body_id)
        self.plan = ContactPlan(geoms)
        self._on: dict = {}

    @classmethod
    def create(cls, mass, inertia, geoms: Geom, plane_z=0.0,
               kinematic=None) -> "World":
        mass = np.asarray(mass, np.float32)
        return cls(mass, inertia, geoms, plane_z,
                   kinematic if kinematic is not None
                   else np.zeros(mass.shape[0], bool))

    @property
    def n_bodies(self) -> int:
        return self.mass.shape[0]

    def on(self, device) -> dict:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = self._tensors(device)
        return self._on[device]

    def _tensors(self, device) -> dict:
        plan, g, nb = self.plan, self.geoms, self.n_bodies
        f = lambda v: torch.as_tensor(np.asarray(v, np.float32)).to(device)

        def sel(idx):
            idx = _selector(idx)
            return idx if isinstance(idx, slice) else torch.as_tensor(
                idx, dtype=torch.long).to(device)

        bids = np.asarray(self.geom_body_ids)
        a, b = np.asarray(plan.body_a), np.asarray(plan.body_b)
        onehot = lambda ids: ((ids[:, None] == np.arange(nb)[None])
                              & (ids[:, None] >= 0)).astype(np.float32)
        inv = lambda ids: np.where(
            ids < 0, 0.0, np.where(self.kinematic[np.maximum(ids, 0)], 0.0,
                                   1.0 / self.mass[np.maximum(ids, 0)]))
        inv_mass = (inv(a) + inv(b)).astype(np.float32)
        pair = lambda pairs, k: sel([p[k] for p in pairs])
        t = dict(
            mass=f(self.mass)[:, None], inertia=f(self.inertia),
            kinematic=torch.as_tensor(self.kinematic).to(device)[:, None],
            # geom poses: identity when geom g sits at body g's origin
            geoms_are_bodies=bool(len(bids) == nb and (bids == np.arange(nb)).all()
                                  and not g.offset.any()),
            geom_body=torch.as_tensor(np.maximum(bids, 0), dtype=torch.long).to(device),
            geom_static=torch.as_tensor(bids < 0).to(device)[:, None],
            geom_offset=f(g.offset),
            plane_box=sel(plan.plane_box),
            plane_sphere=sel(plan.plane_sphere),
            box_corners=f(_CORNER_SIGNS[None] * g.size[plan.plane_box][:, None]),
            plane_sphere_drop=f(np.stack(
                [np.zeros(len(plan.plane_sphere)), np.zeros(len(plan.plane_sphere)),
                 g.size[plan.plane_sphere, 0]], -1)) if plan.plane_sphere
            else None,
            up=f([0.0, 0.0, 1.0]),
            sb_s=pair(plan.sphere_box, 0), sb_b=pair(plan.sphere_box, 1),
            sb_r=f(g.size[[s for s, _ in plan.sphere_box], 0]),
            sb_half=f(g.size[[b_ for _, b_ in plan.sphere_box]]),
            bb_a=pair(plan.box_box, 0), bb_b=pair(plan.box_box, 1),
            bb_corners=f(_CORNER_SIGNS[None]
                         * g.size[[a_ for a_, _ in plan.box_box]][:, None]),
            bb_half=f(g.size[[b_ for _, b_ in plan.box_box]])[:, None],
            ss_a=pair(plan.sphere_sphere, 0), ss_b=pair(plan.sphere_sphere, 1),
            ss_ra=f(g.size[[a_ for a_, _ in plan.sphere_sphere], 0]),
            ss_rb=f(g.size[[b_ for _, b_ in plan.sphere_sphere], 0]),
            arange3=torch.arange(3).to(device),
            # per contact: clamped body ids of both sides (a then b), whether
            # each side is a body at all, its share of each body's sums
            ab=torch.as_tensor(np.maximum(np.concatenate([a, b]), 0),
                               dtype=torch.long).to(device),
            ab_is_body=f(np.concatenate([a, b]) >= 0)[:, None],
            count_matrix=f(onehot(a) + onehot(b)),
            force_matrix=f(onehot(a) - onehot(b)),
            m_eff=f(1.0 / np.maximum(inv_mass, 1e-6)),
        )
        return t


# ---------------------------------------------------------------------------
# contact generation
# ---------------------------------------------------------------------------

def _geom_poses(w: dict, body: RigidBody, mats: torch.Tensor):
    """World position (N, G, 3) and rotation (N, G, 3, 3) of every geom."""
    if w["geoms_are_bodies"]:
        return body.pos, mats
    gb = w["geom_body"]
    r = mats[:, gb]
    pos = torch.where(w["geom_static"], w["geom_offset"],
                      body.pos[:, gb] + rot.rotate(r, w["geom_offset"]))
    eye = rot._tables(pos.device, pos.dtype)["eye"].reshape(3, 3)
    return pos, torch.where(w["geom_static"][..., None], eye, r)


def _first_argmin_face(face_pen: torch.Tensor, local: torch.Tensor, w: dict):
    """Min-penetration face of a box: (penetration along it, its outward
    normal in the box frame, sign(local[axis]) e_axis). Ties take the first
    axis (``torch.argmin`` returns the first minimal index)."""
    axis = torch.argmin(face_pen, dim=-1, keepdim=True)
    onehot = (axis == w["arange3"]).to(face_pen.dtype)
    return (face_pen * onehot).sum(-1), torch.sign(local) * onehot


def _generate(world: World, body: RigidBody, mats: torch.Tensor) -> Contact:
    w = world.on(body.pos.device)
    plan = world.plan
    N = body.pos.shape[0]
    gpos, grot = _geom_poses(w, body, mats)
    points, normals, depths = [], [], []

    if plan.plane_box:          # 8 corners of each box against the plane
        sel = w["plane_box"]
        corners = gpos[:, sel, None] + rot.rotate(grot[:, sel, None],
                                                  w["box_corners"])
        points.append(corners.reshape(N, -1, 3))
        normals.append(w["up"].expand(N, 8 * len(plan.plane_box), 3))
        depths.append(world.plane_z - points[-1][..., 2])
    if plan.plane_sphere:       # the bottom point of each sphere
        pts = gpos[:, w["plane_sphere"]] - w["plane_sphere_drop"]
        points.append(pts)
        normals.append(w["up"].expand(N, len(plan.plane_sphere), 3))
        depths.append(world.plane_z - pts[..., 2])
    if plan.sphere_box:
        sp, bp, br = gpos[:, w["sb_s"]], gpos[:, w["sb_b"]], grot[:, w["sb_b"]]
        r, half = w["sb_r"], w["sb_half"]
        local = rot.rotate_t(br, sp - bp)
        closest = torch.minimum(torch.maximum(local, -half), half)
        delta = local - closest
        dist = torch.linalg.norm(delta, dim=-1)
        outside = dist > 1e-9
        # centre inside the box: push out along the min-penetration face
        pen, inside_n = _first_argmin_face(half - local.abs(), local, w)
        n_local = torch.where(outside[..., None],
                              delta / torch.clamp(dist, min=1e-9)[..., None],
                              inside_n)
        depth = torch.where(outside, r - dist, r + pen)
        normal = rot.rotate(br, n_local)      # from the box into the sphere
        points.append(sp - normal * r[:, None])
        normals.append(normal)
        depths.append(depth)
    if plan.box_box:            # corners of box a inside box b
        ap, ar = gpos[:, w["bb_a"]], grot[:, w["bb_a"]]
        bp, br = gpos[:, w["bb_b"]], grot[:, w["bb_b"]]
        corners = ap[:, :, None] + rot.rotate(ar[:, :, None], w["bb_corners"])
        local = rot.rotate_t(br[:, :, None], corners - bp[:, :, None])
        face_pen = w["bb_half"] - local.abs()                 # (N, B, 8, 3)
        inside = (face_pen > 0).all(-1)
        pen, n_local = _first_argmin_face(face_pen, local, w)
        depth = torch.where(inside, pen, -torch.ones_like(pen))
        normal = rot.rotate(br[:, :, None], n_local)
        points.append(corners.reshape(N, -1, 3))
        normals.append(normal.reshape(N, -1, 3))
        depths.append(depth.reshape(N, -1))
    if plan.sphere_sphere:
        pa, pb = gpos[:, w["ss_a"]], gpos[:, w["ss_b"]]
        d = pa - pb
        dist = torch.linalg.norm(d, dim=-1)
        n = d / torch.clamp(dist, min=1e-9)[..., None]
        depth = w["ss_ra"] + w["ss_rb"] - dist
        points.append(pb + n * (w["ss_rb"] - depth / 2)[..., None])
        normals.append(n)
        depths.append(depth)
    if not points:
        z3 = torch.zeros(N, 1, 3, device=body.pos.device)
        return Contact(z3, z3, -torch.ones(N, 1, device=z3.device), (-1,), (-1,))
    return Contact(torch.cat(points, 1), torch.cat(normals, 1),
                   torch.cat(depths, 1), plan.body_a, plan.body_b)


def generate_contacts(world: World, body: RigidBody) -> Contact:
    """All candidate contacts (fixed count) of every env's scene."""
    return _generate(world, body, rot.quat_to_matrix(body.quat))


# ---------------------------------------------------------------------------
# forces + integration
# ---------------------------------------------------------------------------

def _forces(world: World, body: RigidBody, contacts: Contact,
            params: PhysicsParams, mats: torch.Tensor):
    w = world.on(body.pos.device)
    if contacts.body_a != world.plan.body_a:
        raise ValueError("contacts were not generated from this world")
    C = contacts.depth.shape[1]
    point, normal, depth = contacts.point, contacts.normal, contacts.depth
    active = depth > 0.0

    # world velocity of the contact point on each side (0 for the static
    # world): one gather of (pos, linvel, world angvel) for both sides
    w_world = rot.rotate(mats, body.angvel)
    per_body = torch.cat([body.pos, body.linvel, w_world], -1)[:, w["ab"]]
    arm = torch.cat([point, point], 1) - per_body[..., :3]
    vel = (per_body[..., 3:6] + torch.linalg.cross(per_body[..., 6:], arm)
           ) * w["ab_is_body"]
    rel = vel[:, :C] - vel[:, C:]
    vn = (rel * normal).sum(-1)
    vt = rel - vn[..., None] * normal

    # impulse caps are per-body budgets: split them across that body's
    # simultaneously active contacts
    counts = (active.to(depth.dtype)[:, :, None] * w["count_matrix"]).sum(1)
    per_side = counts[:, w["ab"]]
    n_active = torch.clamp(torch.maximum(per_side[:, :C], per_side[:, C:]),
                           min=1.0)
    m_eff = w["m_eff"] / n_active

    # normal: spring-damper, clamped by the impulse that exits the
    # penetration over tau and cancels the approach velocity
    fn_mag = params.kn * depth - params.cn * vn
    tau = max(4.0 * params.dt, 1e-6)
    fn_cap = m_eff * (torch.clamp(-vn, min=0.0) / params.dt
                      + depth / (tau * params.dt))
    fn_mag = torch.minimum(torch.clamp(fn_mag, min=0.0), fn_cap)
    fn_mag = torch.where(active, fn_mag, torch.zeros_like(fn_mag))
    fn = fn_mag[..., None] * normal

    # friction: viscous model clamped by the Coulomb cone and by the impulse
    # that stops the tangential slip in one step plus a gravity feedforward
    # projected onto the tangent plane
    vt_norm = torch.linalg.norm(vt, dim=-1)
    g_n = params.gravity * normal[..., 2]
    g_vec = params.gravity * w["up"]
    g_tan = torch.linalg.norm(g_vec - g_n[..., None] * normal, dim=-1)
    ft_mag = torch.minimum(
        params.kt * vt_norm,
        torch.minimum(params.mu * fn_mag,
                      m_eff * (vt_norm / params.dt + g_tan)))
    ft = -ft_mag[..., None] * vt / torch.clamp(vt_norm, min=1e-9)[..., None]
    ft = torch.where(active[..., None], ft, torch.zeros_like(ft))

    f = fn + ft                                   # on body_a; −f on body_b
    share = w["force_matrix"][:, :, None]         # (C, NB, 1)
    force = (f[:, :, None, :] * share).sum(1)
    lever = point[:, :, None, :] - body.pos[:, None, :, :]    # (N, C, NB, 3)
    torque = (torch.linalg.cross(lever, f[:, :, None, :].expand_as(lever))
              * share).sum(1)
    return force, torque


def contact_forces(world: World, body: RigidBody, contacts: Contact,
                   params: PhysicsParams):
    """Per-body (force, torque), each (N, NB, 3), from penalty contacts with
    impulse-level stabilization (see the JAX engine's docstring)."""
    return _forces(world, body, contacts, params,
                   rot.quat_to_matrix(body.quat))


def free_body_step(world: World, body: RigidBody, params: PhysicsParams,
                   ext_force: torch.Tensor | None = None,
                   ext_torque: torch.Tensor | None = None) -> RigidBody:
    """One semi-implicit Euler step of all dynamic bodies. Kinematic (mocap)
    bodies keep their state: the caller sets it."""
    w = world.on(body.pos.device)
    mats = rot.quat_to_matrix(body.quat)
    contacts = _generate(world, body, mats)
    force, torque = _forces(world, body, contacts, params, mats)
    if ext_force is not None:
        force = force + ext_force
    if ext_torque is not None:
        torque = torque + ext_torque

    acc = force / w["mass"] + params.gravity * w["up"]
    new_linvel = (body.linvel + params.dt * acc) * (1.0 - params.linear_damping)
    ang_acc = rot.rotate_t(mats, torque) / w["inertia"]
    new_angvel = (body.angvel + params.dt * ang_acc) * (
        1.0 - params.angular_damping)
    new_pos = body.pos + params.dt * new_linvel
    new_quat = rot.quat_integrate(body.quat, new_angvel, params.dt)
    new = RigidBody(new_pos, new_quat, new_linvel, new_angvel)
    return new.map(lambda n, o: torch.where(w["kinematic"], o, n), body)


@functools.cache
def _pair_columns(body_a: tuple, body_b: tuple, body_i: int, body_j: int,
                  device: torch.device) -> torch.Tensor | None:
    """The contact columns between bodies i and j, as a tensor on
    ``device`` made once (a CUDA graph may capture the caller), or None."""
    cols = [c for c, (a, b) in enumerate(zip(body_a, body_b))
            if (a, b) in ((body_i, body_j), (body_j, body_i))]
    return torch.as_tensor(cols).to(device) if cols else None


def pair_in_contact(contacts: Contact, body_i: int, body_j: int) -> torch.Tensor:
    """(N,) bool: any active contact between bodies i and j (−1: the static
    world)."""
    idx = _pair_columns(contacts.body_a, contacts.body_b, body_i, body_j,
                        contacts.depth.device)
    if idx is None:
        return torch.zeros_like(contacts.depth[:, 0], dtype=torch.bool)
    return (contacts.depth[:, idx] > 0.0).any(-1)


def multi_step(world: World, body: RigidBody, params: PhysicsParams,
               n: int) -> RigidBody:
    """n physics substeps (control_dt = n * params.dt)."""
    for _ in range(n):
        body = free_body_step(world, body, params)
    return body
