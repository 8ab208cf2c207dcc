"""MJCF scene importer: XML and STL assets → chains, geoms, actuators,
cameras and k-DOP hulls.

Counterpart of ``latent_diffusion_planning_tpu/envs/mjcf.py``, with numpy on
the host as there; only ``chain_from_mjcf`` differs, returning the port's
``physics/kinematics.JointChain`` of float32 tensors (on the CPU; ``.to``
moves it). The reference's lowest layer is MuJoCo reading MJCF scene files;
this module reads that dialect directly, without MuJoCo:

- ``parse_mjcf`` resolves ``<include>`` files and walks ``<worldbody>`` into
  a body tree with joints, geoms and cameras; it reads ``<actuator>``
  position entries (kp, ctrlrange), ``<keyframe>`` qpos and ``<asset>``
  meshes (the bounding boxes of binary STL files);
- ``chain_from_mjcf`` follows a named body's descendant spine of hinge
  joints into a ``JointChain`` (body quaternions become the chain's fixed
  link rotations); ``chain_joint_limits`` gives its actuator ranges;
- ``static_scene_prims`` places a box for every geom on an unjointed root
  body (tables, bins, pegs);
- ``kdop_directions``, ``fit_kdop``, ``stl_vertices`` and ``body_kdops``
  fit k-DOP hulls over a body's mesh vertices for kernel C's convex prims.

The port's ALOHA constants (``envs/aloha_constants.py``, the ViperX chain)
were transcribed from the reference's files; the reference's assets are not
in this repository, so the importer is held on a synthetic MJCF fixture.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any
from xml.etree import ElementTree as ET

import numpy as np


# ---------------------------------------------------------------------------
# low-level helpers
# ---------------------------------------------------------------------------

def _floats(s: str | None, default=None):
    if s is None:
        return default
    return np.asarray([float(v) for v in s.split()], np.float64)


def _euler_to_quat(euler: np.ndarray) -> np.ndarray:
    """MuJoCo default eulerseq 'xyz' (extrinsic) → wxyz quaternion."""
    def axis_quat(axis, angle):
        h = angle / 2.0
        q = np.zeros(4)
        q[0] = np.cos(h)
        q[1 + axis] = np.sin(h)
        return q

    def mul(a, b):
        w1, x1, y1, z1 = a
        w2, x2, y2, z2 = b
        return np.asarray([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])

    # extrinsic xyz: q = qz * qy * qx applied right-to-left on vectors
    q = axis_quat(0, euler[0])
    q = mul(axis_quat(1, euler[1]), q)
    q = mul(axis_quat(2, euler[2]), q)
    return q


def _elem_quat(e: ET.Element) -> np.ndarray:
    if e.get("quat") is not None:
        return _floats(e.get("quat"))
    if e.get("euler") is not None:
        return _euler_to_quat(_floats(e.get("euler")))
    return np.asarray([1.0, 0.0, 0.0, 0.0])


def stl_bbox(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """(center, half_extents) of a binary STL mesh."""
    raw = Path(path).read_bytes()
    n = struct.unpack_from("<I", raw, 80)[0]
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    off = 84
    for _ in range(n):
        tri = np.frombuffer(raw, np.float32, 12, off)  # normal + 3 verts
        verts = tri[3:].reshape(3, 3)
        lo = np.minimum(lo, verts.min(0))
        hi = np.maximum(hi, verts.max(0))
        off += 50
    return (lo + hi) / 2.0, (hi - lo) / 2.0


# ---------------------------------------------------------------------------
# model structures
# ---------------------------------------------------------------------------

@dataclass
class Joint:
    name: str
    type: str            # hinge | slide | free
    pos: np.ndarray
    axis: np.ndarray
    range: np.ndarray | None


@dataclass
class GeomSpec:
    type: str            # box | sphere | mesh | ...
    size: np.ndarray | None
    pos: np.ndarray
    quat: np.ndarray
    rgba: np.ndarray
    mesh: str | None
    name: str | None


@dataclass
class CameraSpec:
    name: str
    pos: np.ndarray
    fovy: float
    mode: str | None
    target: str | None
    xyaxes: np.ndarray | None


@dataclass
class Body:
    name: str
    pos: np.ndarray
    quat: np.ndarray
    parent: str | None
    joints: list[Joint] = field(default_factory=list)
    geoms: list[GeomSpec] = field(default_factory=list)
    cameras: list[CameraSpec] = field(default_factory=list)
    children: list[str] = field(default_factory=list)


@dataclass
class Actuator:
    joint: str
    kp: float
    ctrlrange: np.ndarray | None


@dataclass
class MJCFModel:
    bodies: dict[str, Body]
    meshes: dict[str, tuple[np.ndarray, np.ndarray]]   # name → (center, half)
    actuators: list[Actuator]
    keyframes: list[np.ndarray]
    root_bodies: list[str]

    def subtree(self, name: str):
        out = [name]
        for child in self.bodies[name].children:
            out += self.subtree(child)
        return out


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

def _resolve_includes(path: Path) -> ET.Element:
    """Parse an MJCF file, splicing <include file=.../> in place (MuJoCo
    semantics: the included file's root children replace the include node;
    <mujocoinclude> wrappers unwrap)."""
    root = ET.parse(path).getroot()

    def splice(elem: ET.Element):
        i = 0
        while i < len(elem):
            child = elem[i]
            if child.tag == "include":
                inc_path = path.parent / child.get("file")
                inc_root = _resolve_includes(inc_path)
                nodes = (list(inc_root) if inc_root.tag in
                         ("mujoco", "mujocoinclude") else [inc_root])
                elem.remove(child)
                for j, node in enumerate(nodes):
                    elem.insert(i + j, node)
                i += len(nodes)
            else:
                splice(child)
                i += 1

    splice(root)
    return root


def parse_mjcf(path: str | Path, load_meshes: bool = True) -> MJCFModel:
    path = Path(path)
    root = _resolve_includes(path)

    meshes: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    if load_meshes:
        for mesh in root.iter("mesh"):
            name = mesh.get("name") or Path(mesh.get("file")).stem
            f = path.parent / mesh.get("file")
            if f.exists():
                center, half = stl_bbox(f)
                scale = _floats(mesh.get("scale"), np.ones(3))
                meshes[name] = (center * scale, half * scale)

    bodies: dict[str, Body] = {}
    roots: list[str] = []

    def walk(elem: ET.Element, parent: str | None):
        for child in elem:
            if child.tag != "body":
                continue
            name = child.get("name") or f"body_{len(bodies)}"
            body = Body(name=name, pos=_floats(child.get("pos"), np.zeros(3)),
                        quat=_elem_quat(child), parent=parent)
            for j in child.findall("joint"):
                body.joints.append(Joint(
                    name=j.get("name") or "",
                    type=j.get("type", "hinge"),
                    pos=_floats(j.get("pos"), np.zeros(3)),
                    axis=_floats(j.get("axis"), np.asarray([0.0, 0.0, 1.0])),
                    range=_floats(j.get("range"))))
            for g in child.findall("geom"):
                body.geoms.append(GeomSpec(
                    type=g.get("type", "sphere"),
                    size=_floats(g.get("size")),
                    pos=_floats(g.get("pos"), np.zeros(3)),
                    quat=_elem_quat(g),
                    rgba=_floats(g.get("rgba"),
                                 np.asarray([0.5, 0.5, 0.5, 1.0])),
                    mesh=g.get("mesh"), name=g.get("name")))
            for c in child.findall("camera"):
                body.cameras.append(CameraSpec(
                    name=c.get("name") or "", pos=_floats(c.get("pos"),
                                                          np.zeros(3)),
                    fovy=float(c.get("fovy", 45.0)), mode=c.get("mode"),
                    target=c.get("target"),
                    xyaxes=_floats(c.get("xyaxes"))))
            bodies[name] = body
            if parent is None:
                roots.append(name)
            else:
                bodies[parent].children.append(name)
            walk(child, name)

    for wb in root.iter("worldbody"):
        walk(wb, None)

    actuators = [Actuator(joint=a.get("joint"), kp=float(a.get("kp", 1.0)),
                          ctrlrange=_floats(a.get("ctrlrange")))
                 for a in root.iter("position")]
    keyframes = [_floats(k.get("qpos")) for k in root.iter("key")
                 if k.get("qpos")]
    return MJCFModel(bodies=bodies, meshes=meshes, actuators=actuators,
                     keyframes=keyframes, root_bodies=roots)


# ---------------------------------------------------------------------------
# chains + scenes
# ---------------------------------------------------------------------------

def chain_from_mjcf(model: MJCFModel, root_body: str, tip_offset=None):
    """Follow ``root_body``'s descendant spine of hinge joints → JointChain.

    Stops at the first body with no hinge-jointed child (slide-joint fingers
    end the arm chain). Body quats become fixed per-link rotations.
    """
    import torch

    from .physics.kinematics import JointChain

    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)

    offsets, axes, link_quats = [], [], []
    base = model.bodies[root_body]
    node = base
    while True:
        nxt = None
        for child_name in node.children:
            child = model.bodies[child_name]
            if any(j.type == "hinge" for j in child.joints):
                nxt = child
                break
        if nxt is None:
            break
        j = next(j for j in nxt.joints if j.type == "hinge")
        offsets.append(nxt.pos)
        link_quats.append(nxt.quat)
        axes.append(j.axis / np.linalg.norm(j.axis))
        node = nxt
    tip = np.asarray(tip_offset if tip_offset is not None else [0.0, 0.0, 0.0])
    return JointChain(
        offsets=f32(np.stack(offsets)), axes=f32(np.stack(axes)),
        base_pos=f32(base.pos), base_quat=f32(base.quat),
        tip_offset=f32(tip), link_quats=f32(np.stack(link_quats)))


def chain_joint_limits(model: MJCFModel, root_body: str):
    """(lo, hi) actuator ctrlranges for the chain's joints, in chain order."""
    ranges = {a.joint: a.ctrlrange for a in model.actuators
              if a.ctrlrange is not None}
    lo, hi = [], []
    node = model.bodies[root_body]
    while True:
        nxt = None
        for child_name in node.children:
            child = model.bodies[child_name]
            if any(j.type == "hinge" for j in child.joints):
                nxt = child
                break
        if nxt is None:
            break
        j = next(j for j in nxt.joints if j.type == "hinge")
        r = ranges.get(j.name, j.range)
        lo.append(r[0] if r is not None else -np.pi)
        hi.append(r[1] if r is not None else np.pi)
        node = nxt
    return np.asarray(lo, np.float32), np.asarray(hi, np.float32)


def static_scene_prims(model: MJCFModel) -> list[dict]:
    """World-placed box primitives for geoms on unjointed root subtrees
    (tables, fixed fixtures) — feed ops/render.Scene."""
    prims = []
    for name in model.root_bodies:
        body = model.bodies[name]
        if body.joints:
            continue
        for g in body.geoms:
            if g.type == "mesh" and g.mesh in model.meshes:
                center, half = model.meshes[g.mesh]
                prims.append(dict(pos=body.pos + g.pos + center, half=half,
                                  rgba=g.rgba, name=g.name))
            elif g.type == "box" and g.size is not None:
                prims.append(dict(pos=body.pos + g.pos, half=g.size,
                                  rgba=g.rgba, name=g.name))
    return prims


# ---------------------------------------------------------------------------
# mesh-accurate convex fitting: k-DOPs for the ray-cast renderer
# ---------------------------------------------------------------------------
# The renderer's mesh mode (ops/render.Scene kind=2) intersects rays with
# convex polytopes given as body-frame half-space sets. A k-DOP (discrete
# oriented polytope) is the tightest such set over a fixed direction family:
# for each unit direction n, offset d = max over mesh vertices of n·v. With
# K=26 directions (axes, edges, corners of a cube) robot-link silhouettes at
# 64×64 are close to the true mesh while keeping the per-ray cost fixed
# (static shapes, a fixed loop in kernel C). Reference parity:
# MuJoCo renders the actual STL triangles through EGL
# (envs/robosuite_env.py:42-48); at the 64-pixel policy-input resolution the
# k-DOP hull is visually near-identical and ~100× cheaper than per-triangle
# intersection.


def kdop_directions(k: int = 26) -> np.ndarray:
    """The standard k-DOP direction family: 6 axis, 12 edge, 8 corner
    directions of the unit cube (k ∈ {6, 18, 26} supported), unit-norm."""
    axes = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
            [0, 0, -1]]
    edges = [[sx, sy, 0] for sx in (1, -1) for sy in (1, -1)] + \
            [[sx, 0, sz] for sx in (1, -1) for sz in (1, -1)] + \
            [[0, sy, sz] for sy in (1, -1) for sz in (1, -1)]
    corners = [[sx, sy, sz] for sx in (1, -1) for sy in (1, -1)
               for sz in (1, -1)]
    if k == 6:
        dirs = axes
    elif k == 18:
        dirs = axes + edges
    elif k == 26:
        dirs = axes + edges + corners
    else:
        raise ValueError(f"k-DOP family must be 6/18/26, got {k}")
    d = np.asarray(dirs, np.float64)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def stl_vertices(path: str | Path) -> np.ndarray:
    """All (deduplicated) vertices of a binary STL mesh, (V, 3) float32."""
    raw = Path(path).read_bytes()
    n = struct.unpack_from("<I", raw, 80)[0]
    tri = np.frombuffer(raw, np.uint8, n * 50, 84)
    tri = tri.reshape(n, 50)[:, :48].copy().view(np.float32).reshape(n, 12)
    verts = tri[:, 3:].reshape(-1, 3)
    return np.unique(verts, axis=0)


def fit_kdop(verts: np.ndarray, dirs: np.ndarray | None = None) -> np.ndarray:
    """Fit a k-DOP to a vertex cloud → (K, 4) half-space rows (n, d):
    inside ⇔ n·x ≤ d. Plug into ops/render.Scene.planes (kind=2)."""
    if dirs is None:
        dirs = kdop_directions(26)
    offs = (verts[None, :, :] * dirs[:, None, :]).sum(-1).max(axis=1)
    return np.concatenate([dirs, offs[:, None]], axis=-1).astype(np.float32)


def _quat_mat_np(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion → 3×3 rotation matrix (numpy, host-side)."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def body_kdops(xml_path: str | Path, body_names: list[str],
               dirs: np.ndarray | None = None) -> dict[str, np.ndarray]:
    """Per-body k-DOPs over each body's mesh-geom vertices (body frame).

    Walks the (include-resolved) MJCF, loads every referenced STL's vertex
    cloud, transforms it by the geom's pos/quat/scale into the owning body's
    frame, and fits one k-DOP per requested body over the union of its mesh
    geoms. Bodies without mesh geoms are omitted.
    """
    if dirs is None:
        dirs = kdop_directions(26)
    xml_path = Path(xml_path)
    root = _resolve_includes(xml_path)
    mesh_files: dict[str, tuple[Path, np.ndarray]] = {}
    for mesh in root.iter("mesh"):
        name = mesh.get("name") or Path(mesh.get("file")).stem
        mesh_files[name] = (xml_path.parent / mesh.get("file"),
                            _floats(mesh.get("scale"), np.ones(3)))
    vert_cache: dict[str, np.ndarray] = {}
    out: dict[str, np.ndarray] = {}
    want = set(body_names)
    for body in root.iter("body"):
        name = body.get("name") or ""
        if name not in want:
            continue
        clouds = []
        for g in body.findall("geom"):
            if g.get("type") != "mesh" or g.get("mesh") not in mesh_files:
                continue
            mesh_name = g.get("mesh")
            if mesh_name not in vert_cache:
                f, scale = mesh_files[mesh_name]
                if not f.exists():
                    continue
                vert_cache[mesh_name] = stl_vertices(f) * scale
            v = vert_cache[mesh_name]
            rot_g = _quat_mat_np(_elem_quat(g))
            pos_g = _floats(g.get("pos"), np.zeros(3))
            clouds.append(v @ rot_g.T + pos_g)
        if clouds:
            out[name] = fit_kdop(np.concatenate(clouds, axis=0), dirs)
    return out
