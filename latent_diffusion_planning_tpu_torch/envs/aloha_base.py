"""Bimanual ViperX joint-space machinery shared by the ALOHA tasks, batched
over envs.

Counterpart of ``latent_diffusion_planning_tpu/envs/aloha_base.py``: 14-dim
actions are absolute joint-position targets (radians) for two 6-DoF
ViperX-300s arms plus a [0, 1] normalized gripper channel per arm, and the
``qpos``/``qvel`` observations are joint-space (the reference's
``alohasim_env.py`` convention). Per-joint position servos with the MJCF
kp-derived tracking bandwidth move the arms over the exact MJCF chains; the
``wrist64`` camera rides the right gripper frame (``vx300s_right.xml:27``:
pos (-0.1, 0, 0.15), fovy 78, looking along the gripper x-axis).

Every function takes the env batch as the leading axis. The device
constants are made once per device (``consts``): a CUDA graph replays the
envs' control steps, so nothing in a step builds a tensor from Python data.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from ..ops import render as R
from ..ops import rotations as rot
from ..ops.kernels import raycast
from . import aloha_constants as C
from .aloha_kdops import ARM_KDOPS, FINGER_SLIDE
from .lift_physics import graphed_transition
from .physics import kinematics as K

TABLE_Z = 0.0
LEFT_BASE = (-0.469, 0.5, 0.0)
RIGHT_BASE = (0.469, 0.5, 0.0)

LEFT_CHAIN = K.viperx300s_chain(LEFT_BASE, base_yaw=0.0)
RIGHT_CHAIN = K.viperx300s_chain(RIGHT_BASE, base_yaw=3.1416)

GRIP_ALPHA = 0.95
GRASP_RADIUS = 0.035
TOUCH_RADIUS = 0.05
CLOSE_THRESH = 0.35       # normalized gripper below this = closing/closed
WRIST_FOV = 78.0
LEFT_COLOR = (0.25, 0.25, 0.35)
RIGHT_COLOR = (0.2, 0.3, 0.2)

# The reference scene's static cameras: (pos, lookat, fovy, (height, width))
TABLE_CENTER = (0.0, 0.6, 0.0)
STATIC_CAMERAS = {
    "top": ((0.0, 0.6, 0.8), TABLE_CENTER, 78.0, (480, 640)),
    "angle": ((0.0, 0.0, 0.6), TABLE_CENTER, 78.0, (480, 640)),
    "front_close": ((0.0, 0.2, 0.4), (0.0, 0.5, 0.1), 78.0, (480, 640)),
    "left_pillar": ((-0.5, 0.2, 0.6), TABLE_CENTER, 78.0, (64, 64)),
    "right_pillar": ((0.5, 0.2, 0.6), TABLE_CENTER, 78.0, (64, 64)),
}


@functools.cache
def consts(device: torch.device) -> dict:
    """The arms' device constants, made once per device."""
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    kp = t(C.ARM_KP)
    return dict(
        left=LEFT_CHAIN.to(device), right=RIGHT_CHAIN.to(device),
        lo=t(C.ARM_JOINT_LO), hi=t(C.ARM_JOINT_HI),
        # first-order servo response per control step from the MJCF kp:
        # alpha = kp DT / (kp DT + c)
        servo_alpha=kp * C.DT / (kp * C.DT + 0.2),
        start_qpos=t(C.START_ARM_QPOS),
        start_grip=t(C.START_GRIPPER_NORMALIZED),
        zero=t(0.0), one=t(1.0),
        cam_offset=t([-0.1, 0.0, 0.15]), x_axis=t([1.0, 0.0, 0.0]),
        y_axis=t([0.0, 1.0, 0.0]),
        finger_x=t(0.0687), finger_lo=t(FINGER_SLIDE[0]),
        finger_span=t(FINGER_SLIDE[1] - FINGER_SLIDE[0]),
        kdops=t(ARM_KDOPS), eye=torch.eye(3, device=device),
        link_width=t([[0.035], [0.028], [0.022], [0.012]]),
        left_color=t([LEFT_COLOR]), right_color=t([RIGHT_COLOR]))


@dataclass
class ArmState:
    qpos: torch.Tensor       # (N, 6) joint angles (rad)
    qvel: torch.Tensor       # (N, 6) rad/s
    grip: torch.Tensor       # (N,) normalized [0 close, 1 open] position
    grip_vel: torch.Tensor   # (N,) normalized /s

    def map(self, fn, *others: "ArmState") -> "ArmState":
        """Apply ``fn`` field by field (to this state and ``others``)."""
        return ArmState(**{
            f.name: fn(getattr(self, f.name),
                       *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)})


def map_state(state, fn, *others):
    """A task state's ``map``: ``fn`` leaf by leaf through its arms, bodies
    and tensors."""
    out = {}
    for f in dataclasses.fields(state):
        mine = getattr(state, f.name)
        theirs = [getattr(o, f.name) for o in others]
        out[f.name] = (mine.map(fn, *theirs) if hasattr(mine, "map")
                       else fn(mine, *theirs))
    return type(state)(**out)


def arm_reset(n: int, device) -> ArmState:
    c = consts(torch.device(device))
    return ArmState(qpos=c["start_qpos"].expand(n, 6).clone(),
                    qvel=torch.zeros(n, 6, device=device),
                    grip=c["start_grip"].expand(n).clone(),
                    grip_vel=torch.zeros(n, device=device))


def arm_step(arm: ArmState, q_target: torch.Tensor, grip_target: torch.Tensor,
             grip_rate: float | None = None) -> ArmState:
    """One control step of the position servos (targets (N, 6) rad and (N,)
    in [0, 1]). ``grip_rate`` caps the normalized gripper travel a step:
    the contact-physics env closes its pads at a bounded speed, so a pad
    does not sweep the whole gap in one step and punt the cube."""
    c = consts(arm.qpos.device)
    q_target = torch.minimum(torch.maximum(q_target, c["lo"]), c["hi"])
    q_new = arm.qpos + c["servo_alpha"] * (q_target - arm.qpos)
    g_delta = GRIP_ALPHA * (torch.clamp(grip_target, 0.0, 1.0) - arm.grip)
    if grip_rate is not None:
        g_delta = torch.clamp(g_delta, -grip_rate, grip_rate)
    g_new = arm.grip + g_delta
    return ArmState(qpos=q_new, qvel=(q_new - arm.qpos) / C.DT,
                    grip=g_new, grip_vel=(g_new - arm.grip) / C.DT)


def eef(chain: K.JointChain, arm: ArmState):
    """(grasp-point position (N, 3), gripper-frame quat (N, 4))."""
    return K.eef_pose(chain, arm.qpos)


def qpos_obs(left: ArmState, right: ArmState) -> torch.Tensor:
    """(N, 14) reference qpos: [l_arm(6), l_grip, r_arm(6), r_grip]."""
    return torch.cat([left.qpos, left.grip[:, None], right.qpos,
                      right.grip[:, None]], -1)


def qvel_obs(left: ArmState, right: ArmState) -> torch.Tensor:
    return torch.cat([left.qvel, left.grip_vel[:, None], right.qvel,
                      right.grip_vel[:, None]], -1)


def holding(chain: K.JointChain, arm: ArmState, obj_pos: torch.Tensor,
            was_held: torch.Tensor, tip: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Kinematic-grasp latch: engage near + closing, release on open."""
    if tip is None:
        tip, _ = eef(chain, arm)
    near = torch.linalg.norm(obj_pos - tip, dim=-1) < GRASP_RADIUS
    closing = arm.grip < CLOSE_THRESH
    return torch.where(was_held, closing, near & closing)


def touching(chain: K.JointChain, arm: ArmState, obj_pos: torch.Tensor,
             tip: torch.Tensor | None = None) -> torch.Tensor:
    if tip is None:
        tip, _ = eef(chain, arm)
    return torch.linalg.norm(obj_pos - tip, dim=-1) < TOUCH_RADIUS


def scripted_arm_action(chain: K.JointChain, arm: ArmState,
                        cart_target: torch.Tensor, speed) -> torch.Tensor:
    """Cartesian waypoint → joint targets via one DLS-IK step toward the
    target clipped to ``speed`` (a float or (N,)) per axis."""
    c = consts(arm.qpos.device)
    tip, _ = eef(chain, arm)
    if torch.is_tensor(speed):
        speed = speed[:, None]
    step = torch.clamp(cart_target - tip, -speed, speed)
    return K.dls_ik_step(chain, arm.qpos, tip + step, lo=c["lo"], hi=c["hi"])


def wrist64_camera(right: ArmState) -> R.CameraBatch:
    """Each env's camera on its right gripper frame (vx300s_right.xml:27)."""
    c = consts(right.qpos.device)
    ps, qs = K.fk(c["right"], right.qpos)
    g_pos, g_quat = ps[:, 5], qs[:, 5]           # gripper_link frame
    cam_pos = g_pos + rot.quat_rotate(g_quat, c["cam_offset"].expand_as(g_pos))
    fwd = rot.quat_rotate(g_quat, c["x_axis"].expand_as(g_pos))
    up = rot.quat_rotate(g_quat, c["y_axis"].expand_as(g_pos))
    return R.camera_batch(cam_pos, cam_pos + fwd, up, WRIST_FOV)


def static_camera(name: str) -> tuple[R.Camera, tuple[int, int]]:
    pos, lookat, fovy, hw = STATIC_CAMERAS[name]
    return R.Camera(tuple(map(float, pos)), tuple(map(float, lookat)),
                    (0.0, 0.0, 1.0), fovy), hw


def camera_views(camera_names, right: ArmState, image_size: int) -> dict:
    """name → (camera, (H, W)) for the observed cameras: ``wrist64`` rides
    every env's right gripper at ``image_size``; the static names are one
    camera for all envs at their reference resolutions."""
    views = {}
    for name in camera_names:
        if name == "wrist64":
            views[name] = (wrist64_camera(right), (image_size, image_size))
        else:
            views[name] = static_camera(name)
    return views


def arm_scene_prims(chain: K.JointChain, arm: ArmState, color: torch.Tensor):
    """4 boxes approximating each env's arm (upper arm, forearm, wrist,
    gripper; the gripper's width shows its grip) → (pos (N, 4, 3), rot
    (N, 4, 3, 3), size (N, 4, 3), color (N, 4, 3))."""
    c = consts(arm.qpos.device)
    ps, _ = K.fk(chain, arm.qpos)
    starts = ps[:, [1, 2, 4, 5]]
    ends = ps[:, [2, 4, 5, 6]]
    pos, rots, half = R.link_frame(starts, ends, c["link_width"])
    # gripper block: spans gripper_link → fingertip; width tracks grip
    gw = 0.012 + 0.02 * arm.grip
    grip_half = torch.stack([half[:, 3, 0], gw,
                             torch.full_like(gw, 0.015)], -1)
    size = torch.cat([half[:, :3], grip_half[:, None]], 1)
    n = arm.qpos.shape[0]
    return pos, rots, size, color.expand(n, 4, 3)


def arm_scene_prims_kdop(chain: K.JointChain, arm: ArmState,
                         color: torch.Tensor):
    """Mesh-accurate arm prims: 9 convex k-DOP hulls of the ViperX STL
    links (``envs/aloha_kdops.py``) posed at the FK frames: base, six
    joint-driven links and the two prismatic fingers sliding ±y in the
    gripper frame → (pos (N, 9, 3), rot (N, 9, 3, 3), size (N, 9, 3)
    [unused], color (N, 9, 3), planes (9, K, 4))."""
    c = consts(arm.qpos.device)
    n = arm.qpos.shape[0]
    ps, qs = K.fk(chain, arm.qpos)
    # fingers ride the gripper frame: body offset 0.0687 x, slide along ±y
    # (grip 0 = closed = inner limit, 1 = open = outer limit)
    y = c["finger_lo"] + arm.grip * c["finger_span"]
    g_pos, g_quat = ps[:, 5], qs[:, 5]
    x = c["finger_x"].expand(n)
    zero = torch.zeros_like(y)
    fingers = [g_pos + rot.quat_rotate(g_quat, torch.stack([x, s * y, zero],
                                                           -1))
               for s in (1.0, -1.0)]
    pos = torch.cat([chain.base_pos.expand(n, 1, 3), ps[:, :6],
                     torch.stack(fingers, 1)], 1)
    quats = torch.cat([chain.base_quat.expand(n, 1, 4), qs[:, :6],
                       g_quat[:, None], g_quat[:, None]], 1)
    return (pos, rot.quat_to_matrix(quats), torch.ones_like(pos),
            color.expand(n, 9, 3), c["kdops"])


class AlohaTask:
    """What the two ALOHA envs share: the constructor's settings, the
    reset/step surface over ``reset_state``/``_step``, the CUDA-graph
    transition, the joint-space observation and the cameras' renders.
    Subclasses give ``reset_draws``, ``reset_state``, ``_step``, ``scene``
    and ``env_state``."""

    obs_keys = ("qpos", "qvel", "env_state", "wrist64_image")
    action_dim = 14
    max_reward = 4.0

    def __init__(self, image_size: int = 64, render_images: bool = True,
                 episode_len: int = 400, renderer: str = "xla",
                 camera_names: tuple = ("wrist64",), mesh_mode: str = "box",
                 cuda_graph: bool = True):
        """``renderer`` is the JAX env's choice of XLA or Pallas; the port
        renders through kernel C on the card and its twin on the CPU either
        way. ``mesh_mode``: "box" draws each arm as 4 boxes, "kdop" as 9
        convex hulls of its STL links (18 hulls, drawn first)."""
        if mesh_mode not in ("box", "kdop"):
            raise ValueError(f"unknown mesh_mode {mesh_mode!r}")
        self.image_size = image_size
        self.render_images = render_images
        self.episode_len = episode_len
        self.renderer = renderer
        self.camera_names = tuple(camera_names)
        self.mesh_mode = mesh_mode
        self.n_convex = 18 if mesh_mode == "kdop" else 0
        self.cuda_graph = cuda_graph
        self._graphs: dict = {}
        self._rays: dict = {}

    def reset(self, n: int, generator: torch.Generator, **draws):
        state = self.reset_state(n, generator, **draws)
        return state, self.obs(state)

    def reset_to(self, state):
        """Deterministic state-injection reset."""
        return state, self.obs(state)

    def step(self, state, action: torch.Tensor):
        new_state, reward, success = self.transition(state, action)
        return new_state, self.obs(new_state), reward, success

    def transition(self, state, action: torch.Tensor):
        """``step`` without the observation → (state, reward, success); on
        the card with ``cuda_graph`` replayed from a CUDA graph captured for
        this batch size."""
        return graphed_transition(self, state, action)

    def obs(self, state) -> dict:
        out = {"qpos": qpos_obs(state.left, state.right),
               "qvel": qvel_obs(state.left, state.right),
               "env_state": self.env_state(state)}
        if self.render_images:
            scene = self.scene(state)
            views = camera_views(self.camera_names, state.right,
                                 self.image_size)
            for name, (cam, (h, w)) in views.items():
                out[f"{name}_image"] = self.render_scene(scene, cam, h, w)
        return out

    def render_scene(self, scene: R.Scene, cam, height: int,
                     width: int) -> torch.Tensor:
        """(N, H, W, 3) float32 in [0, 255] through kernel C (its twin on
        the CPU); the ray table is made once per device and camera."""
        per_env = isinstance(cam, R.CameraBatch)
        key = (scene.pos.device, cam.fov_deg if per_env else cam, height,
               width)
        if key not in self._rays:
            self._rays[key] = raycast.default_rays(cam, height, width,
                                                   scene.pos.device)
        return raycast.render_batch_cuda(scene, cam, height, width,
                                         self.n_convex, self._rays[key])

    def render(self, state) -> torch.Tensor:
        """The ``wrist64`` frame (N, H, W, 3)."""
        return self.render_scene(self.scene(state), wrist64_camera(
            state.right), self.image_size, self.image_size)
