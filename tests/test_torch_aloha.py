"""The port's bimanual ALOHA envs against the JAX package's, on the CPU.

The JAX transfer-cube step takes minutes to compile on XLA-CPU (the JAX
package's own ALOHA tests are ``slow``), so the JAX side is the recorded
fixture ``tests/fixtures/aloha_golden.npz`` (``tools/record_aloha_fixture.py``):
ViperX kinematics, ``arm_step``, pads, latches, the wrist camera, resets from
JAX's uniforms, expert steps of both tasks, JAX's expert success and the XLA
renderer's ``wrist64`` frames in both ``mesh_mode``s. Tolerances:

- kinematics, servos, pads, camera: 2e-6 (float32 rounding of the same
  formulas, measured under 1.2e-6);
- the transfer-cube expert over 24 steps: actions 1e-4 and body positions
  1e-4 (the contact solver's sums round apart, measured 1.8e-5 and 8e-6),
  quaternions 5e-4 (the spawned cube settles on its penalty contact in the
  first steps and wobbles: measured 1.8e-4 at step 2, 5e-6 by step 6),
  rewards, success and every contact flag equal;
- the insertion expert over its whole 160-step episode (no contacts, no
  chaos): actions and object positions 1e-5 (measured 8.7e-7), the latches,
  rewards and success equal;
- ``wrist64`` frames: 99.9% of pixels within 2.0 of 255 and a mean error
  under 0.05 (kernel C's bar; measured: every pixel within 0.015);
- the expert's success rate: Fisher's exact test may not tell the port's
  from JAX's at the 3-sigma level (p >= 0.0027), as for Can and Square.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.stats import fisher_exact

from latent_diffusion_planning_tpu_torch.envs import aloha_base as B
from latent_diffusion_planning_tpu_torch.envs import aloha_cube as AC
from latent_diffusion_planning_tpu_torch.envs import aloha_insertion as AI
from latent_diffusion_planning_tpu_torch.envs import physics as ph
from latent_diffusion_planning_tpu_torch.envs.physics import kinematics as K
from latent_diffusion_planning_tpu_torch.rollout import engine
from torch_thread import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "aloha_golden.npz"
G = np.load(FIXTURE)
KIN_TOL = 2e-6
CHAINS = {"L": B.LEFT_CHAIN, "R": B.RIGHT_CHAIN}


def T(key: str) -> torch.Tensor:
    return torch.from_numpy(np.array(G[key]))


def _arm(prefix: str, side: str, n: int | None = None) -> B.ArmState:
    return B.ArmState(*(T(f"{prefix}{side}_{k}")[:n]
                        for k in ("qpos", "qvel", "grip", "grip_vel")))


def _kin_arm() -> B.ArmState:
    n = G["kin_q"].shape[0]
    return B.ArmState(T("kin_q"), torch.zeros(n, 6), T("kin_grip"),
                      torch.zeros(n))


def _close(got: torch.Tensor, key: str, atol: float):
    np.testing.assert_allclose(got.numpy(), G[key], atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the arms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["L", "R"])
def test_viperx_forward_kinematics_match_jax(side):
    ps, qs = K.fk(CHAINS[side], T("kin_q"))
    _close(ps, f"kin_{side}_pos", KIN_TOL)
    _close(qs, f"kin_{side}_quat", KIN_TOL)


@pytest.mark.parametrize("side", ["L", "R"])
def test_dls_ik_step_matches_jax(side):
    lo = torch.tensor(B.C.ARM_JOINT_LO)
    hi = torch.tensor(B.C.ARM_JOINT_HI)
    got = K.dls_ik_step(CHAINS[side], T("kin_q"), T(f"kin_{side}_target"),
                        lo=lo, hi=hi)
    _close(got, f"kin_{side}_ik", 2e-5)
    # the chain's limits are the actuators'
    np.testing.assert_array_equal(K.VIPERX_LO.numpy(), lo.numpy())
    np.testing.assert_array_equal(K.VIPERX_HI.numpy(), hi.numpy())


@pytest.mark.parametrize("tag,rate", [("free", None), ("rate", AC.GRIP_RATE)])
def test_arm_step_matches_jax(tag, rate):
    new = B.arm_step(_kin_arm(), T("kin_q_target"), T("kin_g_target"),
                     grip_rate=rate)
    for k in ("qpos", "grip"):
        _close(getattr(new, k), f"kin_step_{tag}_{k}", KIN_TOL)
    # velocities are differences over DT = 0.02: rounding grows by 50
    for k in ("qvel", "grip_vel"):
        _close(getattr(new, k), f"kin_step_{tag}_{k}", 1e-4)


@pytest.mark.parametrize("side", ["L", "R"])
def test_pads_and_latches_match_jax(side):
    arm = _kin_arm()
    a, b = AC.pad_positions(CHAINS[side], arm)
    _close(a, f"kin_{side}_pad_a", KIN_TOL)
    _close(b, f"kin_{side}_pad_b", KIN_TOL)
    held = B.holding(CHAINS[side], arm, T(f"kin_{side}_obj"),
                     T(f"kin_{side}_was_held"))
    np.testing.assert_array_equal(held.numpy(), G[f"kin_{side}_holding"])
    touch = B.touching(CHAINS[side], arm, T(f"kin_{side}_obj"))
    np.testing.assert_array_equal(touch.numpy(), G[f"kin_{side}_touching"])


def test_wrist_camera_matches_jax():
    """The camera rides the right gripper: its origin, and the basis the
    JAX renderer derives from (pos, lookat, up)."""
    from latent_diffusion_planning_tpu_torch.ops import render as R
    cam = B.wrist64_camera(_kin_arm())
    _close(cam.pos, "kin_cam_pos", KIN_TOL)
    want = R.camera_basis(T("kin_cam_pos"), T("kin_cam_lookat"),
                          T("kin_cam_up"))
    np.testing.assert_allclose(cam.basis.numpy(), want.numpy(), atol=1e-5)
    # orthonormal columns: right, down, forward
    eye = cam.basis.transpose(1, 2) @ cam.basis
    np.testing.assert_allclose(eye.numpy(), np.eye(3)[None].repeat(16, 0),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the tasks
# ---------------------------------------------------------------------------

def _cube_env(**kw):
    return AC.AlohaTransferCubeEnv(render_images=False, **kw)


def _ins_env(**kw):
    return AI.AlohaInsertionEnv(render_images=False, **kw)


def test_resets_follow_jax_uniforms():
    g = torch.Generator().manual_seed(0)
    env = _cube_env()
    s = env.reset_state(8, g, **env.reset_draws(T("cube_u")))
    _close(s.bodies.pos, "cube_reset_obj_pos", 1e-7)
    _close(s.bodies.quat, "cube_reset_obj_quat", 0.0)
    for side in ("l", "r"):
        arm = s.left if side == "l" else s.right
        for k in ("qpos", "qvel", "grip", "grip_vel"):
            _close(getattr(arm, k), f"cube_reset_{side}_{k}", 0.0)
    env = _ins_env()
    s = env.reset_state(8, g, **env.reset_draws(T("ins_u")))
    _close(s.peg_pos, "ins_reset_peg_pos", 1e-7)
    _close(s.socket_pos, "ins_reset_socket_pos", 1e-7)
    obs = env.obs(s)
    _close(obs["env_state"], "ins_reset_env_state", 1e-7)
    # draws of its own land inside the spawn boxes, on the generator's
    # device, with the layout the engine's uniforms give
    s = env.reset_state(64, g)
    assert (s.peg_pos[:, 0] >= 0.1).all() and (s.peg_pos[:, 0] <= 0.2).all()
    assert (s.socket_pos[:, 0] <= -0.1).all()
    assert env.reset_uniforms == 4 and _cube_env().reset_uniforms == 2


def test_transfer_cube_expert_steps_match_jax():
    """24 steps of the contact-event expert from JAX's spawns: the right
    arm descends and squeezes the cube."""
    env = _cube_env()
    s = env.reset_state(8, torch.Generator(),
                        **env.reset_draws(T("cube_u")))
    for t in range(G["cube_actions"].shape[1]):
        act = env.scripted_action(s)
        np.testing.assert_allclose(act.numpy(), G["cube_actions"][:, t],
                                   atol=1e-4, rtol=0)
        s, obs, r, ok = env.step(s, act)
        np.testing.assert_allclose(s.bodies.pos.numpy(),
                                   G["cube_obj_pos"][:, t], atol=1e-4, rtol=0)
        np.testing.assert_allclose(s.bodies.quat.numpy(),
                                   G["cube_obj_quat"][:, t], atol=5e-4,
                                   rtol=0)
        np.testing.assert_array_equal(r.numpy(), G["cube_reward"][:, t])
        np.testing.assert_array_equal(ok.numpy(), G["cube_success"][:, t])
        for k, v in env.contact_flags(s).items():
            np.testing.assert_array_equal(v.numpy(),
                                          G[f"cube_flag_{k}"][:, t], k)
        np.testing.assert_allclose(obs["qpos"].numpy(),
                                   G["cube_qpos_obs"][:, t], atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(obs["env_state"][:, :3].numpy(),
                                   G["cube_env_state"][:, t, :3], atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(obs["env_state"][:, 3:].numpy(),
                                   G["cube_env_state"][:, t, 3:], atol=5e-4,
                                   rtol=0)
    # the recorded steps reach the squeeze: the right pads touch the cube
    assert G["cube_flag_touch_right"].any()


def test_insertion_expert_episode_matches_jax():
    """The whole 160-step episode of the two-arm expert from JAX's spawns:
    both grasps latch, the objects rise, the peg goes in."""
    env = _ins_env()
    s = env.reset_state(8, torch.Generator(), **env.reset_draws(T("ins_u")))
    for t in range(G["ins_actions"].shape[1]):
        act = env.scripted_action(s)
        np.testing.assert_allclose(act.numpy(), G["ins_actions"][:, t],
                                   atol=1e-5, rtol=0)
        s, r, ok = env.transition(s, act)
        for k in ("peg_pos", "socket_pos"):
            np.testing.assert_allclose(getattr(s, k).numpy(),
                                       G[f"ins_{k}"][:, t], atol=1e-5, rtol=0)
        for k in ("peg_held", "socket_held"):
            np.testing.assert_array_equal(getattr(s, k).numpy(),
                                          G[f"ins_{k}"][:, t])
        np.testing.assert_array_equal(r.numpy(), G["ins_reward"][:, t])
        np.testing.assert_array_equal(ok.numpy(), G["ins_success"][:, t])
    assert G["ins_success"].any(1).all()


def test_reward_ladders_and_obs_layout():
    """The obs keys and widths are the shape meta's; the cube at rest is 0,
    squeezed by the right pads on the table 1, lifted 2, touched by the
    left pads 3, held by the left off the table 4."""
    env = AC.AlohaTransferCubeEnv(image_size=16)
    g = torch.Generator().manual_seed(1)
    s, obs = env.reset(5, g)
    meta = AC.ALOHA_SHAPE_META["all_shapes"]
    for k in ("qpos", "qvel", "env_state"):
        assert list(obs[k].shape[1:]) == meta[k]
    assert tuple(obs["wrist64_image"].shape) == (5, 16, 16, 3)
    h = AC.CUBE_HALF
    cube = torch.tensor([[0.1, 0.5, h - 1e-4]] * 5)
    cube[[2, 4], 2] = 0.2
    side = lambda c, a: c + torch.tensor([[0.0, a * (h + AC.PAD_RADIUS
                                                     - 0.002), 0.0]])
    far = torch.tensor([[0.0, 0.0, 1.0]])
    pads = [[far, far, far, far], [far, far, side(cube[1:2], -1), far],
            [far, far, side(cube[2:3], -1), far],
            [side(cube[3:4], 1), far, far, far],
            [side(cube[4:5], 1), side(cube[4:5], -1), far, far]]
    pos = torch.stack([torch.cat([cube[i:i + 1]] + pads[i]) for i in range(5)])
    s.bodies = ph.RigidBody(pos=pos, quat=s.bodies.quat,
                            linvel=s.bodies.linvel, angvel=s.bodies.angvel)
    assert env.reward(s).tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    ins = AI.AlohaInsertionEnv(render_images=False)
    si = ins.reset_state(1, g)
    assert ins.reward(si).tolist() == [0.0]
    assert ins.obs(si)["env_state"].shape == (1, 14)


def _success_rate_test(name: str, env, steps: int) -> tuple[int, int, float]:
    want = G[f"{name}_expert_success"].any(1)
    out = engine.run_scripted_collection(env, len(want), seed=3,
                                         episode_len=steps, device="cpu")
    got = out["success"].any(1).numpy()
    table = [[int(got.sum()), int((~got).sum())],
             [int(want.sum()), int((~want).sum())]]
    return int(got.sum()), int(want.sum()), fisher_exact(table)[1]


@pytest.mark.parametrize("name,steps", [("cube", 120), ("ins", 160)])
def test_expert_success_rate_is_jaxs(name, steps):
    """The port's expert over its own spawns (the engine's per-episode
    draws), as many episodes as the fixture holds of JAX's, through the
    engine's scripted collection: the rates may not differ at the 3-sigma
    level (Fisher's exact test, p >= 0.0027)."""
    env = (_cube_env(episode_len=steps) if name == "cube"
           else _ins_env(episode_len=steps))
    got, want, p = _success_rate_test(name, env, steps)
    assert p >= 0.0027, (name, got, want, p)
    assert want >= 0.75 * len(G[f"{name}_expert_success"])


# ---------------------------------------------------------------------------
# the wrist64 frames: kernel C's twin with a camera per env
# ---------------------------------------------------------------------------

def _state(task: str, tag: str, n: int = 4):
    prefix = f"{task}_{'reset' if tag == 'first' else 'last'}_"
    left, right = _arm(prefix, "l", n), _arm(prefix, "r", n)
    t = torch.zeros(n, dtype=torch.int32)
    if task == "cube":
        bodies = ph.RigidBody(*(T(prefix + f"obj_{k}")[:n]
                                for k in ("pos", "quat", "linvel", "angvel")))
        return AC.AlohaCubeState(left, right, bodies, t)
    return AI.AlohaInsertionState(
        left, right, *(T(prefix + k)[:n] for k in (
            "peg_pos", "socket_pos", "peg_held", "socket_held")), t)


@pytest.mark.parametrize("tag", ["first", "last"])
@pytest.mark.parametrize("mode", ["box", "kdop"])
@pytest.mark.parametrize("task", ["cube", "ins"])
def test_wrist64_frames_match_jax(task, mode, tag):
    """Each env's frame from its own gripper camera, at reset and after the
    recorded steps, in both mesh modes (box: 13 and 10 prims; kdop: 18
    hulls of 26 half-spaces, then the cube and pads or the peg and socket),
    against the JAX XLA renderer's."""
    env = (AC.AlohaTransferCubeEnv if task == "cube"
           else AI.AlohaInsertionEnv)(mesh_mode=mode)
    img = env.render(_state(task, tag)).numpy()
    want = G[f"{task}_frames_{mode}_{tag}"]
    diff = np.abs(img - want).max(-1)
    assert (diff < 2.0).mean() >= 0.999 and diff.mean() < 0.05
    assert want.std() > 10          # a scene, not a blank frame


def test_a_camera_per_env_is_each_envs_own_camera():
    """Rendering N envs with a ``CameraBatch`` is rendering each env alone
    with its camera: the twin's rays from the per-env basis, and the
    kernel's way (a camera-frame table rotated by the basis) within 1e-6."""
    from latent_diffusion_planning_tpu_torch.ops import render as R
    env = AC.AlohaTransferCubeEnv(image_size=24)
    s = _state("cube", "last")
    scene = env.scene(s)
    cams = B.wrist64_camera(s.right)
    both = R.render_batch(scene, cams, 24, 24)
    for i in range(4):
        one = R.Scene(**{k: (v[i:i + 1] if torch.is_tensor(v) else v)
                         for k, v in scene.__dict__.items()})
        alone = R.render_batch(one, R.CameraBatch(
            cams.pos[i:i + 1], cams.basis[i:i + 1], cams.fov_deg), 24, 24)
        np.testing.assert_array_equal(both[i:i + 1].numpy(), alone.numpy())
    frame = R.camera_frame_rays(cams.fov_deg, 24, 24).reshape(-1, 3)
    rotated = torch.einsum("nij,pj->npi", cams.basis, frame)
    world = R.camera_batch_rays(cams, 24, 24).reshape(4, -1, 3)
    np.testing.assert_allclose(rotated.numpy(), world.numpy(), atol=1e-6)


def test_static_cameras_render_at_their_resolutions():
    """The reference's static cameras are one camera for every env (the
    ``top`` overhead at 480 x 640 looks straight down: the basis falls back
    to the least aligned world axis)."""
    env = AI.AlohaInsertionEnv(camera_names=("wrist64", "left_pillar", "top"))
    s, obs = env.reset(2, torch.Generator().manual_seed(0))
    assert tuple(obs["wrist64_image"].shape) == (2, 64, 64, 3)
    assert tuple(obs["left_pillar_image"].shape) == (2, 64, 64, 3)
    assert tuple(obs["top_image"].shape) == (2, 480, 640, 3)
    for k in ("wrist64_image", "left_pillar_image", "top_image"):
        assert torch.isfinite(obs[k]).all() and obs[k].std() > 5, k


def test_a_list_of_paths_welds_the_recipes_segments(tmp_path):
    """The phys4 recipe trains on clean and DART-noised segments given as a
    list of files (the JAX facade's list-valued ``train_path``): the
    facade welds them in order, caps each part at ``n_demos``, and pairs
    latent files positionally or raises."""
    from latent_diffusion_planning_tpu_torch.data import ingest
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.data.writer import (
        write_trajectories)
    env = AI.AlohaInsertionEnv(image_size=8)
    paths = []
    for i, n in enumerate((3, 4)):
        out = engine.run_scripted_collection(env, n, seed=i, episode_len=6,
                                             device="cpu")
        paths.append(str(tmp_path / f"part{i}.npz"))
        write_trajectories(paths[-1], out, env_meta={
            "env_name": "AlohaInsertionEnv", "env_kwargs": {}})
    keys = ["qpos", "wrist64_image"]
    meta = {"lowdim_obs": ["qpos"], "rgb_obs": ["wrist64_image"],
            "shape_meta": AC.ALOHA_SHAPE_META,
            "obs_normalization": AC.ALOHA_OBS_STATS}
    data = OfflineData(name="aloha", meta=meta, train_path=paths,
                       eval_path=paths[0], seq_length=4, device="cpu",
                       train_n_episode_overfit=3)
    got = data.welded("train")
    parts = [ingest.load_npz(p, keys, n_demos=3) for p in paths]
    assert got.n_demos == 6 and got.total_steps == sum(
        p.total_steps for p in parts)
    for k in keys:
        assert torch.equal(got.arrays[k], torch.cat(
            [p.arrays[k] for p in parts]))
    assert got.env_meta["env_name"] == "AlohaInsertionEnv"
    with pytest.raises(ValueError, match="pair positionally"):
        OfflineData(name="aloha", meta=meta, train_path=paths,
                    eval_path=paths[0], train_latent_path=[paths[0]],
                    device="cpu").welded("train")
    with pytest.raises(ValueError, match="one per part"):
        OfflineData(name="aloha", meta=meta, train_path=paths,
                    eval_path=paths[0], train_latent_path=paths[0],
                    device="cpu").welded("train")
