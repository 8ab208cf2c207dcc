"""The port's Can and Square envs (kinematic and contact-physics) against
the JAX package.

An XLA-CPU compile of these envs' steps takes minutes and a physics step
seconds, so the port is held against ``tests/fixtures/pick_place_golden.npz``
and ``tests/fixtures/square_expert_golden.npz``, which
``tools/record_pick_place_fixture.py`` writes from the JAX package:

- resets from handed-in draws: the JAX resets' spawns handed to the port,
  bodies, joints and observations (the 14-dim ``object`` among them)
  within 1e-5;
- success geometry of both tasks (kinematic: held and not held) and
  ``holding`` as a contact event, on the states the JAX package judged;
- control steps at the ``tests/test_torch_physics.py`` tolerances (object
  position 1e-3, eef 1e-4, reward 1e-3): 20 steps of the scripted expert
  on 8 Square envs and on 8 of each kinematic env; on 8 Can envs the 8
  steps up to the squeeze. From the squeeze on the Can's contacts amplify
  float rounding: the port's own can moves by 1.4e-2 within 13 steps when
  its spawn moves by 1e-7, as much as it differs from JAX's;
- the render twin against the JAX XLA renderer's 32×32 frames, at the JAX
  renderer's bar (more than 98% of pixels within 2.0);
- the physics experts from the spawns the JAX experts ran from succeed at
  rates Fisher's exact test does not tell from the JAX experts' (Can: a
  can flung by the contacts lands in the bin in some episodes; Square: the
  nut is squeezed, and rarely lands on the peg; neither reaches the 0.9 of
  the JAX package's own test), and the kinematic experts in at least 0.9
  of 8 envs × 300 steps;
- ``make_env_from_meta`` routing and the eval env a dataset names.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.stats import fisher_exact

from latent_diffusion_planning_tpu_torch.envs import from_meta
from latent_diffusion_planning_tpu_torch.envs import pick_place as pp
from latent_diffusion_planning_tpu_torch.envs import pick_place_physics as phys
from latent_diffusion_planning_tpu_torch.envs.physics import kinematics as K
from latent_diffusion_planning_tpu_torch.rollout import engine
from torch_thread import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "pick_place_golden.npz"
SQUARE_FIXTURE = (Path(__file__).parent / "fixtures"
                  / "square_expert_golden.npz")
PHYS = ("CanPhysicsEnv", "SquarePhysicsEnv")
KIN = ("CanEnv", "SquareEnv")
OBJ_ATOL, EEF_ATOL, REWARD_ATOL, STATE_ATOL = 1e-3, 1e-4, 1e-3, 1e-5
N = 8


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as f:
        return dict(f)


def _t(a):
    return torch.from_numpy(np.array(a))


def _env(name, **kw):
    module = phys if "Physics" in name else pp
    return getattr(module, name)(**kw)


def _reset(env, golden, name, n=N):
    return env.reset_state(
        n, torch.Generator(), obj_xy=_t(golden[f"{name}_obj_xy"][:n]),
        obj_yaw=_t(golden[f"{name}_obj_yaw"][:n].astype(np.float32)))


def _frac_close(a, b):
    return (np.abs(np.asarray(a) - np.asarray(b)).max(-1) < 2.0).mean()


def _phys_state(pos, quat, like):
    return phys.PickPlacePhysState(
        bodies=phys.ph.RigidBody(pos=_t(pos), quat=_t(quat),
                                 linvel=torch.zeros(pos.shape),
                                 angvel=torch.zeros(pos.shape)),
        qpos=like.qpos[:len(pos)], eef_target=like.eef_target[:len(pos)],
        gripper=like.gripper[:len(pos)], t=like.t[:len(pos)])


# -- resets, success and holding ---------------------------------------------

@pytest.mark.parametrize("name", PHYS)
def test_physics_reset_from_handed_in_draws(golden, name):
    env = _env(name, render_images=False)
    s = _reset(env, golden, name)
    g = lambda k: golden[f"{name}_reset_{k}"]
    for got, key in ((s.bodies.pos, "pos"), (s.bodies.quat, "quat"),
                     (s.qpos, "qpos"), (s.eef_target, "eef_target"),
                     (s.gripper, "gripper")):
        np.testing.assert_allclose(got.numpy(), g(key), atol=STATE_ATOL,
                                   err_msg=key)
    obs = env.obs(s)
    for k in ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos",
              "robot0_joint_pos", "object"):
        np.testing.assert_allclose(obs[k].numpy(), g(k), atol=STATE_ATOL,
                                   err_msg=k)
    assert obs["object"].shape == (N, 14)


@pytest.mark.parametrize("name", PHYS)
def test_physics_success_geometry(golden, name):
    """The object at rest in the goal, above it, beside it, just inside and
    just outside the xy tolerance, just under the height limit."""
    env = _env(name, render_images=False)
    cases = golden[f"{name}_success_cases"]
    s = _reset(env, golden, name, n=1)
    pos = np.repeat(s.bodies.pos.numpy(), len(cases), 0)
    pos[:, 0] = cases
    quat = np.repeat(s.bodies.quat.numpy(), len(cases), 0)
    like = _reset(env, golden, name, n=len(cases))
    got = env.check_success(_phys_state(pos, quat, like)).numpy()
    want = golden[f"{name}_success_verdicts"]
    assert got.tolist() == want.tolist()
    assert want[0] and not want[1] and not want[2]


@pytest.mark.parametrize("name", KIN)
def test_kinematic_success_rules(golden, name):
    env = _env(name, render_images=False)
    cases = _t(golden[f"{name}_success_cases"])
    s = _reset(env, golden, name, n=len(cases))
    for held, want in zip((False, True), golden[f"{name}_success_verdicts"]):
        s = pp.PickPlaceState(
            qpos=s.qpos, eef_target=s.eef_target, gripper=s.gripper,
            obj_pos=cases, obj_yaw=s.obj_yaw,
            grasped=torch.full((len(cases),), held), t=s.t)
        assert env.check_success(s).numpy().tolist() == want.tolist()
    assert not golden[f"{name}_success_verdicts"][1].any()


def test_holding_is_a_contact_event(golden):
    """Open at home: no; the pads squeezing the can: yes; the same squeeze
    with the can 5 cm along y: no. As the JAX package judged them."""
    name = "CanPhysicsEnv"
    env = _env(name, render_images=False)
    like = _reset(env, golden, name, n=3)
    got = env.holding(_phys_state(golden[f"{name}_holding_pos"],
                                  golden[f"{name}_holding_quat"], like))
    want = golden[f"{name}_holding_verdicts"]
    assert got.numpy().tolist() == want.tolist() == [False, True, False]


# -- control steps -------------------------------------------------------

@pytest.mark.parametrize("name,steps", [("CanPhysicsEnv", 8),
                                        ("SquarePhysicsEnv", 20)])
def test_physics_steps_match_jax(golden, name, steps):
    """JAX's expert actions replayed from JAX's spawn: the expert's action,
    the object's position, the eef, the reward, success, ``holding`` and
    the ``object`` observation's positions after every step."""
    env = _env(name, render_images=False)
    s = _reset(env, golden, name)
    g = lambda k: golden[f"{name}_{k}"]
    actions = _t(g("actions"))
    chain = env._const("cpu")["chain"]
    for t in range(steps):
        np.testing.assert_allclose(env.scripted_action(s).numpy(),
                                   actions[:, t].numpy(), atol=5e-3,
                                   err_msg=f"expert @ {t}")
        s, r, ok = env.transition(s, actions[:, t])
        eef, _ = K.eef_pose(chain, s.qpos)
        for got, key, tol in ((s.obj_pos, "obj_pos", OBJ_ATOL),
                              (eef, "eef", EEF_ATOL),
                              (r, "reward", REWARD_ATOL)):
            np.testing.assert_allclose(got.numpy(), g(key)[:, t], atol=tol,
                                       err_msg=f"{key} @ {t}")
        assert ok.numpy().tolist() == g("success")[:, t].tolist()
        assert env.holding(s).numpy().tolist() == g("holding")[:, t].tolist()
        obj = env.obs(s)["object"].numpy()
        cols = [0, 1, 2, 7, 8, 9]         # position, position to the eef
        np.testing.assert_allclose(obj[:, cols], g("object")[:, t][:, cols],
                                   atol=OBJ_ATOL, err_msg=f"object @ {t}")


@pytest.mark.parametrize("name", KIN)
def test_kinematic_steps_match_jax(golden, name):
    """20 expert steps from JAX's spawns: actions, the object, the grasp,
    reward and success, then the final observation."""
    env = _env(name, render_images=False)
    s = _reset(env, golden, name)
    g = lambda k: golden[f"{name}_{k}"]
    for t in range(g("actions").shape[1]):
        a = env.scripted_action(s)
        np.testing.assert_allclose(a.numpy(), g("actions")[:, t], atol=1e-4,
                                   err_msg=f"action @ {t}")
        s, r, ok = env.transition(s, a)
        np.testing.assert_allclose(s.obj_pos.numpy(), g("obj_pos")[:, t],
                                   atol=OBJ_ATOL, err_msg=f"obj @ {t}")
        np.testing.assert_allclose(r.numpy(), g("reward")[:, t],
                                   atol=REWARD_ATOL, err_msg=f"reward @ {t}")
        assert s.grasped.numpy().tolist() == g("grasped")[:, t].tolist()
        assert ok.numpy().tolist() == g("success")[:, t].tolist()
    obs = env.obs(s)
    for k in ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos",
              "robot0_joint_pos", "object"):
        np.testing.assert_allclose(obs[k].numpy(), g(f"last_{k}"),
                                   atol=EEF_ATOL, err_msg=k)


# -- renders ---------------------------------------------------------------

@pytest.mark.parametrize("name", PHYS)
def test_physics_render_matches_jax(golden, name):
    """Frames of the reset states (and, for Square, after the 20 steps)
    through the kernel's twin against the JAX XLA renderer."""
    env = _env(name, image_size=32)
    s = _reset(env, golden, name)
    kinds = env.scene(s).kind[0].tolist()
    assert len(kinds) == 10 and kinds.count(1) == 2 and 2 not in kinds
    pairs = [(env.render(s).numpy(), golden[f"{name}_frames_first"])]
    if name == "SquarePhysicsEnv":
        for a in _t(golden[f"{name}_actions"]).unbind(1):
            s = env.transition(s, a)[0]
        pairs.append((env.render(s).numpy(), golden[f"{name}_frames_last"]))
    for got, ref in pairs:
        assert got.shape == (N, 32, 32, 3)
        assert _frac_close(got, ref) > 0.98


@pytest.mark.parametrize("name", KIN)
def test_kinematic_render_matches_jax(golden, name):
    """Two objects lifted, one gripper closed."""
    env = _env(name, image_size=32)
    g = lambda k: _t(golden[f"{name}_render_{k}"])
    s = pp.PickPlaceState(qpos=g("qpos"), eef_target=g("eef_target"),
                          gripper=g("gripper"), obj_pos=g("obj_pos"),
                          obj_yaw=g("obj_yaw"), grasped=g("grasped"),
                          t=g("t"))
    got = env.render(s).numpy()
    assert got.shape == (4, 32, 32, 3)
    assert _frac_close(got, golden[f"{name}_render_frames"]) > 0.98


# -- the scripted experts ------------------------------------------------

def _expert_episodes(golden, name) -> dict:
    """The JAX expert's recorded episodes: spawns (``obj_xy``, ``obj_yaw``)
    and success per step. Square's seeds 8 and up, from
    ``SQUARE_FIXTURE``, follow the first 8."""
    keys = ("obj_xy", "obj_yaw", "success")
    eps = {k: golden[f"{name}_expert_{k}"] for k in keys}
    if name == "SquarePhysicsEnv":
        with np.load(SQUARE_FIXTURE) as f:
            assert f[f"{name}_expert_seeds"].min() == len(eps["success"])
            eps = {k: np.concatenate([eps[k], f[f"{name}_expert_{k}"]])
                   for k in keys}
    return eps


@pytest.mark.parametrize("name", PHYS)
def test_physics_expert_rate_matches_jax(golden, name):
    """The expert from each spawn the JAX expert ran from (its
    ``run_scripted_collection``, 32 Can and 56 Square episodes × 300
    steps): Fisher's exact test does not tell the two success rates apart
    at the 3-sigma level (two-sided p ≥ 0.0027). Episodes are not compared
    one by one: after the squeeze an object's path hangs on float rounding
    (see the module's docstring)."""
    eps = _expert_episodes(golden, name)
    want = eps["success"].any(1)
    n, steps = eps["success"].shape
    env = _env(name, render_images=False)
    s = env.reset_state(
        n, torch.Generator(), obj_xy=_t(eps["obj_xy"]),
        obj_yaw=_t(eps["obj_yaw"].astype(np.float32)))
    success = torch.zeros(n, dtype=torch.bool)
    for _ in range(steps):
        s, _, ok = env.transition(s, env.scripted_action(s))
        success |= ok
    got, k = int(success.sum()), int(want.sum())
    p = fisher_exact([[got, n - got], [k, n - k]])[1]
    print(f"{name}: the port {got} of {n}, JAX {k} of {n}, Fisher p {p:.3g}")
    assert p >= 0.0027, (got, k, n, p)


@pytest.mark.parametrize("name", KIN)
def test_kinematic_expert_succeeds(name):
    env = _env(name, render_images=False)
    out = engine.run_scripted_collection(env, N, 0, episode_len=300,
                                         device="cpu")
    rate = out["success"].any(1).float().mean().item()
    assert rate >= 0.9, f"{name} expert {rate:.0%}"


# -- routing -------------------------------------------------------------

@pytest.mark.parametrize("meta,cls", [
    ({"env_name": "Lift"}, "LiftPhysicsEnv"),
    ({"env_name": "PickPlaceCan"}, "CanPhysicsEnv"),
    ({"env_name": "NutAssemblySquare"}, "SquarePhysicsEnv"),
    ({"env_name": "CanEnv"}, "CanEnv"),
    ({"env_name": "SquareEnv"}, "SquareEnv"),
    ({"env_name": "CanPhysicsEnv"}, "CanPhysicsEnv"),
    ({"env_name": "SquarePhysicsEnv"}, "SquarePhysicsEnv"),
    ({"env_name": "LiftEnv"}, "LiftEnv"),
])
def test_make_env_from_meta_routes(meta, cls):
    env = from_meta.make_env_from_meta(meta, render_images=False)
    assert type(env).__name__ == cls


def test_make_env_from_meta_kwargs_and_refusals():
    env = from_meta.make_env_from_meta(
        {"env_name": "PickPlaceCan",
         "env_kwargs": {"camera_heights": 32, "camera_widths": 32,
                        "horizon": 123, "control_freq": 20}})
    assert (env.image_size, env.episode_len) == (32, 123)
    env = from_meta.make_env_from_meta(
        {"env_name": "SquarePhysicsEnv", "env_kwargs": {"episode_len": 300}},
        episode_len=400)
    assert env.episode_len == 400
    # the ALOHA names, refused until the envs were ported, now build them
    # (tests/test_torch_config.py holds all eight against the JAX registry)
    for name, cls in (("sim_transfer_cube", "AlohaTransferCubeEnv"),
                      ("sim_insertion_scripted", "AlohaInsertionEnv"),
                      ("AlohaTransferCubeEnv", "AlohaTransferCubeEnv")):
        env = from_meta.make_env_from_meta({"env_name": name})
        assert type(env).__name__ == cls
    with pytest.raises(KeyError, match="no env registered"):
        from_meta.make_env_from_meta({"env_name": "PickPlaceMilk"})
    assert set(from_meta.NATIVE_REGISTRY) == {
        "LiftEnv", "LiftPhysicsEnv", "CanEnv", "SquareEnv", "CanPhysicsEnv",
        "SquarePhysicsEnv", "AlohaTransferCubeEnv", "AlohaInsertionEnv"}


def test_a_can_dataset_evaluates_in_its_env():
    """``train.loop.eval_env`` rebuilds the env a dataset's ``env_args``
    name; the recipe config's ``episode_len`` wins."""
    from latent_diffusion_planning_tpu_torch.train.loop import eval_env

    class Data:
        env_params = {"env": {"episode_len": 400}}
        env_meta = {"env_name": "CanPhysicsEnv",
                    "env_kwargs": {"episode_len": 300, "image_size": 64}}

    env = eval_env(Data())
    assert isinstance(env, phys.CanPhysicsEnv) and env.episode_len == 400
    Data.env_meta = {"env_name": "NutAssemblySquare", "env_kwargs": {}}
    assert isinstance(eval_env(Data()), phys.SquarePhysicsEnv)
