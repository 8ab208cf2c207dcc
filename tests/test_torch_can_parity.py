"""What the Can recipe's closed loop rests on and ``test_torch_pick_place``
does not hold: the port's own spawn draws, and the data path on Can-shaped
demos, against the JAX package.

- Spawns: 4096 resets of ``CanPhysicsEnv`` and of ``SquarePhysicsEnv`` from
  each package's own sampler (JAX: ``reset`` under ``vmap``; the port:
  ``reset_state`` from a generator, and the engine's reset of episodes
  0..4095, which the evals and the collections take). The spawn boxes are
  equal, the samples' extremes agree within 0.5% of each box's width (4096
  uniform draws come within 0.025% of a bound on average), and a two-sample
  Kolmogorov-Smirnov test does not tell the port's draws of x, y and yaw
  from JAX's at the 3-sigma level (p ≥ 0.0027 per coordinate).
- Data: a synthetic collection shaped like the Can recipe's (three lowdim
  keys, an image, episodes kept only on success, so of unequal length),
  written by each package's writer (JAX: HDF5, the port: ``.npz``), with
  16-wide ``latent_agentview_image`` companions of equal values. The bounds
  ``stats_from_data=[latent_agentview_image]`` measures are equal, and so
  are the windows of ``horizon 9, obs_horizon 1`` at every start, the
  padded ones at episode ends among them, before and after each
  package's ``prepare_batch`` normalizes them (atol 1e-6: one fp32
  affine map in two frameworks).
- Contacts: one control step of ``CanPhysicsEnv`` from the 72 perturbed
  contact states of ``tests/fixtures/can_contact_golden.npz`` (pads, can
  and bin walls touching as a policy's imprecise grasp leaves them;
  ``tools/record_pick_place_fixture.py --contact-step``) against JAX's
  step. Penalty contacts turn float rounding into velocity: the bar for
  each group of 8 states is ``ROUNDING`` times the port's own fp32 step's
  distance from its fp64 step, plus a floor of 1e-6 (positions) or 1e-5;
  the arm within 1e-5, the reward within 1e-5, success and ``holding``
  exactly. The same states' 64×64 frames (the recipe's size) against the
  JAX XLA renderer's, at its bar: more than 98% of each frame's pixels
  within 2.0.
"""

import contextlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from latent_diffusion_planning_tpu.data import datasets as jdatasets
from latent_diffusion_planning_tpu.data import synthetic as jsynthetic
from latent_diffusion_planning_tpu.data.writer import (
    write_trajectories as jwrite_trajectories)
from latent_diffusion_planning_tpu.envs import pick_place_physics as J
from latent_diffusion_planning_tpu.models.agents import common as jcommon
from latent_diffusion_planning_tpu.ops import normalize as jnz
from latent_diffusion_planning_tpu_torch.data import datasets, ingest
from latent_diffusion_planning_tpu_torch.data.writer import (
    write_latents, write_trajectories)
from latent_diffusion_planning_tpu_torch.envs import pick_place_physics as phys
from latent_diffusion_planning_tpu_torch.models.agents import common
from latent_diffusion_planning_tpu_torch.ops import normalize as nz
from latent_diffusion_planning_tpu_torch.ops import rotations as rot
from latent_diffusion_planning_tpu_torch.rollout import engine
from latent_diffusion_planning_tpu_torch.utils.config import load_config
from torch_thread import one_torch_thread  # noqa: F401

CONTACT = Path(__file__).parent / "fixtures" / "can_contact_golden.npz"
ROUNDING = 5.0
N_SPAWNS = 4096
KS_P = 0.0027
EDGE = 0.005          # of the box's width
WINDOW_ATOL = 1e-6
PHYS = ("CanPhysicsEnv", "SquarePhysicsEnv")


# -- spawns ------------------------------------------------------------------

def _xy_yaw(pos, quat):
    """(x, y, yaw) of the object from its body pose."""
    q = np.asarray(quat)[:, 0]
    yaw = 2 * np.arctan2(q[:, 3], q[:, 0])
    return np.concatenate([np.asarray(pos)[:, 0, :2], yaw[:, None]], 1)


@pytest.fixture(scope="module")
def jax_spawns():
    """JAX's ``reset`` with the arm's home-pose settle and the observation
    stubbed out: neither touches the draws, and the settle's XLA compile
    under ``vmap`` takes over a minute a task."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J.ra, "arm_track", lambda chain, qpos, eef: qpos)
        for name in PHYS:
            env = getattr(J, name)(render_images=False)
            mp.setattr(env, "obs", lambda state: {})
            keys = jax.random.split(jax.random.PRNGKey(16), N_SPAWNS)
            states, _ = jax.jit(jax.vmap(env.reset))(keys)
            out[name] = _xy_yaw(states.bodies.pos, states.bodies.quat)
    return out


def _port_spawns(name, sampler):
    env = getattr(phys, name)(render_images=False)
    gen = torch.Generator().manual_seed(16)
    if sampler == "generator":
        s = env.reset_state(N_SPAWNS, gen)
    else:
        s = engine._initial_states(env, N_SPAWNS, 16, None, None, gen)
    return _xy_yaw(s.bodies.pos, s.bodies.quat)


@pytest.mark.parametrize("sampler", ["generator", "engine"])
@pytest.mark.parametrize("name", PHYS)
def test_spawn_distribution_matches_jax(jax_spawns, name, sampler):
    jenv, env = getattr(J, name), getattr(phys, name)
    lo = np.r_[np.asarray(jenv.spawn_lo), -np.pi / 6]
    hi = np.r_[np.asarray(jenv.spawn_hi), np.pi / 6]
    np.testing.assert_array_equal(np.asarray(env.spawn_lo, np.float32),
                                  np.asarray(jenv.spawn_lo))
    np.testing.assert_array_equal(np.asarray(env.spawn_hi, np.float32),
                                  np.asarray(jenv.spawn_hi))
    want, got = jax_spawns[name], _port_spawns(name, sampler)
    width = hi - lo
    for draws in (want, got):
        assert (draws >= lo - 1e-6).all() and (draws <= hi + 1e-6).all()
    assert (np.abs(got.min(0) - want.min(0)) <= EDGE * width).all(), \
        (got.min(0), want.min(0))
    assert (np.abs(got.max(0) - want.max(0)) <= EDGE * width).all(), \
        (got.max(0), want.max(0))
    for i, coord in enumerate(("x", "y", "yaw")):
        p = ks_2samp(got[:, i], want[:, i]).pvalue
        assert p >= KS_P, (coord, p)


# -- the Can recipe's data path ------------------------------------------------

LOWDIM = {"robot0_eef_pos": (3,), "robot0_eef_quat": (4,),
          "robot0_gripper_qpos": (2,)}
LATENT = "latent_agentview_image"
HORIZON, OBS_HORIZON = 9, 1


def _can_collection(N=8, T=40, seed=16):
    """Episodes of T steps, the first success at a different step in each
    (never in two of them)."""
    rng = np.random.default_rng(seed)
    obs = {k: rng.normal(size=(N, T) + s).astype(np.float32)
           for k, s in LOWDIM.items()}
    obs["agentview_image"] = rng.integers(0, 256, (N, T, 8, 8, 3)).astype(
        np.float32)
    success = np.zeros((N, T), bool)
    for i, s in enumerate([30, None, 5, 17, None, 39, 3, 24]):
        if s is not None:
            success[i, s:] = True
    return dict(first_obs={k: v[:, 0] for k, v in obs.items()}, obs=obs,
                actions=rng.uniform(-1, 1, (N, T, 7)).astype(np.float32),
                rewards=rng.uniform(size=(N, T)).astype(np.float32),
                success=success)


@pytest.fixture(scope="module", params=[None, 2],
                ids=["as-collected", "trimmed"])
def can_files(request, tmp_path_factory):
    """The same demos and latents as JAX's HDF5 pair and the port's
    ``.npz`` pair (the recipe's format): the successful episodes whole, as
    the Can recipe keeps them (all of one length), or cut 2 steps after
    their first success (of unequal lengths, some shorter than a
    window)."""
    d = tmp_path_factory.mktemp("can")
    col = _can_collection()
    meta = {"env_name": "CanPhysicsEnv", "env_kwargs": {"episode_len": 300}}
    kw = dict(env_meta=meta, successful_only=True,
              trim_success_margin=request.param)
    n = jwrite_trajectories(d / "demos.hdf5", col, **kw)
    assert write_trajectories(d / "demos.npz", col, **kw) == n == 6
    jsynthetic.write_latent_hdf5(d / "latent.hdf5", d / "demos.hdf5",
                                 ["agentview_image"], latent_dim=16, seed=3)
    welded = ingest.load_demos(str(d / "demos.hdf5"), [LATENT],
                               latent_path=str(d / "latent.hdf5"))
    z = welded.arrays[LATENT]
    write_latents(d / "latent.npz", welded, ["agentview_image"],
                  float(z.min()), float(z.max()))
    return d


def _can_meta():
    cfg = load_config("train_bc", ["agent=ldp_agent", "data=can/latent_img"])
    return cfg.data.to_dict()["meta"]


def _facades(d):
    meta = _can_meta()
    kw = dict(name="can", meta=meta, batch_size=8, obs_horizon=OBS_HORIZON,
              seq_length=HORIZON, stats_from_data=[LATENT])
    want = jdatasets.OfflineData(
        train_path=str(d / "demos.hdf5"), eval_path=str(d / "demos.hdf5"),
        train_latent_path=str(d / "latent.hdf5"),
        eval_latent_path=str(d / "latent.hdf5"), **kw)
    got = datasets.OfflineData(
        train_path=str(d / "demos.npz"), eval_path=str(d / "demos.npz"),
        train_latent_path=str(d / "latent.npz"),
        eval_latent_path=str(d / "latent.npz"), device="cpu", **kw)
    return want, got


def test_can_latent_stats_match_jax(can_files):
    want, got = _facades(can_files)
    lengths = got.welded("train").demo_lengths.tolist()
    assert lengths == want.welded("train").demo_lengths.tolist()
    assert got.meta["obs_normalization"] == want.meta["obs_normalization"]
    bounds = got.meta["obs_normalization"]["obs"][LATENT]
    assert bounds != _can_meta()["obs_normalization"]["obs"][LATENT]


def test_can_windows_match_jax(can_files):
    want, got = _facades(can_files)
    jds, ds = want.device_dataset("train"), got.device_dataset("train")
    welded = got.welded("train")
    assert ds.n_steps == jds.n_steps == int(welded.demo_lengths.sum())
    idx = np.arange(jds.n_steps, dtype=np.int32)
    jb = jds.gather(jnp.asarray(idx))
    b = ds.gather(torch.from_numpy(idx).long())
    keys = list(LOWDIM) + [LATENT]
    for k in keys:
        np.testing.assert_array_equal(b["obs"][k].numpy(),
                                      np.asarray(jb["obs"][k]), err_msg=k)
    np.testing.assert_array_equal(b["actions"].numpy(),
                                  np.asarray(jb["actions"]))
    # the last window of each demo runs past its end: padded
    ends = (welded.demo_starts + welded.demo_lengths - 1).tolist()
    last = b["obs"][LATENT][ends]
    assert last.shape[1] == HORIZON and torch.equal(last[:, -1], last[:, 0])
    jn = jcommon.prepare_batch({"obs": {k: jb["obs"][k] for k in keys},
                                "actions": jb["actions"]},
                               jnz.stats_to_arrays(
                                   want.meta["obs_normalization"]))
    n = common.prepare_batch({"obs": {k: b["obs"][k] for k in keys},
                              "actions": b["actions"]},
                             nz.stats_to_tensors(
                                 got.meta["obs_normalization"], "cpu"))
    for k in keys:
        np.testing.assert_allclose(n["obs"][k].numpy(),
                                   np.asarray(jn["obs"][k]), rtol=0,
                                   atol=WINDOW_ATOL, err_msg=k)
    np.testing.assert_allclose(n["actions"].numpy(), np.asarray(jn["actions"]),
                               rtol=0, atol=WINDOW_ATOL)


# -- contacts ------------------------------------------------------------------

@contextlib.contextmanager
def _default_dtype(dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _contact_step(g, dtype):
    """The port's control step from the fixture's states, with the env's
    constants and the state in ``dtype``."""
    with _default_dtype(dtype):
        env = phys.CanPhysicsEnv(render_images=False)
        new, reward, success = env.transition(
            _contact_state(g, dtype), torch.from_numpy(g["action"]).to(dtype))
        return new, reward, success, env.holding(new)


def _contact_state(g, dtype=torch.float32):
    t = lambda k: torch.from_numpy(g[k]).to(dtype)
    return phys.PickPlacePhysState(
        bodies=phys.ph.RigidBody(pos=t("pos"), quat=t("quat"),
                                 linvel=t("linvel"), angvel=t("angvel")),
        qpos=t("qpos"), eef_target=t("eef_target"), gripper=t("gripper"),
        t=torch.from_numpy(g["t"]))


def test_can_frames_at_64_match_jax():
    with np.load(CONTACT) as f:
        g = {k: f[k][::3] for k in f}
    got = phys.CanPhysicsEnv(image_size=64).render(_contact_state(g))
    jenv = J.CanPhysicsEnv(image_size=64)
    for i, frame in enumerate(got.numpy()):
        state = J.PickPlacePhysState(
            bodies=J.ph.RigidBody(**{k: jnp.asarray(g[k][i]) for k in
                                     ("pos", "quat", "linvel", "angvel")}),
            qpos=jnp.asarray(g["qpos"][i]),
            eef_target=jnp.asarray(g["eef_target"][i]),
            gripper=jnp.asarray(g["gripper"][i]), t=jnp.asarray(g["t"][i]))
        want = np.asarray(jenv.render(state))
        assert frame.shape == want.shape == (64, 64, 3)
        assert (np.abs(frame - want).max(-1) < 2.0).mean() > 0.98, i


def test_can_contact_step_matches_jax():
    with np.load(CONTACT) as f:
        g = dict(f)
    new, reward, success, held = _contact_step(g, torch.float32)
    new64 = _contact_step(g, torch.float64)[0]
    groups = len(g["t"]) // 8
    for k, floor in (("pos", 1e-6), ("quat", 1e-5), ("linvel", 1e-5),
                     ("angvel", 1e-5)):
        got = getattr(new.bodies, k).double().numpy()
        own = np.abs(got - getattr(new64.bodies, k).numpy())
        err = np.abs(got - g[f"next_{k}"])
        own, err = (x.reshape(groups, -1).max(1) for x in (own, err))
        assert (err <= ROUNDING * own + floor).all(), (k, err, own)
    np.testing.assert_allclose(new.qpos.numpy(), g["next_qpos"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(reward.numpy(), g["reward"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(success.numpy(), g["success"])
    np.testing.assert_array_equal(held.numpy(), g["holding"])
    assert g["holding"].any() and g["success"].any()


def test_contact_step_keeps_its_type_after_an_fp64_step():
    """The rotation tables are made per device and type: an fp64 step made
    first in a process leaves the next fp32 step in fp32 and equal to one
    made alone (a table of the first step's type promoted every later
    product to it)."""
    with np.load(CONTACT) as f:
        g = dict(f)
    rot._tables.cache_clear()
    alone = _contact_step(g, torch.float32)[0]
    rot._tables.cache_clear()
    _contact_step(g, torch.float64)
    after = _contact_step(g, torch.float32)[0]
    for k in ("pos", "quat", "linvel", "angvel"):
        a, b = getattr(alone.bodies, k), getattr(after.bodies, k)
        assert b.dtype == torch.float32
        assert torch.equal(a, b), k


@pytest.mark.parametrize("rates,want", [
    ({"card_d0": 60, "cpu_d0": 140, "card_d1": 70, "cpu_d1": 150},
     "the card carries the gap"),
    ({"card_d0": 88, "cpu_d0": 71, "card_d1": 80, "cpu_d1": 140},
     "spread of the demo draw"),
    ({"card_d0": 100, "cpu_d0": 140, "card_d1": 60, "cpu_d1": 90},
     "spread of the demo draw"),
    ({"card_d0": 100, "cpu_d0": 132, "card_d1": 101, "cpu_d1": 133},
     "open")])
def test_can_arms_rule(tmp_path, rates, want):
    """``tools/compare_can_arms.py``'s demo-draw rule on arms of 1024
    episodes at 30k: the card below the CPU at both draws by 0.03 or more
    with p < 0.01 carries the gap; at or above it at one draw, or draws of
    one device as far apart as the devices, is spread; else open."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import compare_can_arms as cca
    arms = {}
    for name, k in rates.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({"checkpoints": [
            {"step": 30000, "route": cca.KERNELS, "successes": k,
             "n_episodes": 1024}]}))
        arms[name] = cca.pooled(path, 30000)[cca.KERNELS]
    assert cca.verdict(arms) == want
