"""The port's data path against the JAX package's: scripted collection,
the in-memory weld, the HDF5 loader, latent encoding, window sampling and
the dataset facade.

Exact where the JAX side computes nothing in floating point (welds, loads,
gathers); 1e-5 for the collection on the kinematic ``LiftEnv`` (a few fp32
operations a step, compounded over 30 steps) and for VAE latents (fp32
convolutions in two frameworks' summation orders).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.data import ingest as jingest
from latent_diffusion_planning_tpu.data import synthetic
from latent_diffusion_planning_tpu.data import windows as jwindows
from latent_diffusion_planning_tpu.data.writer import write_trajectories
from latent_diffusion_planning_tpu.envs import lift as jlift
from latent_diffusion_planning_tpu.models.vae import KLVAE as JaxKLVAE
from latent_diffusion_planning_tpu.rollout import engine as jengine
from latent_diffusion_planning_tpu_torch import bridge
from latent_diffusion_planning_tpu_torch.data import datasets, ingest, windows
from latent_diffusion_planning_tpu_torch.data.latents import encode_latents
from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
from latent_diffusion_planning_tpu_torch.envs import lift
from latent_diffusion_planning_tpu_torch.models.vae import KLVAE
from latent_diffusion_planning_tpu_torch.rollout import engine
from torch_thread import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_welded_equal(got: ingest.WeldedDemos, want: jingest.WeldedDemos):
    assert set(got.arrays) == set(want.arrays)
    for k, v in want.arrays.items():
        assert _np(got.arrays[k]).dtype == v.dtype, k
        np.testing.assert_array_equal(_np(got.arrays[k]), v, err_msg=k)
    np.testing.assert_array_equal(_np(got.demo_starts), want.demo_starts)
    np.testing.assert_array_equal(_np(got.demo_lengths), want.demo_lengths)
    assert tuple(got.obs_keys) == tuple(want.obs_keys)
    assert tuple(got.dataset_keys) == tuple(want.dataset_keys)
    assert got.env_meta == want.env_meta


# ---------------------------------------------------------------------------
# the in-memory weld against write_trajectories → load_robomimic
# ---------------------------------------------------------------------------

def _collection(N=6, T=12, seed=0):
    """A synthetic collection: lowdim streams, an image stream with
    fractional values (the writer truncates to uint8), successes that start
    at different steps (never in episode 1)."""
    rng = np.random.default_rng(seed)
    obs = {"robot0_eef_pos": rng.normal(size=(N, T, 3)).astype(np.float32),
           "object": rng.normal(size=(N, T, 10)).astype(np.float32),
           "agentview_image": rng.uniform(-3, 258, (N, T, 4, 4, 3)).astype(
               np.float32)}
    first = {k: v[:, 0] * 0.5 for k, v in obs.items()}
    success = np.zeros((N, T), bool)
    for i, s in enumerate([3, None, 7, 0, 10, 5][:N]):
        if s is not None:
            success[i, s:] = True
    return dict(first_obs=first, obs=obs,
                actions=rng.uniform(-1, 1, (N, T, 7)).astype(np.float32),
                rewards=rng.uniform(size=(N, T)).astype(np.float32),
                success=success)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(successful_only=True),
    dict(successful_only=True, trim_success_margin=2),
    dict(unsuccessful_only=True),
    dict(successful_only=True, max_demos=3, trim_success_margin=0),
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "all")
def test_weld_matches_write_and_load(tmp_path, opts):
    col = _collection()
    meta = {"env_name": "LiftPhysicsEnv", "env_kwargs": {"episode_len": 12}}
    path = tmp_path / "demos.hdf5"
    n = write_trajectories(path, col, env_meta=meta, **opts)
    keys = ("robot0_eef_pos", "agentview_image", "object", "optimal")
    want = jingest.load_robomimic(str(path), keys)
    tcol = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in col.items()}
    got = weld_collection(tcol, obs_keys=keys, env_meta=meta, **opts)
    assert got.n_demos == n
    _assert_welded_equal(got, want)


# ---------------------------------------------------------------------------
# HDF5 ingest
# ---------------------------------------------------------------------------

@pytest.fixture
def robomimic_files(tmp_path):
    src = synthetic.write_robomimic_hdf5(
        tmp_path / "demos.hdf5", n_demos=4, demo_len=9,
        obs_shapes={"robot0_eef_pos": (3,), "agentview_image": (8, 8, 3)},
        image_keys=("agentview_image",))
    lat = synthetic.write_latent_hdf5(tmp_path / "latent.hdf5", src,
                                      ["agentview_image"], latent_dim=16)
    return str(src), str(lat)


@pytest.mark.parametrize("n_demos", [None, 2, ["demo_3", "demo_1"]])
def test_load_robomimic_matches_jax(robomimic_files, n_demos):
    src, lat = robomimic_files
    keys = ("robot0_eef_pos", "agentview_image", "latent_agentview_image",
            "optimal")
    want = jingest.load_robomimic(src, keys, n_demos=n_demos,
                                  latent_path=lat, optimal=0.0, name="x")
    got = ingest.load_robomimic(src, keys, n_demos=n_demos, latent_path=lat,
                                optimal=0.0, name="x")
    _assert_welded_equal(got, want)
    np.testing.assert_array_equal(_np(got.demo_slice(1)["actions"]),
                                  want.demo_slice(1)["actions"])


def test_concat_welded_matches_jax(robomimic_files):
    src, lat = robomimic_files
    keys = ("robot0_eef_pos", "latent_agentview_image")
    parts_j = [jingest.load_robomimic(src, keys, n_demos=n, latent_path=lat)
               for n in (2, 3)]
    parts = [ingest.load_robomimic(src, keys, n_demos=n, latent_path=lat)
             for n in (2, 3)]
    _assert_welded_equal(ingest.concat_welded(parts, "c"),
                         jingest.concat_welded(parts_j, "c"))


def test_welded_select_and_first_demos(robomimic_files):
    src, lat = robomimic_files
    keys = ("robot0_eef_pos", "latent_agentview_image")
    full = ingest.load_robomimic(src, keys + ("agentview_image",),
                                 latent_path=lat)
    _assert_welded_equal(full.select(keys).first_demos(3),
                         jingest.load_robomimic(src, keys, n_demos=3,
                                                latent_path=lat))
    with pytest.raises(KeyError):
        full.select(("nope",))


# ---------------------------------------------------------------------------
# window sampling
# ---------------------------------------------------------------------------

def _welded_pair(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([5, 1, 9, 3], np.int64)
    n = int(lengths.sum())
    arrays = {"a": rng.normal(size=(n, 3)).astype(np.float32),
              "img": rng.integers(0, 256, (n, 2, 2, 3), dtype=np.uint8),
              "actions": rng.normal(size=(n, 7)).astype(np.float32)}
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    jw = jingest.WeldedDemos(arrays=arrays, demo_starts=starts,
                             demo_lengths=lengths, obs_keys=("a", "img"),
                             dataset_keys=("actions",))
    tw = ingest.WeldedDemos(
        arrays={k: torch.from_numpy(v) for k, v in arrays.items()},
        demo_starts=torch.from_numpy(starts),
        demo_lengths=torch.from_numpy(lengths), obs_keys=("a", "img"),
        dataset_keys=("actions",))
    return jw, tw


@pytest.mark.parametrize("fs,sl", [(1, 9), (2, 4), (3, 1)])
def test_gather_and_sample_match_jax(fs, sl):
    jw, tw = _welded_pair()
    jds = jwindows.DeviceDataset.from_welded(jw, fs, sl)
    ds = windows.DeviceDataset.from_welded(tw, fs, sl, device="cpu")
    idx = np.arange(jds.n_steps, dtype=np.int32)
    want = jds.gather(jnp.asarray(idx))
    got = ds.gather(torch.from_numpy(idx).long())
    for k in ("a", "img"):
        np.testing.assert_array_equal(got["obs"][k].numpy(),
                                      np.asarray(want["obs"][k]))
    np.testing.assert_array_equal(got["actions"].numpy(),
                                  np.asarray(want["actions"]))
    # sample(): JAX's uniform draw handed in
    key = jax.random.PRNGKey(fs * 10 + sl)
    jidx = np.array(jax.random.randint(key, (16,), 0, jds.n_steps))
    want = jds.sample(key, 16)
    got = ds.sample(16, idx=jidx)
    np.testing.assert_array_equal(got["obs"]["img"].numpy(),
                                  np.asarray(want["obs"]["img"]))
    np.testing.assert_array_equal(got["actions"].numpy(),
                                  np.asarray(want["actions"]))


def test_sample_draws_on_the_device_dataset():
    """Uniform draws cover the steps; weighted draws stay on the support."""
    _, tw = _welded_pair()
    ds = windows.DeviceDataset.from_welded(tw, 1, 2, device="cpu")
    g = torch.Generator().manual_seed(0)
    b = ds.sample(512, g)
    assert b["obs"]["a"].shape == (512, 2, 3) and b["actions"].shape == (512, 2, 7)
    w = torch.zeros(ds.n_steps)
    w[[2, 7]] = 1.0
    ds_w = windows.DeviceDataset.from_welded(tw, 1, 1, device="cpu",
                                             sample_weights=w)
    got = ds_w.sample(64, g)["obs"]["a"][:, 0]
    allowed = tw.arrays["a"][[2, 7]]
    assert all((row == allowed).all(-1).any() for row in got)


def test_sample_traj_matches_jax():
    jw, tw = _welded_pair()
    want, got = jwindows.sample_traj(jw, 2), windows.sample_traj(tw, 2)
    np.testing.assert_array_equal(got["obs"]["img"].numpy(), want["obs"]["img"])
    np.testing.assert_array_equal(got["actions"].numpy(), want["actions"])


# ---------------------------------------------------------------------------
# the dataset facade
# ---------------------------------------------------------------------------

META = {"lowdim_obs": ["robot0_eef_pos"], "rgb_obs": ["latent_agentview_image"],
        "shape_meta": {"ac_dim": 7, "all_shapes": {}}}


def test_offline_data_paths_and_welded_give_the_same_batches(robomimic_files):
    src, lat = robomimic_files
    kw = dict(name="x", meta=META, batch_size=8, obs_horizon=1, seq_length=4,
              eval_n_episode_overfit=2, device="cpu",
              env_params={"env": {"name": "LiftEnv"}})
    by_path = datasets.OfflineData(train_path=src, eval_path=src,
                                   train_latent_path=lat,
                                   eval_latent_path=lat, **kw)
    full = ingest.load_robomimic(src, ("robot0_eef_pos", "agentview_image",
                                       "latent_agentview_image"),
                                 latent_path=lat)
    welded = datasets.OfflineData(train=full, eval=full, **kw)
    for a, b in ((by_path.train_dataloader(), welded.train_dataloader()),
                 (by_path.eval_dataloader(), welded.eval_dataloader())):
        for _ in range(2):
            x, y = next(a), next(b)
            assert set(x["obs"]) == set(META["lowdim_obs"] + META["rgb_obs"])
            for k in x["obs"]:
                torch.testing.assert_close(x["obs"][k], y["obs"][k],
                                           rtol=0, atol=0)
            torch.testing.assert_close(x["actions"], y["actions"], rtol=0,
                                       atol=0)
    assert welded.welded("eval").n_demos == 2
    assert by_path.env_meta["env_name"] == "SyntheticLift"
    t = welded.sample_traj("train", 1)
    assert t["obs"]["robot0_eef_pos"].shape == (10, 1, 3)


# ---------------------------------------------------------------------------
# latents
# ---------------------------------------------------------------------------

def _load_process_latents():
    spec = importlib.util.spec_from_file_location(
        "process_latents", REPO / "tools" / "process_latents.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_encode_latents_matches_process_latents(tmp_path):
    """Every frame, the terminal one too, through the same VAE weights
    (bridged), shards of 8 over demos of 10 frames."""
    import h5py
    src = synthetic.write_robomimic_hdf5(
        tmp_path / "demos.hdf5", n_demos=3, demo_len=9,
        obs_shapes={"robot0_eef_pos": (3,), "agentview_image": (64, 64, 3)},
        image_keys=("agentview_image",))
    cfg = dict(block_out_channels=[8, 16, 16, 16], norm_groups=4,
               patch_size=4, latent_channels=4)
    jvae = JaxKLVAE(**cfg)
    params = jvae.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)),
                       jax.random.PRNGKey(0))["params"]
    pl = _load_process_latents()
    dst = tmp_path / "latent.hdf5"
    with jax.default_matmul_precision("highest"):
        lo, hi = pl.encode_file(str(src), str(dst), jvae, params,
                                ["agentview_image"], {"min": 0, "max": 255},
                                shard=8)
    vae = bridge.load_klvae_encoder(KLVAE(**cfg),
                                    jax.tree_util.tree_map(np.asarray, params))
    w = ingest.load_robomimic(str(src), ("agentview_image",))
    got_lo, got_hi = encode_latents(w, vae, ["agentview_image"], shard=8)
    assert "latent_agentview_image" in w.obs_keys
    with h5py.File(dst, "r") as f:
        want = np.concatenate([f[f"data/demo_{d}/latent/agentview_image"][:]
                               for d in range(3)])
    np.testing.assert_allclose(w.arrays["latent_agentview_image"].numpy(),
                               want, atol=1e-5, rtol=0)
    np.testing.assert_allclose([got_lo, got_hi], [lo, hi], atol=1e-5)


# ---------------------------------------------------------------------------
# scripted collection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noise,hold,clean", [(0.0, 1, False),
                                              (0.3, 3, True),
                                              (0.3, 1, False)])
def test_scripted_collection_matches_jax(noise, hold, clean):
    """The kinematic ``LiftEnv`` expert from the JAX engine's resets, with
    its held noise draws handed in: observations, recorded actions, rewards
    and success agree."""
    n, T = 4, 30
    rng = jax.random.PRNGKey(2)
    jenv = jlift.LiftEnv(render_images=False)
    ref = jengine.run_scripted_collection(jenv, n, rng, episode_len=T,
                                          noise=noise, noise_hold=hold,
                                          clean_labels=clean, host_loop=True)
    reset_rng, act_rng = jax.random.split(rng)
    keys = jax.vmap(lambda s: jax.random.fold_in(reset_rng, s))(
        jnp.arange(n, dtype=jnp.int32))
    states, _ = jax.vmap(jenv.reset)(keys)
    init = lift.LiftState(**{k: torch.from_numpy(np.array(getattr(states, k)))
                             for k in ("eef_pos", "gripper", "cube_pos",
                                       "cube_yaw", "grasped", "t")})
    step_keys = jengine._collection_step_rngs(act_rng, T, hold)
    draws = np.stack([np.asarray(jax.vmap(
        lambda r: jax.random.normal(r, (7,)))(jax.random.split(k, n)))
        for k in step_keys])
    got = engine.run_scripted_collection(
        lift.LiftEnv(render_images=False), n, episode_len=T, noise=noise,
        noise_hold=hold, clean_labels=clean, init_states=init,
        noise_draws=torch.from_numpy(draws), device="cpu")
    for k in ref["obs"]:
        np.testing.assert_allclose(got["obs"][k].numpy(), ref["obs"][k],
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["first_obs"][k].numpy(),
                                   ref["first_obs"][k], atol=1e-5)
    np.testing.assert_allclose(got["actions"].numpy(), ref["actions"],
                               atol=1e-5)
    np.testing.assert_allclose(got["rewards"].numpy(), ref["rewards"],
                               atol=1e-5)
    np.testing.assert_array_equal(got["success"].numpy(), ref["success"])
    if noise == 0.0:
        assert got["success"].any(1).all()


def test_scripted_collection_draws_its_own_noise_in_held_blocks():
    env = lift.LiftEnv(render_images=False)
    a = engine.run_scripted_collection(env, 3, 4, episode_len=7, noise=0.5,
                                       noise_hold=3, device="cpu")
    clean = engine.run_scripted_collection(env, 3, 4, episode_len=7,
                                           noise=0.5, noise_hold=3,
                                           clean_labels=True, device="cpu")
    # the same draws execute: identical trajectories, different labels
    torch.testing.assert_close(a["obs"]["robot0_eef_pos"],
                               clean["obs"]["robot0_eef_pos"], rtol=0, atol=0)
    assert not torch.equal(a["actions"], clean["actions"])
    assert a["actions"].shape == (3, 7, 7) and a["success"].shape == (3, 7)


def test_lift_scripted_action_matches_jax():
    rng = np.random.default_rng(3)
    n = 16
    cube = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)),
                           np.full((n, 1), jlift.TABLE_Z + 0.02)], 1)
    eef = cube + rng.normal(0, 0.02, (n, 3)) * rng.integers(0, 2, (n, 1))
    eef[::3, 2] += 0.1
    grasped = rng.integers(0, 2, n).astype(bool)
    state = dict(eef_pos=eef.astype(np.float32),
                 gripper=rng.uniform(size=n).astype(np.float32),
                 cube_pos=cube.astype(np.float32),
                 cube_yaw=rng.uniform(-0.5, 0.5, n).astype(np.float32),
                 grasped=grasped, t=np.zeros(n, np.int32))
    jenv = jlift.LiftEnv(render_images=False)
    want = jax.vmap(jenv.scripted_action)(jlift.LiftState(
        **{k: jnp.asarray(v) for k, v in state.items()}))
    got = lift.LiftEnv(render_images=False).scripted_action(lift.LiftState(
        **{k: torch.from_numpy(v) for k, v in state.items()}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.slow       # minutes of XLA compile for the JAX physics step
def test_scripted_collection_on_lift_physics_matches_jax():
    """The physics env's expert, 2 envs × 12 steps from the JAX engine's
    resets, noise held over 4 steps with clean labels: the eef and the cube
    at the JAX package's replay tolerances (1e-4 and 1e-3: contacts feed
    fp32 differences forward), the joints at 1e-3 (the damped least-squares
    IK moves them by up to 3e-4 for an eef difference of 1e-6), rewards 1e-3,
    labels 2e-3 (an expert label is (target − eef) / 0.05: the eef's 1e-4
    times 20), success exactly."""
    from latent_diffusion_planning_tpu.envs import lift_physics as jlp
    from latent_diffusion_planning_tpu_torch.envs import lift_physics as lp
    from latent_diffusion_planning_tpu_torch.envs import physics as ph
    n, T = 2, 12
    rng = jax.random.PRNGKey(3)
    jenv = jlp.LiftPhysicsEnv(render_images=False)
    ref = jengine.run_scripted_collection(jenv, n, rng, episode_len=T,
                                          noise=0.2, noise_hold=4,
                                          clean_labels=True, host_loop=True)
    reset_rng, act_rng = jax.random.split(rng)
    keys = jax.vmap(lambda s: jax.random.fold_in(reset_rng, s))(
        jnp.arange(n, dtype=jnp.int32))
    states, _ = jax.vmap(jenv.reset)(keys)
    t = lambda a: torch.from_numpy(np.array(a))
    init = lp.LiftPhysState(
        bodies=ph.RigidBody(**{f: t(getattr(states.bodies, f))
                               for f in ("pos", "quat", "linvel", "angvel")}),
        **{f: t(getattr(states, f)) for f in ("qpos", "eef_target", "gripper",
                                              "cube_yaw0", "t")})
    draws = np.stack([np.asarray(jax.vmap(
        lambda r: jax.random.normal(r, (7,)))(jax.random.split(k, n)))
        for k in jengine._collection_step_rngs(act_rng, T, 4)])
    got = engine.run_scripted_collection(
        lp.LiftPhysicsEnv(render_images=False), n, episode_len=T, noise=0.2,
        noise_hold=4, clean_labels=True, init_states=init,
        noise_draws=torch.from_numpy(draws), device="cpu")
    for k, tol in (("robot0_eef_pos", 1e-4), ("robot0_joint_pos", 1e-3),
                   ("object", 1e-3)):
        np.testing.assert_allclose(got["obs"][k].numpy(), ref["obs"][k],
                                   atol=tol, err_msg=k)
    np.testing.assert_allclose(got["actions"].numpy(), ref["actions"],
                               atol=2e-3)
    np.testing.assert_allclose(got["rewards"].numpy(), ref["rewards"],
                               atol=1e-3)
    np.testing.assert_array_equal(got["success"].numpy(), ref["success"])
