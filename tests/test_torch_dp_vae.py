"""The port's DPVAE agent and its data plumbing against the JAX package's:
the random shift and grid sampling, measured normalization bounds and
event-weighted sampling, the DPVAE losses, gradients, one update and
sampling with JAX's draws, the kernel refusals, the bridge, and a short CPU
run of the DPVAE workspace on a VAE snapshot.

Both sides are fp32 on the CPU with JAX's matmuls at "highest" precision.
Exact where nothing is computed in floating point (bounds rounded to 5
decimals, event weights, gathers); 1e-6 for bilinear sampling; 1e-5 for
losses, gradients (of the largest entry) and updated weights (an update
moves a weight by at most the learning rate); 1e-4 for sampled actions
(25 DDIM steps whose x0-clip feeds summation-order differences forward).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.data import datasets as jdatasets
from latent_diffusion_planning_tpu.data import ingest as jingest
from latent_diffusion_planning_tpu.data import synthetic
from latent_diffusion_planning_tpu.data import windows as jwindows
from latent_diffusion_planning_tpu.models.agents import common as jcommon
from latent_diffusion_planning_tpu.models.agents.dp_vae import (
    DPVAEAgent as JaxDPVAEAgent)
from latent_diffusion_planning_tpu.ops import augment as jaugment
from latent_diffusion_planning_tpu.train import state as jstate
from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.data import datasets, ingest, windows
from latent_diffusion_planning_tpu_torch.models.agents.dp_vae import DPVAEAgent
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    ConditionalUnet1D)
from latent_diffusion_planning_tpu_torch.ops import augment
from latent_diffusion_planning_tpu_torch.train.checkpoint import (
    Checkpointer, apply_params_snapshot)
from torch_thread import one_torch_thread  # noqa: F401

SMALL_VAE = dict(block_out_channels=[8, 16, 16, 16], norm_groups=4,
                 latent_channels=4, patch_size=4)


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [1, 4])
def test_random_shift_matches_jax(pad):
    """JAX's offsets (``randint(key, (B, 2), 0, 2·pad + 1)``) handed in."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (6, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(pad)
    want = jaugment.random_shift(key, jnp.asarray(imgs), pad)
    shift = np.array(jax.random.randint(key, (6, 2), 0, 2 * pad + 1))
    got = augment.random_shift(torch.from_numpy(imgs), pad,
                               torch.from_numpy(shift))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    u8 = augment.random_shift(torch.from_numpy(imgs).to(torch.uint8), pad,
                              torch.from_numpy(shift))
    assert u8.dtype == torch.uint8 and u8.shape == (6, 16, 16, 3)


def test_grid_sample_matches_jax():
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(3, 9, 7, 2)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (3, 5, 6, 2)).astype(np.float32)
    want = jaugment.grid_sample(jnp.asarray(imgs), jnp.asarray(grid))
    got = augment.grid_sample(torch.from_numpy(imgs), torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# measured bounds and event weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("demos")
    src = synthetic.write_robomimic_hdf5(
        d / "demos.hdf5", n_demos=4, demo_len=20,
        obs_shapes={"robot0_eef_pos": (3,), "object": (10,)}, seed=3)
    lat = synthetic.write_latent_hdf5(d / "latent.hdf5", src,
                                      ["agentview_image"], latent_dim=16)
    return str(src), str(lat)


KEYS = ("robot0_eef_pos", "object", "latent_agentview_image")


def test_measure_stats_matches_jax(demo_file):
    src, lat = demo_file
    want_w = jingest.load_robomimic(src, KEYS, latent_path=lat)
    got_w = ingest.load_robomimic(src, KEYS, latent_path=lat)
    keys = list(KEYS) + ["actions"]
    want = jdatasets.measure_stats(want_w, keys, pad=0.05)
    got = datasets.measure_stats(got_w, keys, pad=0.05)
    assert got == want
    assert isinstance(got["latent_agentview_image"]["min"], float)
    meta = {"obs_normalization": {"obs": {}, "actions": {"clip_min": -1}}}
    j = jdatasets._apply_measured_stats(meta, want_w, keys, 0.05, "x")
    assert datasets.apply_measured_stats(meta, got_w, keys, 0.05) == j
    assert meta == {"obs_normalization": {"obs": {},
                                          "actions": {"clip_min": -1}}}


@pytest.mark.parametrize("channels,boost,halfwidth", [([6], 3.0, 8),
                                                      ([0, 6], 1.5, 2)])
def test_action_event_weights_match_jax(demo_file, channels, boost,
                                        halfwidth):
    src, lat = demo_file
    want = jwindows.action_event_weights(
        jingest.load_robomimic(src, KEYS, latent_path=lat), channels, boost,
        halfwidth)
    got = windows.action_event_weights(
        ingest.load_robomimic(src, KEYS, latent_path=lat), channels, boost,
        halfwidth)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and float(got.max()) > 1.0


def test_offline_data_measures_bounds_and_oversamples(demo_file):
    src, lat = demo_file
    meta = {"lowdim_obs": ["robot0_eef_pos"],
            "rgb_obs": ["latent_agentview_image"],
            "shape_meta": configs.SHAPE_META,
            "obs_normalization": configs.OBS_NORMALIZATION}
    over = {"channels": [6], "boost": 2.0, "halfwidth": 3}
    kw = dict(name="x", meta=meta, train_path=src, eval_path=src,
              train_latent_path=lat, eval_latent_path=lat, batch_size=4,
              seq_length=8, stats_from_data=["latent_agentview_image",
                                             "actions"],
              oversample=over)
    want = jdatasets.OfflineData(**kw, device_put=False)
    got = datasets.OfflineData(**kw, device="cpu")
    norm = got.meta["obs_normalization"]
    assert norm == want.meta["obs_normalization"]
    assert norm["obs"]["latent_agentview_image"] != (
        configs.OBS_NORMALIZATION["obs"]["latent_agentview_image"])
    np.testing.assert_array_equal(
        got.device_dataset("train").sample_weights.numpy(),
        jdatasets._event_weights(want.welded("train"), over))
    assert got.device_dataset("eval").sample_weights is None


# ---------------------------------------------------------------------------
# the agent against the JAX DPVAEAgent
# ---------------------------------------------------------------------------

def _small_config(**over):
    cfg = configs.lift_dp_vae_train_config()["agent"]
    cfg.pop("vae_pretrain_path")
    cfg.update(planner={"down_dims": [16, 32], "kernel_size": 5, "n_groups": 4,
                        "diffusion_step_embed_dim": 32},
               vae=SMALL_VAE, n_diffusion_steps=12, inference_steps=4,
               lr=1e-3, end_lr=1e-4, warmup_steps=2, decay_steps=10,
               random_shift=2)
    cfg.update(over)
    return cfg


def _jax_agent(cfg):
    return JaxDPVAEAgent.create(
        jax.random.PRNGKey(0), None, configs.SHAPE_META,
        planner={"_target_": "latent_diffusion_planning_tpu.models.nets."
                 "unet1d.ConditionalUnet1D", **cfg["planner"]},
        **{k: v for k, v in cfg.items() if k not in ("planner", "name")},
        fused_sampler=False)


def _bridged(jagent, cfg):
    snap = {"planner_params": _np(jagent.planner_state.params),
            "planner_ema_params": _np(jagent.planner_state.ema_params),
            "vae_params": _np(jagent.vae_params)}
    return bridge.dp_vae_agent_from_flax(snap, cfg, configs.SHAPE_META,
                                         device="cpu")


@pytest.fixture(scope="module")
def pair():
    cfg = _small_config()
    return cfg, _jax_agent(cfg)


def _batch(B=3, T=8, seed=0, images=True):
    """A raw batch: lowdim keys, the camera frame (uint8 values) for the
    VAE to encode, actions."""
    rng = np.random.default_rng(seed)
    obs = {"robot0_eef_pos": (rng.normal(size=(B, T, 3)) * 0.1
                              + [0, 0, 1.0]).astype(np.float32),
           "robot0_eef_quat": rng.uniform(-1, 1, (B, T, 4)).astype(np.float32),
           "robot0_gripper_qpos": (rng.uniform(size=(B, T, 2))
                                   * [0.05, -0.05]).astype(np.float32)}
    if images:
        obs["agentview_image"] = rng.integers(
            0, 256, (B, T, 64, 64, 3)).astype(np.float32)
    else:
        obs["latent_agentview_image"] = rng.normal(0, 3, (B, T, 16)).astype(
            np.float32)
    return {"obs": obs,
            "actions": rng.uniform(-1.2, 1.2, (B, T, 7)).astype(np.float32)}


def _torch_batch(batch):
    return {"obs": {k: torch.from_numpy(v) for k, v in batch["obs"].items()},
            "actions": torch.from_numpy(batch["actions"])}


def _jax_draws(rng, batch, pad):
    """JAX ``update``: one split per raw image key for its shift offsets
    (in the batch's key order), then ``_loss`` splits what is left into the
    timesteps' and the noise's keys."""
    shifts = {}
    for k, v in batch["obs"].items():
        if v.ndim == 5 and pad > 0:
            rng, sub = jax.random.split(rng)
            shifts[k] = np.array(jax.random.randint(
                sub, (v.shape[0] * v.shape[1], 2), 0, 2 * pad + 1))
    t_rng, n_rng = jax.random.split(rng)
    B = batch["actions"].shape[0]
    return {"shift": shifts,
            "t": np.array(jax.random.randint(t_rng, (B,), 0, 12)),
            "noise": np.array(jax.random.normal(n_rng,
                                                batch["actions"].shape))}


def _jax_prepared(jagent, batch):
    b = jcommon.prepare_batch(jax.tree_util.tree_map(jnp.asarray, batch),
                              jagent.obs_normalization)
    b["obs"] = jagent._encode_obs(b["obs"])
    return b


def _close(got, want, rtol=1e-5):
    for k, v in want.items():
        assert k in got, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("images", [True, False], ids=["frames", "latents"])
def test_losses_match_jax(pair, images):
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    batch = _batch(seed=1, images=images)
    rng = jax.random.PRNGKey(2)
    _, want = jax.jit(jagent._loss)({"planner": jagent.planner_state.params},
                                    _jax_prepared(jagent, batch), rng)
    draws = _jax_draws(rng, {"obs": {}, "actions": batch["actions"]}, 0)
    with torch.no_grad():
        _, got = agent._loss(agent._prepare(_torch_batch(batch)), draws=draws)
    _close(got, want)
    assert float(want["loss"]) > 0.1


def test_gradients_match_jax(pair):
    """JAX's gradient pytree through the bridge's U-Net loader."""
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    agent.config = dataclasses.replace(agent.config, random_shift=0)
    batch = _batch(seed=3)
    rng = jax.random.PRNGKey(4)
    grads, _ = jax.jit(jax.grad(jagent._loss, has_aux=True))(
        {"planner": jagent.planner_state.params}, _jax_prepared(jagent, batch),
        rng)
    metrics = agent.backward(_torch_batch(batch),
                             draws=_jax_draws(rng, batch, 0))
    np.testing.assert_allclose(float(metrics["g_norm"]),
                               float(jstate.global_norm(grads)), rtol=1e-5)
    p = cfg["planner"]
    want = bridge.load_unet1d(ConditionalUnet1D(
        7, 25, p["diffusion_step_embed_dim"], p["down_dims"],
        p["kernel_size"], p["n_groups"]), _np(grads["planner"]))
    scale = max(float(w.detach().abs().max()) for w in want.parameters())
    for (name, w), g in zip(want.named_parameters(), agent.planner.parameters()):
        np.testing.assert_allclose(g.grad.numpy(), w.detach().numpy(),
                                   atol=1e-5 * scale, rtol=0, err_msg=name)


def test_one_update_matches_jax(pair):
    """One ``update`` at step 0 with the random shift of 2 on the camera
    frames (JAX's offsets handed in): metrics, lr, step, the new weights
    and their EMA. Adam's first step moves a weight by lr·g / (|g| + 1e-8),
    so where a gradient is below 1e-7 the step turns on the gradient's
    rounding (the gradients agree to 1e-5 of the largest, see above): there
    the test holds Adam's bound, a move of at most the learning rate."""
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    batch = _batch(seed=5)
    rng = jax.random.PRNGKey(6)
    draws = _jax_draws(rng, batch, cfg["random_shift"])
    probe = _bridged(jagent, cfg)
    probe.backward(_torch_batch(batch), draws=draws)
    tiny = {n: p.grad.abs() < 1e-7 for n, p in probe.planner.named_parameters()}
    before = {n: p.detach().clone() for n, p in agent.planner.named_parameters()}
    new, want = jagent.update(jax.tree_util.tree_map(jnp.asarray, batch), rng)
    got = agent.update(_torch_batch(batch), 0, draws=draws)
    _close(got, want)
    assert agent.planner_state.step == int(new.planner_state.step) == 1
    lr = float(want["planner_lr"])
    moved = _bridged(new, cfg)
    for mine, theirs, share in (
            (agent.planner, moved.planner, 1.0),
            (agent.planner_state.ema, moved.planner_state.ema,
             1.0 - cfg["ema_decay"])):
        for (name, p), q in zip(mine.named_parameters(), theirs.parameters()):
            p, q = p.detach(), q.detach()
            keep = ~tiny[name]
            np.testing.assert_allclose(p[keep].numpy(), q[keep].numpy(),
                                       atol=1e-5, rtol=0, err_msg=name)
            step = (p - before[name])[tiny[name]].abs()
            assert not step.numel() or float(step.max()) <= share * lr * 1.001


@pytest.mark.parametrize("use_ema", [False, True])
def test_sample_action_matches_jax(pair, use_ema):
    """DDIM-4 of 12 through the plain twin of kernel B's route, JAX's
    initial sample (``normal(split(key)[1])``) handed in; the EMA weights
    (bridged from the snapshot's ``planner_ema_params``) with ``use_ema``."""
    cfg, jagent = pair
    cfg = dict(cfg, use_ema=use_ema)
    jagent = jagent.replace(config=jagent.config.replace(use_ema=use_ema))
    if use_ema:   # EMA weights that differ from the trained ones
        ema = jax.tree_util.tree_map(lambda x: x * 0.9,
                                     jagent.planner_state.params)
        jagent = jagent.replace(planner_state=jagent.planner_state.replace(
            ema_params=ema))
    agent = _bridged(jagent, cfg)
    window = {"obs": _batch(B=4, T=1, seed=7)["obs"]}
    rng = jax.random.PRNGKey(8)
    want = jagent.sample_action(jax.tree_util.tree_map(jnp.asarray, window),
                                rng)
    x_init = np.array(jax.random.normal(jax.random.split(rng)[1], (4, 8, 7)))
    got = agent.sample_action(
        {"obs": {k: torch.from_numpy(v) for k, v in window["obs"].items()}},
        draws={"x_init": x_init})
    assert got.shape == want.shape == (4, 4, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("change,reason", [
    (dict(pred_horizon=7), "not divisible"),
    # fp32 weights, once refused, run through kernel B's fp32 instances
    (dict(fused_dtype="float32"), None),
    # fp16 weights, once refused (the case keeps its name), run through
    # kernel B's fp16 instance
    pytest.param(dict(fused_dtype="float16"), None,
                 id="change2-float32 or bfloat16"),
    (dict(planner={"down_dims": [16, 32], "kernel_size": 4, "n_groups": 4,
                   "diffusion_step_embed_dim": 32}), "odd kernel_size"),
])
def test_kernel_refusals(change, reason):
    """What the JAX agent hands to its XLA scan, the port refuses on the
    card with the reason, and what kernel B now takes it accepts (the same
    check runs here on a CPU agent)."""
    agent = DPVAEAgent.create(_small_config(**change), configs.SHAPE_META,
                              device="cpu")
    if reason is None:
        agent._check_kernels()
        return
    with pytest.raises(ValueError, match=reason):
        agent._check_kernels()


@pytest.mark.parametrize("change", [dict(inference_steps=None),
                                    dict(inference_steps=12)])
def test_kernel_check_accepts_ddpm(change):
    """``dp_repr_agent.yaml``'s ``inference_steps: null``, and steps not
    below the 12 trained, mean the full DDPM process; once refused as
    "DDIM only", it runs through kernel B with per-step noise: the check
    accepts it and the sampler's table is the 12-step ancestral one."""
    agent = DPVAEAgent.create(_small_config(**change), configs.SHAPE_META,
                              device="cpu")
    agent._check_kernels()
    ts, coefs = agent.sampler.table()
    assert len(ts) == 12 and bool(coefs[:-1, 4].gt(0).all())


def test_ddpm_samples_on_the_cpu():
    agent = DPVAEAgent.create(_small_config(inference_steps=None),
                              configs.SHAPE_META, device="cpu")
    batch = _batch(B=2, T=1, seed=9, images=False)
    acts = agent.sample_action({"obs": {k: torch.from_numpy(v) for k, v in
                                        batch["obs"].items()}},
                               torch.Generator().manual_seed(0))
    assert acts.shape == (2, 4, 7) and torch.isfinite(acts).all()


def test_weights_changed_drops_the_packs():
    """Kernel B reads a packed copy of the weights; an update, a restore
    and a params snapshot drop it (a sentinel stands for a pack)."""
    agent = DPVAEAgent.create(_small_config(), configs.SHAPE_META,
                              device="cpu")
    agent.sampler._pack = "stale"
    agent.update(_torch_batch(_batch(seed=10, images=False)), 0,
                 torch.Generator().manual_seed(0))
    assert agent.sampler._pack is None
    agent.sampler._pack = "stale"
    agent.load_state_dict(agent.state_dict())
    assert agent.sampler._pack is None
    agent.sampler._pack = "stale"
    apply_params_snapshot(agent, agent.get_params())
    assert agent.sampler._pack is None


def test_state_round_trip_is_exact(tmp_path):
    cfg = _small_config()
    agent = DPVAEAgent.create(cfg, configs.SHAPE_META, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        agent.update(_torch_batch(_batch(seed=11, images=False)), 0, g)
    ck = Checkpointer(tmp_path)
    other = DPVAEAgent.create(cfg, configs.SHAPE_META, seed=1, device="cpu")
    ck.restore_state(ck.save_state(2, agent), other)
    batch = _torch_batch(_batch(seed=12))
    m1 = agent.update(batch, 2, torch.Generator().manual_seed(2))
    m2 = other.update(batch, 2, torch.Generator().manual_seed(2))
    assert float(m1["loss"]) == float(m2["loss"])
    for p, q in zip(agent.planner_state.ema.parameters(),
                    other.planner_state.ema.parameters()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# the workspace
# ---------------------------------------------------------------------------

def test_dp_vae_workspace_on_a_vae_snapshot(tmp_path):
    """Scripted demos on the kinematic ``LiftEnv``, latents from a VAE
    snapshot, 20 steps of the DPVAE workspace with ``vae_pretrain_path``
    set, ending with its eval (offline action MSE, a closed loop of 2
    episodes through ``sample_action``)."""
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.data.latents import (
        process_latents)
    from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
    from latent_diffusion_planning_tpu_torch.models.vae import VAEModel
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace
    env = LiftEnv(episode_len=40)
    meta = {"env_name": "LiftEnv", "env_kwargs": {"episode_len": 40}}
    welded = {s: weld_collection(
        engine.run_scripted_collection(env, n, seed, device="cpu"),
        env_meta=meta, successful_only=True) for s, n, seed in
        (("train", 4, 0), ("eval", 2, 1))}
    vcfg = configs.lift_vae_train_config()["model"]
    vcfg["vae"] = SMALL_VAE
    snap = Checkpointer(tmp_path / "vae").save_params(
        0, VAEModel.create(vcfg, device="cpu").get_params())
    process_latents(list(welded.values()), snap, SMALL_VAE,
                    ["agentview_image"], device="cpu")
    cfg = configs.lift_dp_vae_train_config(vae_pretrain_path=str(snap))
    cfg["agent"].update({k: v for k, v in _small_config(
        lr=3e-3, warmup_steps=5, decay_steps=200, random_shift=0).items()
        if k != "vae_pretrain_path"})
    cfg.update(n_grad_steps=20, batch_size=8, log_every=10, save_every=0,
               eval_every=0, n_eval_episodes=2)
    cfg["data"].update(batch_size=8, eval_n_episode_overfit=None)
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=welded["train"], eval=welded["eval"],
                       device="cpu")
    ws = Workspace(cfg, tmp_path / "dp_vae", data=data, device="cpu")
    ws.init_agent()
    assert isinstance(ws.agent, DPVAEAgent)
    ws.run()
    curve = ws.loss_curve()["loss"]
    assert torch.isfinite(curve).all()
    assert curve[-5:].mean() < curve[:5].mean()
    ev = ws.last_eval
    assert np.isfinite(ev["eval_action_mse"]) and ev["n_episodes"] == 2
    assert 0.0 <= ev["success"] <= 1.0
    assert "eval_plan_mse" not in ev
