"""The port's VAE half against the JAX package's: the decoder, the full
``KLVAE`` call with a given posterior noise, ``kl_divergence``, the
``VAEModel`` loss and one update, the committed bench VAE's decoder at full
width, LDP's plan visualization on the bench checkpoint, the PNG writer, and
short CPU runs of the VAE workspace feeding the LDP workspace.

Both sides are fp32 on the CPU with JAX's matmuls at "highest" precision.
Tolerances are stated per test: a decoder is a few dozen fp32 convolutions
summed in two frameworks' orders (1e-5; 1e-4 at the bench's full widths); an
update holds its gradients to 1e-4 of each tensor's largest and each weight
to Adam's first step's sensitivity at them; plan visualization runs two
reverse processes and the decoder (1e-4).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from latent_diffusion_planning_tpu.models.vae import KLVAE as JaxKLVAE
from latent_diffusion_planning_tpu.models.vae import VAEModel as JaxVAEModel
from latent_diffusion_planning_tpu.models.vae import (
    kl_divergence as jax_kl_divergence)
from latent_diffusion_planning_tpu.train.checkpoint import (
    Checkpointer as JaxCheckpointer, apply_params_snapshot as japply)
from latent_diffusion_planning_tpu.utils.config import _configify, instantiate
from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.models.vae import (
    VAEModel, kl_divergence, latent_grid_shape)
from latent_diffusion_planning_tpu_torch.utils import media
from torch_thread import one_torch_thread  # noqa: F401

CKPT = Path(__file__).resolve().parent.parent / "assets" / "bench"
SMALL_VAE = dict(block_out_channels=[8, 16, 16], norm_groups=4,
                 latent_channels=4)


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _images(B, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (B, 64, 64, 3)).astype(
        np.float32)


def _jax_vae(cfg, seed=0):
    vae = JaxKLVAE(**cfg)
    params = jax.jit(vae.init)(jax.random.PRNGKey(seed),
                               jnp.zeros((1, 64, 64, 3)),
                               jax.random.PRNGKey(1))["params"]
    return vae, params


# ---------------------------------------------------------------------------
# the autoencoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patch_size", [1, 4])
def test_decoder_matches_flax(patch_size):
    """Patch 4 checks the pixel-shuffle order of the un-patch head, patch 1
    the plain output conv; both the nearest 2× upsampling."""
    cfg = dict(SMALL_VAE, patch_size=patch_size)
    jvae, params = _jax_vae(cfg)
    h = 64 // 2 ** (patch_size.bit_length() - 1 + 2)
    z = np.random.default_rng(1).normal(size=(3, h, h, 4)).astype(np.float32)
    want = jax.jit(lambda p, z: jvae.apply({"params": p}, z,
                                           method=JaxKLVAE.decode))(params, z)
    vae = bridge.klvae_from_flax(_np(params), **cfg)
    got = vae.decode(torch.from_numpy(z))
    assert got.shape == want.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_nearest_upsample_is_jax_resize():
    x = np.random.default_rng(2).normal(size=(2, 5, 3, 4)).astype(np.float32)
    want = jax.image.resize(x, (2, 10, 6, 4), method="nearest")
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2.0,
        mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_klvae_call_matches_flax():
    """The full autoencoder with JAX's posterior draw ε handed in."""
    cfg = dict(SMALL_VAE, patch_size=4)
    jvae, params = _jax_vae(cfg, seed=3)
    x = _images(4)
    key = jax.random.PRNGKey(7)
    rec, mean, logvar = jax.jit(lambda p, x: jvae.apply({"params": p}, x, key))(
        params, x)
    eps = np.array(jax.random.normal(key, mean.shape))
    vae = bridge.klvae_from_flax(_np(params), **cfg)
    with torch.no_grad():
        got = vae(torch.from_numpy(x), torch.from_numpy(eps))
    for g, w in zip(got, (rec, mean, logvar)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_kl_divergence_matches_jax():
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(5, 2, 2, 4)).astype(np.float32)
    logvar = rng.normal(size=(5, 2, 2, 4)).astype(np.float32)
    want = np.asarray(jax_kl_divergence(mean, logvar))
    got = kl_divergence(torch.from_numpy(mean), torch.from_numpy(logvar))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    assert latent_grid_shape(16) == (2, 2, 4)
    with pytest.raises(ValueError):
        latent_grid_shape(17)


# ---------------------------------------------------------------------------
# VAEModel against the JAX VAEModel
# ---------------------------------------------------------------------------

def _model_config(**over):
    cfg = configs.lift_vae_train_config()["model"]
    cfg.update(vae=dict(SMALL_VAE, patch_size=4), lr=1e-3, end_lr=1e-4,
               warmup_steps=2, decay_steps=10)
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def vae_pair():
    cfg = _model_config()
    jmodel = JaxVAEModel.create(
        jax.random.PRNGKey(0), None, vae=cfg["vae"], beta=cfg["beta"],
        rgb_obs=cfg["rgb_obs"], obs_normalization=cfg["obs_normalization"],
        lr=cfg["lr"], end_lr=cfg["end_lr"], warmup_steps=cfg["warmup_steps"],
        decay_steps=cfg["decay_steps"], ema_decay=cfg["ema_decay"])
    return cfg, jmodel


def _ported(jmodel, cfg):
    model = VAEModel.create(cfg, device="cpu")
    vae = bridge.klvae_from_flax(_np(jmodel.vae_state.params), **cfg["vae"])
    model.vae_state.set_params(vae.state_dict())
    return model


def _vae_batch(B=3, seed=5):
    rng = np.random.default_rng(seed)
    return {"obs": {"agentview_image": rng.integers(
        0, 256, (B, 2, 64, 64, 3)).astype(np.uint8)}}


def _eps(rng, model, B):
    """JAX ``VAEModel.loss`` draws ε from ``split(rng)[0]``."""
    return np.array(jax.random.normal(jax.random.split(rng)[0],
                                      (B, *model.latent_hw())))


def _torch_batch(batch):
    return {"obs": {k: torch.from_numpy(v) for k, v in batch["obs"].items()}}


def test_vae_model_metrics_match_jax(vae_pair):
    cfg, jmodel = vae_pair
    model = _ported(jmodel, cfg)
    batch, rng = _vae_batch(), jax.random.PRNGKey(8)
    want = jmodel.get_metrics(jax.tree_util.tree_map(jnp.asarray, batch), rng)
    got = model.get_metrics(_torch_batch(batch),
                            draws={"eps": _eps(rng, model, 3)})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(want["loss_kl"]) > 0


# the gradients' bar: each tensor's largest difference over its largest
# gradient (two frameworks' fp32 sums of one backward pass)
GRAD_RTOL = 1e-4
ADAM_EPS = 1e-8
F32_ULP = float(np.finfo(np.float32).eps)
# Adam's constants in fp32: 1 - fp32(0.999) is 1.3e-5 off 1e-3, so either
# side's first step lr · g / |g| may sit 6.4e-6 of itself off the exact one
ADAM_REL = 2e-5


def _jax_grads(jmodel, batch, rng):
    """The gradients ``jmodel.update`` applies, from its own loss."""
    from latent_diffusion_planning_tpu.ops import normalize as jnz
    nb = jnz.normalize_batch(jax.tree_util.tree_map(jnp.asarray, batch),
                             jmodel.obs_normalization)
    grads, _ = jax.jit(jax.grad(jmodel.loss, has_aux=True))(
        jmodel.vae_state.params, nb, rng)
    return grads


def _first_adam_step(g):
    """Adam's first update direction m̂ / (sqrt(v̂) + eps) = g / (|g| + eps),
    in fp64."""
    return g / (np.abs(g) + ADAM_EPS)


def _update_excess(mine, grads, before, want_vae, want_grads, lr, moved):
    """The largest ratio, over the weights (not the key bias), of the
    distance to JAX's updated weight over what the gradients' bar allows:
    how far Adam's first step moves when the port's observed gradient g
    moves by up to GRAD_RTOL of its tensor's largest JAX gradient,
    ``moved`` × lr × max |a(g ± Δ) − a(g)|, plus the fp32 rounding of the
    update (two ulps of the weight, and ADAM_REL of the step). Above 1: the
    update is not Adam's at gradients within the bar."""
    worst = 0.0
    for (name, p), q, gj in zip(mine.named_parameters(),
                                want_vae.parameters(),
                                want_grads.parameters()):
        if name.endswith("attn.k.bias"):
            continue
        w = p.detach().numpy().astype(np.float64)
        g = grads[name].numpy().astype(np.float64)
        delta = GRAD_RTOL * float(np.abs(gj.detach().numpy()).max())
        a = _first_adam_step(g)
        sens = moved * lr * np.maximum(
            np.abs(_first_adam_step(g + delta) - a),
            np.abs(_first_adam_step(g - delta) - a))
        rounding = (2 * F32_ULP * np.maximum(np.abs(w),
                                             np.abs(before[name].numpy()))
                    + ADAM_REL * moved * lr * np.abs(a))
        err = np.abs(w - q.detach().numpy())
        worst = max(worst, float((err / (sens + rounding + 1e-30)).max()))
    return worst


def test_vae_model_update_matches_jax(vae_pair):
    """One update at step 0 (lr end_lr = 1e-4): metrics, the learning rate
    and step, the gradients, the new weights and their EMA.

    The gradients hold JAX's to 1e-4 of each tensor's largest. The update
    holds where it is well defined: Adam's first step is lr · g / (|g| +
    eps), so where |g| is near eps it magnifies the rounding of g (an
    element of a conv weight moved 1.06e-5 from JAX's on one host, under
    1e-5 on another); each weight is held to that step's own sensitivity
    at the port's gradient over the gradients' bar, plus the update's fp32
    rounding. The attention's key bias adds the same q·b to every logit of
    a row, which the softmax cancels: its true gradient is 0, both sides
    compute rounding noise, and Adam turns noise into a step of up to the
    learning rate either way. For it the test holds that bound instead.
    Negative control: the same update at 1.01 × the learning rate leaves
    the bar."""
    cfg, jmodel = vae_pair
    batch, rng = _vae_batch(seed=6), jax.random.PRNGKey(9)
    want_grads = bridge.klvae_from_flax(_np(_jax_grads(jmodel, batch, rng)),
                                        **cfg["vae"])
    new, want = jmodel.update(jax.tree_util.tree_map(jnp.asarray, batch), rng)
    want_vaes = [bridge.klvae_from_flax(_np(t), **cfg["vae"]) for t in (
        new.vae_state.params, new.vae_state.ema_params)]
    lr = float(want["vae_lr"])

    def step(lr_scale):
        model = _ported(jmodel, cfg)
        before = {k: v.detach().clone()
                  for k, v in model.vae.named_parameters()}
        got = model.backward(_torch_batch(batch),
                             draws={"eps": _eps(rng, model, 3)})
        grads = {k: v.grad.detach().clone()
                 for k, v in model.vae.named_parameters()}
        schedule = model.vae_state.schedule
        model.vae_state.schedule = lambda c: lr_scale * schedule(c)
        got.update(model.apply_gradients())
        excess = [_update_excess(mine, grads, before, want_vae, want_grads,
                                 lr, moved)
                  for mine, want_vae, moved in zip(
                      (model.vae, model.vae_state.ema), want_vaes,
                      (1.0, 1.0 - cfg["ema_decay"]))]
        return model, before, got, grads, excess

    model, before, got, grads, excess = step(1.0)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert model.vae_state.step == int(new.vae_state.step) == 1
    worst_grad = 0.0
    for name, gj in want_grads.named_parameters():
        if name.endswith("attn.k.bias"):
            continue
        gj = gj.detach().numpy()
        rel = float(np.abs(grads[name].numpy() - gj).max()
                    / max(np.abs(gj).max(), 1e-30))
        worst_grad = max(worst_grad, rel)
        assert rel <= GRAD_RTOL, (name, rel)
    for mine, moved in ((model.vae, 1.0),
                        (model.vae_state.ema, 1.0 - cfg["ema_decay"])):
        for name, p in mine.named_parameters():
            if name.endswith("attn.k.bias"):
                moved_by = (p.detach() - before[name]).abs().max()
                assert float(moved_by) <= moved * lr * 1.001, name
    faulty = step(1.01)[4]
    print(f"gradients: worst {worst_grad:.2e} of a tensor's largest; update "
          f"/ its bar: weights {excess[0]:.3f}, EMA {excess[1]:.3f}; at "
          f"1.01 lr {faulty[0]:.1f}, {faulty[1]:.3f}")
    assert max(excess) <= 1.0, excess
    assert max(faulty) > 1.0, faulty


def test_vae_model_inference_matches_jax(vae_pair):
    """encode_mode, decode, reconstruct and sample (prior draws handed in)
    on the EMA weights."""
    cfg, jmodel = vae_pair
    model = _ported(jmodel, cfg)
    batch = _vae_batch(B=2, seed=7)
    want = jmodel.reconstruct(jax.tree_util.tree_map(jnp.asarray, batch))
    got = model.reconstruct(_torch_batch(batch))
    # in [0, 255]: the decoder's bar of 1e-5 in its [-1, 1] output is 127.5e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=127.5e-5,
                               rtol=0)
    rng = jax.random.PRNGKey(10)
    want = jmodel.sample(rng, 2)
    z = jax.random.normal(rng, (2, *model.latent_hw()))
    got = model.sample(2, z=torch.from_numpy(np.array(z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=127.5e-5,
                               rtol=0)
    params = model.get_params()
    assert set(params) == {"vae_params", "vae_ema_params"}
    assert model.latent_hw() == tuple(jmodel.latent_hw())


def test_bench_checkpoint_decoder_matches_jax():
    """The committed bench VAE (decoder params through ``restore_raw``) at
    its full widths, decoding latents at the encoder's scale."""
    cfg = configs.BENCH_AGENT["vae"]
    params = JaxCheckpointer(CKPT).restore_raw(CKPT / "agent.ckpt")[
        "vae_params"]
    jvae = JaxKLVAE(**cfg)
    z = (np.random.default_rng(11).normal(size=(4, 2, 2, 4)) * 2).astype(
        np.float32)
    want = jax.jit(lambda p, z: jvae.apply({"params": p}, z,
                                           method=JaxKLVAE.decode))(params, z)
    vae = bridge.klvae_from_flax(_np(params), **cfg)
    got = vae.decode(torch.from_numpy(z)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# LDP's plan visualization on the bench checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_pair():
    cfg_j = _configify(yaml.safe_load((CKPT / "config.yaml").read_text()))
    agent_cfg = dict(cfg_j.agent)
    agent_cfg.pop("vae_pretrain_path", None)
    agent_cfg.update(planner_inference_steps=10, idm_inference_steps=10,
                     fused_sampler=False)
    snap = JaxCheckpointer(CKPT).restore_raw(CKPT / "agent.ckpt")
    agent_cfg["vae_params"] = snap["vae_params"]
    jagent = japply(instantiate(agent_cfg, jax.random.PRNGKey(0), None,
                                configs.SHAPE_META), snap)
    agent = bridge.ldp_agent_from_flax(_np(snap), configs.bench_agent_config(),
                                       configs.SHAPE_META, device="cpu")
    return jagent, agent


def _window(B, H, seed):
    rng = np.random.default_rng(seed)
    return {
        "robot0_eef_pos": (rng.normal(size=(B, H, 3)) * 0.1
                           + [0, 0, 1.0]).astype(np.float32),
        "robot0_eef_quat": np.tile(np.asarray([0, 0, 0, 1.0], np.float32),
                                   (B, H, 1)),
        "robot0_gripper_qpos": np.tile(np.asarray([0.04, -0.04], np.float32),
                                       (B, H, 1)),
        "agentview_image": rng.uniform(0, 255, (B, H, 64, 64, 3)).astype(
            np.float32),
    }


def test_sample_viz_matches_jax_on_bench_checkpoint(bench_pair):
    """A window of 9 frames (so plan_mse is read too) and JAX's draws: its
    non-fused DDIM takes each initial sample from ``split(key)[1]`` of the
    planner's and the IDM's keys."""
    jagent, agent = bench_pair
    B, c = 2, agent.config
    window = _window(B, 9, 12)
    rng = jax.random.PRNGKey(13)
    acts, metrics = jagent.sample_viz({"obs": window}, rng)
    rng1, plan_rng = jax.random.split(rng)
    _, idm_rng = jax.random.split(rng1)
    draws = {"planner": np.array(jax.random.normal(
                 jax.random.split(plan_rng)[1], (B, 8, c.obs_dim))),
             "idm": np.array(jax.random.normal(
                 jax.random.split(idm_rng)[1], (B * c.action_horizon, 7)))}
    got, gm = agent.sample_viz(
        {"obs": {k: torch.from_numpy(v) for k, v in window.items()}},
        draws=draws)
    assert got.shape == (B, 4, 7) and gm["plan_viz"].shape == (B, 5, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(acts), atol=1e-4,
                               rtol=0)
    for k in ("plan", "plan_viz", "plan_mse"):
        np.testing.assert_allclose(gm[k].numpy(), np.asarray(metrics[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def test_sample_action_from_plan_matches_jax_on_bench_checkpoint(bench_pair):
    jagent, agent = bench_pair
    B, H = 2, 3
    window = _window(B, H, 14)
    next_plan = np.random.default_rng(15).uniform(
        -1, 1, (B, H, agent.config.obs_dim)).astype(np.float32)
    rng = jax.random.PRNGKey(16)
    want = jagent.sample_action_from_plan({"obs": window}, next_plan, rng)
    x_idm = np.array(jax.random.normal(jax.random.split(rng)[1], (B * H, 7)))
    got = agent.sample_action_from_plan(
        {"obs": {k: torch.from_numpy(v) for k, v in window.items()}},
        torch.from_numpy(next_plan), draws={"idm": x_idm})
    assert got.shape == (B, H, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# media
# ---------------------------------------------------------------------------

def _decode_png(data: bytes) -> np.ndarray:
    """The minimal reader of what ``encode_png`` writes."""
    import struct
    import zlib
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and b"IEND" in chunks
    c = {0: 1, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("shape", [(64, 64, 3), (5, 7, 4), (3, 9, 1)])
def test_png_round_trip(shape, tmp_path):
    img = np.random.default_rng(17).integers(0, 256, shape).astype(np.uint8)
    back = _decode_png(media.save_image(tmp_path / "a.png", img).read_bytes())
    np.testing.assert_array_equal(back, img)


def test_to_uint8_hwc_matches_jax():
    from latent_diffusion_planning_tpu.utils import media as jmedia
    rng = np.random.default_rng(18)
    for img in (rng.uniform(-1, 1, (3, 8, 8)), rng.uniform(0, 1, (8, 8, 3)),
                rng.uniform(0, 300, (8, 8, 3)),
                rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)):
        img = img.astype(img.dtype if img.dtype == np.uint8 else np.float32)
        np.testing.assert_array_equal(media.to_uint8_hwc(img),
                                      jmedia.to_uint8_hwc(img))
        np.testing.assert_array_equal(
            media.to_uint8_hwc(torch.from_numpy(img)), jmedia.to_uint8_hwc(img))


# ---------------------------------------------------------------------------
# the recipe's first half on the CPU: VAE workspace → latents → LDP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lift_demos():
    """Scripted demos on the kinematic ``LiftEnv`` (rendered), welded."""
    from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
    from latent_diffusion_planning_tpu_torch.rollout import engine
    env = LiftEnv(episode_len=40)
    meta = {"env_name": "LiftEnv", "env_kwargs": {"episode_len": 40}}
    return {s: weld_collection(
        engine.run_scripted_collection(env, n, seed, device="cpu"),
        env_meta=meta, successful_only=True) for s, n, seed in
        (("train", 4, 0), ("eval", 2, 1))}


def test_vae_workspace_snapshot_feeds_ldp(lift_demos, tmp_path):
    """20 steps of the VAE workspace (its eval writes the HTML report),
    its snapshot encoded into latents with its EMA weights, then 20 steps
    of the LDP workspace whose ``vae_pretrain_path`` is that snapshot."""
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.data.latents import (
        process_latents)
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace
    from latent_diffusion_planning_tpu_torch.train.vae_loop import VAEWorkspace
    vcfg = configs.lift_vae_train_config()
    vcfg["model"].update(vae=dict(SMALL_VAE, block_out_channels=[8, 16, 16, 16],
                                  patch_size=4), warmup_steps=5,
                         decay_steps=100)
    vcfg.update(n_grad_steps=20, batch_size=16, log_every=10, save_every=0,
                eval_every=0, n_eval_batches=2)
    vcfg["data"].update(batch_size=16, eval_n_episode_overfit=None)
    data_kw = {k: v for k, v in vcfg["data"].items() if not k.endswith("path")}
    vdata = OfflineData(**data_kw, train=lift_demos["train"],
                        eval=lift_demos["eval"], device="cpu")
    vws = VAEWorkspace(vcfg, tmp_path / "vae", data=vdata, device="cpu")
    vws.run()
    curve = vws.loss_curve()
    assert torch.isfinite(curve["loss"]).all()
    assert curve["loss"][-5:].mean() < curve["loss"][:5].mean()
    html = vws.report_path.read_text()
    assert vws.report_path.name == "recon_20.html"
    assert html.count("data:image/png;base64,") == 24
    snap_path = vws.ckpt.list_checkpoints()[-1]
    assert np.isfinite(vws.last_eval["loss_mse"])

    lo, hi = process_latents(list(lift_demos.values()), snap_path,
                             vcfg["model"]["vae"], ["agentview_image"],
                             device="cpu")
    assert lo < hi and "latent_agentview_image" in lift_demos["eval"].obs_keys
    cfg = configs.bench_train_config(vae_pretrain_path=str(snap_path))
    cfg["agent"].update(
        planner={"down_dims": [16, 32], "kernel_size": 5, "n_groups": 4,
                 "diffusion_step_embed_dim": 32},
        idm_net={"n_blocks": 2, "hidden_dim": 64, "time_dim": 16,
                 "cond_hidden_dims": [32, 32]},
        vae=vcfg["model"]["vae"], planner_n_diffusion_steps=12,
        idm_n_diffusion_steps=12, planner_inference_steps=4,
        idm_inference_steps=4, lr=3e-3, idm_lr=3e-3, warmup_steps=5,
        decay_steps=200)
    cfg.update(n_grad_steps=20, batch_size=8, log_every=10, save_every=0,
               eval_every=0, n_eval_episodes=2)
    cfg["data"].update(batch_size=8, eval_n_episode_overfit=None)
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=lift_demos["train"],
                       eval=lift_demos["eval"], device="cpu")
    ws = Workspace(cfg, tmp_path / "ldp", data=data, device="cpu")
    ws.init_agent()
    want = torch.load(snap_path, weights_only=True)["vae_ema_params"]
    for k, v in ws.agent.vae.state_dict().items():
        assert torch.equal(v, want[k]), k
    ws.run()
    for k in ("plan_loss", "idm_loss"):
        assert torch.isfinite(ws.loss_curve()[k]).all()
    assert np.isfinite(ws.last_eval["eval_plan_mse"])
    assert 0.0 <= ws.last_eval["success"] <= 1.0
