"""The port's ResNet encoder and DP agent against the JAX package's: the
encoder over its pooling heads, block classes, norms and output heads at
64×64 and at an odd size, full-width ResNet-18, the SAME padding that makes
the parity hold, the DP losses, gradients, one update (EMA on both nets,
``obs_horizon`` 2, so the condition's order is pinned) and sampling with
JAX's draws, the shared encoder's condition, the kernel refusals, the state
round trip and a short CPU run of the DP workspace. Also the workspace's
repairs: the bounds it normalizes with are the ones its config and its
snapshots record, and ``env_steps_per_sec`` is the JAX log's quantity.

Both sides are fp32 on the CPU with JAX's matmuls and convolutions at
"highest" precision. 1e-5 for the small encoder, the losses, gradients (of
the largest entry) and updated weights (an update moves a weight by at most
the learning rate); 1e-4 for ResNet-18 at full width (eight 3×3 convs of
up to 4608 products a sum) and for sampled actions (25 DDIM steps whose
x0-clip feeds summation-order differences forward).
"""

import json
from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.models.agents.dp import DPAgent as JaxDPAgent
from latent_diffusion_planning_tpu.models.nets.resnet import (
    ResNetEncoder as JaxResNetEncoder)
from latent_diffusion_planning_tpu.train import state as jstate
from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.models.agents.dp import DPAgent
from latent_diffusion_planning_tpu_torch.models.nets import resnet
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    ConditionalUnet1D)
from latent_diffusion_planning_tpu_torch.train.checkpoint import (
    Checkpointer, apply_params_snapshot)
from torch_thread import one_torch_thread  # noqa: F401

UNET = "latent_diffusion_planning_tpu.models.nets.unet1d.ConditionalUnet1D"
RESNET = "latent_diffusion_planning_tpu.models.nets.resnet.ResNetEncoder"
SMALL_ENCODER = dict(stage_sizes=[1, 1, 1, 1], n_filters=8)
# the agent's: two stages keep JAX's compiles of the agent short
AGENT_ENCODER = dict(stage_sizes=[1, 1], n_filters=8)


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _images(n, hw, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, hw, hw, 3)).astype(np.float32)


def _seeded_params(shapes, seed):
    """Weights for a Flax tree of shapes, drawn with numpy: kernels at
    variance 1 / fan_in (fan_in: all axes but the last), norm scales about
    1 and biases about 0, so no weight sits at its init's constant (the
    bottleneck's last norm scale starts at 0 in Flax)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            v = rng.normal(size=leaf.shape) / np.sqrt(fan_in)
        elif name in ("scale", "softmax_temperature"):
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        else:
            v = 0.2 * rng.normal(size=leaf.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _encoder_pair(cfg, hw, seed=0):
    """The JAX encoder's output on numpy-seeded images and weights (its
    tree's shapes from ``eval_shape``, which compiles nothing), and the
    port's encoder bridged from those weights."""
    jnet = JaxResNetEncoder(**cfg)
    x = _images(2, hw, seed)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = _seeded_params(shapes["params"], seed)
    want = np.asarray(jax.jit(lambda p, v: jnet.apply({"params": p}, v))(
        params, jnp.asarray(x)))
    net = bridge.resnet_from_flax(_np(params), image_shape=(hw, hw, 3), **cfg)
    return net, x, want


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [64, 36])
@pytest.mark.parametrize("block_cls", ["ResNetBlock", "BottleneckResNetBlock"])
@pytest.mark.parametrize("pooling", ["spatial_softmax",
                                     "spatial_learned_embeddings", "avg",
                                     "max", "none"])
def test_resnet_encoder_matches_jax(pooling, block_cls, hw):
    """Stages (1,1,1,1), 8 filters; 36×36 runs the stride-2 windows over
    odd sizes (18 → 9 → 5 → 3 → 2), where SAME pads (1, 1)."""
    cfg = dict(SMALL_ENCODER, block_cls=block_cls, pooling_method=pooling)
    net, x, want = _encoder_pair(cfg, hw)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("options", [
    dict(norm="layer"),
    dict(add_spatial_coordinates=True),
    dict(softmax_temperature=-1),
    dict(feature_layers=[32, 16], use_sigmoid=True),
    dict(feature_layers=[16], use_tanh=True),
    dict(use_simnorm=True),
    dict(use_simnorm_rescale=True, simnorm_dim=4),
    dict(act="swish", pooling_method="avg"),
], ids=lambda o: "-".join(o))
def test_resnet_encoder_options_match_jax(options):
    net, x, want = _encoder_pair(dict(SMALL_ENCODER, **options), 64, seed=1)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resnet18_at_full_width_matches_jax():
    """The DP recipe's encoder: ResNet-18, GroupNorm, spatial softmax, on 2
    frames of 64×64 → (2, 1024)."""
    cfg = dict(configs.lift_dp_train_config()["agent"]["encoder"])
    net, x, want = _encoder_pair(cfg, 64, seed=2)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1024) and net.n_features == 1024
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_same_pads_match_lax():
    for size in range(1, 40):
        for k, s in ((3, 2), (1, 2), (3, 1), (7, 2), (5, 3)):
            want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
            assert resnet.same_pads(size, k, s) == tuple(want), (size, k, s)
    assert resnet.same_pads(32, 3, 2) == (0, 1)     # the stem's pool
    assert resnet.same_pads(16, 1, 2) == (0, 0)     # a 1×1 projection


def test_symmetric_padding_would_break_the_parity(monkeypatch):
    """torch's ``padding=1`` (what ``nn.Conv2d(..., padding=1)`` and
    ``nn.MaxPool2d(3, 2, 1)`` do) gives the same shapes with every stride-2
    window one pixel off: far from JAX, where the SAME helper is within
    1e-5."""
    cfg = dict(SMALL_ENCODER, pooling_method="avg")
    net, x, want = _encoder_pair(cfg, 64, seed=3)
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(), want,
                                   atol=1e-5, rtol=0)
        monkeypatch.setattr(resnet, "same_pads",
                            lambda size, k, s: (k // 2, k // 2))
        torch_default = net(torch.from_numpy(x)).numpy()
    assert torch_default.shape == want.shape
    assert np.abs(torch_default - want).max() > 1e-2


def test_unported_options_raise():
    """FiLM, multiplicative conditioning and bf16 compute, once refused,
    build (``tests/test_torch_options.py`` holds them against Flax); what
    still raises: conditioning without the condition's width, and a
    compute type of neither float32 nor bfloat16."""
    for ok in (dict(use_film=True, cond_dim=4),
               dict(use_multiplicative_cond=True, cond_dim=4),
               dict(compute_dtype="bfloat16")):
        resnet.ResNetEncoder((64, 64, 3), **ok)
    for bad, reason in ((dict(use_film=True), "cond_dim"),
                        (dict(use_multiplicative_cond=True), "cond_dim"),
                        (dict(compute_dtype="float16"), "float32 or bfloat16")):
        with pytest.raises(ValueError, match=reason):
            resnet.ResNetEncoder((64, 64, 3), **bad)


# ---------------------------------------------------------------------------
# the agent against the JAX DPAgent
# ---------------------------------------------------------------------------

def _small_config(**over):
    cfg = configs.lift_dp_train_config()["agent"]
    cfg.update(planner={"down_dims": [16, 32], "kernel_size": 5, "n_groups": 4,
                        "diffusion_step_embed_dim": 32},
               encoder=dict(cfg["encoder"], **AGENT_ENCODER),
               n_diffusion_steps=12, inference_steps=4, obs_horizon=2,
               lr=1e-3, end_lr=1e-4, warmup_steps=2, decay_steps=10,
               planner_ema_decay=0.75, encoder_ema_decay=0.5)
    cfg.update(over)
    return cfg


def _jax_agent(cfg):
    """The JAX DPAgent of ``cfg``. Its nets' weights are drawn with numpy
    (``_seeded_params``) in place of Flax's ``init``, which would run every
    layer eagerly: half a minute of single-op compiles on the CPU."""
    orig = flax.linen.Module.init

    def init(module, rngs, *args, **kwargs):
        shapes = jax.eval_shape(
            lambda r, *a: orig(module, r, *a, **kwargs), rngs, *args)
        return {"params": _seeded_params(shapes["params"], 0)}
    with mock.patch.object(flax.linen.Module, "init", init):
        return JaxDPAgent.create(
            jax.random.PRNGKey(0), None, configs.SHAPE_META,
            planner={"_target_": UNET, **cfg["planner"]},
            encoder={"_target_": RESNET, **cfg["encoder"]},
            **{k: v for k, v in cfg.items()
               if k not in ("planner", "encoder", "name")},
            fused_sampler=False)


def _snapshot(jagent):
    enc = lambda attr: {f"{k}_params": _np(getattr(s, attr))
                        for k, s in jagent.encoder_states.items()}
    return {"planner_params": _np(jagent.planner_state.params),
            "planner_ema_params": _np(jagent.planner_state.ema_params),
            "encoder_params": enc("params"),
            "encoder_ema_params": enc("ema_params")}


def _bridged(jagent, cfg):
    return bridge.dp_agent_from_flax(_snapshot(jagent), cfg,
                                     configs.SHAPE_META, device="cpu")


@pytest.fixture(scope="module")
def pair():
    cfg = _small_config()
    return cfg, _jax_agent(cfg)


def _batch(B=3, T=8, seed=0):
    """A raw batch: lowdim keys, the camera frame (uint8 values), actions."""
    rng = np.random.default_rng(seed)
    obs = {"robot0_eef_pos": (rng.normal(size=(B, T, 3)) * 0.1
                              + [0, 0, 1.0]).astype(np.float32),
           "robot0_eef_quat": rng.uniform(-1, 1, (B, T, 4)).astype(np.float32),
           "robot0_gripper_qpos": (rng.uniform(size=(B, T, 2))
                                   * [0.05, -0.05]).astype(np.float32),
           "agentview_image": rng.integers(
               0, 256, (B, T, 64, 64, 3)).astype(np.float32)}
    return {"obs": obs,
            "actions": rng.uniform(-1.2, 1.2, (B, T, 7)).astype(np.float32)}


def _torch_batch(batch):
    return {"obs": {k: torch.from_numpy(v) for k, v in batch["obs"].items()},
            "actions": torch.from_numpy(batch["actions"])}


def _jax_draws(rng, batch, n_steps=12):
    """JAX ``_loss``: the timesteps' and the noise's keys from one split."""
    t_rng, n_rng = jax.random.split(rng)
    B = batch["actions"].shape[0]
    return {"t": np.array(jax.random.randint(t_rng, (B,), 0, n_steps)),
            "noise": np.array(jax.random.normal(n_rng,
                                                batch["actions"].shape))}


def _jax_params(jagent):
    return {"planner": jagent.planner_state.params,
            "encoder": {k: s.params for k, s in jagent.encoder_states.items()}}


def _jax_prepared(jagent, batch):
    from latent_diffusion_planning_tpu.models.agents import common as jcommon
    return jcommon.prepare_batch(jax.tree_util.tree_map(jnp.asarray, batch),
                                 jagent.obs_normalization)


def _close(got, want, rtol=1e-5):
    for k, v in want.items():
        assert k in got, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def jax_grads(pair):
    """JAX's loss metrics and gradients on one batch (one compile serves
    the loss and the gradient tests)."""
    _, jagent = pair
    batch = _batch(seed=1)
    rng = jax.random.PRNGKey(2)
    grads, metrics = jax.jit(jax.grad(jagent._loss, has_aux=True))(
        _jax_params(jagent), _jax_prepared(jagent, batch), rng)
    return batch, rng, grads, metrics


def test_losses_match_jax(pair, jax_grads):
    cfg, jagent = pair
    batch, rng, _, want = jax_grads
    agent = _bridged(jagent, cfg)
    got = agent.get_metrics(_torch_batch(batch), draws=_jax_draws(rng, batch))
    assert set(got) == set(want)
    _close(got, want)
    assert agent.config.cond_dim == 2 * (32 + 9)


def test_condition_order_matches_jax(pair):
    """Features of both frames first, then the lowdim keys flattened
    time-major: the condition itself, at 1e-5."""
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    prepared = _jax_prepared(jagent, _batch(seed=3))
    want = jax.jit(jagent._obs_cond)(_jax_params(jagent)["encoder"],
                                     prepared["obs"])
    obs = {k: torch.from_numpy(np.array(v))
           for k, v in prepared["obs"].items()}
    with torch.no_grad():
        got = agent._obs_cond(agent.encoders, obs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _assert_grads(module, want, scale, what):
    for (name, w), g in zip(want.named_parameters(), module.parameters()):
        np.testing.assert_allclose(g.grad.numpy(), w.detach().numpy(),
                                   atol=1e-5 * scale, rtol=0,
                                   err_msg=f"{what}.{name}")


def test_gradients_match_jax(pair, jax_grads):
    """JAX's gradient pytree through the bridge's loaders, for the planner
    and the encoder."""
    cfg, jagent = pair
    batch, rng, grads, _ = jax_grads
    agent = _bridged(jagent, cfg)
    metrics = agent.backward(_torch_batch(batch),
                             draws=_jax_draws(rng, batch))
    np.testing.assert_allclose(float(metrics["g_norm"]),
                               float(jstate.global_norm(grads)), rtol=1e-5)
    want_planner = bridge.load_unet1d(ConditionalUnet1D(
        7, agent.config.cond_dim, 32, [16, 32], 5, 4), _np(grads["planner"]))
    want_enc = bridge.resnet_from_flax(
        _np(grads["encoder"]["agentview_image"]), image_shape=(64, 64, 3),
        **cfg["encoder"])
    scale = max(float(w.detach().abs().max())
                for net in (want_planner, want_enc) for w in net.parameters())
    _assert_grads(agent.planner, want_planner, scale, "planner")
    _assert_grads(agent.encoders["agentview_image"], want_enc, scale,
                  "encoder")


def test_one_update_matches_jax(pair):
    """One ``update`` at step 0: metrics, both learning rates, the step, the
    new weights of the planner and the encoder and their EMA copies. Where
    a gradient is below 1e-7 Adam's step turns on its rounding, so there the
    test holds Adam's bound: a move of at most the learning rate."""
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    batch = _batch(seed=6)
    rng = jax.random.PRNGKey(7)
    draws = _jax_draws(rng, batch)
    probe = _bridged(jagent, cfg)
    probe.backward(_torch_batch(batch), draws=draws)
    nets = lambda a: {"planner": a.planner,
                      "encoder": a.encoders["agentview_image"]}
    tiny = {w: {n: p.grad.abs() < 1e-7 for n, p in m.named_parameters()}
            for w, m in nets(probe).items()}
    before = {w: {n: p.detach().clone() for n, p in m.named_parameters()}
              for w, m in nets(agent).items()}
    new, want = jagent.update(jax.tree_util.tree_map(jnp.asarray, batch), rng)
    got = agent.update(_torch_batch(batch), 0, draws=draws)
    assert set(got) == set(want)
    _close(got, want)
    assert agent.planner_state.step == int(new.planner_state.step) == 1
    assert agent.encoder_states["agentview_image"].step == 1
    lr = float(want["planner_lr"])
    moved = _bridged(new, cfg)
    emas = lambda a: {"planner": a.planner_state.ema,
                      "encoder": a.encoder_states["agentview_image"].ema}
    decay = {"planner": cfg["planner_ema_decay"],
             "encoder": cfg["encoder_ema_decay"]}
    for which in ("planner", "encoder"):
        for mine, theirs, share in (
                (nets(agent)[which], nets(moved)[which], 1.0),
                (emas(agent)[which], emas(moved)[which], 1 - decay[which])):
            for (name, p), q in zip(mine.named_parameters(),
                                    theirs.parameters()):
                p, q = p.detach(), q.detach()
                keep = ~tiny[which][name]
                np.testing.assert_allclose(p[keep].numpy(), q[keep].numpy(),
                                           atol=1e-5, rtol=0,
                                           err_msg=f"{which}.{name}")
                step = (p - before[which][name])[tiny[which][name]].abs()
                assert not step.numel() or float(step.max()) <= (
                    share * lr * 1.001)


@pytest.mark.parametrize("use_ema", [False, True])
def test_sample_action_matches_jax(pair, use_ema):
    """DDIM-4 of 12 through the plain twin of kernel B's route, JAX's
    initial sample (``normal(split(key)[1])``) handed in; with ``use_ema``
    the EMA encoder and planner (bridged from the snapshot's EMA trees)."""
    cfg, jagent = pair
    cfg = dict(cfg, use_ema=use_ema)
    jagent = jagent.replace(config=jagent.config.replace(use_ema=use_ema))
    if use_ema:   # EMA weights that differ from the trained ones
        scale = lambda s, f: s.replace(ema_params=jax.tree_util.tree_map(
            lambda x: x * f, s.params))
        jagent = jagent.replace(
            planner_state=scale(jagent.planner_state, 0.9),
            encoder_states={k: scale(s, 0.95)
                            for k, s in jagent.encoder_states.items()})
    agent = _bridged(jagent, cfg)
    window = {"obs": _batch(B=4, T=2, seed=8)["obs"]}
    rng = jax.random.PRNGKey(9)
    want = jagent.sample_action(jax.tree_util.tree_map(jnp.asarray, window),
                                rng)
    x_init = np.array(jax.random.normal(jax.random.split(rng)[1], (4, 8, 7)))
    got = agent.sample_action(
        {"obs": {k: torch.from_numpy(v) for k, v in window["obs"].items()}},
        draws={"x_init": x_init})
    assert got.shape == want.shape == (4, 4, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_shared_encoder_condition_matches_jax(pair):
    """One encoder for two cameras: the frames joined over cameras on the
    time axis before they are encoded, then the lowdim keys."""
    cfg, jagent = pair
    cams = ("agentview_image", "eye_in_hand_image")
    state = jagent.encoder_states["agentview_image"]
    shared = jagent.replace(
        config=jagent.config.replace(shared_encoder=True, rgb_obs=cams),
        encoder_states={"shared": state})
    meta = {**configs.SHAPE_META, "all_shapes": {
        **configs.SHAPE_META["all_shapes"], "eye_in_hand_image": [64, 64, 3]}}
    agent = DPAgent.create(dict(cfg, shared_encoder=True, rgb_obs=list(cams)),
                           meta, device="cpu")
    assert set(agent.encoders) == {"shared"}
    assert agent.config.cond_dim == 2 * (2 * 32 + 9)
    bridge.load_resnet(agent.encoders["shared"], _np(state.params))
    rng = np.random.default_rng(10)
    obs = {k: v for k, v in _batch(seed=10)["obs"].items()}
    obs["eye_in_hand_image"] = rng.uniform(-1, 1, (3, 8, 64, 64, 3)).astype(
        np.float32)
    obs["agentview_image"] = obs["agentview_image"] / 127.5 - 1.0
    want = jax.jit(shared._obs_cond)({"shared": state.params},
                                     jax.tree_util.tree_map(jnp.asarray, obs))
    with torch.no_grad():
        got = agent._obs_cond(agent.encoders, {k: torch.from_numpy(v)
                                               for k, v in obs.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
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
    agent = DPAgent.create(_small_config(**change), configs.SHAPE_META,
                           device="cpu")
    if reason is None:
        agent._check_kernels()
        return
    with pytest.raises(ValueError, match=reason):
        agent._check_kernels()


@pytest.mark.parametrize("change", [dict(inference_steps=None),
                                    dict(inference_steps=12)])
def test_kernel_check_accepts_ddpm(change):
    """``dp_agent.yaml``'s ``inference_steps: null``, and steps not below
    the 12 trained, mean the full DDPM process; once refused as "DDIM
    only", it runs through kernel B with per-step noise: the check accepts
    it and the sampler's table is the 12-step ancestral one."""
    agent = DPAgent.create(_small_config(**change), configs.SHAPE_META,
                           device="cpu")
    agent._check_kernels()
    ts, coefs = agent.sampler.table()
    assert len(ts) == 12 and bool(coefs[:-1, 4].gt(0).all())


def test_the_recipe_passes_the_kernel_check():
    """At the recipe's widths (ResNet-18's 1024 features + 9 lowdim: a
    1033-wide condition) kernel B takes the action U-Net: the condition
    half of its prologue walks the condition in chunks, so it runs 64
    samples a block at any width; a 4000-wide condition, once refused,
    passes too."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as kunet)
    agent = DPAgent.create(configs.lift_dp_train_config()["agent"],
                           configs.SHAPE_META, device="cpu")
    agent._check_kernels()
    assert agent.config.cond_dim == 1033
    assert kunet.COND_ROWS == 64
    assert kunet.prologue_smem_bytes(agent.planner) <= kunet.SMEM_LIMIT
    assert kunet.kernel_info(agent.planner, 1024, 8, 25)[
        "prologue_grid"] == 25 + 1024 // 64
    p = agent.planner
    too_wide = ConditionalUnet1D(7, 4000, p.dsed, p.down_dims, p.kernel_size,
                                 p.n_groups)
    kunet.check_supported(too_wide, 8)
    assert kunet.prologue_smem_bytes(too_wide) <= kunet.SMEM_LIMIT


def test_ddpm_samples_on_the_cpu():
    agent = DPAgent.create(_small_config(inference_steps=None),
                           configs.SHAPE_META, device="cpu")
    batch = _batch(B=2, T=2, seed=11)
    acts = agent.sample_action({"obs": {k: torch.from_numpy(v) for k, v in
                                        batch["obs"].items()}},
                               torch.Generator().manual_seed(0))
    assert acts.shape == (2, 4, 7) and torch.isfinite(acts).all()


def test_weights_changed_drops_the_packs():
    """Kernel B reads a packed copy of the weights; an update, a restore
    and a params snapshot drop it (a sentinel stands for a pack)."""
    agent = DPAgent.create(_small_config(), configs.SHAPE_META, device="cpu")
    agent.sampler._pack = "stale"
    agent.update(_torch_batch(_batch(seed=12)), 0,
                 torch.Generator().manual_seed(0))
    assert agent.sampler._pack is None
    agent.sampler._pack = "stale"
    agent.load_state_dict(agent.state_dict())
    assert agent.sampler._pack is None
    agent.sampler._pack = "stale"
    apply_params_snapshot(agent, agent.get_params())
    assert agent.sampler._pack is None


def test_params_snapshot_rebinds_the_encoders():
    """``get_params`` has the JAX keys; applying one agent's snapshot to
    another gives it the planner's and the encoders' weights, EMA copies
    included."""
    src = DPAgent.create(_small_config(), configs.SHAPE_META, seed=0,
                         device="cpu")
    params = src.get_params()
    assert set(params) == {"planner_params", "encoder_params",
                           "planner_ema_params", "encoder_ema_params"}
    assert set(params["encoder_params"]) == {"agentview_image_params"}
    dst = DPAgent.create(_small_config(), configs.SHAPE_META, seed=1,
                         device="cpu")
    apply_params_snapshot(dst, params)
    for mine, theirs in ((dst.encoders["agentview_image"],
                          src.encoders["agentview_image"]),
                         (dst.encoder_states["agentview_image"].ema,
                          src.encoders["agentview_image"]),
                         (dst.planner_state.ema, src.planner)):
        for p, q in zip(mine.parameters(), theirs.parameters()):
            assert torch.equal(p, q)


def test_state_round_trip_is_exact(tmp_path):
    cfg = _small_config()
    agent = DPAgent.create(cfg, configs.SHAPE_META, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        agent.update(_torch_batch(_batch(seed=13)), 0, g)
    ck = Checkpointer(tmp_path)
    other = DPAgent.create(cfg, configs.SHAPE_META, seed=1, device="cpu")
    ck.restore_state(ck.save_state(2, agent), other)
    assert other.encoder_states["agentview_image"].step == 2
    batch = _torch_batch(_batch(seed=14))
    m1 = agent.update(batch, 2, torch.Generator().manual_seed(2))
    m2 = other.update(batch, 2, torch.Generator().manual_seed(2))
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in ((agent.planner_state.ema, other.planner_state.ema),
                 (agent.encoder_states["agentview_image"].ema,
                  other.encoder_states["agentview_image"].ema)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# the workspace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def welded():
    """Scripted demos on the kinematic ``LiftEnv`` (rendered 64×64),
    welded in memory."""
    from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
    from latent_diffusion_planning_tpu_torch.rollout import engine
    env = LiftEnv(episode_len=40)
    meta = {"env_name": "LiftEnv", "env_kwargs": {"episode_len": 40}}
    return {s: weld_collection(
        engine.run_scripted_collection(env, n, seed, device="cpu"),
        env_meta=meta, successful_only=True) for s, n, seed in
        (("train", 4, 0), ("eval", 2, 1))}


def _workspace(tmp_path, welded, **data_over):
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace
    cfg = configs.lift_dp_train_config()
    cfg["agent"] = _small_config(obs_horizon=1, lr=3e-3, warmup_steps=5,
                                 decay_steps=200)
    cfg.update(n_grad_steps=10, batch_size=8, log_every=5, save_every=0,
               eval_every=0, n_eval_episodes=2)
    cfg["data"].update(batch_size=8, eval_n_episode_overfit=None, **data_over)
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=welded["train"], eval=welded["eval"],
                       device="cpu")
    return Workspace(cfg, tmp_path, data=data, device="cpu")


def test_dp_workspace_trains(tmp_path, welded):
    """10 steps of the DP workspace at small widths on raw frames, ending
    with its snapshot and eval (offline action MSE, a closed loop of 2
    episodes whose policy sees the raw camera frame)."""
    ws = _workspace(tmp_path, welded)
    assert ws._policy_obs_keys() == tuple(configs.BENCH_POLICY_KEYS)
    ws.init_agent()
    assert isinstance(ws.agent, DPAgent)
    ws.run()
    curve = ws.loss_curve()["loss"]
    assert curve.shape == (10,) and torch.isfinite(curve).all()
    ev = ws.last_eval
    assert np.isfinite(ev["eval_action_mse"]) and ev["n_episodes"] == 2
    assert 0.0 <= ev["success"] <= 1.0
    assert [p.name for p in ws.ckpt.list_states()] == ["10.state"]
    snap = ws.ckpt.restore_raw(ws.ckpt.list_checkpoints()[-1])
    assert set(snap["encoder_params"]) == {"agentview_image_params"}


def test_workspace_records_the_measured_bounds(tmp_path, welded):
    """With ``stats_from_data`` the agent normalizes with measured bounds;
    ``config.json`` and a state snapshot's config hold those, not the
    config's hand-written ones, as the JAX Workspace writes them back."""
    keys = ["robot0_eef_pos", "actions"]
    ws = _workspace(tmp_path, welded, stats_from_data=keys)
    measured = ws.data.meta["obs_normalization"]
    assert measured["obs"]["robot0_eef_pos"] != (
        configs.OBS_NORMALIZATION["obs"]["robot0_eef_pos"])
    ws.init_agent()
    want = json.loads(json.dumps(measured))
    written = json.loads((tmp_path / "config.json").read_text())
    assert written["agent"]["obs_normalization"] == want
    ws.save_snapshot()
    saved = json.loads((ws.ckpt.directory / "0.config.json").read_text())
    assert saved["agent"]["obs_normalization"] == want
    lo = ws.agent.obs_normalization["obs"]["robot0_eef_pos"]["min"]
    assert lo.tolist() == pytest.approx(measured["obs"]["robot0_eef_pos"]["min"])


def test_eval_logs_the_jax_env_steps_per_sec(tmp_path, welded, monkeypatch):
    """Episodes that end early: ``env_steps_per_sec`` counts their steps to
    the end (JAX: horizon × n_episodes / wall), and
    ``computed_env_steps_per_sec`` every step the engine ran (episode_len ×
    n_episodes / wall)."""
    from latent_diffusion_planning_tpu_torch.train import loop
    ws = _workspace(tmp_path, welded)
    ws.init_agent()
    metrics = {"success": 1.0, "reward": 1.0, "horizon": 12.5,
               "avg_reward": 0.1, "n_episodes": 2}
    monkeypatch.setattr(loop.rollout_engine, "run_batched_eval",
                        lambda *a, **k: {"metrics": dict(metrics)})
    ev = ws.eval()
    wall = ev["total_time"]
    assert ws._env.episode_len == 80
    assert ev["env_steps_per_sec"] == pytest.approx(12.5 * 2 / wall)
    assert ev["computed_env_steps_per_sec"] == pytest.approx(80 * 2 / wall)
