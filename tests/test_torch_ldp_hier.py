"""The port's hierarchical LDP against the JAX package's ``LDPHierAgent``:
the U-Net that does not downsample (through ``bridge``), the strided plan
loss and the chunk IDM loss, their gradients, one update, ``sample_fast``,
``sample_action``, ``sample_plan_stats`` and ``sample_viz`` with JAX's draws
handed in, the checkpoint round trip, the kernel refusals and a short CPU
``Workspace`` run.

Both nets are at the recipe's widths (``lift_ldp_hier_train_config()``:
planner [64,128,256] k 5 over 2 strided latents, chunk IDM [64,128] k 3
over chunks of 4 actions, neither downsampling), with the recipe's 50
train and 25 DDIM steps; the VAE is narrow (its own tests hold it at full
width), and batches come in latent form. The JAX agent is built without
Flax's eager ``init``: its trees' shapes come from ``jax.eval_shape`` and
the weights are drawn with numpy.

Both sides are fp32 on the CPU with JAX's matmuls at "highest" precision.
Tolerances: the nets' outputs 1e-5; losses 1e-5 relative and gradients
1e-5 of the largest entry (differently ordered fp32 sums, as
``tests/test_torch_train.py``); an updated weight 1e-5 (an Adam step moves
it by at most the learning rate); samplers 2e-4, the JAX package's own
kernel-vs-scan bar (``tests/test_pallas_sampler.py:66``); plan statistics
1e-4 relative (a mean over a sampled plan); decoded plan frames 1e-4 (the
VAE decoder's convolutions over a sampled plan).
"""

from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.models.agents import common as jcommon
from latent_diffusion_planning_tpu.models.agents.ldp_hier import (
    LDPHierAgent as JaxLDPHierAgent)
from latent_diffusion_planning_tpu.models.nets.unet1d import (
    ConditionalUnet1D as JaxUnet)
from latent_diffusion_planning_tpu.train import state as jstate
from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
from latent_diffusion_planning_tpu_torch.models.agents.ldp_hier import (
    LDPHierAgent)
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    unet_from_config)
from latent_diffusion_planning_tpu_torch.train.checkpoint import (
    Checkpointer, apply_params_snapshot)
from torch_thread import one_torch_thread  # noqa: F401

UNET = "latent_diffusion_planning_tpu.models.nets.unet1d.ConditionalUnet1D"
SMALL_VAE = {"block_out_channels": [8, 16, 16, 16], "norm_groups": 4,
             "patch_size": 4, "latent_channels": 4}
D, A, P, K = 25, 7, 2, 4       # obs_dim, action_dim, plan length, chunk


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _seeded_params(shapes, seed):
    """Weights for a Flax tree of shapes, drawn with numpy: kernels at
    variance 1 / fan_in, norm scales about 1, biases about 0."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(size=leaf.shape) / np.sqrt(
                int(np.prod(leaf.shape[:-1])))
        elif name == "scale":
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        else:
            v = 0.2 * rng.normal(size=leaf.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _config(**over):
    cfg = configs.lift_ldp_hier_train_config()["agent"]
    cfg.update(vae=SMALL_VAE, lr=1e-3, end_lr=1e-4, idm_lr=1e-3,
               idm_end_lr=1e-4, warmup_steps=2, decay_steps=10, ema_decay=0.5)
    cfg.update(over)
    return cfg


def _jax_agent(cfg):
    orig = flax.linen.Module.init

    def init(module, rngs, *args, **kwargs):
        shapes = jax.eval_shape(
            lambda r, *a: orig(module, r, *a, **kwargs), rngs, *args)
        return {"params": _seeded_params(shapes["params"], 0)}
    keys = ("idm_horizon", "vae_feature_dim", "lowdim_obs", "rgb_obs",
            "obs_normalization", "obs_horizon", "pred_horizon",
            "action_horizon", "planner_n_diffusion_steps",
            "idm_n_diffusion_steps", "planner_inference_steps",
            "idm_inference_steps", "alpha_planner", "alpha_idm", "lr",
            "end_lr", "idm_lr", "idm_end_lr", "warmup_steps", "decay_steps",
            "grad_clip", "ema_decay", "update_planner_every",
            "update_idm_every", "update_idm_after", "update_planner_until",
            "update_planner_after", "action_loss_weights")
    with mock.patch.object(flax.linen.Module, "init", init):
        return JaxLDPHierAgent.create(
            jax.random.PRNGKey(0), None, configs.SHAPE_META,
            planner={"_target_": UNET, **cfg["planner"]},
            idm_net={"_target_": UNET, **cfg["idm_net"]}, vae=cfg["vae"],
            fused_sampler=False, **{k: cfg[k] for k in keys if k in cfg})


def _snapshot(jagent):
    return {"planner_params": _np(jagent.planner_state.params),
            "idm_params": _np(jagent.idm_state.params),
            "planner_ema_params": _np(jagent.planner_state.ema_params),
            "idm_ema_params": _np(jagent.idm_state.ema_params),
            "vae_params": _np(jagent.vae_params)}


def _bridged(jagent, cfg):
    return bridge.ldp_hier_agent_from_flax(_snapshot(jagent), cfg,
                                           configs.SHAPE_META, device="cpu")


@pytest.fixture(scope="module")
def pair():
    cfg = _config()
    return cfg, _jax_agent(cfg)


def _batch(B=3, H=9, seed=0):
    """A raw latent-form batch (the VAE passes latents through)."""
    rng = np.random.default_rng(seed)
    return {"obs": {
        "robot0_eef_pos": (rng.normal(size=(B, H, 3)) * 0.1
                           + [0, 0, 1.0]).astype(np.float32),
        "robot0_eef_quat": rng.uniform(-1, 1, (B, H, 4)).astype(np.float32),
        "robot0_gripper_qpos": (rng.uniform(size=(B, H, 2))
                                * [0.05, -0.05]).astype(np.float32),
        "latent_agentview_image": rng.normal(0, 3, (B, H, 16)).astype(
            np.float32)},
        "actions": rng.uniform(-1.2, 1.2, (B, H, A)).astype(np.float32)}


def _torch_batch(batch):
    out = {"obs": {k: torch.from_numpy(v) for k, v in batch["obs"].items()}}
    if "actions" in batch:
        out["actions"] = torch.from_numpy(batch["actions"])
    return out


def _window(batch, H):
    return {"obs": {k: v[:, :H] for k, v in batch["obs"].items()}}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# the U-Net that does not downsample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which,T", [("planner", P), ("idm_net", K),
                                     ("planner", 7)])
def test_unet_without_downsampling_matches_flax(which, T):
    """The recipe's planner at its plan length (and at an odd one, which
    only a net that does not downsample takes) and its chunk IDM at its
    chunk length: Flax names the top level's only plain conv, the final
    1×1, ``Conv_0`` and has no ``ConvTranspose``, and the bridge lands it
    there (1e-5)."""
    cfg = _config()[which]
    din, dc = (D, D) if which == "planner" else (A, 2 * D)
    jnet = JaxUnet(input_dim=din, global_cond_dim=dc, **cfg)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, T, din)).astype(np.float32)
    t = np.array([0, 17, 49], np.int32)
    c = rng.normal(size=(3, dc)).astype(np.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, t, c)
    params = _seeded_params(shapes["params"], 2)
    assert not any(k.startswith("ConvTranspose") for k in params)
    assert [k for k in params if k.startswith("Conv_")] == ["Conv_0"]
    assert params["Conv_0"]["kernel"].shape == (1, cfg["down_dims"][0], din)
    want = jax.jit(lambda p: jnet.apply({"params": p}, x, t, c))(params)
    net = bridge.unet1d_from_flax(_np(params), input_dim=din,
                                  global_cond_dim=dc, **cfg)
    assert not net.downsample and not len(net.downs) and not len(net.ups)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _hand_count(net, T):
    """(conv products a sample and step, products a step, products a sample)
    of ``net`` at length ``T``, counted from hooks on one forward of the
    net: each conv only at the (row, tap) pairs whose input row is a real
    one (a tap on the padding multiplies a zero; the down conv's input
    carries its (0, 1) pad as a row), the time MLP and each FiLM
    projection's time half once a step, its condition half once a
    sample."""
    counts = [0, 0, 0]
    downs = set(net.downs)

    def conv(mod, args, out):
        n_in = args[0].shape[-1] - (mod in downs)
        (s,), (p,), (k,) = mod.stride, mod.padding, mod.kernel_size
        if isinstance(mod, torch.nn.ConvTranspose1d):   # x[t] w[j] → y[st+j-p]
            pairs = sum(0 <= s * t + j - p < out.shape[-1]
                        for t in range(n_in) for j in range(k))
        else:                                           # y[o] ← x[so+j-p] w[j]
            pairs = sum(0 <= s * o + j - p < n_in
                        for o in range(out.shape[-1]) for j in range(k))
        counts[0] += 2 * pairs * mod.in_channels * mod.out_channels

    def film(mod, args, out):
        counts[1] += 2 * net.dsed * mod.out_features
        counts[2] += 2 * net.global_cond_dim * mod.out_features

    def time_mlp(mod, args, out):
        counts[1] += 2 * mod.in_features * mod.out_features

    hooks = [m.register_forward_hook(conv) for m in net.modules()
             if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))]
    hooks += [b.film.register_forward_hook(film) for b in net.blocks]
    hooks += [m.register_forward_hook(time_mlp)
              for m in (net.time_dense0, net.time_dense1)]
    with torch.no_grad():
        net(torch.zeros(1, T, net.input_dim), torch.zeros(1, dtype=torch.long),
            torch.zeros(1, net.global_cond_dim))
    for h in hooks:
        h.remove()
    return tuple(counts)


@pytest.mark.parametrize("down_dims,k,T,downsample,same_pairs", [
    ((64, 128, 256), 5, P, False, 4), ((64, 128), 3, K, False, 10),
    ((64, 128, 256), 5, 8, True, 34)])
def test_kernel_bound_counts_follow_the_topology(down_dims, k, T, downsample,
                                                 same_pairs):
    """``chip_smoke.py`` bounds kernel B by the products it reads off the
    kernel's program records. They equal a hand count of the function's
    work: a SAME conv of 5 taps at T 2 needs 4 of its 10 (row, tap) pairs,
    one of 3 taps at T 4 10 of 12, one of 5 at T 8 34 of 40; the down and
    up convs lose their pad taps too; the time MLP and FiLM's time half
    count once a step, FiLM's condition half once a sample. Held for the
    hier nets that do not downsample and for the bench planner that
    does."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.taps_inside(T, k, 1, k // 2, T) == same_pairs
    net = unet_from_config({"down_dims": down_dims, "kernel_size": k,
                            "downsample": downsample}, D, 2 * D)
    per_sample_step, per_step, per_sample = _hand_count(net, T)
    B, steps = 3, 5
    _, mm, _ = smoke.unet_flops_bytes(net, B, T, steps)
    assert mm == steps * (per_step + B * per_sample_step) + B * per_sample


# ---------------------------------------------------------------------------
# losses, gradients, one update
# ---------------------------------------------------------------------------

def _jax_loss_draws(rng, jagent, B, H, Bm=None, Hm=None):
    """The draws JAX ``_loss`` takes from ``rng``: the planner's over its
    strided targets, the IDM's over the (mixed) batch's chunks."""
    Bm, Hm = Bm or B, Hm or H
    rng, sub = jax.random.split(rng)
    t_rng, n_rng = jax.random.split(sub)
    n_targets = len(range(1, H, K))
    out = {"plan_t": np.array(jax.random.randint(
               t_rng, (B,), 0, jagent.planner_sched.num_steps)),
           "plan_noise": np.array(jax.random.normal(n_rng,
                                                    (B, n_targets, D)))}
    rng, sub = jax.random.split(rng)
    t_rng, n_rng = jax.random.split(sub)
    n = Bm * (Hm - 1) // K
    out["idm_t"] = np.array(jax.random.randint(
        t_rng, (n,), 0, jagent.idm_sched.num_steps))
    out["idm_noise"] = np.array(jax.random.normal(n_rng, (n, K, A)))
    return out


def _jax_prepared(jagent, batch):
    b = jcommon.prepare_batch(_jnp(batch), jagent.obs_normalization)
    b["obs"] = jagent._encode_obs(b["obs"])
    return b


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
    params = {"planner": jagent.planner_state.params,
              "idm": jagent.idm_state.params}
    grads, metrics = jax.jit(jax.grad(jagent._loss, has_aux=True),
                             static_argnums=(4, 5, 6))(
        params, _jax_prepared(jagent, batch), None, rng, True, True, 1)
    return batch, rng, grads, metrics


def test_losses_match_jax(pair, jax_grads):
    """The strided plan loss (targets ``obs_emb[:, 1::4]``), the chunk IDM
    loss on (s, s') pairs 4 apart, their sum and the batch gauges."""
    cfg, jagent = pair
    batch, rng, _, want = jax_grads
    agent = _bridged(jagent, cfg)
    got = agent.get_metrics(_torch_batch(batch),
                            draws=_jax_loss_draws(rng, jagent, 3, 9))
    assert set(got) == set(want)
    _close(got, want)
    assert agent._plan_target(torch.zeros(3, 9, D)).shape == (3, P, D)
    assert agent._idm_target(torch.zeros(3, 9, A)).shape == (6, K, A)


def test_gradients_match_jax(pair, jax_grads):
    """JAX's gradient pytree through the bridge's loader, for the planner
    and the chunk IDM, and the global norm."""
    cfg, jagent = pair
    batch, rng, grads, _ = jax_grads
    agent = _bridged(jagent, cfg)
    metrics = agent.backward(_torch_batch(batch), True, True,
                             draws=_jax_loss_draws(rng, jagent, 3, 9))
    np.testing.assert_allclose(float(metrics["g_norm"]),
                               float(jstate.global_norm(grads)), rtol=1e-5)
    nets = {"planner": (cfg["planner"], D, D),
            "idm": (cfg["idm_net"], A, 2 * D)}
    for name, (net_cfg, din, dc) in nets.items():
        want = bridge.load_unet1d(unet_from_config(net_cfg, din, dc),
                                  _np(grads[name]))
        scale = max(float(w.detach().abs().max()) for w in want.parameters())
        for (pname, w), p in zip(want.named_parameters(),
                                 getattr(agent, name).parameters()):
            np.testing.assert_allclose(p.grad.numpy(), w.detach().numpy(),
                                       atol=1e-5 * scale, rtol=0,
                                       err_msg=f"{name}.{pname}")


def test_one_update_matches_jax(pair):
    """One ``update`` at step 0: the metrics, and each net's weights and
    EMA weights (decay 0.5) after the step. Where a gradient is below 1e-7
    Adam's step turns on its rounding (m / (sqrt(v) + eps) with g near
    eps), so there the test holds Adam's bound: a move of at most the
    learning rate (its share of it for the EMA copy)."""
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    batch = _batch(seed=3)
    rng = jax.random.PRNGKey(4)
    draws = _jax_loss_draws(rng, jagent, 3, 9)
    probe = _bridged(jagent, cfg)
    probe.backward(_torch_batch(batch), True, True, draws=draws)
    tiny = {name: [p.grad.abs() < 1e-7 for p in getattr(probe, name)
                   .parameters()] for name in ("planner", "idm")}
    before = {name: [p.detach().clone() for p in getattr(agent, name)
                     .parameters()] for name in ("planner", "idm")}
    new, want = jagent.update(_jnp(batch), rng, 0)
    got = agent.update(_torch_batch(batch), 0, draws=draws)
    _close(got, want)
    assert agent.planner_state.step == agent.idm_state.step == 1
    lr = float(want["planner_lr"])
    moved = _bridged(new, cfg)
    for name in ("planner", "idm"):
        for mine, theirs, share in (
                (getattr(agent, name), getattr(moved, name), 1.0),
                (getattr(agent, f"{name}_state").ema,
                 getattr(moved, f"{name}_state").ema, 0.5)):
            for i, ((pname, p), q) in enumerate(zip(mine.named_parameters(),
                                                    theirs.parameters())):
                p, q, small = p.detach(), q.detach(), tiny[name][i]
                np.testing.assert_allclose(p[~small].numpy(),
                                           q[~small].numpy(), atol=1e-5,
                                           rtol=0, err_msg=f"{name}.{pname}")
                step = (p - before[name][i])[small].abs()
                assert not step.numel() or float(step.max()) <= (
                    share * lr * 1.001), f"{name}.{pname}"


def test_fifty_updates_match_jax():
    """50 ``update`` steps at the recipe's schedule (lr 3e-4 for both nets,
    warm-up 200, decay over 15000) with an EMA of decay 0.5 (the recipe's
    0.0 makes the EMA a copy), each step on its own batch with JAX's draws
    handed in. Every step's losses within 1e-4 relative of JAX's (the
    weights they are taken at drift by fp32 rounding); after the 50th step
    each net's weights and EMA weights within 1e-4. An element whose
    gradient fell below 1e-7 at some step, where Adam's step turns on its
    rounding (as in ``test_one_update_matches_jax``), is held to Adam's
    bound: a move of at most the sum of the learning rates so far."""
    cfg = _config(lr=3e-4, end_lr=1e-6, idm_lr=3e-4, idm_end_lr=1e-6,
                  warmup_steps=200, decay_steps=15000, ema_decay=0.5)
    jagent = _jax_agent(cfg)
    agent = _bridged(jagent, cfg)
    nets = ("planner", "idm")
    start = {n: [p.detach().clone() for p in getattr(agent, n).parameters()]
             for n in nets}
    tiny = {n: [torch.zeros_like(p, dtype=torch.bool)
                for p in getattr(agent, n).parameters()] for n in nets}
    lr_sum, worst = 0.0, 0.0
    for t in range(50):
        batch, rng = _batch(seed=100 + t), jax.random.PRNGKey(200 + t)
        draws = _jax_loss_draws(rng, jagent, 3, 9)
        got = agent.backward(_torch_batch(batch), True, True, draws=draws)
        for n in nets:
            for mask, p in zip(tiny[n], getattr(agent, n).parameters()):
                mask |= p.grad.abs() < 1e-7
        got.update(agent.apply_gradients(True, True))
        jagent, want = jagent.update(_jnp(batch), rng, t)
        for k in ("plan_loss", "idm_loss"):
            rel = abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
            worst = max(worst, rel)
            assert rel <= 1e-4, (t, k, float(got[k]), float(want[k]))
        lr_sum += float(want["planner_lr"])
    assert agent.planner_state.step == agent.idm_state.step == 50
    assert 0.0 < lr_sum < 50 * 3e-4 * 50 / 200
    moved = _bridged(jagent, cfg)
    for n in nets:
        for mine, theirs in ((getattr(agent, n), getattr(moved, n)),
                             (getattr(agent, f"{n}_state").ema,
                              getattr(moved, f"{n}_state").ema)):
            for i, ((pname, p), q) in enumerate(zip(mine.named_parameters(),
                                                    theirs.parameters())):
                p, q, small = p.detach(), q.detach(), tiny[n][i]
                np.testing.assert_allclose(p[~small].numpy(),
                                           q[~small].numpy(), atol=1e-4,
                                           rtol=0, err_msg=f"{n}.{pname}")
                step = (p - start[n][i])[small].abs()
                assert not step.numel() or float(step.max()) <= (
                    lr_sum * 1.001), f"{n}.{pname}"
    print(f"50 steps: worst loss gap {worst:.2e} relative")


def test_mixed_losses_match_jax(pair):
    """``update_mixed``'s loss: the IDM's chunks from a mixed batch of
    another size, the planner's targets from the expert batch."""
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    batch, mixed = _batch(seed=5), _batch(B=2, seed=6)
    rng = jax.random.PRNGKey(7)
    params = {"planner": jagent.planner_state.params,
              "idm": jagent.idm_state.params}
    _, want = jax.jit(jagent._loss, static_argnums=(4, 5, 6))(
        params, _jax_prepared(jagent, batch), _jax_prepared(jagent, mixed),
        rng, True, True, 1)
    with torch.no_grad():
        _, got = agent._loss(
            agent._prepare_train_batch(_torch_batch(batch)), True, True,
            draws=_jax_loss_draws(rng, jagent, 3, 9, 2, 9),
            mixed_batch=agent._prepare_train_batch(_torch_batch(mixed)))
    _close(got, want)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _decision_draws(rng, B, n_chunks):
    """JAX ``_sample_fast_step``'s and ``_sample_viz_step``'s initial
    samples: the planner's from a split of the first key, the chunk IDM's
    from a split of the second (``normal(split(key)[1])`` in both)."""
    rng, plan_rng = jax.random.split(rng)
    rng, idm_rng = jax.random.split(rng)
    first = lambda k, shape: np.array(jax.random.normal(
        jax.random.split(k)[1], shape))
    return {"planner": first(plan_rng, (B, P, D)),
            "idm": first(idm_rng, (B * n_chunks, K, A))}


def test_sample_fast_matches_jax_scan(pair):
    """A decision on the current latent: 2 strided latents planned, both
    kept (``pred_plan[:, :action_horizon]``), a chunk of 4 decoded toward
    each → 8 actions, against JAX's scans (2e-4)."""
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    obs = _window(_batch(B=4, seed=8), 1)
    rng = jax.random.PRNGKey(9)
    want = jagent.sample_fast(_jnp(obs), rng)
    got = agent.sample_fast(_torch_batch(obs), draws=_decision_draws(rng, 4, P))
    assert got.shape == want.shape == (4, P * K, A)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


def test_sample_action_matches_jax(pair):
    """The offline decode: a chunk between each two *consecutive* latents
    of a 9-step window → 32 actions (2e-4)."""
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    batch = _batch(B=2, seed=10)
    rng = jax.random.PRNGKey(11)
    want = jagent.sample_action(_jnp(batch), rng)
    x = np.array(jax.random.normal(jax.random.split(rng)[1], (16, K, A)))
    got = agent.sample_action(_torch_batch(batch), draws={"idm": x})
    assert got.shape == want.shape == (2, 8 * K, A)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


def test_sample_plan_stats_matches_jax(pair):
    """``LDPAgent``'s statistics: the planner plans at the window's length
    (8) against the consecutive future latents (1e-4 relative)."""
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    batch = _batch(seed=12)
    rng = jax.random.PRNGKey(13)
    want = jagent.sample_plan_stats(_jnp(batch), rng)
    x = np.array(jax.random.normal(jax.random.split(rng)[1], (3, 8, D)))
    got = agent.sample_plan_stats(_torch_batch(batch), draws={"planner": x})
    _close(got, want, rtol=1e-4)


@pytest.mark.parametrize("H", [1, 1 + P])
def test_sample_viz_matches_jax(pair, H):
    """Actions (2e-4), the plan (2e-4), its frames decoded and repeated
    ``idm_horizon`` times (1e-4) and, for a window of ``obs_horizon + P``
    steps, ``plan_mse`` (1e-4 relative); a longer window raises (JAX fails
    to broadcast there)."""
    cfg, jagent = pair
    agent = _bridged(jagent, cfg)
    obs = _window(_batch(B=2, seed=14), H)
    rng = jax.random.PRNGKey(15)
    want_a, want = jagent.sample_viz(_jnp(obs), rng)
    got_a, got = agent.sample_viz(_torch_batch(obs),
                                  draws=_decision_draws(rng, 2, P))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(got["plan"].numpy(), np.asarray(want["plan"]),
                               atol=2e-4, rtol=0)
    assert got["plan_viz"].shape == want["plan_viz"].shape == (
        2, P * K, 64, 64, 3)
    np.testing.assert_allclose(got["plan_viz"].numpy(),
                               np.asarray(want["plan_viz"]), atol=1e-4, rtol=0)
    assert set(got) == set(want)
    if H > 1:
        _close({"plan_mse": got["plan_mse"]}, {"plan_mse": want["plan_mse"]},
               rtol=1e-4)
    else:
        with pytest.raises(ValueError, match="obs_horizon"):
            agent.sample_viz(_torch_batch(_window(_batch(B=2), 9)))


# ---------------------------------------------------------------------------
# the agent's own bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change,reason", [
    # fp32 weights, once refused, run through kernel B's fp32 instances
    (dict(fused_dtype="float32"), None),
    (dict(fused_dtype="float64"), "float32 or bfloat16"),
    (dict(planner={**configs.LIFT_LDP_HIER_AGENT["planner"],
                   "downsample": True}), "not divisible"),
])
def test_kernel_refusals(change, reason):
    """What the JAX agent hands to its XLA scan, the port refuses on the
    card with the reason, and what kernel B now takes it accepts (the same
    check runs here on a CPU agent)."""
    agent = LDPHierAgent.create(_config(**change), configs.SHAPE_META,
                                device="cpu")
    if reason is None:
        agent._check_kernels()
        return
    with pytest.raises(ValueError, match=reason):
        agent._check_kernels()


@pytest.mark.parametrize("change", [dict(planner_inference_steps=None),
                                    dict(idm_inference_steps=50)])
def test_kernel_check_accepts_ddpm(change):
    """DDPM for either net (``ldp_hier_agent.yaml``'s nulls, or steps not
    below the 50 trained), once refused as "DDIM only", runs through
    kernel B with per-step noise: the check accepts it and the net's table
    is the 50-step ancestral one."""
    agent = LDPHierAgent.create(_config(**change), configs.SHAPE_META,
                                device="cpu")
    agent._check_kernels()
    (name, steps), = change.items()
    net = name.removesuffix("_inference_steps")
    ts, coefs = agent._table(getattr(agent, f"{net}_sched"), steps)
    assert len(ts) == 50 and bool(coefs[:-1, 4].gt(0).all())


def test_kernel_check_covers_the_planner_at_the_windows_length():
    """The planner plans P = 2 latents a decision but the window's 8 in
    ``sample_plan_stats``. A planner that does not downsample keeps every
    level at the full length, so its shared memory grows with it. Where no
    tile fits whole, kernel B's wide mode moves the fp32 buffers and the
    skips to global memory: [512,1024,2048] fits that way at T 8. A planner
    [1024,2048,4096], whose widest concat's bf16 operands alone outgrow a
    block at T 8, once refused, moves those operands to global memory too,
    so the check passes; a length past the 256 rows a bf16 instance holds,
    once refused, plans too (one sample a block, its GEMMs walking their
    rows in groups). Its shapes are enough: the nets are built on the meta
    device."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as kunet)
    agent = LDPHierAgent.create(_config(), configs.SHAPE_META, device="cpu")
    with torch.device("meta"):
        wide = unet_from_config(
            {**configs.LIFT_LDP_HIER_AGENT["planner"],
             "down_dims": [512, 1024, 2048]}, D, D)
        agent.planner = unet_from_config(
            {**configs.LIFT_LDP_HIER_AGENT["planner"],
             "down_dims": [1024, 2048, 4096]}, D, D)
    assert kunet.choose_tile(wide, 8)[1]["wide"]
    kunet.choose_tile(agent.planner, P)
    agent._check_kernels()
    assert kunet.choose_tile(agent.planner, 8)[1]["operands_global"]
    kunet.check_supported(agent.planner, 264)
    nb, prog = kunet.choose_tile(agent.planner, 264)
    assert nb == 1 and prog["operands_global"]
    assert 264 > kunet.row_group(prog["wide"])


def test_the_recipe_passes_the_kernel_check_and_refuses_what_it_must():
    LDPHierAgent.create(_config(), configs.SHAPE_META,
                        device="cpu")._check_kernels()
    # x0 prediction runs through kernel B's coefficient table (cx = 0)
    LDPHierAgent.create(_config(idm_prediction_type="sample"),
                        configs.SHAPE_META, device="cpu")._check_kernels()
    with pytest.raises(ValueError, match="multiple of idm_horizon"):
        LDPHierAgent.create(_config(idm_horizon=3), configs.SHAPE_META,
                            device="cpu")
    agent = LDPHierAgent.create(_config(), configs.SHAPE_META, device="cpu")
    with pytest.raises(NotImplementedError, match="chunks"):
        agent.sample_action_from_plan(_torch_batch(_window(_batch(), 1)),
                                      torch.zeros(3, 1, D))


def test_packs_are_picked_by_net_and_dropped_by_updates():
    """Both U-Nets are packed for kernel B (never the chunk IDM with kernel
    A's packer); an update drops the packs (a sentinel stands for one
    here, on the CPU, where the kernels are not packed)."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as kunet)
    agent = LDPHierAgent.create(_config(), configs.SHAPE_META, device="cpu")
    agent.device = torch.device("cuda")     # only for _packed's branch
    try:
        packed = mock.Mock(to=lambda device: "packed")
        with mock.patch.object(kunet, "pack_params",
                               return_value=packed) as pk:
            agent._packed("idm")
            agent._packed("planner")
        assert [c.args[0] for c in pk.call_args_list] == [
            agent.idm_state.ema, agent.planner_state.ema]
        assert agent._packs == {"idm": "packed", "planner": "packed"}
    finally:
        agent.device = torch.device("cpu")
    agent._packs.update(planner="stale", idm="stale")
    agent.update(_torch_batch(_batch()), 0, torch.Generator().manual_seed(0))
    assert agent._packs == {}


def test_checkpoint_round_trip_is_exact(tmp_path):
    """The full state after two steps restores bit for bit onto an agent
    of another seed, and one more step from each copy agrees exactly; a
    params snapshot rebinds the chunk IDM alone."""
    cfg = _config(grad_clip=1.0)
    agent = LDPHierAgent.create(cfg, configs.SHAPE_META, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    for step in range(2):
        agent.update(_torch_batch(_batch(seed=step)), step, g)
    ck = Checkpointer(tmp_path)
    path = ck.save_state(2, agent, config={"a": 1})
    other = LDPHierAgent.create(cfg, configs.SHAPE_META, seed=1, device="cpu")
    ck.restore_state(path, other)
    a, b = agent.state_dict(), other.state_dict()
    for part in ("planner", "idm"):
        assert a[part]["step"] == b[part]["step"] == 2
        for key in ("params", "ema"):
            for k, v in a[part][key].items():
                assert torch.equal(v, b[part][key][k]), (part, key, k)
        for key in ("mu", "nu"):
            for x, y in zip(a[part][key], b[part][key]):
                assert torch.equal(x, y)
    batch = _torch_batch(_batch(seed=9))
    m1 = agent.update(batch, 2, torch.Generator().manual_seed(1))
    m2 = other.update(batch, 2, torch.Generator().manual_seed(1))
    assert float(m1["loss"]) == float(m2["loss"])
    for p, q in zip(agent.idm.parameters(), other.idm.parameters()):
        assert torch.equal(p, q)
    ck.save_params(3, agent.get_params())
    fresh = LDPHierAgent.create(cfg, configs.SHAPE_META, seed=2, device="cpu")
    apply_params_snapshot(fresh, ck.restore_raw(ck.list_checkpoints()[-1]),
                          restore_keys=["idm_params"])
    for p, q in zip(fresh.idm.parameters(), agent.idm.parameters()):
        assert torch.equal(p, q)
    assert not torch.equal(next(fresh.planner.parameters()),
                           next(agent.planner.parameters()))


def test_workspace_trains_ldp_hier_on_a_scripted_kinematic_collection(
        tmp_path):
    """``Workspace`` builds ``ldp_hier`` by name: scripted demos on the
    kinematic ``LiftEnv`` (rendered), latents from the agent's VAE, 20
    steps of ``Workspace.run`` (ending with its snapshot and eval, a closed
    loop included): both losses fall, the eval's metrics are finite, and
    ``resume`` picks up the saved state."""
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.data.latents import encode_latents
    from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace

    env = LiftEnv(episode_len=40)
    meta = {"env_name": "LiftEnv", "env_kwargs": {"episode_len": 40}}
    welded = {s: weld_collection(
        engine.run_scripted_collection(env, n, seed, device="cpu"),
        env_meta=meta, successful_only=True) for s, n, seed in
        (("train", 6, 0), ("eval", 3, 1))}
    cfg = configs.lift_ldp_hier_train_config()
    cfg["agent"].update(vae=SMALL_VAE, lr=3e-3, idm_lr=3e-3, warmup_steps=5,
                        decay_steps=100, planner_inference_steps=5,
                        idm_inference_steps=5, vae_pretrain_path=None)
    cfg.update(n_grad_steps=20, batch_size=16, log_every=10, save_every=10,
               eval_every=0, n_eval_episodes=2, resume=False)
    cfg["data"].update(batch_size=16, eval_n_episode_overfit=None)
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=welded["train"], eval=welded["eval"],
                       device="cpu")
    ws = Workspace(cfg, tmp_path, data=data, device="cpu")
    ws.init_agent()
    assert isinstance(ws.agent, LDPHierAgent)
    for w in welded.values():
        encode_latents(w, ws.agent.vae, ["agentview_image"])
    ws.run()
    curve = ws.loss_curve()
    for k in ("plan_loss", "idm_loss"):
        assert torch.isfinite(curve[k]).all()
        assert curve[k][-5:].mean() < curve[k][:5].mean(), k
    ev = ws.last_eval
    assert 0.0 <= ev["success"] <= 1.0 and ev["n_episodes"] == 2
    assert all(np.isfinite(v) for v in ev.values())
    assert [p.name for p in ws.ckpt.list_states()] == ["10.state", "20.state"]
    again = Workspace({**cfg, "resume": True}, tmp_path, data=data,
                      device="cpu")
    again.init_agent()
    assert again.step == 20
    for p, q in zip(again.agent.idm.parameters(), ws.agent.idm.parameters()):
        assert torch.equal(p, q)
