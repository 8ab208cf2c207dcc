"""Kernels B and A for the ALOHA recipe: every prediction type through the
(T, 6) coefficient tables, against the JAX package's scan samplers.

The ALOHA recipe trains its planner to predict x0
(``agent.planner_prediction_type=sample``), which the JAX agent samples
with its XLA scan (``ops/diffusion.py`` ``ddim_step``/``ddpm_step`` over
``predict_x0``). The port runs it through the kernels' update rule
``x0 = clip(c1 (cx x - c2 y))``; on the CPU through their twins. Here the
twins (the kernels' update rule in plain PyTorch) take JAX's draws and are
held against JAX's scans at 2e-4 in fp32, the JAX package's own
kernel-vs-scan bar (``tests/test_pallas_sampler.py``). Tables: ε's first
five columns are JAX's (T, 5) ones bit for bit up to the cumprod's few ulps
(``tests/test_torch_diffusion.py``), and the x0 rule equals ``predict_x0``
for each prediction type at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.models.nets.mlp import MLPDiffusion
from latent_diffusion_planning_tpu.models.nets.unet1d import ConditionalUnet1D
from latent_diffusion_planning_tpu.ops import diffusion as jdlib
from latent_diffusion_planning_tpu_torch import bridge
from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
from latent_diffusion_planning_tpu_torch.ops.kernels import diffusion_mlp as kmlp
from latent_diffusion_planning_tpu_torch.ops.kernels import (
    diffusion_unet1d as kunet)
from torch_thread import one_torch_thread  # noqa: F401

SAMPLER_ATOL = 2e-4
KINDS = ["sample", "v_prediction"]


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_draws(key, shape, n_steps):
    """The initial sample and per-step noise jdlib's samplers draw."""
    rng, init_rng = jax.random.split(key)
    x0 = jax.random.normal(init_rng, shape, jnp.float32)
    noise = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(
        jax.random.split(rng, n_steps))
    return np.array(x0), np.array(noise)


def _scheds(kind, n=12):
    return (jdlib.DiffusionSchedule.create(n, "squaredcos_cap_v2",
                                           prediction_type=kind),
            dlib.DiffusionSchedule.create(n, "squaredcos_cap_v2",
                                          prediction_type=kind))


def _old_eps_table(sched, inf):
    """The ε table as the port made it before it took other prediction
    types: (T, 5) [c1, c2, m_x0, m_xt, s_var]."""
    ts = dlib.ddim_timesteps(sched.num_steps, inf)
    ts_prev = torch.cat([ts[1:], torch.full((1,), -1, dtype=torch.int64)])
    acp = sched.alphas_cumprod
    abar_t = acp[ts]
    abar_prev = torch.where(ts_prev >= 0, acp[ts_prev.clamp(min=0)],
                            torch.ones_like(abar_t))
    c1 = 1.0 / torch.sqrt(abar_t)
    c2 = torch.sqrt(1.0 - abar_t)
    sp = torch.sqrt(abar_prev)
    dp = torch.sqrt(torch.clamp(1.0 - abar_prev, min=0.0))
    return torch.stack([c1, c2, sp - dp * torch.sqrt(abar_t) / c2, dp / c2,
                        torch.zeros_like(c1)], -1).float()


@pytest.mark.parametrize("train,inf", [(50, 25), (100, 10), (12, 4)])
def test_epsilon_tables_keep_their_bits(train, inf):
    sched = dlib.DiffusionSchedule.create(train)
    ts, coefs = dlib.ddim_coef_table(sched, inf)
    assert coefs.shape == (inf, 6)
    assert torch.equal(coefs[:, :5], _old_eps_table(sched, inf))
    assert torch.equal(coefs[:, 5], torch.ones(inf))


@pytest.mark.parametrize("table", ["ddim", "ddpm"])
@pytest.mark.parametrize("kind", ["epsilon"] + KINDS)
def test_x0_rule_is_predict_x0(kind, table):
    """clip(c1 (cx x - c2 y)) is the schedule's ``predict_x0`` at every
    step, and the step columns do not depend on the prediction type."""
    sched = dlib.DiffusionSchedule.create(50, prediction_type=kind)
    ts, coefs = (dlib.ddim_coef_table(sched, 25) if table == "ddim"
                 else dlib.ddpm_coef_table(sched))
    eps_coefs = (dlib.ddim_coef_table(dlib.DiffusionSchedule.create(50), 25)
                 if table == "ddim" else
                 dlib.ddpm_coef_table(dlib.DiffusionSchedule.create(50)))[1]
    assert torch.equal(coefs[:, 2:5], eps_coefs[:, 2:5])
    g = torch.Generator().manual_seed(0)
    x = torch.randn(len(ts), 64, generator=g)
    y = torch.randn(len(ts), 64, generator=g)
    c = coefs[:, :, None]
    got = torch.clamp(c[:, 0] * (c[:, 5] * x - c[:, 1] * y), -1.0, 1.0)
    want = torch.stack([sched.predict_x0(y[i:i + 1], x[i:i + 1],
                                         ts[i:i + 1])[0]
                        for i in range(len(ts))])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def _idm(N=16, A=14, S=40):
    net = MLPDiffusion(out_dim=A, n_blocks=2, hidden_dim=32, time_dim=16)
    s = np.random.default_rng(3).normal(size=(N, S)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), s[:2], np.zeros((2, A)),
                      np.zeros((2, 1), np.int32))["params"]
    mine = bridge.mlp_diffusion_from_flax(_np(params), s_dim=S, out_dim=A,
                                          n_blocks=2, hidden_dim=32,
                                          time_dim=16)
    return net, params, mine, s


@pytest.mark.parametrize("mode", ["ddim", "ddpm"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_a_twin_matches_jax_scan(kind, mode):
    """Kernel A's twin (the IDM's reverse process, 14 actions as ALOHA's)
    with JAX's draws against ``jdlib.sample_ddim``/``sample_ddpm``."""
    net, params, mine, s = _idm()
    N, A = s.shape[0], 14
    sched_j, sched_t = _scheds(kind)
    key = jax.random.PRNGKey(42)
    denoise_j = lambda a, t: net.apply({"params": params}, s, a, t)
    if mode == "ddim":
        ref = jdlib.sample_ddim(sched_j, denoise_j, key, (N, A), 4)
        x0, _ = _jax_draws(key, (N, A), 4)
        ts, coefs = dlib.ddim_coef_table(sched_t, 4)
        noise = None
    else:
        ref = jdlib.sample_ddpm(sched_j, denoise_j, key, (N, A))
        x0, noise = _jax_draws(key, (N, A), 12)
        noise = torch.from_numpy(noise)
        ts, coefs = dlib.ddpm_coef_table(sched_t)
    twin = kmlp.fused_mlp_diffusion_sample(mine, torch.from_numpy(s),
                                           torch.from_numpy(x0), ts, coefs,
                                           noise)
    np.testing.assert_allclose(twin.numpy(), np.asarray(ref),
                               atol=SAMPLER_ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_b_twin_matches_jax_scan(kind):
    """Kernel B's twin (strided DDIM over the planner U-Net) with JAX's
    draws against ``jdlib.sample_ddim`` of the same prediction type."""
    B, T, D, Dc = 4, 8, 6, 6
    net = ConditionalUnet1D(input_dim=D, global_cond_dim=Dc,
                            diffusion_step_embed_dim=32, down_dims=(8, 16, 32),
                            kernel_size=5, n_groups=4)
    g = np.random.default_rng(4).normal(size=(B, Dc)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), np.zeros((2, T, D)),
                      np.zeros((2,), np.int32), np.zeros((2, Dc)))["params"]
    mine = bridge.unet1d_from_flax(_np(params), input_dim=D, global_cond_dim=Dc,
                                   diffusion_step_embed_dim=32,
                                   down_dims=(8, 16, 32), n_groups=4)
    sched_j, sched_t = _scheds(kind)
    key = jax.random.PRNGKey(7)
    ref = jdlib.sample_ddim(sched_j,
                            lambda x, t: net.apply({"params": params}, x, t, g),
                            key, (B, T, D), 4)
    x0, _ = _jax_draws(key, (B, T, D), 4)
    ts, coefs = dlib.ddim_coef_table(sched_t, 4)
    twin = kunet.fused_unet1d_ddim_sample(mine, torch.from_numpy(g),
                                          torch.from_numpy(x0), ts, coefs)
    np.testing.assert_allclose(twin.numpy(), np.asarray(ref),
                               atol=SAMPLER_ATOL, rtol=0)


def test_kernel_a_fits_wide_conditions():
    """The phys4 IDM (hidden 256, 3 blocks, A = 14, S = 540: two 270-wide
    observations) runs 32 rows a block with a five-stage ring; the bench
    IDM keeps 64 rows; past what 32 rows allow (S = 4000) the row is walked
    in chunks at 64 rows; a hidden width past 1024 still raises with the
    reason."""
    from latent_diffusion_planning_tpu_torch.models.nets.mlp import (
        MLPDiffusion as TorchMLP)
    with torch.device("meta"):
        wide = TorchMLP(s_dim=540, out_dim=14, n_blocks=3, hidden_dim=256)
        bench = TorchMLP(s_dim=2 * 25, out_dim=7, n_blocks=3, hidden_dim=256)
        huge = TorchMLP(s_dim=4000, out_dim=14, n_blocks=3, hidden_dim=256)
    info = kmlp.kernel_info(wide, 256, 14, 540, 25)
    assert info["rows_per_block"] == 32 and info["ring_stages"] == 5
    assert info["grid"] == 8 and info["smem_bytes"] <= kmlp.SMEM_LIMIT
    main = kmlp.kernel_info(bench, 8192, 7, 50, 10)
    assert main["rows_per_block"] == 64 and main["grid"] == 128
    chunked = kmlp.kernel_info(huge, 64, 14, 4000, 25)
    assert chunked["chunked"] and chunked["rows_per_block"] == 64
    assert chunked["smem_bytes"] <= kmlp.SMEM_LIMIT
    assert not main["chunked"] and not info["chunked"]
    with torch.device("meta"):
        too_wide = TorchMLP(s_dim=540, out_dim=14, n_blocks=3,
                            hidden_dim=kmlp.MAX_HIDDEN + 8)
    with pytest.raises(ValueError, match="hidden_dim up to"):
        kmlp.kernel_info(too_wide, 64, 14, 540, 25)
