"""Kernel B's DDPM route and its wide mode, and the port's beta schedules,
against the JAX package.

Beta tables: the cosine schedule is computed in Python floats on both sides
and must agree bit for bit; the linear ones are rounded once from float64
in the port and at every float32 operation in JAX (its ``linspace``, then
the square of ``scaled_linear``), so a linear entry is held to one ulp and
a scaled-linear one to four (JAX's root is up to an ulp off, its square
doubles that and rounds again; measured: at most 4). The DDPM coefficient tables on
them get the bar of ``tests/test_torch_diffusion.py``'s tables (atol 1e-6,
rtol 1e-5: XLA's cumprod multiplies in another order). Samplers get JAX's
draws (the initial sample and the per-step noise of ``sample_ddpm``) and
are held at atol 2e-4, the JAX package's own kernel-vs-scan bar
(``tests/test_pallas_sampler.py``), as the DDPM case of
``tests/test_torch_diffusion.py`` is. The NumPy transcription of the
kernel's data path runs with fp64 sums against the fp64-sum rounding twin,
as ``test_unet_kernel_program_matches_twin`` does: atol 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.models.nets.unet1d import (
    ConditionalUnet1D as JaxUnet)
from latent_diffusion_planning_tpu.ops import diffusion as jdlib
from latent_diffusion_planning_tpu_torch import bridge
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    ConditionalUnet1D)
from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
from latent_diffusion_planning_tpu_torch.ops.kernels import (
    diffusion_unet1d as kunet)
from test_torch_diffusion import _run_unet_program
from torch_thread import one_torch_thread  # noqa: F401

SAMPLER_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ddpm_draws(key, shape, n_steps):
    """What ``jdlib.sample_ddpm`` draws from ``key``: the initial sample
    from ``split(key)[1]``, then one normal per step from
    ``split(split(key)[0], n_steps)``."""
    rng, init_rng = jax.random.split(key)
    x0 = jax.random.normal(init_rng, shape, jnp.float32)
    noise = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(
        jax.random.split(rng, n_steps))
    return np.array(x0), np.array(noise)


# ---------------------------------------------------------------------------
# beta schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["squaredcos_cap_v2", "linear",
                                      "scaled_linear"])
@pytest.mark.parametrize("n", [12, 100, 1000])
def test_beta_schedules_and_ddpm_tables_match_jax(schedule, n):
    mine = dlib.make_betas(n, schedule).numpy()
    ref = np.asarray(jdlib.make_betas(n, schedule))
    assert mine.dtype == ref.dtype == np.float32 and mine.shape == (n,)
    ulps = {"squaredcos_cap_v2": 0, "linear": 1, "scaled_linear": 4}[schedule]
    if ulps:
        np.testing.assert_array_max_ulp(mine, ref, maxulp=ulps)
    else:
        np.testing.assert_array_equal(mine, ref)
    # other ends, as the JAX package's create takes them
    np.testing.assert_array_max_ulp(
        dlib.make_betas(n, schedule, 0.00085, 0.012).numpy(),
        np.asarray(jdlib.make_betas(n, schedule, 0.00085, 0.012)),
        maxulp=ulps)
    with pytest.raises(ValueError, match="unknown beta schedule"):
        dlib.make_betas(n, "sigmoid")


@pytest.mark.parametrize("schedule", ["squaredcos_cap_v2", "linear",
                                      "scaled_linear"])
@pytest.mark.parametrize("n", [12, 50, 100])
def test_ddpm_tables_on_each_schedule_match_jax(schedule, n):
    """The DDPM tables at the step counts the repo's configs train with
    (50, 100). Over 1000 steps the two cumprods' orders part by enough
    ulps near abar = 0 for c1 = 1/sqrt(abar) to pass rtol 1e-5. The linear
    schedules' first betas are small (1e-4), so near t = 0 the tables
    divide by 1 - abar_t, a difference of numbers near 1: an ulp of abar
    from the other multiplication order (6e-8) is 1e-4 of 1 - abar_5 at
    50 scaled-linear steps, where m_x0 differs by 3.3e-5 even when both
    sides start from the same betas. Those are held at rtol 5e-5."""
    ts = dlib.DiffusionSchedule.create(n, schedule)
    js = jdlib.DiffusionSchedule.create(n, schedule)
    got, want = dlib.ddpm_coef_table(ts), jdlib.ddpm_coef_table(js)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    rtol = 1e-5 if schedule == "squaredcos_cap_v2" else 5e-5
    np.testing.assert_allclose(got[1][:, :5].numpy(), np.asarray(want[1]),
                               atol=1e-6, rtol=rtol)


# ---------------------------------------------------------------------------
# kernel B's plain twin with per-step noise against JAX's sample_ddpm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("downsample,T,k,schedule", [
    (True, 8, 5, "squaredcos_cap_v2"),
    (False, 4, 3, "squaredcos_cap_v2"),
    (False, 6, 5, "linear")])
def test_unet_twin_ddpm_matches_jax_sample_ddpm(downsample, T, k, schedule):
    """The wrapper's CPU route (the twin) with JAX's per-step noise handed
    in, over the same Flax U-Net's weights, against the JAX XLA scan: a net
    that downsamples and two that do not (LDP-hier's topology)."""
    B, D, Dc, dd, S = 3, 5, 6, (8, 16, 32), 20
    net = JaxUnet(input_dim=D, global_cond_dim=Dc,
                  diffusion_step_embed_dim=16, down_dims=dd, kernel_size=k,
                  n_groups=4, downsample=downsample)
    g = np.random.default_rng(4).normal(size=(B, Dc)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), np.zeros((2, T, D)),
                      np.zeros((2,), np.int32), np.zeros((2, Dc)))["params"]
    mine = bridge.unet1d_from_flax(_np(params), input_dim=D,
                                   global_cond_dim=Dc,
                                   diffusion_step_embed_dim=16, down_dims=dd,
                                   kernel_size=k, n_groups=4,
                                   downsample=downsample)
    sched_j = jdlib.DiffusionSchedule.create(S, schedule)
    sched_t = dlib.DiffusionSchedule.create(S, schedule)
    key = jax.random.PRNGKey(11)
    ref = jdlib.sample_ddpm(sched_j,
                            lambda x, t: net.apply({"params": params}, x, t, g),
                            key, (B, T, D))
    x0, noise = _ddpm_draws(key, (B, T, D), S)
    ts, coefs = dlib.ddpm_coef_table(sched_t)
    twin = kunet.fused_unet1d_ddim_sample(
        mine, torch.from_numpy(g), torch.from_numpy(x0), ts, coefs,
        torch.from_numpy(noise))
    np.testing.assert_allclose(twin.numpy(), np.asarray(ref),
                               atol=SAMPLER_ATOL, rtol=0)
    # the noise is what makes it DDPM: without it the result moves
    quiet = kunet.fused_unet1d_ddim_sample(
        mine, torch.from_numpy(g), torch.from_numpy(x0), ts, coefs)
    assert np.abs(quiet.numpy() - np.asarray(ref)).max() > 1e-2


# ---------------------------------------------------------------------------
# the wide mode: LDP-hier's default planner at the window's 16 latents
# ---------------------------------------------------------------------------

def _meta_unet(D, Dc, dd, k, down):
    with torch.device("meta"):
        return ConditionalUnet1D(D, Dc, 256, dd, k, 8, down)


def test_choose_tile_takes_ldp_hier_default_planner_at_16_rows_wide():
    """``ldp_hier_agent.yaml``'s planner [256,512,1024] k 5, downsample
    false, obs_dim 25, at T 16: no tile fits shared memory whole (its fp32
    buffers, its 2048-wide concat's operands and its full-length skips
    need 362 KB at one sample a block), so the kernel takes it in wide
    mode, one sample a block, with the fp32 buffers and skips in a global
    scratch; the records are those of the ordinary program."""
    net = _meta_unet(25, 25, (256, 512, 1024), 5, False)
    whole = kunet.build_program(net, 16, 1)
    assert whole["smem_bytes"] > kunet.SMEM_LIMIT
    nb, prog = kunet.choose_tile(net, 16, 256)
    assert nb == 1 and prog["wide"] and prog["smem_bytes"] <= kunet.SMEM_LIMIT
    assert prog["records"] == whole["records"]
    assert (prog["max32"], prog["maxb"], prog["skip_total"]) == (
        whole["max32"], whole["maxb"], whole["skip_total"])
    # what moved out: X32 and Y32 (16 × 1032 floats each) and the skips
    # (16 × (520 + 1032) bf16), 16-byte rows of global memory a block
    assert prog["max32"] == 16 * kunet.ld32(1024)
    assert prog["skip_total"] == 16 * (kunet.ldb(512) + kunet.ldb(1024))
    assert prog["scratch_bytes"] == kunet._up(
        8 * prog["max32"] + 2 * prog["skip_total"], 256)
    assert whole["smem_bytes"] - prog["smem_bytes"] == (
        (whole["stages"] - prog["stages"]) * kunet.STAGE_BYTES
        + 8 * prog["max32"] + 2 * prog["skip_total"])
    info = kunet.kernel_info(net, 256, 16, 100)
    assert info["wide"] and info["grid"] == 256
    assert info["scratch_bytes"] == 256 * prog["scratch_bytes"]
    # the agent's other calls keep the ordinary program: P = 4 latents a
    # decision and the chunk IDM [256,512] k 3 at 4 actions
    assert not kunet.choose_tile(net, 4, 256)[1]["wide"]
    idm = _meta_unet(7, 50, (256, 512), 3, False)
    assert not kunet.choose_tile(idm, 4, 1024)[1]["wide"]


@pytest.mark.parametrize("D,Dc,dd,k,down,T,B", [
    (25, 25, (256, 512, 1024), 5, True, 16, 256),     # LDP's planner
    (7, 25, (256, 512, 1024), 5, True, 16, 256),      # DPVAE's action U-Net
    (7, 1033, (256, 512, 1024), 5, True, 16, 256),    # DP's, 1033 wide
    (25, 25, (64, 128, 256), 5, True, 8, 1024),       # the bench planner
    (25, 25, (64, 128, 256), 5, False, 2, 1024)])     # the recipe's hier
def test_nets_that_fit_keep_their_tiles(D, Dc, dd, k, down, T, B):
    """Wide mode is taken only where no tile fits whole: every other net
    gets the tile it got before (the most samples that fit, then no more
    than leaves 64 blocks)."""
    net = _meta_unet(D, Dc, dd, k, down)
    nb, prog = kunet.choose_tile(net, T, B)
    assert not prog["wide"] and prog["scratch_bytes"] == 0
    fits = [n for n in kunet.NB_CHOICES if n * T <= kunet.MAX_ROWS
            and kunet.build_program(net, T, n)["smem_bytes"]
            <= kunet.SMEM_LIMIT]
    assert nb == next(n for n in fits if -(-B // n) >= min(64, B))


def test_what_wide_mode_cannot_hold_is_refused():
    """A net whose widest concat's bf16 operands alone outgrow a block, once
    refused, runs in the wide mode with its operands in global memory
    (staged through shared memory for ``ldmatrix``): [1024,2048,4096] at
    8 rows, 2 × 8 × 8200 bf16. The wide mode holds one sample of any
    length: [64,128,256] fits whole at 32 rows and runs one sample a block,
    wide, at 40; past 256 rows, once refused, too (its GEMMs walk their rows
    in groups of 256)."""
    net = _meta_unet(25, 25, (1024, 2048, 4096), 5, False)
    assert kunet.choose_tile(net, 2, 64)[0] >= 1
    nb, prog = kunet.choose_tile(net, 8, 64)
    assert nb == 1 and prog["wide"] and prog["operands_global"]
    narrow = _meta_unet(25, 25, (64, 128, 256), 5, False)
    assert not kunet.choose_tile(narrow, 32, 64)[1]["wide"]
    nb, prog = kunet.choose_tile(narrow, 40, 64)
    assert nb == 1 and prog["wide"]
    kunet.check_supported(narrow, 272)
    nb, prog = kunet.choose_tile(narrow, 272, 64)
    assert nb == 1 and prog["wide"] and 272 > kunet.row_group(True)


def test_kernel_info_reports_a_ddpm_call():
    """DDPM-100: the prologue runs a block per step and one per
    ``COND_ROWS`` samples, and FiLM's time half is a (100, film_ld) table;
    the main blocks stream the weights 100 times."""
    net = _meta_unet(25, 25, (256, 512, 1024), 5, True)
    info = kunet.kernel_info(net, 256, 16, 100)
    lay = kunet.layout(net)
    rows = kunet.COND_ROWS
    assert info["prologue_grid"] == 100 + -(-256 // rows)
    assert info["film_t_bytes"] == 4 * 100 * lay["film_ld"]
    assert info["weight_bytes_streamed"] >= (
        info["grid"] * 100 * info["weight_bytes_per_step_and_block"])


@pytest.mark.parametrize("dd,k,T,down,wide", [
    ((8, 16, 32), 5, 4, False, True),
    ((8, 16), 3, 4, False, False),
    ((8, 16, 32), 5, 8, True, False)])
def test_unet_kernel_program_matches_twin_with_noise(dd, k, T, down, wide):
    """Kernel B's record program, run by the NumPy transcription with
    DDPM's per-step noise (the kernel's update ``k2 x0 + k3 x + k4 noise``),
    in the wide mode's program too, computes what the rounding twin with
    the same noise computes (fp64 sums on both sides)."""
    B, D, Dc = 3, 5, 6
    net = kunet.rounding_twin(kunet.ConditionalUnet1D(
        D, Dc, 16, dd, k, 4, down, generator=torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(6)
    g = rng.normal(size=(B, Dc)).astype(np.float32)
    x0 = rng.normal(size=(B, T, D)).astype(np.float32)
    ts, coefs = dlib.ddpm_coef_table(dlib.DiffusionSchedule.create(10))
    noise = rng.normal(size=(10, B, T, D)).astype(np.float32)
    twin64 = copy.deepcopy(net).double()
    g64 = torch.from_numpy(g).double()
    with torch.no_grad():
        want = dlib.sample_with_coefs(
            lambda x, t: twin64(x, t, g64), torch.from_numpy(x0).double(), ts,
            coefs.double(), torch.from_numpy(noise).double(), 1.0)
    got = _run_unet_program(net, g.astype(np.float64), x0, ts, coefs, 1.0,
                            noise=noise, wide=wide)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-4, rtol=0)
    assert float(coefs[:-1, 4].min()) > 0 and float(coefs[-1, 4]) == 0
