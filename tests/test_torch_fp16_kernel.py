"""Kernel B with fp16 weights (``fused_dtype: float16``) on the CPU: its
rounding twin against the JAX Pallas kernel with ``dtype=float16`` in
interpret mode, the LDP agent against the JAX agent, and the fp16 packing.

The fp16 kernel rounds where the JAX kernel rounds (``rounding_twin(net,
torch.float16)``: every conv and dense operand, GroupNorm's statistics from
x and x * x, FiLM's scale and bias and the downsample's output at widths
that are not a multiple of 128, not the final 1x1 conv's input). Such a
function is discontinuous: XLA's fp32 sums and torch's differ in order by
about 1e-6 of a value, so now and then one operand rounds to the other
side of an fp16 half-ulp (2.4e-4 of it) in one and not the other, and that
one flip moves the sample by up to 1e-3 after DDIM-2 of a 12-step cosine
schedule (the twin with fp32 sums against itself with fp64 sums parts by
as much). So, as the card's checks of the bf16 kernel do, the bar of 1e-4
is held on what flips cannot move: the mean error over the pooled samples,
and the share of elements within 1e-4, each of which the unrounded fp32
net misses (at draws no flip touches the twin holds JAX to 1e-6).
"""

import copy
import importlib.util
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ldp as tl
from latent_diffusion_planning_tpu.models.nets.unet1d import (
    ConditionalUnet1D as JaxUnet)
from latent_diffusion_planning_tpu.ops import diffusion as jdlib
from latent_diffusion_planning_tpu.ops.pallas.diffusion_unet1d import (
    fused_unet1d_ddim_sample as jax_fused_unet)
from latent_diffusion_planning_tpu_torch import bridge
from latent_diffusion_planning_tpu_torch.models.agents import common
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    ConditionalUnet1D)
from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
from latent_diffusion_planning_tpu_torch.ops.kernels import (
    diffusion_unet1d as kunet)
from torch_thread import one_torch_thread  # noqa: F401

F16 = torch.float16
BAR = 1e-4
EXACT = 1e-6    # a sample no rounding flip touches
DD, T, D, DC, DSED, G = (8, 16, 32), 8, 5, 5, 32, 4
# widths at which every JAX rounding point shows: an identity residual
# after the downsample reads its rounded output
DD_ALL = (8, 8, 16)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _exact_samples(got, want):
    """The samples on which ``got`` holds ``want`` within ``EXACT``."""
    err = np.abs(got - want).reshape(len(got), -1).max(1)
    return int((err <= EXACT).sum())


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _nets(dd):
    """A JAX U-Net at small widths ``dd``, its init, and the port's copy."""
    net = JaxUnet(input_dim=D, global_cond_dim=DC,
                  diffusion_step_embed_dim=DSED, down_dims=dd, kernel_size=5,
                  n_groups=G)
    params = net.init(jax.random.PRNGKey(0), np.zeros((2, T, D)),
                      np.zeros((2,), np.int32), np.zeros((2, DC)))["params"]
    params = jax.tree_util.tree_map(np.array, params)
    mine = bridge.unet1d_from_flax(params, input_dim=D, global_cond_dim=DC,
                                   diffusion_step_embed_dim=DSED,
                                   down_dims=dd, n_groups=G)
    return params, mine


@pytest.fixture(scope="module")
def unet():
    return _nets(DD)


def _both(params, mine, g, x0, twin):
    """JAX's fp16 kernel (interpret mode, one sample a tile) and ``twin``
    (the port's reverse process) on the same draws, DDIM-2 of 12."""
    ts_j, coefs_j = jdlib.ddim_coef_table(
        jdlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    want = np.asarray(jax_fused_unet(
        params, g, x0, ts_j, coefs_j, down_dims=tuple(mine.down_dims),
        diffusion_step_embed_dim=DSED, n_groups=G, dtype=jnp.float16,
        batch_tile=1, interpret=True))
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    got = [kunet.unet1d_ddim_sample_plain(t, torch.from_numpy(g),
                                          torch.from_numpy(x0), ts,
                                          coefs).numpy() for t in twin]
    return want, got


def test_fp16_twin_matches_jax_fp16_kernel(unet):
    """8 samples pooled: the fp16 rounding twin's mean error against JAX's
    fp16 kernel within 1e-4 and at least 80% of its elements within 1e-4;
    the fp32 net (no rounding) misses both. The samples no rounding flip
    touches (two of these 8) hold JAX within 1e-6."""
    params, mine = unet
    rng = np.random.default_rng(6)
    g = rng.normal(size=(8, DC)).astype(np.float32)
    x0 = rng.normal(size=(8, T, D)).astype(np.float32)
    want, (twin, net) = _both(params, mine, g, x0,
                              [kunet.rounding_twin(mine, F16), mine])
    err, err_net = np.abs(twin - want), np.abs(net - want)
    print(f"fp16 twin: mean {err.mean():.2e}, share within {BAR} "
          f"{(err <= BAR).mean():.3f}, max {err.max():.2e}, samples within "
          f"{EXACT} {_exact_samples(twin, want)}; fp32 net: mean "
          f"{err_net.mean():.2e}, share {(err_net <= BAR).mean():.3f}")
    assert err.mean() <= BAR and (err <= BAR).mean() >= 0.8
    assert _exact_samples(twin, want) >= 2
    assert err_net.mean() > BAR and (err_net <= BAR).mean() < 0.8


@pytest.fixture(scope="module")
def all_points():
    """The nets at ``DD_ALL``, where every rounding point shows."""
    return _nets(DD_ALL)


@pytest.fixture(scope="module")
def jax_all_points(all_points):
    """JAX's fp16 kernel on 16 samples of a net where every rounding point
    shows (``DD_ALL``), the draws, and the port's copy of the net."""
    params, mine = all_points
    rng = np.random.default_rng(8)
    g = rng.normal(size=(16, DC)).astype(np.float32)
    x0 = rng.normal(size=(16, T, D)).astype(np.float32)
    want, (twin,) = _both(params, mine, g, x0,
                          [kunet.rounding_twin(mine, F16)])
    return mine, g, x0, want, twin


@pytest.mark.parametrize("points", [("groupnorm",), ("film",), ("down",),
                                    ("final conv",), "all"])
def test_fp16_twin_needs_each_rounding_point(jax_all_points, points):
    """The twin without any one of JAX's rounding points (or without all
    four: the bf16 program with fp16 operands, ``chip_smoke.py``'s
    ``fp16_twin_without``) misses JAX's fp16 kernel: its mean error or its
    share within 1e-4 fails the bar the whole twin holds, and no sample
    holds JAX within 1e-6, where the whole twin holds a quarter or more."""
    mine, g, x0, want, twin = jax_all_points
    smoke = _smoke()
    less = smoke.fp16_twin_without(
        mine, smoke.FP16_POINTS if points == "all" else points)
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    got = kunet.unet1d_ddim_sample_plain(less, torch.from_numpy(g),
                                         torch.from_numpy(x0), ts,
                                         coefs).numpy()
    err, err_twin = np.abs(got - want), np.abs(twin - want)
    print(f"without {points}: mean {err.mean():.2e}, share "
          f"{(err <= BAR).mean():.3f}, exact samples "
          f"{_exact_samples(got, want)}; the whole twin: mean "
          f"{err_twin.mean():.2e}, share {(err_twin <= BAR).mean():.3f}, "
          f"exact samples {_exact_samples(twin, want)}")
    assert err_twin.mean() <= BAR and (err_twin <= BAR).mean() >= 0.8
    assert _exact_samples(twin, want) >= 4
    assert err.mean() > BAR or (err <= BAR).mean() < 0.8
    assert _exact_samples(got, want) == 0


def _held(got, want):
    """(mean error, share within BAR, samples within EXACT) of ``got``
    against ``want`` over the samples given, and whether that holds the
    bar the twin holds: mean within BAR, 80% of the elements within BAR,
    and a fifth of the samples within EXACT."""
    err = np.abs(got - want)
    stats = (float(err.mean()), float((err <= BAR).mean()),
             _exact_samples(got, want))
    return stats, (stats[0] <= BAR and stats[1] >= 0.8
                   and stats[2] >= len(got) / 5)


def test_fp16_twin_keeps_jax_nonfinite_output(all_points):
    """Sample 1 of 16 driven past |x| = 256 (its initial draw times 500):
    x * x overflows fp16 in JAX's GroupNorm statistics, the variance is
    inf, and JAX's broadcast turns it into NaN in the sample's other
    groups; its output is NaN where the fp32 net's is finite. The twin's
    output is non-finite exactly where JAX's is, and the other 15 samples
    are untouched: bit for bit what the twin gives them with sample 1 at
    its plain draw (a sample depends on itself alone; the same batch size,
    since the CPU's convolutions sum a batch of another size in another
    order), and held to JAX as ``test_fp16_twin_matches_jax_fp16_kernel``
    holds the twin, on a net where every rounding point shows. One sample
    alone is no yardstick there: one rounding flip moves it by up to 1e-3,
    and hosts flip differently. Negative controls: the twin without each
    of JAX's rounding points, and without all four, misses that bar."""
    params, mine = all_points
    rng = np.random.default_rng(7)
    g = rng.normal(size=(16, DC)).astype(np.float32)
    x0 = rng.normal(size=(16, T, D)).astype(np.float32)
    plain = x0.copy()
    x0[1] *= 500
    smoke = _smoke()
    less = [smoke.fp16_twin_without(mine, p) for p in (
        ("groupnorm",), ("film",), ("down",), ("final conv",),
        smoke.FP16_POINTS)]
    twin = kunet.rounding_twin(mine, F16)
    want, (got, net, *controls) = _both(params, mine, g, x0,
                                        [twin, mine, *less])
    bad = ~np.isfinite(want)
    assert bad[1].all() and not np.delete(bad, 1, 0).any()
    assert np.isfinite(net).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    alone = kunet.unet1d_ddim_sample_plain(twin, torch.from_numpy(g),
                                           torch.from_numpy(plain), ts,
                                           coefs).numpy()
    rest = [i for i in range(16) if i != 1]
    np.testing.assert_array_equal(got[rest], alone[rest])
    stats, ok = _held(got[rest], want[rest])
    print(f"twin on the 15 finite samples: mean {stats[0]:.2e}, share "
          f"{stats[1]:.3f}, exact samples {stats[2]}")
    assert ok
    for name, c in zip(("groupnorm", "film", "down", "final conv", "all"),
                       controls):
        stats, ok = _held(c[rest], want[rest])
        print(f"without {name}: mean {stats[0]:.2e}, share {stats[1]:.3f}, "
              f"exact samples {stats[2]}")
        assert not ok, name


def test_fp16_twin_with_fp64_sums_is_the_same_function(unet):
    """The fp16 rounding twin summing in fp64 against itself in fp32, the
    yardstick of the statistics above: two orders of summation of one
    function part by what rounding flips make, up to 2e-3 on a sample,
    and hold the same bar on the mean (1e-4)."""
    _, mine = unet
    twin = kunet.rounding_twin(mine, F16)
    twin64 = copy.deepcopy(twin).double()
    rng = np.random.default_rng(6)
    g = rng.normal(size=(8, DC))
    x0 = rng.normal(size=(8, T, D))
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    with torch.no_grad():
        a = dlib.sample_with_coefs(
            lambda x, t: twin(x, t, torch.from_numpy(g).float()),
            torch.from_numpy(x0).float(), ts, coefs, None, 1.0).numpy()
        b = dlib.sample_with_coefs(
            lambda x, t: twin64(x, t, torch.from_numpy(g)),
            torch.from_numpy(x0), ts, coefs.double(), None, 1.0).numpy()
    err = np.abs(a - b)
    print(f"fp16 twin, fp32 sums against fp64: mean {err.mean():.2e}, max "
          f"{err.max():.2e}")
    assert err.mean() <= BAR and err.max() <= 2e-3


def test_fp16_agent_matches_jax(unet):
    """A small LDP agent with ``fused_dtype: float16``: the port's
    ``sample_fast`` with its planner through what the card's fp16 instance
    computes (its rounding twin; on the CPU the agent would run the plain
    fp32 net, 8e-3 away) against JAX's ``LDPAgent`` through its Pallas
    kernels in interpret mode, planner in fp16, with JAX's draws: 5e-3
    (``tests/test_pallas_sampler.py``'s agent bar). The port's agent
    accepts the weight type on the card's kernel check."""
    cfg = tl._small_config()
    cfg["fused_dtype"] = "float16"
    B, H = 2, 9
    batch = {"obs": {k: jnp.zeros((B, H, *tl.configs.SHAPE_META[
        "all_shapes"][k])) for k in cfg["lowdim_obs"] + cfg["rgb_obs"]},
        "actions": jnp.zeros((B, H, 7))}
    pkg = "latent_diffusion_planning_tpu.models.nets."
    jagent = tl.JaxLDPAgent.create(
        jax.random.PRNGKey(0), batch, tl.configs.SHAPE_META,
        planner={"_target_": pkg + "unet1d.ConditionalUnet1D",
                 **cfg["planner"]},
        idm_net={"_target_": pkg + "mlp.MLPDiffusion", **cfg["idm_net"]},
        vae=cfg["vae"], vae_feature_dim=16, lowdim_obs=cfg["lowdim_obs"],
        rgb_obs=cfg["rgb_obs"], obs_normalization=cfg["obs_normalization"],
        obs_horizon=1, pred_horizon=8, action_horizon=4,
        planner_n_diffusion_steps=12, idm_n_diffusion_steps=12,
        planner_inference_steps=4, idm_inference_steps=4, warmup_steps=2,
        decay_steps=10, fused_sampler=True, fused_dtype="float16")
    assert jagent.config.fused_planner and jagent.config.fused_interpret
    snap = {"planner_params": tl._np(jagent.planner_state.params),
            "idm_params": tl._np(jagent.idm_state.params),
            "vae_params": tl._np(jagent.vae_params)}
    agent = bridge.ldp_agent_from_flax(snap, cfg, tl.configs.SHAPE_META,
                                       device="cpu")
    assert agent.config.fused_dtype == "float16"
    assert common.fused_weight_dtype("float16") == F16
    agent._check_kernels()
    sample = kunet.fused_unet1d_ddim_sample

    def fp16_route(net, *args, dtype=kunet.WEIGHT_DTYPE, **kw):
        # what the card's fp16 instance computes: the twin that rounds
        # where it rounds
        assert dtype == kunet.WEIGHT_DTYPE     # the CPU names the default
        return sample(kunet.rounding_twin(net, F16), *args, **kw)

    window = tl._windows(4, 0)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jagent.sample_fast({"obs": window}, key))
    draws = tl._jax_draws(key, 4, 8, agent.config.obs_dim, 7)
    obs = {"obs": {k: torch.from_numpy(v) for k, v in window.items()}}
    plain = agent.sample_fast(obs, draws=draws).numpy()
    with mock.patch.object(kunet, "fused_unet1d_ddim_sample", fp16_route):
        got = agent.sample_fast(obs, draws=draws).numpy()
    print(f"agent: fp16 route max {np.abs(got - ref).max():.2e}, plain fp32 "
          f"max {np.abs(plain - ref).max():.2e}")
    assert got.shape == ref.shape == (4, 8, 7)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)


@pytest.mark.parametrize("dd", [(8, 16, 32), (64, 128, 256)])
def test_fp16_packing_round_trips(dd):
    """``pack_params(net, float16)`` lays the weights out as the bf16
    packing does (the same layout, 8 KB tiles), each tile read back by
    ``untile_matrix`` to the GEMM's weights rounded to fp16, the vectors
    (biases, GroupNorm scales) too."""
    net = ConditionalUnet1D(D, DC, DSED, dd, 5, G,
                            generator=torch.Generator().manual_seed(1))
    flat = kunet.pack_params(net, F16)
    lay = kunet.layout(net, F16)
    assert flat.dtype == F16 and lay == kunet.layout(net, torch.bfloat16)
    assert kunet.esize(F16) == 2 and kunet.stage_tiles(F16) == 3
    gemms = kunet._gemms(net)
    for stream in ("main", "time", "cond"):
        base = lay["stream"][stream]["tile_base"]
        for name, w, vecs in gemms[stream]:
            g = lay["gemm"][name]
            lo = (base + g["tile_off"]) * kunet.TILE
            K, N = g["taps"] * kunet._up(g["cin"], 32), g["cout"]
            got = kunet.untile_matrix(
                flat[lo:lo + g["n_tiles"] * kunet.TILE], K, N)
            want = kunet._pad_taps(w.detach().float()).to(F16)
            assert torch.equal(got[:, :N], want), name
            if vecs:
                v0 = lay["vec_base"] + g["vec_off"]
                assert torch.equal(flat[v0:v0 + N],
                                   vecs[0].detach().to(F16)), name
