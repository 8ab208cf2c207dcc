"""Kernel B with fp32 weights and its condition walked in chunks, and kernel
A for every MLP-IDM variant, on the CPU: the twins against the JAX package,
and the layouts and programs the CUDA kernels read, transcribed in NumPy.

Twins against JAX get JAX's draws and the JAX package's own
kernel-against-scan bar, 2e-4 (``tests/test_pallas_sampler.py``): kernel
B's fp32 twin against ``fused_unet1d_ddim_sample(dtype=float32,
interpret=True)`` for DDIM, and against ``sample_ddpm`` for DDPM (the JAX
kernel is DDIM only); kernel A's twins against the JAX scan. The NumPy
transcriptions read the packed buffers as the kernels do and run with fp64
sums against the twins with fp64 sums: 1e-5 for fp32 (nothing is rounded on
either side), 1e-4 for the bf16 program (``test_torch_diffusion.py``'s
bar).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_diffusion as ttd
from test_torch_ddpm import _meta_unet
from latent_diffusion_planning_tpu.models.nets.mlp import (
    MLPDiffusion as JaxIDM)
from latent_diffusion_planning_tpu.models.nets.unet1d import (
    ConditionalUnet1D as JaxUnet)
from latent_diffusion_planning_tpu.ops import diffusion as jdlib
from latent_diffusion_planning_tpu.ops.pallas.diffusion_unet1d import (
    fused_unet1d_ddim_sample as jax_fused_unet)
from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.models.agents.dp import DPAgent
from latent_diffusion_planning_tpu_torch.models.nets.mlp import MLPDiffusion
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    ConditionalUnet1D)
from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
from latent_diffusion_planning_tpu_torch.ops.kernels import diffusion_mlp as kmlp
from latent_diffusion_planning_tpu_torch.ops.kernels import (
    diffusion_unet1d as kunet)
from torch_thread import one_torch_thread  # noqa: F401

SAMPLER_ATOL = 2e-4
F32 = torch.float32


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _unet_pair(Dc, dd=(8, 16, 32), T=8, D=5, d=32, seed=0):
    net = JaxUnet(input_dim=D, global_cond_dim=Dc, diffusion_step_embed_dim=d,
                  down_dims=dd, kernel_size=5, n_groups=4)
    params = net.init(jax.random.PRNGKey(seed), np.zeros((2, T, D)),
                      np.zeros((2,), np.int32), np.zeros((2, Dc)))["params"]
    mine = bridge.unet1d_from_flax(_np(params), input_dim=D, global_cond_dim=Dc,
                                   diffusion_step_embed_dim=d, down_dims=dd,
                                   n_groups=4)
    return net, params, mine


# ---------------------------------------------------------------------------
# kernel B with fp32 weights: the twin against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Dc", [5, 300])
def test_fp32_twin_matches_jax_fp32_kernel(Dc):
    """Kernel B's route with ``dtype=float32`` (on the CPU its fp32 twin)
    against JAX's ``fused_unet1d_ddim_sample(dtype=float32)`` in interpret
    mode, DDIM-4 of 12 steps, at a narrow condition and at one wider than a
    prologue chunk (300 > 256): 2e-4."""
    B, T, D = 4, 8, 5
    net, params, mine = _unet_pair(Dc)
    g = np.random.default_rng(4).normal(size=(B, Dc)).astype(np.float32)
    sched_j = jdlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    sched_t = dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    ts_j, coefs_j = jdlib.ddim_coef_table(sched_j, 4)
    x0 = np.random.default_rng(5).normal(size=(B, T, D)).astype(np.float32)
    want = jax_fused_unet(params, g, x0, ts_j, coefs_j, down_dims=(8, 16, 32),
                          diffusion_step_embed_dim=32, n_groups=4,
                          dtype=jnp.float32, batch_tile=B, interpret=True)
    ts, coefs = dlib.ddim_coef_table(sched_t, 4)
    got = kunet.fused_unet1d_ddim_sample(mine, torch.from_numpy(g),
                                         torch.from_numpy(x0), ts, coefs,
                                         dtype=F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLER_ATOL, rtol=0)


def test_fp32_twin_matches_jax_ddpm():
    """DDPM-12 with JAX's draws (``sample_ddpm``'s initial sample and
    per-step noise) against the JAX scan: 2e-4."""
    B, T, D, Dc = 3, 8, 5, 6
    net, params, mine = _unet_pair(Dc, seed=1)
    g = np.random.default_rng(6).normal(size=(B, Dc)).astype(np.float32)
    sched_j = jdlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    sched_t = dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    key = jax.random.PRNGKey(8)
    want = jdlib.sample_ddpm(
        sched_j, lambda x, t: net.apply({"params": params}, x, t, g), key,
        (B, T, D))
    x0, noise = ttd._jax_draws(key, (B, T, D), 12)
    ts, coefs = dlib.ddpm_coef_table(sched_t)
    got = kunet.fused_unet1d_ddim_sample(
        mine, torch.from_numpy(g), torch.from_numpy(x0), ts, coefs,
        torch.from_numpy(noise), dtype=F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLER_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# kernel B with fp32 weights: what the CUDA kernel reads
# ---------------------------------------------------------------------------

def test_fp32_tiles_hold_the_fragments_the_kernel_reads():
    """``pack_params(net, float32)`` untiles to every weight exactly, its
    streams are not padded (a ring stage is one tile), and a lane's two
    16-byte reads of a tile (``gemm`` in ``csrc/unet1d.cuh``: floats
    ``warp·256 + lane·4`` and 128 past them) are the ``m16n8k8`` B
    fragments of its column for the K slots the kernel assigns: word h
    holds rows 16 h + 4 tq .. + 3 of column 8 warp + g, so (k8, b) = B[16
    (k8 // 2) + 4 tq + 2 (k8 % 2) + b][8 warp + g] — the same four
    consecutive channels the kernel loads from an activation row."""
    torch.manual_seed(2)
    net = ConditionalUnet1D(25, 300, 64, (24, 40), 5, 8)
    lay = kunet.layout(net, F32)
    packed = kunet.pack_params(net, F32)
    assert packed.dtype == F32 and packed.numel() == lay["numel"]
    for st in lay["stream"].values():
        assert st["stages"] == st["n_tiles"]
    for stream, gemms in kunet._gemms(net).items():
        base = lay["stream"][stream]["tile_base"]
        for name, w, _ in gemms:
            g = lay["gemm"][name]
            taps, cin, cout = w.shape
            lo = (base + g["tile_off"]) * kunet.TILE
            flat = packed[lo:lo + g["n_tiles"] * kunet.TILE]
            full = kunet.untile_matrix_f32(flat, taps * kunet._up(cin, 32),
                                           cout)
            want = kunet._pad_taps(w.detach().float())
            assert torch.equal(full[:, :cout], want), name
            assert not full[:, cout:].any(), name
    # the fragments of the first tile of the first GEMM, as the kernel reads
    w = kunet._pad_taps(kunet._gemms(net)["main"][0][1].detach().float())
    tile = packed[:kunet.TILE]
    for warp in (0, 7, 15):
        for lane in (0, 13, 31):
            g, tq = lane // 4, lane % 4
            words = torch.cat([tile[warp * 256 + lane * 4:][:4],
                               tile[warp * 256 + 128 + lane * 4:][:4]])
            for k8 in range(4):
                for b in range(2):
                    k = 16 * (k8 // 2) + 4 * tq + 2 * (k8 % 2) + b
                    n = 8 * warp + g
                    want = w[k, n] if n < w.shape[1] else 0.0
                    assert float(words[2 * k8 + b]) == float(want)


DEFAULT_CALLS = {   # (D, Dc, down_dims, k, downsample, T, B)
    "ldp planner": (25, 25, (256, 512, 1024), 5, True, 16, 256),
    "ldp_hier planner": (25, 25, (256, 512, 1024), 5, False, 4, 256),
    "ldp_hier window": (25, 25, (256, 512, 1024), 5, False, 16, 256),
    "ldp_hier chunk IDM": (7, 50, (256, 512), 3, False, 4, 1024),
    "dp": (7, 2066, (256, 512, 1024), 5, True, 16, 256),
    "dp obs_horizon 3": (7, 3099, (256, 512, 1024), 5, True, 16, 256),
    "bench planner": (25, 25, (64, 128, 256), 5, True, 8, 1024),
}


@pytest.mark.parametrize("call", sorted(DEFAULT_CALLS))
def test_fp32_programs_fit_every_default_call(call):
    """Every call of the four default agents (and the bench planner) has an
    fp32 program that fits a block: the ordinary one, or the wide mode,
    where no tile fits whole (LDP-hier's window) or where it lets more
    samples share a block, with the fp32 buffers and the skips in the
    global scratch and the operand buffers in shared memory where they fit
    beside the ring, else in the scratch too (the window). The records are
    bf16's but for the skips' offsets, which count fp32 operands."""
    D, Dc, dd, k, down, T, B = DEFAULT_CALLS[call]
    net = _meta_unet(D, Dc, dd, k, down)
    nb, prog = kunet.choose_tile(net, T, B, F32)
    assert prog["smem_bytes"] <= kunet.SMEM_LIMIT
    whole = kunet.build_program(net, T, 1, False, F32)
    if whole["smem_bytes"] > kunet.SMEM_LIMIT:
        assert prog["wide"]
    bf16 = kunet.build_program(net, T, nb, prog["wide"])
    for r32, r16 in zip(prog["records"], bf16["records"]):
        if r32[0] in (kunet.SAVE, kunet.CONCAT):
            r32, r16 = r32[2:], r16[2:]
        assert r32 == r16
    if prog["wide"]:
        operands = 2 * prog["maxb"] if prog["operands_global"] else 0
        assert prog["scratch_bytes"] == kunet._up(
            8 * prog["max32"] + 4 * (operands + prog["skip_total"])
            + kunet.F32_RED_BYTES, 256)
    assert prog["operands_global"] == (call in ("ldp_hier window",
                                                "ldp_hier chunk IDM"))
    if call == "ldp_hier window":
        assert prog["maxb"] == nb * T * kunet.ldb(2048, F32)
    assert kunet.prologue_smem_bytes(net, F32) <= kunet.SMEM_LIMIT
    info = kunet.kernel_info(net, B, T, 100, dtype=F32)
    assert info["dtype"] == "float32" and info["prologue_cond_rows"] == 64


def _f32_program(net, g, x0, ts, coefs, noise=None):
    """``test_torch_diffusion._run_unet_program`` reading the fp32 packing
    and program with no bf16 rounding: the fp32 kernel's data path."""
    pack, build = kunet.pack_params, kunet._build_program
    sig = kunet._signature(net)
    with mock.patch.object(ttd, "_bf16", lambda a: np.asarray(a, np.float64)), \
            mock.patch.object(kunet, "pack_params", lambda n: pack(n, F32)), \
            mock.patch.object(kunet, "untile_matrix", kunet.untile_matrix_f32), \
            mock.patch.object(kunet, "layout",
                              lambda n, *a: kunet._layout(sig, F32)), \
            mock.patch.object(kunet, "build_program",
                              lambda n, T, nb, wide=False, *a: build(
                                  sig, T, nb, wide, F32)):
        return ttd._run_unet_program(net, g, x0, ts, coefs, 1.0, noise)


@pytest.mark.parametrize("Dc,down", [(6, True), (300, True), (300, False)])
def test_fp32_program_matches_the_twin(Dc, down):
    """The fp32 kernel's records, tiles and condition chunks, run by the
    NumPy transcription with nothing rounded, compute what the fp32 twin
    computes (fp64 sums on both sides): 1e-5, DDPM-10 with noise."""
    B, T, D = 3, 8, 5
    net = ConditionalUnet1D(D, Dc, 16, (8, 16, 32), 5, 4, down,
                            generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    g = rng.normal(size=(B, Dc))
    x0 = rng.normal(size=(B, T, D)).astype(np.float32)
    ts, coefs = dlib.ddpm_coef_table(dlib.DiffusionSchedule.create(10))
    noise = rng.normal(size=(10, B, T, D)).astype(np.float32)
    twin64 = net.double()
    with torch.no_grad():
        want = dlib.sample_with_coefs(
            lambda x, t: twin64(x, t, torch.from_numpy(g)),
            torch.from_numpy(x0).double(), ts, coefs.double(),
            torch.from_numpy(noise).double(), 1.0)
    got = _f32_program(net.float(), g, x0, ts, coefs, noise)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("Dc", [257, 600])
def test_chunked_condition_program_matches_rounding_twin(Dc):
    """The bf16 kernel's program with a condition of more than one
    ``COND_CHUNK`` (the prologue adds each chunk's product into film_g) in
    the NumPy transcription against the rounding twin with fp64 sums, as
    ``test_unet_kernel_program_matches_twin`` holds it: 1e-4."""
    B, T, D = 3, 8, 5
    net = kunet.rounding_twin(ConditionalUnet1D(
        D, Dc, 16, (8, 16, 32), 5, 4, generator=torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(8)
    g = rng.normal(size=(B, Dc)).astype(np.float32)
    x0 = rng.normal(size=(B, T, D)).astype(np.float32)
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 4)
    import copy
    twin64 = copy.deepcopy(net).double()
    with torch.no_grad():
        want = dlib.sample_with_coefs(
            lambda x, t: twin64(x, t, torch.from_numpy(g).double()),
            torch.from_numpy(x0).double(), ts, coefs.double(), None, 1.0)
    got = ttd._run_unet_program(net, g.astype(np.float64), x0, ts, coefs, 1.0)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-4, rtol=0)
    names = [n for n in kunet.layout(net)["gemm"] if n.startswith("film_g")]
    assert len(names) == -(-Dc // kunet.COND_CHUNK)


def test_any_condition_width_takes_64_rows():
    """The prologue's shared memory no longer grows with the condition: a
    10000-wide one takes 64 samples a block in both weight types, and the
    default DP at ``obs_horizon=3`` (a 3099-wide condition) passes the
    card's kernel check in both."""
    wide = _meta_unet(7, 10000, (256, 512, 1024), 5, True)
    for dt in kunet.WEIGHT_DTYPES:
        assert kunet.prologue_smem_bytes(wide, dt) <= kunet.SMEM_LIMIT
        assert kunet.kernel_info(wide, 256, 16, 100, dtype=dt)[
            "prologue_grid"] == 100 + 4
    cfg = configs.lift_dp_train_config()["agent"]
    for dt in ("bfloat16", "float32"):
        agent = DPAgent.create(dict(cfg, obs_horizon=3, fused_dtype=dt),
                               configs.SHAPE_META, device="cpu")
        assert agent.planner.global_cond_dim == 3099
        agent._check_kernels()


def test_dp_at_a_3099_wide_condition_matches_jax():
    """The default DP at ``obs_horizon=3`` (ResNet-18's 1024 features and 9
    lowdim, three frames: a 3099-wide condition; its U-Net narrowed) from
    the command line: ``sample_action`` against the JAX agent's DDPM-100
    scan with JAX's draws, 2e-4. On the card kernel B's prologue walks
    this condition in 13 chunks."""
    from test_torch_defaults import (BRIDGE, NARROW, _both, _ddpm_draws,
                                     _jax_agent, _snapshot, _window)
    from latent_diffusion_planning_tpu.utils import config as jconfig
    from latent_diffusion_planning_tpu_torch.utils.config import load_config
    line = ["agent=dp_agent", "data=lift/img", "obs_horizon=3",
            *NARROW["common"]]
    cfg = load_config("train_bc", line)
    jagent = _jax_agent(jconfig.load_config("train_bc", line))
    agent_cfg = {k: v for k, v in dict(cfg.agent).items()
                 if k != "vae_pretrain_path"}
    agent = BRIDGE["dp_agent"](_snapshot(jagent), agent_cfg,
                               cfg.data["meta"]["shape_meta"], device="cpu")
    assert agent.planner.global_cond_dim == 3099
    agent._check_kernels()
    jobs, tobs = _both(_window("dp_agent", 2, 3, seed=1))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jagent.sample_action(jobs, key))
    x0, noise = _ddpm_draws(key, (2, 16, 7))
    got = agent.sample_action(tobs, draws={"x_init": x0,
                                           "step_noise": noise}).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=SAMPLER_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# kernel A for every MLP-IDM variant
# ---------------------------------------------------------------------------

IDM_VARIANTS = {
    "mish": dict(cond_activation="mish"),
    "relu-three-layers": dict(cond_activation="relu",
                              cond_hidden_dims=(24, 40, 16)),
    "gelu": dict(cond_activation="gelu"),
    "no-layer-norm": dict(use_layer_norm=False),
    "fixed-time": dict(learnable_time=False),
    "hidden-48": dict(hidden_dim=48),
    "hidden-200": dict(hidden_dim=200),
    "hidden-320": dict(hidden_dim=320),
    "hidden-504-no-ln": dict(hidden_dim=504, use_layer_norm=False),
}


def _idm_pair(variant, S=12, A=7):
    kw = dict(time_dim=16, cond_hidden_dims=(32, 24), n_blocks=2,
              hidden_dim=64)
    kw.update(variant)
    net = JaxIDM(out_dim=A, **kw)
    s = np.random.default_rng(9).normal(size=(6, S)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(3), s[:2], np.zeros((2, A)),
                      np.zeros((2, 1), np.int32))["params"]
    # non-zero biases, so the padded vectors' layout shows
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.normal(size=np.shape(v)).astype(
            np.float32), params)
    mine = bridge.mlp_diffusion_from_flax(_np(params), s_dim=S, out_dim=A,
                                          **kw)
    return net, params, mine, s


@pytest.mark.parametrize("case", sorted(set(IDM_VARIANTS)
                                         - {"hidden-200", "hidden-320"}))
def test_idm_variant_twins_match_jax_scan(case):
    """Kernel A's route (on the CPU its twin) for the variants the kernel
    now takes, DDPM-12 with JAX's draws, against the JAX scan: 2e-4 (hidden
    200 and 320 only in the transcription below, which pads them as 48 and
    504 are padded here)."""
    net, params, mine, s = _idm_pair(IDM_VARIANTS[case])
    kmlp.check_supported(mine)
    N, A = s.shape[0], 7
    sched_j = jdlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    sched_t = dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    key = jax.random.PRNGKey(12)
    want = jdlib.sample_ddpm(
        sched_j, lambda a, t: net.apply({"params": params}, s, a, t), key,
        (N, A))
    x0, noise = ttd._jax_draws(key, (N, A), 12)
    ts, coefs = dlib.ddpm_coef_table(sched_t)
    got = kmlp.fused_mlp_diffusion_sample(
        mine, torch.from_numpy(s), torch.from_numpy(x0), ts, coefs,
        torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLER_ATOL, rtol=0)


def _kernel_a_numpy(net, s, x0, ts, coefs, noise):
    """csrc/diffusion_mlp.cu's data path over ``pack_params(net)`` in
    NumPy (fp64): the time kernel walking the vectors (Fourier features,
    each cond layer, the time's share of the trunk input), then per step
    the padded trunk (Hp columns), LayerNorm over the real H columns only,
    the 4H layer in its passes, ReLU, the output layer and the update."""
    lay = kmlp.layout(net)
    flat = kmlp.pack_params(net).double().numpy()
    Hp, nc, H = lay["Hp"], lay["passes"], kmlp.hidden(net)
    hc = 4 * Hp // nc
    V = flat[lay["vec_base"]:]
    vo = lay["vec_offsets"]
    A, S = net.out_dim, net.s_dim
    widths = [lin.out_features for lin in net.cond.dense]
    half = net.time_dim // 2
    act = {"relu": lambda v: np.maximum(v, 0),
           "swish": lambda v: v / (1 + np.exp(-v)),
           "mish": lambda v: v * np.tanh(np.logaddexp(v, 0)),
           "gelu": lambda v: 0.5 * v * (1 + np.tanh(
               0.7978845608028654 * (v + 0.044715 * v ** 3)))}[
        net.cond_activation]
    cbias = []
    for t in ts.tolist():
        f = V[:half] * (2 * np.pi * t if net.time.learnable else t)
        h = np.concatenate([np.cos(f), np.sin(f)])
        o, k = half, 2 * half
        for i, w in enumerate(widths):
            W = V[o:o + k * w].reshape(k, w)
            h = h @ W + V[o + k * w:o + k * w + w]
            o += k * w + w
            if i + 1 < len(widths):
                h = act(h)
            k = w
        twc = V[o:o + k * Hp].reshape(k, Hp)
        cbias.append(h @ twc + V[o + k * Hp:o + k * Hp + Hp])

    def matrix(name, K, N):
        o = lay["offsets"][name]
        Kp = kmlp._up(K, kmlp.STAGE_K)
        return kmlp.untile_matrix(torch.from_numpy(flat[o:o + Kp * N]), K,
                                  N).numpy()[:K]
    x = x0.astype(np.float64)
    for step in range(len(ts)):
        h = np.concatenate([x, s], 1) @ matrix("trunk_in", A + S, Hp)
        h = h + cbias[step]
        for b in range(len(net.trunk.blocks)):
            blk = V[vo[f"blk.{b}"]:]
            ln_s, ln_b = blk[:Hp], blk[Hp:2 * Hp]
            b0, b1 = blk[2 * Hp:6 * Hp], blk[6 * Hp:7 * Hp]
            if net.use_layer_norm:
                mu = h[:, :H].mean(1, keepdims=True)
                var = ((h[:, :H] - mu) ** 2).mean(1, keepdims=True)
                ln = (h - mu) / np.sqrt(var + 1e-6) * ln_s + ln_b
            else:
                ln = h
            h = h + b1
            for c in range(nc):
                a1 = np.maximum(ln @ matrix(f"w0.{b}.{c}", Hp, hc)
                                + b0[c * hc:(c + 1) * hc], 0)
                h = h + a1 @ matrix(f"w1.{b}.{c}", hc, Hp)
        ow = V[vo["ow"]:vo["ow"] + Hp * A].reshape(Hp, A)
        assert not ow[H:].any()
        y = np.maximum(h, 0) @ ow + V[vo["ob"]:vo["ob"] + A]
        c0, c1, c2, c3, c4, cx = coefs[step].double().tolist()
        x0_ = np.clip(c0 * (cx * x - c1 * y), -1, 1)
        x = c2 * x0_ + c3 * x + (c4 * noise[step] if noise is not None else 0)
    return x


@pytest.mark.parametrize("case", sorted(IDM_VARIANTS))
def test_idm_variant_packing_matches_the_twin(case):
    """Kernel A's packing for each variant (the cond layers in the
    vectors, fixed frequencies, widths padded to whole tiles with zeros,
    the 4H layer in its passes) read as the kernel reads it, in NumPy,
    computes what the twin computes: 1e-5 after DDPM-12 (fp64 against the
    fp32 twin, whose sums round in fp32; the net's time features take fp32
    inputs, so the twin does not run in fp64). Past 256 a block holds 32
    rows."""
    _, _, mine, s = _idm_pair(IDM_VARIANTS[case])
    N, A = s.shape[0], 7
    ts, coefs = dlib.ddpm_coef_table(dlib.DiffusionSchedule.create(12))
    rng = np.random.default_rng(13)
    x0 = rng.normal(size=(N, A)).astype(np.float32)
    noise = rng.normal(size=(12, N, A)).astype(np.float32)
    want = kmlp.mlp_diffusion_sample_plain(
        mine, torch.from_numpy(s), torch.from_numpy(x0), ts, coefs,
        torch.from_numpy(noise))
    got = _kernel_a_numpy(mine, s.astype(np.float64), x0, ts, coefs,
                          noise.astype(np.float64))
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)
    H = kmlp.hidden(mine)
    info = kmlp.kernel_info(mine, 4096, A, s.shape[1], 12)
    assert info["hidden_padded"] == kmlp.padded(H) >= H
    assert info["rows_per_block"] == (64 if kmlp.padded(H) <= 256 else 32)


def test_what_kernel_a_still_refuses():
    """Only a hidden width past ``MAX_HIDDEN`` (1536, run with ring stages
    of 8 K-rows) and a cond MLP the JAX IDM never builds are refused; widths
    that are not a multiple of 8 or pass 512 or 1024 run."""
    for ok in (100, 520, 1024, 1100, 1536):
        kmlp.check_supported(MLPDiffusion(12, 7, 16, (32, 24), "swish", 2, ok))
    net = MLPDiffusion(12, 7, 16, (32, 24), "swish", 2, kmlp.MAX_HIDDEN + 8)
    with pytest.raises(ValueError, match="hidden_dim up to 1536"):
        kmlp.check_supported(net)
    net = MLPDiffusion(12, 7, 16, (32, 24), "swish", 2, 64)
    kmlp.check_supported(net)
    net.cond.tanh_output = True
    with pytest.raises(ValueError, match="cond MLP"):
        kmlp.check_supported(net)
