"""The shapes the JAX package's Pallas kernels A and B take and the CUDA
kernels once refused, on the CPU: kernel A at hidden widths that are not a
multiple of 8 or pass 512 or 1024 and with ``[x|s]`` rows too wide to hold
whole; kernel B at plan lengths past 128 GEMM rows (and past 256, and in
fp32, where its GEMMs walk their rows in groups), on an up block whose
concatenated input is as wide as its output, in the wide mode past 32 rows
and with its bf16 operands in global memory.

For each: the plan the wrapper launches (rows a block, passes, chunks,
instance, shared memory), the port's net against the JAX Pallas kernel run
in interpret mode on the same weights and draws (the JAX package's own
kernel-against-scan bar, 2e-4, ``tests/test_pallas_sampler.py``), and for
kernel B the NumPy transcription of the program the card runs against its
twin (fp64 sums on both sides: 1e-4 for bf16, 1e-5 for fp32, the bars of
``test_torch_diffusion.py`` and ``test_torch_fp32_kernel.py``).
"""

import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_diffusion as ttd
import test_torch_fp32_kernel as tfk
from latent_diffusion_planning_tpu.models.nets.mlp import (
    MLPDiffusion as JaxIDM)
from latent_diffusion_planning_tpu.ops import diffusion as jdlib
from latent_diffusion_planning_tpu.ops.pallas.diffusion_mlp import (
    fused_mlp_diffusion_sample as jax_fused_mlp)
from latent_diffusion_planning_tpu_torch import bridge
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    ConditionalUnet1D)
from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
from latent_diffusion_planning_tpu_torch.ops.kernels import diffusion_mlp as kmlp
from latent_diffusion_planning_tpu_torch.ops.kernels import (
    diffusion_unet1d as kunet)
from torch_thread import one_torch_thread  # noqa: F401

ATOL = 2e-4
F32 = torch.float32


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------

# name: (hidden, S, rows a block, passes, chunked)
A_SHAPES = {"hidden-36": (36, 12, 64, 4, False),
            "hidden-1024": (1024, 12, 16, 16, False),
            "hidden-1536": (1536, 12, 16, 24, False),
            "row-1100": (256, 1100, 64, 4, True),
            "row-2048": (256, 2048, 64, 4, True)}


def _idm(hidden, S, A=7, N=4):
    """The JAX kernel's recipe (swish cond MLP, LayerNorm, learnable time),
    two blocks, its init with small nonzero biases, and the port's copy."""
    kw = dict(time_dim=16, cond_hidden_dims=(32, 24), n_blocks=2,
              hidden_dim=hidden)
    net = JaxIDM(out_dim=A, **kw)
    rng = np.random.default_rng(hidden + S)
    s = rng.normal(size=(N, S)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(1), s[:2], np.zeros((2, A)),
                      np.zeros((2, 1), np.int32))["params"]
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.02 * rng.normal(size=np.shape(v)).astype(
            np.float32), params)
    mine = bridge.mlp_diffusion_from_flax(_np(params), s_dim=S, out_dim=A,
                                          **kw)
    return params, mine, s


@pytest.mark.parametrize("case", sorted(A_SHAPES))
def test_kernel_a_plan_at_shape(case):
    """The launch the wrapper plans: rows a block, the 4H layer's passes,
    the row walked in chunks where it is too wide to hold, and a ring of at
    least two stages inside the card's shared memory."""
    H, S, rows, n_pass, chunked = A_SHAPES[case]
    with torch.device("meta"):
        net = kmlp.MLPDiffusion(S, 7, 16, (32, 24), "swish", 2, H)
    kmlp.check_supported(net)
    info = kmlp.kernel_info(net, 4096, 7, S, 100)
    assert info["hidden_padded"] == kmlp.padded(H) >= H
    assert (info["rows_per_block"], info["passes"], info["chunked"]) == (
        rows, n_pass, chunked)
    assert info["ring_stages"] >= 2
    assert info["smem_bytes"] <= kmlp.SMEM_LIMIT
    assert info["grid"] == 4096 // rows
    hr, hc = kmlp.pass_cols(H)
    assert hr * n_pass >= 4 * H > hr * (n_pass - 1) and hr <= hc


@pytest.mark.parametrize("case", sorted(A_SHAPES))
def test_kernel_a_twin_matches_jax_kernel_at_shape(case):
    """Kernel A's route (on the CPU its twin) against the JAX Pallas kernel
    in interpret mode on the same weights, DDIM-2 of 12 steps with JAX's
    initial draw: 2e-4."""
    H, S = A_SHAPES[case][:2]
    params, mine, s = _idm(H, S)
    N, A = s.shape[0], 7
    sched_j = jdlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    ts_j, coefs_j = jdlib.ddim_coef_table(sched_j, 2)
    x0 = np.random.default_rng(3).normal(size=(N, A)).astype(np.float32)
    want = jax_fused_mlp(params, jnp.asarray(s), jnp.asarray(x0), ts_j,
                         coefs_j, jnp.zeros((2, N, A)), tile=N,
                         interpret=True)
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    got = kmlp.fused_mlp_diffusion_sample(mine, torch.from_numpy(s),
                                          torch.from_numpy(x0), ts, coefs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("case", ["hidden-36", "hidden-1024", "hidden-1536"])
def test_kernel_a_packing_matches_the_twin_at_shape(case):
    """The packed buffer at these widths (the 4H layer cut into passes of
    ceil(4H / passes) real columns, each padded) read as the kernel reads
    it, in NumPy, computes what the twin computes: 1e-5, DDPM-4."""
    H, S = A_SHAPES[case][:2]
    _, mine, s = _idm(H, S)
    N, A = s.shape[0], 7
    ts, coefs = dlib.ddpm_coef_table(dlib.DiffusionSchedule.create(4))
    rng = np.random.default_rng(14)
    x0 = rng.normal(size=(N, A)).astype(np.float32)
    noise = rng.normal(size=(4, N, A)).astype(np.float32)
    want = kmlp.mlp_diffusion_sample_plain(
        mine, torch.from_numpy(s), torch.from_numpy(x0), ts, coefs,
        torch.from_numpy(noise))
    got = tfk._kernel_a_numpy(mine, s.astype(np.float64), x0, ts, coefs,
                              noise.astype(np.float64))
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------

def _unet(dd, T, D, Dc, d=32, G=8):
    """A JAX U-Net, its init, and the port's copy."""
    from latent_diffusion_planning_tpu.models.nets.unet1d import (
        ConditionalUnet1D as JaxUnet)
    net = JaxUnet(input_dim=D, global_cond_dim=Dc, diffusion_step_embed_dim=d,
                  down_dims=dd, kernel_size=5, n_groups=G)
    params = net.init(jax.random.PRNGKey(0), np.zeros((2, T, D)),
                      np.zeros((2,), np.int32), np.zeros((2, Dc)))["params"]
    mine = bridge.unet1d_from_flax(_np(params), input_dim=D, global_cond_dim=Dc,
                                   diffusion_step_embed_dim=d, down_dims=dd,
                                   n_groups=G)
    return net, params, mine


# name: (down_dims, T, n_groups); 256 steps plan as 160 do (one sample a
# block, the wide mode), held below by its program
B_SHAPES = {"T160": ((64, 128, 256), 160, 8),
            "T320": ((64, 128, 256), 320, 8),
            "skip-as-wide-as-output": ((32, 16, 16), 8, 4)}


@pytest.mark.parametrize("case", ["T160", "T320", "skip-as-wide-as-output"])
def test_kernel_b_twin_matches_jax_kernel_at_shape(case):
    """Kernel B's fp32 route (on the CPU its twin) against the JAX Pallas
    kernel with ``dtype=float32`` in interpret mode on the same weights and
    initial draw, DDIM-2 of 12 steps: 2e-4."""
    dd, T, G = B_SHAPES[case]
    B, D, Dc = 2, 5, 5
    _, params, mine = _unet(dd, T, D, Dc, G=G)
    kunet.check_supported(mine, T)
    rng = np.random.default_rng(6)
    g = rng.normal(size=(B, Dc)).astype(np.float32)
    x0 = rng.normal(size=(B, T, D)).astype(np.float32)
    ts_j, coefs_j = jdlib.ddim_coef_table(
        jdlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    want = tfk.jax_fused_unet(params, g, x0, ts_j, coefs_j, down_dims=dd,
                              diffusion_step_embed_dim=32, n_groups=G,
                              dtype=jnp.float32, batch_tile=B, interpret=True)
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    got = kunet.fused_unet1d_ddim_sample(mine, torch.from_numpy(g),
                                         torch.from_numpy(x0), ts, coefs,
                                         dtype=F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _program_against_twin(net, T, B=1, Dc=5, wide=False, f32=False):
    """The NumPy transcription of the program against the twin with fp64
    sums (the rounding twin for bf16), DDIM-2: the largest difference."""
    D = net.input_dim
    rng = np.random.default_rng(12)
    g = rng.normal(size=(B, Dc)).astype(np.float32)
    x0 = rng.normal(size=(B, T, D)).astype(np.float32)
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    twin = net if f32 else kunet.rounding_twin(net)
    twin64 = copy.deepcopy(twin).double()
    with torch.no_grad():
        want = dlib.sample_with_coefs(
            lambda x, t: twin64(x, t, torch.from_numpy(g).double()),
            torch.from_numpy(x0).double(), ts, coefs.double(), None, 1.0)
    if f32:
        got = tfk._f32_program(net, g.astype(np.float64), x0, ts, coefs)
    else:
        got = ttd._run_unet_program(twin, g.astype(np.float64), x0, ts, coefs,
                                    1.0, wide=wide)
    return np.abs(got - want.numpy()).max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_skip_as_wide_as_output_keeps_an_fp32_skip(dtype):
    """down_dims (32, 16, 16): the up block at level 1 reads [16 | 16] and
    writes 32 channels, so it has no projection and its residual is [h |
    skip] in fp32. The program marks that level's SAVE and CONCAT with an
    fp32 slot (and only that level), sizes it, and its transcription
    computes what the twin computes in both weight types."""
    dt = getattr(torch, dtype)
    net = ConditionalUnet1D(5, 5, 16, (32, 16, 16), 5, 4,
                            generator=torch.Generator().manual_seed(2))
    kunet.check_supported(net, 8, dt)
    prog = kunet.build_program(net, 8, 1, dtype=dt)
    saves = [r for r in prog["records"] if r[0] == kunet.SAVE]
    cats = [r for r in prog["records"] if r[0] == kunet.CONCAT]
    assert [r[4] for r in saves] == [1, 0] and [r[5] for r in cats] == [0, 1]
    assert prog["skip32_total"] == 4 * kunet.ld32(16)   # level 1: T 4
    assert prog["smem_bytes"] <= kunet.SMEM_LIMIT
    for wide in (False, True):
        assert kunet.build_program(net, 8, 1, wide, dt)["skip32_total"] == (
            prog["skip32_total"])
    err = _program_against_twin(net, 8, B=2, f32=dt == F32)
    assert err <= (1e-5 if dt == F32 else 1e-4)


@pytest.mark.parametrize("T", [160, 256])
def test_long_plan_runs_one_sample_a_block(T):
    """A plan past 128 rows: one sample a block, its 160 or 256 rows in the
    bf16 wide instance of 16 row tiles (the wrapper's ``rows_fit``; the
    ordinary mode's buffers do not fit at the Lift planner's widths), its
    operands in shared memory; its program's transcription matches the
    rounding twin (1e-4). The fp32 instances, which once refused it, plan
    it too: one sample a block inside the shared memory, its rows past the
    instance's walked in groups."""
    net = ConditionalUnet1D(5, 5, 32, (64, 128, 256), 5, 8,
                            generator=torch.Generator().manual_seed(3))
    kunet.check_supported(net, T)
    nb, prog = kunet.choose_tile(net, T, 64)
    assert nb == 1 and prog["wide"] and kunet.rows_fit(1, T, True)
    assert not prog.get("operands_global", False)
    assert not kunet.rows_fit(2, T, True)
    assert prog["smem_bytes"] <= kunet.SMEM_LIMIT
    assert kunet.build_program(net, T, 1)["smem_bytes"] > kunet.SMEM_LIMIT
    kunet.check_supported(net, T, F32)
    nb32, prog32 = kunet.choose_tile(net, T, 64, F32)
    assert nb32 == 1 and prog32["smem_bytes"] <= kunet.SMEM_LIMIT
    assert T > kunet.row_group(prog32["wide"], F32)
    if T == 160:
        assert _program_against_twin(net, T, wide=True) <= 1e-4


def test_wide_mode_past_32_rows():
    """The bf16 wide mode holds one sample of more than 32 rows (here 40 on
    the Lift planner widths, which the wrapper takes with ``nb=1,
    wide=True``): the program fits beside the ring and its transcription
    matches the rounding twin."""
    net = ConditionalUnet1D(5, 5, 32, (64, 128, 256), 5, 8,
                            generator=torch.Generator().manual_seed(4))
    assert kunet.rows_fit(1, 40, True) and not kunet.rows_fit(2, 40, True)
    # the fp32 wide instance holds 32 rows and walks more in groups
    assert kunet.rows_fit(1, 40, True, F32)
    assert not kunet.rows_fit(2, 40, True, F32)
    assert kunet.row_group(True, F32) == 32
    prog = kunet.build_program(net, 40, 1, True)
    assert prog["wide"] and not prog.get("operands_global", False)
    assert prog["smem_bytes"] <= kunet.SMEM_LIMIT
    assert _program_against_twin(net, 40, wide=True) <= 1e-4


def _window_copies(cin, rows_in, taps, n_groups, cap, offset):
    """The bf16 GEMM's staging loop (``csrc/unet1d.cuh``, ``gemm``) over a
    GEMM of ``cin`` input channels: runs of at most three tiles, cut where
    the ring's stage of three tiles ends (``offset`` tiles of it taken
    before); every run must lie in the window. Returns the copies made."""
    kt_per_tap = -(-cin // 32)
    wt = min(kt_per_tap, (cap // rows_in - 8) >> 5)
    assert wt >= 3 and rows_in * (32 * wt + 8) <= cap
    w0, copies, taken = -1, 0, offset
    for _ in range(n_groups * taps):
        kt = 0
        while kt < kt_per_tap:
            n = min(3 - taken % 3, 3, kt_per_tap - kt)
            taken += n
            if w0 < 0 or kt < w0 or kt + n > w0 + wt:
                w0, copies = kt, copies + 1
            assert w0 <= kt and kt + n <= w0 + wt
            kt += n
    return copies


@pytest.mark.parametrize("cap,most", [(8 * 8200, 1), (65424, 2 * 32 * 5),
                                      (8 * kunet.STAGED_LD, 32 * 5 * 86)])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_staging_window_covers_every_run(cap, most, offset):
    """The widest GEMM of the [1024,2048,4096] planner without downsampling
    (8 rows, an 8192-channel concat into 4096 columns, 5 taps): with the
    plan's window of the whole input the GEMM copies its input once, not
    once for each column group, tap and run of tiles; a window of 255 tiles
    (the room at 32 rows) copies at most twice a tap; the least window,
    three tiles a row, once a run."""
    copies = _window_copies(8192, 8, 5, 32, cap, offset)
    assert 1 <= copies <= most
    if cap == 8 * 8200:
        assert copies == 1


@pytest.mark.parametrize("T,downsample", [(8, False), (32, True)])
def test_bf16_operands_in_global_memory(T, downsample):
    """A [1024,2048,4096] planner, at 8 rows without downsampling (LDP-hier's
    topology) and at 32 rows with it: no tile holds its bf16 operand
    buffers beside the ring, so the plan is the wide mode with the operands
    in the scratch (``operands_global``) and a staging window in shared
    memory: the widest operand buffer where it fits beside a ring of
    ``STAGED_RING`` stages (one sample at 8 rows: every GEMM's input is
    copied once), else the room left (and at least ``STAGED_LD`` a row). A
    net that fits keeps its operands in shared memory."""
    with torch.device("meta"):
        big = ConditionalUnet1D(16, 16, 256, (1024, 2048, 4096), 5, 8,
                                downsample=downsample)
    kunet.check_supported(big, T)
    nb, prog = kunet.choose_tile(big, T, 4)
    assert prog["wide"] and prog["operands_global"] and nb == 1
    assert prog["smem_bytes"] <= kunet.SMEM_LIMIT
    floats = kunet._up(nb * T * 16 + 2 * nb * 8, 4)
    window = prog["stage_elems"]
    assert prog["smem_bytes"] == prog["stages"] * kunet.STAGE_BYTES + (
        4 * floats + 2 * (16 + window))
    room = (kunet.SMEM_LIMIT - kunet.STAGED_RING * kunet.STAGE_BYTES
            - 4 * floats) // 2 - 16
    assert window == max(nb * T * kunet.STAGED_LD,
                         min(prog["maxb"], room) & ~7)
    assert prog["stages"] >= kunet.STAGED_RING
    if not downsample:
        assert window == prog["maxb"]
    assert prog["scratch_bytes"] >= 4 * 2 * prog["max32"] + 2 * (
        2 * prog["maxb"] + prog["skip_total"])
    info = kunet.kernel_info(big, 256, T, 10)
    assert info["operands_global"] and info["stage_elems"] >= (
        info["samples_per_block"] * T * kunet.STAGED_LD)
    assert info["grid"] == -(-256 // info["samples_per_block"])
    with torch.device("meta"):
        small = ConditionalUnet1D(16, 16, 256, (256, 512, 1024), 5, 8)
    assert "operands_global" not in kunet.choose_tile(small, 16, 256)[1]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_plan_past_the_rows_of_an_instance(dtype):
    """A 320-step plan on the Lift planner's widths (down_dims (64, 128,
    256), 25 channels), refused once past 256 rows (bf16) and 128 (fp32):
    one sample a block, the rows past the instance's (``row_group``: 256 in
    bf16 and fp16, 128 in fp32, 32 in its wide mode) walked in groups; the
    plan fits the shared memory and the check takes it; several samples a
    block still stop at ``MAX_ROWS`` (``WIDE_MAX_ROWS`` wide)."""
    dt = getattr(torch, dtype)
    with torch.device("meta"):
        net = ConditionalUnet1D(25, 25, 32, (64, 128, 256), 5, 8)
    kunet.check_supported(net, 320, dt)
    nb, prog = kunet.choose_tile(net, 320, 64, dt)
    assert nb == 1 and prog["smem_bytes"] <= kunet.SMEM_LIMIT
    assert 320 > kunet.row_group(prog["wide"], dt)
    assert kunet.row_group(False, dt) == (256 if dt != F32 else 128)
    for wide in (False, True):
        assert kunet.rows_fit(1, 320, wide, dt)
        cap = kunet.WIDE_MAX_ROWS if wide else kunet.MAX_ROWS
        assert kunet.rows_fit(cap // 8, 8, wide, dt)
        assert not kunet.rows_fit(2, cap // 2 + 8, wide, dt)
    info = kunet.kernel_info(net, 16, 320, 10, dtype=dt)
    assert info["samples_per_block"] == 1 and info["grid"] == 16


def test_plan_past_256_rows_transcribed():
    """The bf16 program at 320 steps (its records, offsets and index maps;
    the row groups are the card's own) read as the kernel reads it matches
    the rounding twin with fp64 sums: 1e-4."""
    net = ConditionalUnet1D(5, 5, 32, (64, 128, 256), 5, 8,
                            generator=torch.Generator().manual_seed(5))
    assert _program_against_twin(net, 320, wide=True) <= 1e-4



def _smoke_shapes():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SHAPE_UNET, mod.ORDINARY_ROW_GROUPS


@pytest.mark.parametrize("key", ["B (8,16,32) T=288",
                                 "B (8,16,32) T=288 fp16",
                                 "B (32,16,16) T=160 fp32"])
def test_ordinary_mode_row_groups(key):
    """``chip_smoke.py``'s shapes that launch the ordinary mode's row-group
    instances (bf16 and fp16 past 256 rows, fp32 past 128, the buffers in
    shared memory): each plans one sample a block in the ordinary mode past
    its instance's rows, as the card's check requires; the bf16 program's
    transcription at 288 steps matches the rounding twin (1e-4)."""
    shapes, ordinary = _smoke_shapes()
    assert key in ordinary
    dd, down, B, T, wt, plan = shapes[key]
    dt = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": F32}[wt]
    net = ConditionalUnet1D(25, 25, 256, dd, 5, 8 if dd[0] > 32 else 4,
                            downsample=down,
                            generator=torch.Generator().manual_seed(3))
    kunet.check_supported(net, T, dt)
    info = kunet.kernel_info(net, B, T, 10, dtype=dt)
    assert plan is None and info["samples_per_block"] == 1
    assert not info["wide"] and T > kunet.row_group(False, dt)
    assert info["smem_bytes"] <= kunet.SMEM_LIMIT
    if wt == "bf16":
        assert _program_against_twin(net, T, Dc=25) <= 1e-4
