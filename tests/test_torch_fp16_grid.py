"""Kernel B's fp16 grid mode on the CPU: its work schedule and its choice
(``grid_schedule``, ``grid_fits``, ``choose_grid``, ``grid_plan`` in
``ops/kernels/diffusion_unet1d.py``, the arithmetic of ``grid_gemm`` in
``csrc/unet1d_grid.cuh``), and the fp16 rounding twin summed in the grid
mode's order against the twin summed in fp64.

At each of the default agents' six kernel-B calls (256 samples, DDPM-100)
every output element of every GEMM and its whole K range belong to exactly
one item, an item holds whole samples, no GroupNorm group spans two items'
columns, and each item's weight tiles are its column group's stripe of the
GEMM's tiles; the wrapper takes the grid mode where its cost in bytes is
below the ordinary mode's.
"""

import copy
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from latent_diffusion_planning_tpu_torch import configs
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    ConditionalUnet1D)
from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
from latent_diffusion_planning_tpu_torch.ops.kernels import (
    diffusion_unet1d as kunet)
from torch_thread import one_torch_thread  # noqa: F401

F16 = torch.float16
BAR = 1e-4


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def default_calls():
    smoke = _smoke()
    agents = smoke.default_agents(torch.device("cpu"))
    return {k: (net, T, B) for k, (_, net, _, T, B)
            in smoke.default_unets(agents).items()}


def _bench_planner():
    p = configs.BENCH_AGENT["planner"]
    return ConditionalUnet1D(25, 25, p["diffusion_step_embed_dim"],
                             tuple(p["down_dims"]), p["kernel_size"],
                             p["n_groups"],
                             generator=torch.Generator().manual_seed(3))


def test_grid_mode_is_chosen_where_its_bytes_are_fewer(default_calls):
    """The grid mode takes every default call at 256 samples; it fits the
    chunk IDM (1024 samples) and the bench planner too, but there the
    ordinary mode's blocks stream fewer bytes than the grid mode's phases
    cost (the card measured both slower in the grid mode), and bf16 and
    fp32 keep the ordinary mode."""
    assert len(default_calls) == 6
    for key, (net, T, B) in default_calls.items():
        assert kunet.grid_fits(net, B, T, F16), key
        grid = key != "B ldp_hier chunk IDM"
        assert kunet.choose_grid(net, T, B, F16) == grid, key
        assert (kunet.ordinary_bytes(net, B, T, F16)
                > kunet.grid_bytes(net, B, T)) == grid, key
        assert not kunet.choose_grid(net, T, B), key        # bf16
        assert not kunet.choose_grid(net, T, B, torch.float32), key
    net = _bench_planner()
    assert kunet.grid_fits(net, 1024, 8, F16)
    assert not kunet.choose_grid(net, 8, 1024, F16)


def test_grid_schedule_covers_each_output_and_k_once(default_calls):
    for key, (net, T, B) in default_calls.items():
        lay = kunet.layout(net, F16)["gemm"]
        for g in kunet.grid_schedule(net, B, T):
            cover = np.zeros((g["rows"], g["N"]), np.int32)
            first = lay[g["name"]]["tile_off"]
            n_tiles = lay[g["name"]]["n_tiles"]
            stripe = g["K"] // kunet.TILE_K
            seen_tiles = set()
            for i, it in enumerate(g["items"]):
                assert it["block"] == i % kunet.H100_SMS
                assert (it["k0"], it["k1"]) == (0, g["K"])
                # whole samples
                assert it["r0"] % g["length"] == 0
                assert it["rows"] % g["length"] == 0
                cover[it["r0"]:it["r0"] + it["rows"],
                      it["c0"]:it["c0"] + it["cols"]] += 1
                lo, hi = it["tiles"]
                assert hi - lo == stripe
                assert first <= lo and hi <= first + n_tiles
                assert lo == first + it["c0"] // kunet.TILE_N * stripe
                seen_tiles.add(lo)
            assert (cover == 1).all(), (key, g["name"])
            assert len(seen_tiles) == -(-g["N"] // kunet.TILE_N)


def test_no_group_spans_two_items(default_calls):
    for key, (net, T, B) in default_calls.items():
        for g in kunet.grid_schedule(net, B, T):
            c = g["gn_channels"]
            if not c:
                continue
            assert g["N"] == c * net.n_groups
            for it in g["items"]:
                assert it["c0"] % c == 0, (key, g["name"])
                assert it["cols"] % c == 0, (key, g["name"])


def test_grid_plan_buffers_are_disjoint(default_calls):
    for key, (net, T, B) in default_calls.items():
        plan = kunet.grid_plan(net, B, T)
        prog = plan["program"]
        o = plan["offsets"]
        sizes = {"x32": 4 * prog["max32"], "y32": 4 * prog["max32"],
                 "xb": 2 * prog["maxb"], "yb": 2 * prog["maxb"],
                 "skip": 2 * prog["skip_total"] + 4 * prog["skip32_total"],
                 "xcur": 4 * B * T * net.input_dim,
                 "stats": 8 * B * net.n_groups, "bar": 8}
        spans = sorted((o[k], o[k] + n) for k, n in sizes.items())
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), key
        assert spans[-1][1] <= plan["scratch_bytes"]
        assert all(v % 256 == 0 for v in o.values())
        assert 32 + 4 * kunet.GRID_STAT_FLOATS + plan["space"] \
            <= kunet.SMEM_LIMIT
        # the launch's table, which the kernel runs as it stands: every
        # GEMM's input fits the window whole, beside a ring of 2 to 8
        # stages, in passes of whole samples, and the host side's checks
        # (unet1d_sample_grid) pass
        dims = kunet.grid_dims(net, B, T)
        table = kunet.grid_table(net, B, T)
        sched = kunet.grid_schedule(net, B, T)
        assert dims[:3] == [plan["blocks"], plan["smem_bytes"],
                            plan["space"]]
        assert dims[11] == len(table) == len(sched)
        assert len(dims) == 12 + 4 * len(table)
        assert len(table) <= kunet.GRID_MAX_GEMMS
        assert [tuple(dims[12 + 4 * i:16 + 4 * i])
                for i in range(len(table))] == table
        for g, (item_rows, rows, stages, win) in zip(sched, table):
            assert item_rows == g["item_rows"], g["name"]
            assert 2 <= stages <= kunet.MAX_STAGES, g["name"]
            assert rows % g["length"] == 0 and item_rows % rows == 0
            assert item_rows <= kunet.GRID_ROWS and win % 128 == 0
            # a narrow GEMM's items fill the grid in one wave
            assert len(g["items"]) <= kunet.H100_SMS or \
                item_rows == kunet.GRID_ROWS
            rows_in = rows // g["length"] * g["length_in"]
            assert win >= 2 * rows_in * (g["cin_pad"] + 8)
            assert win + stages * kunet.stage_bytes(F16) <= plan["space"]


def _chunks(taps, cin):
    """(tap, first channel, end channel) of each partial sum an item adds,
    in order: the tiles of a tap in runs that end at a tap's end or at a
    ring stage's end (3 tiles from the stripe's start)."""
    kpt = -(-cin // kunet.TILE_K)
    out, f = [], 0
    for tap in range(taps):
        kt = 0
        while kt < kpt:
            n = min(kunet.STAGE_TILES - f % kunet.STAGE_TILES, kpt - kt)
            out.append((tap, 32 * kt, min(cin, 32 * (kt + n))))
            kt += n
            f += n
    return out


def _grid_order_forward(final, m, x):
    """A conv of the fp16 twin summed as a grid-mode item sums it: from its
    bias, one partial sum of products a chunk (``_chunks``, taps in the
    kernel's order: a transpose conv's are flipped). The final 1x1 conv
    reads its fp32 input as fp16 hi + lo in two passes, the lo products
    summed from zero and added last."""
    transpose = isinstance(m, torch.nn.ConvTranspose1d)
    k = m.kernel_size[0]
    cin = m.in_channels
    fn = F.conv_transpose1d if transpose else F.conv1d

    def passes(inp):
        acc = None
        for tap, a, b in _chunks(k, cin):
            j = k - 1 - tap if transpose else tap
            w = torch.zeros_like(m.weight)
            if transpose:
                w[a:b, :, j] = m.weight[a:b, :, j]
            else:
                w[:, a:b, j] = m.weight[:, a:b, j]
            part = fn(inp, w, None, m.stride, m.padding)
            acc = part if acc is None else acc + part
        return acc

    if final:
        hi = x.to(F16).to(x.dtype)
        lo = torch.where(torch.isfinite(hi), x - hi, 0).to(F16).to(x.dtype)
        return (passes(lo) + (m.bias[:, None] + passes(hi)))
    return m.bias[:, None] + passes(x)


def grid_order_twin(net):
    """``rounding_twin(net, float16)`` with every conv summed in the grid
    mode's order."""
    twin = copy.deepcopy(kunet.rounding_twin(net, F16))
    for m in twin.modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            m.forward = functools.partial(_grid_order_forward,
                                          m is twin.final_conv, m)
    return twin


def test_grid_order_conv_sums_the_conv():
    """At widths of several K tiles a tap (128, 256, 256: no output of the
    downsample rounded), each conv of the grid-order twin (a same conv, the
    stride-2 downsample, the transpose upsample, a 1x1 projection) sums
    what the plain twin's does, to fp32 rounding of its largest output."""
    net = ConditionalUnet1D(5, 5, 32, (128, 256, 256), 5, 8,
                            generator=torch.Generator().manual_seed(3))
    twin, plain = grid_order_twin(net), kunet.rounding_twin(net, F16)
    gen = torch.Generator().manual_seed(1)
    for get, cin in ((lambda n: n.blocks[1].block0.conv, 128),
                     (lambda n: n.downs[0], 128), (lambda n: n.ups[0], 256),
                     (lambda n: n.blocks[2].proj, 128)):
        x = torch.randn(4, cin, 8, generator=gen)
        with torch.no_grad():
            a, b = get(twin)(x), get(plain)(x)
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_fp16_twin_in_grid_order_is_the_same_function():
    """The fp16 rounding twin summed in the grid mode's order against the
    twin summed in fp64, on the net and draws of
    ``test_fp16_twin_with_fp64_sums_is_the_same_function`` and to its bar:
    mean within 1e-4, no element beyond 2e-3."""
    net = ConditionalUnet1D(5, 5, 32, (8, 16, 32), 5, 4,
                            generator=torch.Generator().manual_seed(3))
    twin = grid_order_twin(net)
    twin64 = kunet.rounding_twin(net, F16).double()
    rng = np.random.default_rng(6)
    g = rng.normal(size=(8, 5))
    x0 = rng.normal(size=(8, 8, 5))
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    with torch.no_grad():
        got = dlib.sample_with_coefs(
            lambda x, t: twin(x, t, torch.from_numpy(g).float()),
            torch.from_numpy(x0).float(), ts, coefs, None, 1.0).numpy()
        want = dlib.sample_with_coefs(
            lambda x, t: twin64(x, t, torch.from_numpy(g)),
            torch.from_numpy(x0), ts, coefs.double(), None, 1.0).numpy()
    err = np.abs(got - want)
    print(f"fp16 twin in the grid mode's order against fp64 sums: mean "
          f"{err.mean():.2e}, max {err.max():.2e}")
    assert err.mean() <= BAR and err.max() <= 2e-3
