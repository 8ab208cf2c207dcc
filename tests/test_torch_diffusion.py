"""The port's schedules, samplers and kernel twins vs the JAX package.

Coefficient tables are fp32 arithmetic on the same Python-float betas:
atol 1e-6, plus rtol 1e-5 because XLA's cumprod multiplies in another order
than torch's (a few ulps on alphas_cumprod, which c1 = 1/sqrt(abar) turns
into 4e-6 at c1 ≈ 1e3). Samplers get the JAX draws (initial sample and per-step noise,
made with the same ``jax.random`` splits as ``dlib.sample_ddim`` /
``sample_ddpm``) and are held at atol 2e-4, the JAX package's own
kernel-vs-scan bar (``tests/test_pallas_sampler.py``). The kernel twins are
held against the JAX scan samplers, which the JAX package holds its
kernels against.
"""

import copy

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

SAMPLER_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("train,inf", [(50, 10), (12, 4), (100, 25)])
def test_coef_tables_match_jax(train, inf):
    js = jdlib.DiffusionSchedule.create(train, "squaredcos_cap_v2")
    ts = dlib.DiffusionSchedule.create(train, "squaredcos_cap_v2")
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(),
                               np.asarray(js.alphas_cumprod), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_array_equal(dlib.ddim_timesteps(train, inf).numpy(),
                                  np.asarray(jdlib.ddim_timesteps(train, inf)))
    # the port's (T, 6) ε tables are JAX's (T, 5) ones and a column of
    # ones (cx, the x_t factor of the x0 rule)
    for mine, ref in ((dlib.ddim_coef_table(ts, inf),
                       jdlib.ddim_coef_table(js, inf)),
                      (dlib.ddpm_coef_table(ts), jdlib.ddpm_coef_table(js))):
        np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(mine[1][:, :5].numpy(), np.asarray(ref[1]),
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_array_equal(mine[1][:, 5].numpy(), 1.0)


def _jax_draws(key, shape, n_steps):
    """The initial sample and per-step noise that jdlib's samplers draw."""
    rng, init_rng = jax.random.split(key)
    x0 = jax.random.normal(init_rng, shape, jnp.float32)
    noise = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(
        jax.random.split(rng, n_steps))
    return np.array(x0), np.array(noise)


def _idm(N=16, A=7, S=20):
    net = MLPDiffusion(out_dim=A, n_blocks=2, hidden_dim=32, time_dim=16)
    s = np.random.default_rng(3).normal(size=(N, S)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), s[:2], np.zeros((2, A)),
                      np.zeros((2, 1), np.int32))["params"]
    mine = bridge.mlp_diffusion_from_flax(_np(params), s_dim=S, out_dim=A,
                                          n_blocks=2, hidden_dim=32,
                                          time_dim=16)
    return net, params, mine, s


@pytest.mark.parametrize("mode", ["ddim", "ddpm"])
def test_idm_samplers_match_jax(mode):
    """Plain loops and kernel A's twin, both against the JAX scan."""
    net, params, mine, s = _idm()
    N, A = s.shape[0], 7
    sched_j = jdlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    sched_t = dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    key = jax.random.PRNGKey(42)
    denoise_j = lambda a, t: net.apply({"params": params}, s, a, t)
    st = torch.from_numpy(s)
    denoise_t = lambda a, t: mine(st, a, t)
    if mode == "ddim":
        ref = jdlib.sample_ddim(sched_j, denoise_j, key, (N, A), 4)
        x0, _ = _jax_draws(key, (N, A), 4)
        with torch.no_grad():
            loop = dlib.sample_ddim(sched_t, denoise_t, torch.from_numpy(x0), 4)
        ts, coefs = dlib.ddim_coef_table(sched_t, 4)
        noise = None
    else:
        ref = jdlib.sample_ddpm(sched_j, denoise_j, key, (N, A))
        x0, noise = _jax_draws(key, (N, A), 12)
        noise = torch.from_numpy(noise)
        with torch.no_grad():
            loop = dlib.sample_ddpm(sched_t, denoise_t, torch.from_numpy(x0),
                                    noise)
        ts, coefs = dlib.ddpm_coef_table(sched_t)
    twin = kmlp.fused_mlp_diffusion_sample(mine, st, torch.from_numpy(x0), ts,
                                           coefs, noise)
    np.testing.assert_allclose(loop.numpy(), np.asarray(ref),
                               atol=SAMPLER_ATOL, rtol=0)
    np.testing.assert_allclose(twin.numpy(), np.asarray(ref),
                               atol=SAMPLER_ATOL, rtol=0)


def test_unet_ddim_samplers_match_jax():
    """Plain DDIM loop and kernel B's twin against the JAX scan."""
    B, T, D, Dc = 4, 8, 5, 5
    net = ConditionalUnet1D(input_dim=D, global_cond_dim=Dc,
                            diffusion_step_embed_dim=32, down_dims=(8, 16, 32),
                            kernel_size=5, n_groups=4)
    g = np.random.default_rng(4).normal(size=(B, Dc)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), np.zeros((2, T, D)),
                      np.zeros((2,), np.int32), np.zeros((2, Dc)))["params"]
    mine = bridge.unet1d_from_flax(_np(params), input_dim=D, global_cond_dim=Dc,
                                   diffusion_step_embed_dim=32,
                                   down_dims=(8, 16, 32), n_groups=4)
    sched_j = jdlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    sched_t = dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    key = jax.random.PRNGKey(7)
    ref = jdlib.sample_ddim(sched_j,
                            lambda x, t: net.apply({"params": params}, x, t, g),
                            key, (B, T, D), 4)
    x0, _ = _jax_draws(key, (B, T, D), 4)
    gt = torch.from_numpy(g)
    with torch.no_grad():
        loop = dlib.sample_ddim(sched_t, lambda x, t: mine(x, t, gt),
                                torch.from_numpy(x0), 4)
    ts, coefs = dlib.ddim_coef_table(sched_t, 4)
    twin = kunet.fused_unet1d_ddim_sample(mine, gt, torch.from_numpy(x0), ts,
                                          coefs)
    np.testing.assert_allclose(loop.numpy(), np.asarray(ref),
                               atol=SAMPLER_ATOL, rtol=0)
    np.testing.assert_allclose(twin.numpy(), np.asarray(ref),
                               atol=SAMPLER_ATOL, rtol=0)


PAD_DIMS = dict(bench=(256, (64, 128, 256), 8), padded=(64, (24, 40), 8))


def _bf16(a):
    """Round a NumPy array through bf16 (what the kernel's operands are)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).double().numpy()


@pytest.mark.parametrize("case", sorted(PAD_DIMS))
def test_unet_packing_round_trips(case):
    """Un-tiling ``pack_params(net)`` gives back every weight, bf16-rounded,
    and zeros in all padding (K to taps × pad32(Cin), N to 128, streams to
    whole ring stages), at the bench widths and at widths that need padding
    (D = 25 in and out, cond 281, down_dims (24, 40))."""
    dsed, dd, G = PAD_DIMS[case]
    torch.manual_seed(1)
    net = kunet.ConditionalUnet1D(25, 25, dsed, dd, 5, G)
    lay = kunet.layout(net)
    packed = kunet.pack_params(net)
    assert packed.dtype == torch.bfloat16 and packed.numel() == lay["numel"]
    flat = packed.float()
    vec = flat[lay["vec_base"]:]
    covered = torch.zeros(lay["vec_base"] // kunet.TILE, dtype=torch.bool)
    n_vec = 0
    for stream, gemms in kunet._gemms(net).items():
        base = lay["stream"][stream]["tile_base"]
        for name, w, vecs in gemms:
            g = lay["gemm"][name]
            taps, cin, cout = w.shape
            lo = (base + g["tile_off"]) * kunet.TILE
            got = kunet.untile_matrix(flat[lo:lo + g["n_tiles"] * kunet.TILE],
                                      taps * kunet._up(cin, 32), cout)
            got = got.reshape(taps, kunet._up(cin, 32), -1)
            want = w.detach().to(torch.bfloat16).float()
            assert torch.equal(got[:, :cin, :cout], want), name
            assert not got[:, cin:].any() and not got[:, :, cout:].any(), name
            assert not covered[base + g["tile_off"]:
                               base + g["tile_off"] + g["n_tiles"]].any()
            covered[base + g["tile_off"]:
                    base + g["tile_off"] + g["n_tiles"]] = True
            if vecs:
                o = g["vec_off"]
                np_ = kunet._up(cout, kunet.TILE_N)
                want = [v.detach().to(torch.bfloat16).float() for v in vecs]
                assert torch.equal(vec[o:o + cout], want[0]), name
                assert not vec[o + cout:o + np_].any(), name
                o += np_
                for v in want[1:]:
                    assert torch.equal(vec[o:o + v.numel()], v), name
                    o += v.numel()
                n_vec += o - g["vec_off"]
    assert n_vec == lay["n_vec"] == vec.numel()
    # what no GEMM covers is the zero padding of each stream's last stage
    pad = flat[:lay["vec_base"]].reshape(-1, kunet.TILE)[~covered]
    assert not pad.any()
    assert (~covered).sum() < 3 * kunet.STAGE_TILES
    for st in lay["stream"].values():
        assert st["tile_base"] % kunet.STAGE_TILES == 0


def _program_tiles(net, prog):
    """(tile offset, GEMM name) of every GEMM the records run, in order."""
    out = []
    n = 0
    for r in prog["records"]:
        if r[0] == kunet.FILM:
            out += [(r[4], f"conv1.{n}"), (r[5], f"conv2.{n}")]
            if r[7] >= 0:
                out.append((r[7], f"proj.{n}"))
            n += 1
        elif r[0] in (kunet.DOWN, kunet.UP):
            out.append((r[3], None))
        elif r[0] in (kunet.FINAL_BLOCK, kunet.FINAL_CONV):
            out.append((r[4], None))
    return out


def _assert_program_covers_every_weight(mine, T, nb):
    prog = kunet.build_program(mine, T, nb)
    lay = kunet.layout(mine)
    kinds = [r[0] for r in prog["records"]]
    assert kinds.count(kunet.FILM) == len(mine.blocks)
    n_resample = len(mine.down_dims) - 1 if mine.downsample else 0
    assert kinds.count(kunet.DOWN) == kinds.count(kunet.UP) == n_resample
    main = [g for g in lay["gemm"].values() if g["stream"] == "main"]
    starts = [g["tile_off"] for g in main]
    used = _program_tiles(mine, prog)
    assert [o for o, _ in used] == starts       # each once, in stream order
    for o, name in used:
        if name is not None:
            assert lay["gemm"][name]["tile_off"] == o
    # contiguous: each GEMM starts where the one before it ends
    ends = [g["tile_off"] + g["n_tiles"] for g in main]
    assert starts == [0] + ends[:-1]
    assert ends[-1] == lay["stream"]["main"]["n_tiles"]
    assert lay["numel"] == kunet.pack_params(mine).numel()
    # FiLM columns: every block's 2·ch slice of the hoisted projection, once
    foffs = [r[6] for r in prog["records"] if r[0] == kunet.FILM]
    widths = [2 * r[2] for r in prog["records"] if r[0] == kunet.FILM]
    assert foffs == [sum(widths[:i]) for i in range(len(widths))]
    assert sum(widths) == lay["film_total"]
    return prog


def test_unet_kernel_program_covers_every_weight():
    """The kernel's op program reads each GEMM of the main stream exactly
    once, in the order the stream holds them (the kernel never seeks: it
    consumes tiles in order), checked on the CPU: no card needed."""
    mine = bridge.ConditionalUnet1D(25, 25, 64, (16, 32, 64), 5, 8)
    _assert_program_covers_every_weight(mine, 8, 4)


@pytest.mark.parametrize("dd,k,T", [((64, 128, 256), 5, 2),
                                    ((64, 128), 3, 4)])
def test_unet_kernel_program_covers_every_weight_without_downsampling(
        dd, k, T):
    """LDP-hier's planner and chunk IDM at the recipe's widths: no DOWN or
    UP record, every record at the full length, a skip slot of the full
    length per level, and the same once-in-order reading of the stream.
    A net that downsamples and one that does not, at equal widths, get
    different layouts and programs (the caches key on the flag)."""
    D, Dc = (25, 25) if T == 2 else (7, 50)
    mine = kunet.ConditionalUnet1D(D, Dc, 256, dd, k, 8, False)
    nb, _ = kunet.choose_tile(mine, T, 1024)
    prog = _assert_program_covers_every_weight(mine, T, nb)
    lens = {r[3] for r in prog["records"] if r[0] in (kunet.FILM,
                                                      kunet.FINAL_BLOCK,
                                                      kunet.FINAL_CONV)}
    lens |= {r[3] for r in prog["records"] if r[0] == kunet.SAVE}
    lens |= {r[4] for r in prog["records"] if r[0] == kunet.CONCAT}
    assert lens == {T}
    assert prog["skip_total"] == nb * T * sum(kunet.ldb(c) for c in dd[1:])
    kunet.check_supported(mine, T + 1)      # any length: no stride
    down = kunet.ConditionalUnet1D(D, Dc, 256, dd, k, 8, True)
    assert kunet.layout(down)["numel"] > kunet.layout(mine)["numel"]
    assert (kunet.build_program(down, 8, 1)["records"]
            != kunet.build_program(mine, 8, 1)["records"])


# the bench planner's program (8 samples a block, T 8) and a SHA-256 of its
# packed buffer on numpy-drawn weights (seed 2024, N(0, 0.1²)), recorded
# before kernel B learned nets that do not downsample: a downsampling net's
# records and packed layout must not move by a bit
BENCH_PLANNER_RECORDS = [
    [0, 25, 64, 8, 0, 5, 0, 15, 0, 256, 512, 0],
    [0, 64, 64, 8, 16, 26, 128, -1, 640, 896, 0, 0],
    [3, 64, 8, 36, 1152, 0, 0, 0, 0, 0, 0, 0],
    [0, 64, 128, 4, 42, 52, 256, 72, 1280, 1664, 2048, 0],
    [0, 128, 128, 4, 74, 94, 512, -1, 2176, 2560, 0, 0],
    [1, 0, 128, 4, 0, 0, 0, 0, 0, 0, 0, 0],
    [3, 128, 4, 114, 2944, 0, 0, 0, 0, 0, 0, 0],
    [0, 128, 256, 2, 126, 166, 768, 246, 3072, 3840, 4608, 0],
    [0, 256, 256, 2, 254, 334, 1280, -1, 4864, 5632, 0, 0],
    [1, 4352, 256, 2, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 256, 256, 2, 414, 494, 1792, -1, 6400, 7168, 0, 0],
    [0, 256, 256, 2, 574, 654, 2304, -1, 7936, 8704, 0, 0],
    [2, 4352, 256, 256, 2, 0, 0, 0, 0, 0, 0, 0],
    [0, 512, 128, 2, 734, 814, 2816, 834, 9472, 9856, 10240, 0],
    [0, 128, 128, 2, 850, 870, 3072, -1, 10368, 10752, 0, 0],
    [4, 128, 2, 890, 11136, 0, 0, 0, 0, 0, 0, 0],
    [2, 0, 128, 128, 4, 0, 0, 0, 0, 0, 0, 0],
    [0, 256, 64, 4, 906, 946, 3328, 956, 11264, 11520, 11776, 0],
    [0, 64, 64, 4, 964, 974, 3456, -1, 11904, 12160, 0, 0],
    [4, 64, 4, 984, 12416, 0, 0, 0, 0, 0, 0, 0],
    [5, 64, 64, 8, 992, 12544, 0, 0, 0, 0, 0, 0],
    [6, 64, 25, 8, 1002, 12800, 0, 0, 0, 0, 0, 0]]
BENCH_PLANNER_PACK_SHA256 = (
    "ad844c3fadac745f82d1347658f1694c922f91ebd4988fd1623105d4b594bec5")


def test_bench_planner_program_and_pack_are_pinned():
    import hashlib
    net = kunet.ConditionalUnet1D(25, 25, 256, (64, 128, 256), 5, 8)
    rng = np.random.default_rng(2024)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(
                rng.normal(size=tuple(p.shape)).astype(np.float32) * 0.1))
    prog = kunet.build_program(net, 8, 8)
    assert prog["records"] == BENCH_PLANNER_RECORDS
    assert (prog["max32"], prog["maxb"], prog["skip_total"], prog["stages"],
            prog["smem_bytes"]) == (4608, 8448, 8576, 5, 217632)
    assert kunet.choose_tile(net, 8, 1024)[0] == 8
    packed = kunet.pack_params(net)
    assert packed.numel() == kunet.layout(net)["numel"] == 5707136
    digest = hashlib.sha256(packed.view(torch.int16).numpy().tobytes())
    assert digest.hexdigest() == BENCH_PLANNER_PACK_SHA256


def _run_unet_program(net, gcond, x, ts, coefs, clip, noise=None,
                      wide=False):
    """A NumPy transcription of csrc/diffusion_unet1d.cu's data path (one
    tile holding every sample): the packed tiles are consumed strictly in
    order through a cursor, as the kernel's ring delivers them; every GEMM
    operand is rounded to bf16 where the kernel rounds it; the time MLP and
    FiLM are hoisted into a prologue as in the kernel. So the records,
    offsets, tiling and conv index maps the card runs are checked here.
    ``noise`` (S, B, T, D) adds DDPM's per-step term as the kernel does
    (row r of the tile, channel c reads ``noise[step][r // T][r % T][c]``);
    ``wide`` runs the program of the kernel's wide mode."""
    B, T, D = x.shape
    nb = B
    prog = kunet.build_program(net, T, nb, wide)
    lay = kunet.layout(net)
    flat = kunet.pack_params(net).float()
    V = flat[lay["vec_base"]:].double().numpy()
    K, G, d = net.kernel_size, net.n_groups, net.dsed
    mish = lambda v: v * np.tanh(np.logaddexp(v, 0.0))
    up32 = lambda c: kunet._up(c, 32)
    upn = lambda c: kunet._up(c, kunet.TILE_N)

    class Cursor:
        def __init__(self, stream):
            self.base = lay["stream"][stream]["tile_base"]
            self.pos = 0

        def gemm(self, taps, cin, cout):
            """The next GEMM's weights: (taps, pad32(cin), pad128(cout))."""
            n = taps * up32(cin) // 32 * (upn(cout) // kunet.TILE_N)
            lo = (self.base + self.pos) * kunet.TILE
            self.pos += n
            w = kunet.untile_matrix(flat[lo:lo + n * kunet.TILE],
                                    taps * up32(cin), cout)
            return w.double().numpy().reshape(taps, up32(cin), upn(cout))

    def conv(cur, inp, cin, tin, cout, tout, voff, k, mode, rows=None):
        """inp: bf16-rounded operand rows (n, cin)."""
        w = cur.gemm(k, cin, cout)[:, :cin, :cout]
        n_rows = nb * tout if rows is None else rows
        bias = V[voff:voff + cout] if voff is not None else np.zeros(cout)
        out = np.tile(bias, (n_rows, 1))
        for r in range(n_rows):
            b, t = divmod(r, tout)
            for j in range(k):
                if mode == "same":
                    s = t + j - k // 2
                    ok = 0 <= s < tin
                elif mode == "down":
                    s = 2 * t + j
                    ok = s < tin
                else:
                    s = t + j - 2
                    ok = s >= 0 and s % 2 == 0
                    s //= 2
                    ok = ok and s < tin
                if ok:
                    out[r] += inp[b * tin + s] @ w[j]
        return out

    def gn_mish(v, c, tl, voff, film=None):
        cg = c // G
        y = v.reshape(nb, tl, G, cg)
        mu = y.mean((1, 3), keepdims=True)
        var = ((y - mu) ** 2).mean((1, 3), keepdims=True)
        y = ((y - mu) / np.sqrt(var + 1e-6)).reshape(nb * tl, c)
        o = voff + upn(c)
        y = mish(y * V[o:o + c] + V[o + c:o + 2 * c])
        if film is not None:
            f = np.repeat(film, tl, axis=0)
            y = f[:, :c] * y + f[:, c:]
        return y

    # ---- prologue: what does not depend on the sample, or on the step ----
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / (half - 1))
    gm = lay["gemm"]
    FT = lay["film_total"]
    film_t = []
    for t in ts.tolist():
        cur = Cursor("time")
        emb = _bf16(np.concatenate([np.sin(t * freqs), np.cos(t * freqs)]))[None]
        hid = _bf16(mish(conv(cur, emb, d, 1, 4 * d, 1, gm["time0"]["vec_off"],
                              1, "same", rows=1)))
        temb = _bf16(mish(conv(cur, hid, 4 * d, 1, d, 1,
                               gm["time1"]["vec_off"], 1, "same", rows=1)))
        film_t.append(conv(cur, temb, d, 1, FT, 1, gm["film_t"]["vec_off"], 1,
                           "same", rows=1)[0])
        assert cur.pos == lay["stream"]["time"]["n_tiles"]
    # the condition half, in chunks of COND_CHUNK channels as the stream
    # holds it
    cur = Cursor("cond")
    film_g = 0.0
    for c0 in range(0, gcond.shape[1], kunet.COND_CHUNK):
        part = gcond[:, c0:c0 + kunet.COND_CHUNK]
        film_g = film_g + conv(cur, _bf16(mish(part)), part.shape[1], 1, FT,
                               1, None, 1, "same", rows=nb)
    assert cur.pos == lay["stream"]["cond"]["n_tiles"]

    # ---- the steps ----
    xcur = x.reshape(nb * T, D).astype(np.float64)
    skip, skip32 = {}, {}
    for step in range(len(film_t)):
        cur = Cursor("main")
        h = xcur.copy()
        for rec in prog["records"]:
            kind = rec[0]
            assert kind in (kunet.SAVE, kunet.CONCAT) or cur.pos == (
                rec[3] if kind in (kunet.DOWN, kunet.UP) else rec[4])
            if kind == kunet.FILM:
                cin, ch, tl = rec[1:4]
                fo = rec[6]
                film = film_t[step][fo:fo + 2 * ch] + film_g[:, fo:fo + 2 * ch]
                hb = _bf16(h)
                y = conv(cur, hb, cin, tl, ch, tl, rec[8], K, "same")
                y = _bf16(gn_mish(y, ch, tl, rec[8], film))
                assert cur.pos == rec[5]
                z = conv(cur, y, ch, tl, ch, tl, rec[9], K, "same")
                z = gn_mish(z, ch, tl, rec[9])
                if rec[7] >= 0:
                    assert cur.pos == rec[7]
                    h = z + conv(cur, hb, cin, tl, ch, tl, rec[10], 1, "same")
                else:
                    h = z + h
            elif kind == kunet.SAVE:
                skip[rec[1]] = _bf16(h)
                if rec[4]:      # the fp32 copy an up block's residual reads
                    skip32[rec[5]] = h.copy()
            elif kind == kunet.CONCAT:
                # [h | skip] in fp32 where the up block's residual reads it,
                # else its bf16 operand (the proj conv reads only that)
                h = (np.concatenate([h, skip32[rec[6]]], 1) if rec[5]
                     else np.concatenate([_bf16(h), skip[rec[1]]], 1))
            elif kind == kunet.DOWN:
                h = conv(cur, _bf16(h), rec[1], rec[2], rec[1], rec[2] // 2,
                         rec[4], 3, "down")
            elif kind == kunet.UP:
                h = conv(cur, _bf16(h), rec[1], rec[2], rec[1], 2 * rec[2],
                         rec[4], 4, "up")
            elif kind == kunet.FINAL_BLOCK:
                cin, ch, tl = rec[1:4]
                h = gn_mish(conv(cur, _bf16(h), cin, tl, ch, tl, rec[5], K,
                                 "same"), ch, tl, rec[5])
            else:
                h = conv(cur, _bf16(h), rec[1], rec[3], rec[2], rec[3], rec[5],
                         1, "same")
        assert cur.pos == lay["stream"]["main"]["n_tiles"]
        c = coefs[step].tolist()
        x0 = np.clip(c[0] * (c[5] * xcur - c[1] * h), -clip, clip)
        xcur = c[2] * x0 + c[3] * xcur
        if noise is not None:
            xcur = xcur + c[4] * np.asarray(noise[step], np.float64).reshape(
                nb * T, D)
    return xcur.reshape(B, T, D)


UNET_PROGRAM_CASES = [
    ((8, 16, 32), 4, 6, 8, 5, True, "dd0-4"),
    ((24, 40), 8, 6, 8, 5, True, "dd1-8"),
    # DP's condition is 1033 wide: several 32-row K tiles of the condition
    # half, the last one ragged (Dc 75 pads to 96: two full tiles and 11 of
    # 32 rows; with the 16-wide step embedding the FiLM input is 91 wide)
    ((8, 16), 4, 75, 8, 5, True, "wide-ragged-cond"),
    # LDP-hier's nets do not downsample: its planner's 2-long plans under
    # 5 taps (the SAME conv's zero rows on both sides of every sample) and
    # its chunk IDM's 4-long chunks under 3 taps
    ((8, 16, 32), 4, 6, 2, 5, False, "no-downsample-T2-k5"),
    ((8, 16), 4, 10, 4, 3, False, "no-downsample-T4-k3")]


@pytest.mark.parametrize("dd,G,Dc,T,k,down,torch_init", [
    pytest.param(*case[:-1], torch_init, id=case[-1] + suffix)
    for torch_init, suffix in ((False, ""), (True, "-torch-init"))
    for case in UNET_PROGRAM_CASES])
def test_unet_kernel_program_matches_twin(dd, G, Dc, T, k, down, torch_init):
    """Kernel B's record program and tiled weights, run by the NumPy
    transcription of its data path (bf16 operands, hoisted FiLM), compute
    what the rounding twin computes, on the port's own weights (Flax's
    init) and on torch's default draws (``-torch-init``), whose nonzero
    biases exercise the bias paths that Flax's zero biases leave idle.

    The twin runs here with fp64 sums, as the transcription does: a bf16
    product is exact in fp64, so neither side's summation order shows. With
    fp32 sums the twin flips a bf16 rounding wherever a value lies within
    fp32 rounding of a tie, and on Flax's init such flips carry the output
    past 1e-4 (dd1-8). atol 1e-4."""
    B, D = 3, 5
    net = kunet.ConditionalUnet1D(D, Dc, 16, dd, k, G, down,
                                  generator=torch.Generator().manual_seed(0))
    if torch_init:
        torch.manual_seed(0)
        for m in net.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters()
    net = kunet.rounding_twin(net)
    rng = np.random.default_rng(5)
    g = rng.normal(size=(B, Dc)).astype(np.float32)
    x0 = rng.normal(size=(B, T, D)).astype(np.float32)
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 4)
    twin64 = copy.deepcopy(net).double()
    g64 = torch.from_numpy(g).double()
    with torch.no_grad():
        twin = dlib.sample_with_coefs(
            lambda x, t: twin64(x, t, g64), torch.from_numpy(x0).double(),
            ts, coefs.double(), None, 1.0)
    got = _run_unet_program(net, g.astype(np.float64), x0, ts, coefs, 1.0)
    np.testing.assert_allclose(got, twin.numpy(), atol=1e-4, rtol=0)


def test_unet_rounding_twin_matches_jax_bf16_kernel():
    """The rounding twin (bf16 weights, bf16 conv and dense inputs, fp32
    elsewhere) against the JAX Pallas kernel itself, run with
    ``dtype=bfloat16`` in interpret mode, on the same numpy-seeded inputs and
    the same initial draw.

    The bar is 5e-3, the JAX package's own bar for its fused path
    (``tests/test_pallas_sampler.py``), held on the mean error. It cannot be
    held element by element: a function that rounds its activations to bf16
    is discontinuous, so wherever a value sits near a rounding boundary two
    summation orders round it apart, and a sampler amplifies that (the JAX
    kernel's own bf16 and fp32 runs differ by 3.6e-2 at most here). The two
    also differ by design in two places: the JAX kernel pools its GroupNorm
    statistics through bf16 products and keeps its last 1×1 conv's input in
    fp32. So, beside the mean: no element beyond 0.1, and the twin must
    explain the bf16 kernel better than the fp32 kernel does."""
    from latent_diffusion_planning_tpu.ops.pallas.diffusion_unet1d import (
        fused_unet1d_ddim_sample as jax_fused)
    B, T, D, Dc = 4, 8, 5, 5
    dd = (8, 16, 32)
    net = ConditionalUnet1D(input_dim=D, global_cond_dim=Dc,
                            diffusion_step_embed_dim=32, down_dims=dd,
                            kernel_size=5, n_groups=4)
    rng = np.random.default_rng(11)
    g = rng.normal(size=(B, Dc)).astype(np.float32)
    x0 = rng.normal(size=(B, T, D)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), np.zeros((2, T, D)),
                      np.zeros((2,), np.int32), np.zeros((2, Dc)))["params"]
    mine = bridge.unet1d_from_flax(_np(params), input_dim=D, global_cond_dim=Dc,
                                   diffusion_step_embed_dim=32, down_dims=dd,
                                   n_groups=4)
    sched_j = jdlib.DiffusionSchedule.create(12, "squaredcos_cap_v2")
    ts_j, coefs_j = jdlib.ddim_coef_table(sched_j, 4)
    run_j = lambda dt: np.asarray(jax_fused(
        params, jnp.asarray(g), jnp.asarray(x0), ts_j, coefs_j, down_dims=dd,
        diffusion_step_embed_dim=32, n_groups=4, dtype=dt, batch_tile=B,
        interpret=True))
    ref, ref32 = run_j(jnp.bfloat16), run_j(jnp.float32)
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 4)
    twin = kunet.unet1d_ddim_sample_plain(
        kunet.rounding_twin(mine), torch.from_numpy(g), torch.from_numpy(x0),
        ts, coefs).numpy()
    assert np.isfinite(ref).all()
    err = np.abs(twin - ref)
    assert err.mean() <= 5e-3
    assert err.max() <= 0.1
    assert err.mean() < np.abs(ref32 - ref).mean()


def test_unet_rounding_twin_is_discontinuous():
    """Why kernel B is not held to its twin element by element: moving the
    input by 2e-7 (less than fp32 sums in another order move the
    activations) moves some sample of the rounding twin by more than 1e-3,
    hundreds of times further than it moves the fp32 net (1e-5 at most),
    while most samples of the twin do not move either. A bf16 rounding that
    flips is a step, and ten DDIM steps amplify it; over 1024 samples on the
    card the largest such move is 2.5e-2 (``chip_smoke.py`` prints it)."""
    B = 128
    torch.manual_seed(3)
    net = kunet.ConditionalUnet1D(25, 25, 256, (64, 128, 256), 5, 8)
    twin = kunet.rounding_twin(net)
    g = torch.Generator().manual_seed(4)
    gc = torch.randn(B, 25, generator=g)
    x0 = torch.randn(B, 8, 25, generator=g)
    moved = x0 * (1 + 2e-7 * torch.randn(x0.shape, generator=g))
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(50, "squaredcos_cap_v2"), 10)
    run = lambda m, x: kunet.unet1d_ddim_sample_plain(m, gc, x, ts, coefs)
    per_sample = lambda a, b: (a - b).abs().flatten(1).amax(1)
    d_twin = per_sample(run(twin, x0), run(twin, moved))
    d_fp32 = per_sample(run(net, x0), run(net, moved))
    assert float(d_fp32.max()) < 1e-5
    assert float(d_twin.median()) < 1e-5
    assert float(d_twin.max()) > 1e-3
    assert float(d_twin.max()) > 100 * float(d_fp32.max())


# ---------------------------------------------------------------------------
# kernel A: tiled packing and the 3xTF32 numerics, decided before the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [64, 256])
def test_idm_packing_round_trips(H):
    """Un-tiling ``pack_params(net)`` gives back every streamed matrix in the
    order the kernel consumes them (zero rows where K is padded to 16), and
    the vector region holds everything else, once."""
    torch.manual_seed(2)
    net = kmlp.MLPDiffusion(50, 7, 64, (128, 128), "swish", 3, H)
    lay = kmlp.layout(net)
    packed = kmlp.pack_params(net)
    assert packed.dtype == torch.float32 and packed.numel() == lay["numel"]
    o = 0
    for name, w in kmlp._stream(net):
        assert lay["offsets"][name] == o
        K = w.shape[0]
        Kp = kmlp._up(K, kmlp.STAGE_K)
        got = kmlp.untile_matrix(packed[o:o + Kp * H], K, H)
        assert torch.equal(got[:K], w.detach()), name
        assert not got[K:].any(), name
        o += Kp * H
    assert o == lay["vec_base"] == lay["stream_stages"] * kmlp.STAGE_K * H
    # 57 input rows pad to 64; 3 blocks x 4 chunks x (w0 chunk + w1 chunk)
    assert lay["stream_stages"] == (64 + 3 * 4 * 2 * H) // kmlp.STAGE_K
    vec = torch.cat([p.detach().reshape(-1) for _, p in kmlp._vectors(net)])
    assert torch.equal(packed[o:], vec)
    n_params = sum(p.numel() for p in net.parameters())
    assert packed.numel() == n_params + (64 - 57) * H
    # any width up to MAX_HIDDEN runs (padded to whole tiles); past it not
    for ok in (96, 100, 520, 1024):
        kmlp.check_supported(kmlp.MLPDiffusion(50, 7, 64, (128, 128),
                                               "swish", 3, ok))
    with pytest.raises(ValueError, match="hidden_dim"):
        kmlp.check_supported(kmlp.MLPDiffusion(
            50, 7, 64, (128, 128), "swish", 3, kmlp.MAX_HIDDEN + 8))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: what ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _SplitLinear(torch.nn.Module):
    """A Linear whose product is emulated as the kernel computes it: operands
    split hi + lo in TF32, ``terms`` of hi·hi, hi·lo, lo·hi summed in fp32
    (1 term is plain single-pass TF32)."""

    def __init__(self, lin: torch.nn.Linear, terms: int, n_split: int | None):
        super().__init__()
        self.lin, self.terms, self.n_split = lin, terms, n_split

    def forward(self, x):
        n = x.shape[-1] if self.n_split is None else self.n_split
        w = self.lin.weight[:, :n].t()
        a = x[..., :n]
        ah, wh = _tf32(a), _tf32(w)
        out = ah @ wh
        if self.terms == 3:
            al, wl = _tf32(a - ah), _tf32(w - wh)
            out = (al @ wh + ah @ wl) + out
        # columns past n_split (the time's share) stay fp32, like the bias
        return out + x[..., n:] @ self.lin.weight[:, n:].t() + self.lin.bias


def _tf32_emulated(net, terms):
    import copy
    out = copy.deepcopy(net)
    out.trunk.dense0 = _SplitLinear(out.trunk.dense0, terms,
                                    net.out_dim + net.s_dim)
    for blk in out.trunk.blocks:
        blk.dense0 = _SplitLinear(blk.dense0, terms, None)
        blk.dense1 = _SplitLinear(blk.dense1, terms, None)
    return out


@pytest.mark.parametrize("mode,tol", [("ddim", 1e-4), ("ddpm", 1e-3)])
def test_idm_split_tf32_numerics(mode, tol):
    """Kernel A's products are 3×TF32 on the card. Emulated here (round to
    nearest to 10 mantissa bits, three terms, fp32 sums) inside the IDM
    sampler at the bench widths (hidden 256, 3 blocks, S = 50, A = 7), the
    result stays within the kernel's tolerance (1e-4 DDIM-10, 1e-3 DDPM-50)
    of the fp32 twin and of the JAX Pallas kernel in interpret mode. The same
    with single-pass TF32 does not: that is why the kernel pays for three
    passes."""
    from latent_diffusion_planning_tpu.ops.pallas.diffusion_mlp import (
        fused_mlp_diffusion_sample as jax_fused)
    N, A, S = 32, 7, 50
    net = MLPDiffusion(out_dim=A, n_blocks=3, hidden_dim=256, time_dim=64)
    rng = np.random.default_rng(21)
    s = rng.normal(size=(N, S)).astype(np.float32)
    x0 = rng.normal(size=(N, A)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), s[:2], np.zeros((2, A)),
                      np.zeros((2, 1), np.int32))["params"]
    mine = bridge.mlp_diffusion_from_flax(_np(params), s_dim=S, out_dim=A,
                                          n_blocks=3, hidden_dim=256,
                                          time_dim=64)
    sched_j = jdlib.DiffusionSchedule.create(50, "squaredcos_cap_v2")
    sched_t = dlib.DiffusionSchedule.create(50, "squaredcos_cap_v2")
    if mode == "ddim":
        ts_j, coefs_j = jdlib.ddim_coef_table(sched_j, 10)
        ts, coefs = dlib.ddim_coef_table(sched_t, 10)
        noise = np.zeros((10, N, A), np.float32)
    else:
        ts_j, coefs_j = jdlib.ddpm_coef_table(sched_j)
        ts, coefs = dlib.ddpm_coef_table(sched_t)
        noise = rng.normal(size=(50, N, A)).astype(np.float32)
    ref_j = np.asarray(jax_fused(params, jnp.asarray(s), jnp.asarray(x0), ts_j,
                                 coefs_j, jnp.asarray(noise), tile=N,
                                 interpret=True))
    run = lambda m: kmlp.mlp_diffusion_sample_plain(
        m, torch.from_numpy(s), torch.from_numpy(x0), ts, coefs,
        None if mode == "ddim" else torch.from_numpy(noise)).numpy()
    twin = run(mine)
    three = run(_tf32_emulated(mine, 3))
    one = run(_tf32_emulated(mine, 1))
    np.testing.assert_allclose(twin, ref_j, atol=tol, rtol=0)
    np.testing.assert_allclose(three, twin, atol=tol, rtol=0)
    np.testing.assert_allclose(three, ref_j, atol=tol, rtol=0)
    # on file: single-pass TF32 misses the bar the kernel is held to
    assert np.abs(one - twin).max() > tol
