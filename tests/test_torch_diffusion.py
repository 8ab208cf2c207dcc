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
    for mine, ref in ((dlib.ddim_coef_table(ts, inf),
                       jdlib.ddim_coef_table(js, inf)),
                      (dlib.ddpm_coef_table(ts), jdlib.ddpm_coef_table(js))):
        np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(mine[1].numpy(), np.asarray(ref[1]),
                                   atol=1e-6, rtol=1e-5)


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


def test_unet_kernel_program_covers_every_weight():
    """The kernel's op program reads each packed weight group exactly once,
    in the order the net runs (checked on the CPU: no card needed)."""
    mine = bridge.ConditionalUnet1D(25, 25, 64, (16, 32, 64), 5, 8)
    prog = kunet.build_program(mine, 8, 4)
    kinds = [r[0] for r in prog["records"]]
    assert kinds.count(kunet.FILM) == len(mine.blocks)
    assert kinds.count(kunet.DOWN) == kinds.count(kunet.UP) == 2
    offs = sorted(o for r in prog["records"] for o in
                  ((r[4], r[5], r[6], r[7]) if r[0] == kunet.FILM else
                   (r[3],) if r[0] in (kunet.DOWN, kunet.UP) else
                   (r[4],) if r[0] in (kunet.FINAL_BLOCK, kunet.FINAL_CONV)
                   else ()) if o >= 0)
    starts = []
    o = 0
    for _, group in kunet._groups(mine):
        starts.append(o)
        o += sum(p.numel() for p in group)
    assert offs == starts[1:]                  # every group but the time MLP
    assert o == kunet.pack_params(mine).numel()


def _run_unet_program(net, gcond, x, ts, coefs, clip):
    """A NumPy transcription of csrc/diffusion_unet1d.cu's interpreter (one
    tile holding every sample, the packed bf16 weights), so the records,
    offsets and conv index maps the card runs are checked here."""
    B, T, D = x.shape
    nb = B
    prog = kunet.build_program(net, T, nb)
    W = kunet.pack_params(net).double().numpy()
    K, G, d = net.kernel_size, net.n_groups, net.dsed
    mish = lambda v: v * np.tanh(np.logaddexp(v, 0.0))

    def conv(inp, cin, tin, cout, tout, off, k, mode):
        w = W[off:off + k * cin * cout].reshape(k, cin, cout)
        out = np.tile(W[off + k * cin * cout:off + k * cin * cout + cout],
                      (nb * tout, 1))
        for r in range(nb * tout):
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

    def gn_mish(v, c, tl, off, film=None):
        cg = c // G
        y = v.reshape(nb, tl, G, cg)
        mu = y.mean((1, 3), keepdims=True)
        var = ((y - mu) ** 2).mean((1, 3), keepdims=True)
        y = ((y - mu) / np.sqrt(var + 1e-6)).reshape(nb * tl, c)
        y = mish(y * W[off:off + c] + W[off + c:off + 2 * c])
        if film is not None:
            f = np.repeat(film, tl, axis=0)
            y = f[:, :c] * y + f[:, c:]
        return y

    def dense(inp, k, n, off):
        w = W[off:off + k * n].reshape(k, n)
        return inp @ w + W[off + k * n:off + k * n + n]

    xcur = x.reshape(nb * T, D).astype(np.float64)
    skip = np.zeros(prog["skip_total"])
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / (half - 1))
    for step, t in enumerate(ts.tolist()):
        emb = np.concatenate([np.sin(t * freqs), np.cos(t * freqs)])[None]
        hid = mish(dense(emb, d, 4 * d, 0))
        temb = dense(hid, 4 * d, d, d * 4 * d + 4 * d)
        mcond = mish(np.concatenate([np.repeat(temb, nb, 0), gcond], 1))
        h = xcur.copy()
        for rec in prog["records"]:
            kind = rec[0]
            if kind == kunet.FILM:
                cin, ch, tl = rec[1:4]
                fw = rec[6]
                film = dense(mcond, mcond.shape[1], 2 * ch, fw)
                y = conv(h, cin, tl, ch, tl, rec[4], K, "same")
                y = gn_mish(y, ch, tl, rec[4] + K * cin * ch + ch, film)
                z = conv(y, ch, tl, ch, tl, rec[5], K, "same")
                z = gn_mish(z, ch, tl, rec[5] + K * ch * ch + ch)
                h = z + (conv(h, cin, tl, ch, tl, rec[7], 1, "same")
                         if rec[7] >= 0 else h)
            elif kind == kunet.SAVE:
                skip[rec[1]:rec[1] + h.size] = h.reshape(-1)
            elif kind == kunet.CONCAT:
                c1, c2, tl = rec[2:5]
                sk = skip[rec[1]:rec[1] + nb * tl * c2].reshape(nb * tl, c2)
                h = np.concatenate([h, sk], 1)
            elif kind == kunet.DOWN:
                h = conv(h, rec[1], rec[2], rec[1], rec[2] // 2, rec[3], 3,
                         "down")
            elif kind == kunet.UP:
                h = conv(h, rec[1], rec[2], rec[1], 2 * rec[2], rec[3], 4, "up")
            elif kind == kunet.FINAL_BLOCK:
                cin, ch, tl = rec[1:4]
                h = gn_mish(conv(h, cin, tl, ch, tl, rec[4], K, "same"), ch, tl,
                            rec[4] + K * cin * ch + ch)
            else:
                h = conv(h, rec[1], rec[3], rec[2], rec[3], rec[4], 1, "same")
        c = coefs[step].tolist()
        x0 = np.clip(c[0] * (xcur - c[1] * h), -clip, clip)
        xcur = c[2] * x0 + c[3] * xcur
    return xcur.reshape(B, T, D)


def test_unet_kernel_program_matches_twin():
    """Kernel B's record program, run by the NumPy transcription of its
    interpreter, computes what the twin computes (fp64 vs fp32: atol 1e-4)."""
    B, T, D, Dc = 3, 8, 5, 6
    torch.manual_seed(0)
    net = kunet.round_weights(kunet.ConditionalUnet1D(D, Dc, 16, (8, 16, 32),
                                                      5, 4))
    rng = np.random.default_rng(5)
    g = rng.normal(size=(B, Dc)).astype(np.float32)
    x0 = rng.normal(size=(B, T, D)).astype(np.float32)
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 4)
    twin = kunet.fused_unet1d_ddim_sample(net, torch.from_numpy(g),
                                          torch.from_numpy(x0), ts, coefs)
    got = _run_unet_program(net, g.astype(np.float64), x0, ts, coefs, 1.0)
    np.testing.assert_allclose(got, twin.numpy(), atol=1e-4, rtol=0)
