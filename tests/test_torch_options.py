"""The options the JAX package's nets and agents take, in the port, against
the Flax modules and the JAX agents.

Weights come from Flax (``init``, perturbed where Flax starts them at zero,
or drawn with numpy over ``jax.eval_shape``'s tree) through ``bridge.py``;
inputs and draws are made with numpy and handed to both sides. fp32 options
are held at 1e-5 (JAX's matmuls at "highest" precision; only the summation
order differs). A bf16 ``compute_dtype`` is held against the Flax module
applied op by op (each bf16 operation rounds, the module as written; under
``jit`` XLA may keep fused chains in fp32, which no port can follow) two
ways: the port's bf16 output is closer to JAX's than the port's fp32 output
is (the rounding sits where Flax puts it), and within a stated bar of it.

Dropout acts only under ``training=True`` with an explicit generator: at
``training=False`` a net with a rate equals one without; under training
the share of dropped elements stays within binomial bounds and the kept
ones are scaled by 1 / (1 - p). The agents never train with dropout on (as
in the JAX package), so the LDP agent's losses with ``dropout_rate`` equal
JAX's with its draws.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.models.nets import mlp as jmlp
from latent_diffusion_planning_tpu.models.nets import resnet as jresnet
from latent_diffusion_planning_tpu.models.nets.unet1d import (
    ConditionalUnet1D as JaxUnet)
from latent_diffusion_planning_tpu.models.vae import KLVAE as JaxKLVAE
from latent_diffusion_planning_tpu.utils import config as jconfig
from latent_diffusion_planning_tpu_torch import bridge
from latent_diffusion_planning_tpu_torch.models.nets import mlp, resnet
from latent_diffusion_planning_tpu_torch.models.vae import KLVAE
from latent_diffusion_planning_tpu_torch.ops.kernels import (
    diffusion_unet1d as kunet)
from latent_diffusion_planning_tpu_torch.utils.config import load_config
from test_torch_defaults import (BRIDGE, _both, _jax_agent, _jax_plan_draws,
                                 _seeded_params, _snapshot, _window,
                                 command_line)
from torch_thread import one_torch_thread  # noqa: F401

ATOL = 1e-5
BF16 = "bfloat16"


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _perturbed(params, seed):
    """Flax's params with every leaf moved by a seeded normal draw (scale
    0.1), so zero-initialised Denses (FiLM's) and unit norms carry
    weight."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.1 * rng.normal(size=np.shape(v))
                   ).astype(np.float32), params)


def _closer(mine_bf16, mine_fp32, want_bf16, bar):
    """The port's bf16 output nearer JAX's bf16 output than its fp32 output
    is (mean abs difference), and within ``bar`` of it everywhere."""
    d16 = np.abs(mine_bf16 - want_bf16)
    d32 = np.abs(mine_fp32 - want_bf16)
    assert d16.mean() < d32.mean(), (d16.mean(), d32.mean())
    assert d16.max() <= bar, d16.max()


# ---------------------------------------------------------------------------
# the MLP options
# ---------------------------------------------------------------------------

MLP_OPTIONS = {
    "layer-norm": dict(use_layer_norm=True),
    "activate-final": dict(activate_final=True),
    "tanh-output": dict(tanh_output=True),
    "all-gelu": dict(use_layer_norm=True, activate_final=True,
                     tanh_output=True, activation="gelu"),
    "dropout-inert": dict(dropout_rate=0.3, use_layer_norm=True),
    "lecun-mish": dict(kernel_init="lecun", activation="mish"),
}


@pytest.mark.parametrize("case", sorted(MLP_OPTIONS))
def test_mlp_options_match_flax(case):
    """``MLP``'s options at the Flax positions (Dense → dropout → LayerNorm
    → activation, tanh last), through ``bridge.load_mlp``; dropout inert at
    ``training=False``."""
    opts = dict(MLP_OPTIONS[case])
    act = opts.pop("activation", "relu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 9)).astype(np.float32)
    jnet = jmlp.MLP((16, 12, 6), activation=act, **opts)
    params = _perturbed(jnet.init(jax.random.PRNGKey(0), x)["params"], 1)
    want = np.asarray(jnet.apply({"params": params}, x))
    net = bridge.load_mlp(mlp.MLP(9, (16, 12, 6), act, **opts),
                          _np(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind,flax_init", [
    ("xavier", jax.nn.initializers.xavier_uniform()),
    ("kaiming", jax.nn.initializers.kaiming_uniform()),
    ("lecun", jax.nn.initializers.lecun_normal())])
def test_mlp_kernel_init_draws_as_flax(kind, flax_init):
    """``kernel_init``'s three initializers draw the Flax spread: the
    standard deviation of a 256 × 384 kernel within 2% of Flax's, and the
    bound of the uniform ones equal."""
    net = mlp.MLP(256, (384,), kernel_init=kind,
                  generator=torch.Generator().manual_seed(0))
    w = net.dense[0].weight.detach().numpy()
    ref = np.asarray(flax_init(jax.random.PRNGKey(0), (256, 384)))
    assert abs(w.std() / ref.std() - 1) < 0.02
    if kind != "lecun":
        assert abs(np.abs(w).max() / np.abs(ref).max() - 1) < 0.01
    assert not net.dense[0].bias.detach().any()


@pytest.mark.parametrize("in_features", [10, 16])
def test_mlp_resnet_block_matches_flax(in_features):
    """``MLPResNetBlock`` with an input narrower than its features projects
    the residual (Flax's ``Dense_2``), through
    ``bridge.load_mlp_resnet_block``; at its own width it does not."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, in_features)).astype(np.float32)
    jblk = jmlp.MLPResNetBlock(16, dropout_rate=0.2)
    params = _perturbed(jblk.init(jax.random.PRNGKey(2), x)["params"], 3)
    assert ("Dense_2" in params) == (in_features != 16)
    want = np.asarray(jblk.apply({"params": params}, x))
    blk = bridge.load_mlp_resnet_block(
        mlp.MLPResNetBlock(16, in_features=in_features, dropout_rate=0.2),
        _np(params))
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bridge_refuses_a_projection_the_block_lacks():
    x = np.zeros((2, 10), np.float32)
    params = jmlp.MLPResNetBlock(16).init(jax.random.PRNGKey(0), x)["params"]
    with pytest.raises(ValueError, match="projects its residual"):
        bridge.load_mlp_resnet_block(mlp.MLPResNetBlock(16), _np(params))


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def _idm_pair(**over):
    N, S, A = 6, 10, 7
    kw = dict(time_dim=16, cond_hidden_dims=(32, 24), n_blocks=2,
              hidden_dim=32, **over)
    rng = np.random.default_rng(4)
    s = rng.normal(size=(N, S)).astype(np.float32)
    a = rng.normal(size=(N, A)).astype(np.float32)
    t = rng.integers(0, 50, size=(N, 1)).astype(np.int32)
    jnet = jmlp.MLPDiffusion(out_dim=A, **kw)
    params = _perturbed(jnet.init(jax.random.PRNGKey(4), s, a, t)["params"],
                        5)
    net = bridge.mlp_diffusion_from_flax(_np(params), s_dim=S, out_dim=A,
                                         **{k: v for k, v in kw.items()
                                            if k != "compute_dtype"},
                                         compute_dtype=kw.get(
                                             "compute_dtype", "float32"))
    return jnet, params, net, (s, a, t)


def test_dropout_is_inert_without_training():
    """An IDM with ``dropout_rate`` 0.1 equals the Flax module at
    ``training=False`` and the same net without dropout."""
    jnet, params, net, (s, a, t) = _idm_pair(dropout_rate=0.1)
    want = np.asarray(jnet.apply({"params": params}, s, a, t))
    args = [torch.from_numpy(v) for v in (s, a, t)]
    with torch.no_grad():
        got = net(*args).numpy()
        net.dropout_rate = None
        for m in net.modules():
            if hasattr(m, "dropout_rate"):
                m.dropout_rate = None
        plain = net(*args).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_under_training_drops_its_share(p):
    """Under ``training=True`` with a generator: the dropped share of
    100 000 elements within 4 standard deviations of p, every kept element
    scaled by exactly 1 / (1 - p), and a second draw from the same seed
    equal; without a generator it raises."""
    x = torch.full((100_000,), 3.0)
    y = mlp.dropout(x, p, True, torch.Generator().manual_seed(0))
    dropped = float((y == 0).double().mean())
    assert abs(dropped - p) < 4 * np.sqrt(p * (1 - p) / x.numel())
    kept = y[y != 0]
    assert torch.equal(kept, torch.full_like(kept, 3.0) / (1 - p))
    again = mlp.dropout(x, p, True, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    assert torch.equal(mlp.dropout(x, p, False, None), x)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        mlp.dropout(x, p, True, None)


def test_dropout_under_training_matches_flax_with_its_masks():
    """The trunk's dropout sits where Flax's does (before each block's
    LayerNorm, one mask a block): the JAX module under ``training=True``
    is reproduced by the port's when the port's masks are Flax's own keep
    decisions, recorded from its ``bernoulli`` draws."""
    jnet, params, net, (s, a, t) = _idm_pair(dropout_rate=0.25)
    key = jax.random.PRNGKey(9)
    masks = []
    orig = jax.random.bernoulli

    def record(k, p=0.5, shape=None):
        m = orig(k, p, shape)
        masks.append(np.asarray(m))
        return m
    with mock.patch.object(jax.random, "bernoulli", record):
        want = np.asarray(jnet.apply({"params": params}, s, a, t,
                                     training=True, rngs={"dropout": key}))
    assert len(masks) == 2 and 0 < np.mean(masks[0]) < 1
    it = iter(masks)

    def given(x, rate, training, generator):
        assert training and generator is not None
        if not rate:            # the cond MLP: no dropout
            return x
        keep = torch.from_numpy(np.array(next(it)))
        return torch.where(keep, x / (1 - rate), torch.zeros_like(x))
    with mock.patch.object(mlp, "dropout", given), torch.no_grad():
        got = net(*[torch.from_numpy(v) for v in (s, a, t)], training=True,
                  generator=torch.Generator()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# bf16 compute
# ---------------------------------------------------------------------------

def test_unet_bf16_compute_follows_flax():
    """``ConditionalUnet1D(compute_dtype="bfloat16")``: closer to JAX's
    bf16 output than the port's fp32 output is, and within 1e-3 of it: the
    port rounds where XLA does (each product once, then its bias; Mish op
    by op in bf16), so only a rare near-tie flips (measured: 2.4e-7, the
    fp32 output 3.5e-2 off)."""
    B, T, D, Dc, d = 3, 8, 5, 7, 32
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    t = np.asarray([0, 17, 49], np.int32)
    g = rng.normal(size=(B, Dc)).astype(np.float32)
    kw = dict(input_dim=D, global_cond_dim=Dc, diffusion_step_embed_dim=d,
              down_dims=(8, 16, 32), kernel_size=5, n_groups=4)
    jnet = JaxUnet(**kw, compute_dtype=BF16)
    params = _seeded_params(jax.eval_shape(
        jnet.init, jax.random.PRNGKey(6), x, t, g)["params"], 7)
    want = np.asarray(jnet.apply({"params": params}, x, t, g),
                      np.float32)
    outs = {}
    for dt in ("float32", BF16):
        net = bridge.load_unet1d(bridge.unet_from_config(
            dict(kw, compute_dtype=dt), D, Dc), _np(params))
        with torch.no_grad():
            outs[dt] = net(*[torch.from_numpy(v) for v in (x, t, g)]).numpy()
    assert outs[BF16].dtype == np.float32
    _closer(outs[BF16], outs["float32"], want, 1e-3)


def test_mlp_diffusion_bf16_compute_follows_flax():
    """``MLPDiffusion(compute_dtype="bfloat16")`` (the trunk in bf16, its
    LayerNorm and output layer fp32): closer to JAX's bf16 output than the
    fp32 port is; within 0.05."""
    jnet, params, net, (s, a, t) = _idm_pair(compute_dtype=BF16)
    want = np.asarray(jnet.apply({"params": params}, s, a, t), np.float32)
    args = [torch.from_numpy(v) for v in (s, a, t)]
    with torch.no_grad():
        got16 = net(*args).numpy()
        for m in net.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = None
        got32 = net(*args).numpy()
    _closer(got16, got32, want, 0.05)


def test_klvae_bf16_compute_follows_flax():
    """``KLVAE(compute_dtype="bfloat16")``'s encoder mean and decoded
    frames: closer to JAX's bf16 outputs than the fp32 port's; within 0.05
    (the latent) and 0.1 (a frame in [-1, 1] after six bf16 stages)."""
    cfg = dict(block_out_channels=(8, 16, 16), norm_groups=4, patch_size=2)
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jvae = JaxKLVAE(**cfg, compute_dtype=jnp.bfloat16)
    params = _seeded_params(jax.eval_shape(
        jvae.init, jax.random.PRNGKey(8), x)["params"], 9)
    mean, _ = jvae.apply({"params": params}, x, method=JaxKLVAE.encode)
    rec = jvae.apply({"params": params}, mean, method=JaxKLVAE.decode)
    mine = {dt: bridge.load_klvae(KLVAE(**cfg, compute_dtype=dt), _np(params))
            for dt in ("float32", BF16)}
    got = {}
    with torch.no_grad():
        for dt, vae in mine.items():
            m, _ = vae.encode(torch.from_numpy(x))
            r = vae.decode(torch.from_numpy(np.asarray(mean, np.float32)))
            got[dt] = (m.numpy(), r.numpy())
    _closer(got[BF16][0], got["float32"][0], np.asarray(mean, np.float32),
            0.05)
    _closer(got[BF16][1], got["float32"][1], np.asarray(rec, np.float32), 0.1)


def test_resnet_bf16_compute_follows_flax():
    """``ResNetEncoder(compute_dtype="bfloat16")`` (convs bf16, norms and
    the spatial softmax fp32): closer to JAX's bf16 keypoints than the fp32
    port's; within 0.05 (keypoints lie in [-1, 1])."""
    cfg = dict(stage_sizes=(1, 1), n_filters=8)
    rng = np.random.default_rng(10)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jnet = jresnet.ResNetEncoder(**cfg, compute_dtype=jnp.bfloat16)
    params = _seeded_params(jax.eval_shape(
        jnet.init, jax.random.PRNGKey(10), x)["params"], 11)
    want = np.asarray(jnet.apply({"params": params}, x), np.float32)
    got = {}
    for dt in ("float32", BF16):
        net = bridge.resnet_from_flax(_np(params), image_shape=(64, 64, 3),
                                      compute_dtype=dt, **cfg)
        with torch.no_grad():
            got[dt] = net(torch.from_numpy(x)).numpy()
    _closer(got[BF16], got["float32"], want, 0.05)


# ---------------------------------------------------------------------------
# ResNet conditioning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [dict(use_film=True),
                                  dict(use_multiplicative_cond=True),
                                  dict(use_film=True,
                                       use_multiplicative_cond=True)])
def test_resnet_conditioning_matches_flax(opts):
    """FiLM (``x·(1 + mult) + add`` from Denses that start at zero) and the
    multiplicative gate after every block, on ``cond_var``, bridged from
    Flax (perturbed, so FiLM's Denses carry weight): 1e-5."""
    cfg = dict(stage_sizes=(1, 1), n_filters=8, **opts)
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    c = rng.normal(size=(2, 6)).astype(np.float32)
    jnet = jresnet.ResNetEncoder(**cfg)
    raw = jnet.init(jax.random.PRNGKey(12), x, cond_var=c)["params"]
    params = _perturbed(raw, 13)
    want = np.asarray(jnet.apply({"params": params}, x, cond_var=c))
    net = bridge.resnet_from_flax(_np(params), image_shape=(64, 64, 3),
                                  cond_dim=6, **cfg)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # FiLM's Denses start at zero in both; the gates draw xavier-normal
    fresh = resnet.ResNetEncoder((64, 64, 3), cond_dim=6,
                                 generator=torch.Generator().manual_seed(0),
                                 **cfg)
    for film in fresh.films or ():
        assert not film.add.weight.any() and not film.mult.weight.any()
    for i, gate in enumerate(fresh.gates or ()):
        ref = np.asarray(raw[f"Dense_{i}"]["kernel"])
        w = gate.weight.detach().numpy()
        assert abs(w.std() / ref.std() - 1) < 0.25


def test_resnet_conditioning_needs_its_condition():
    with pytest.raises(ValueError, match="cond_dim"):
        resnet.ResNetEncoder((64, 64, 3), use_film=True)
    net = resnet.ResNetEncoder((64, 64, 3), stage_sizes=(1,), n_filters=8,
                               use_multiplicative_cond=True, cond_dim=3)
    with pytest.raises(ValueError, match="cond_var"):
        net(torch.zeros(1, 64, 64, 3))


# ---------------------------------------------------------------------------
# the agents
# ---------------------------------------------------------------------------

LDP_OPTIONS = ["agent.fused_dtype=float32",
               "agent.idm_net.cond_activation=mish",
               "agent.idm_net.dropout_rate=0.1"]


def _options_pair(extra):
    """The narrowed default LDP agent with ``extra`` on the command line:
    (the port's config, the JAX agent, the port's agent bridged from it)."""
    line = command_line("ldp_agent") + list(extra)
    cfg = load_config("train_bc", line)
    jagent = _jax_agent(jconfig.load_config("train_bc", line))
    agent_cfg = {k: v for k, v in dict(cfg.agent).items()
                 if k != "vae_pretrain_path"}
    agent = BRIDGE["ldp_agent"](_snapshot(jagent), agent_cfg,
                                cfg.data["meta"]["shape_meta"], device="cpu")
    return cfg, jagent, agent


@pytest.fixture(scope="module")
def ldp_options():
    return _options_pair(LDP_OPTIONS)


@pytest.fixture(scope="module")
def ldp_bf16_planner():
    return _options_pair(LDP_OPTIONS + ["agent.planner.compute_dtype="
                                        "bfloat16"])


def test_ldp_options_build_and_pass_the_kernel_check(ldp_options):
    """What the port refused before (``fused_dtype: float32``, a mish IDM,
    dropout) builds, and the card's kernel check accepts it."""
    _, _, agent = ldp_options
    assert agent.config.fused_dtype == "float32"
    assert agent.idm.cond_activation == "mish"
    assert agent.idm.dropout_rate == 0.1
    agent._check_kernels()


def test_ldp_losses_with_dropout_match_jax(ldp_options):
    """The LDP agent's losses with ``dropout_rate`` 0.1 in its IDM equal
    the JAX agent's with its draws (the agents never train with dropout on,
    in either package): 1e-5."""
    from test_torch_train import (_batch, _jax_loss_draws, _jax_prepared,
                                  _jit_loss, _torch_batch)
    _, jagent, agent = ldp_options
    batch = _batch(B=4, H=17)
    rng = jax.random.PRNGKey(11)
    params = {"planner": jagent.planner_state.params,
              "idm": jagent.idm_state.params}
    _, want = _jit_loss(jagent)(params, _jax_prepared(jagent, batch), None,
                                rng, True, True, 1)
    draws = _jax_loss_draws(rng, jagent, 4, 17)
    with torch.no_grad():
        _, got = agent._loss(agent._prepare_train_batch(_torch_batch(batch)),
                             True, True, draws=draws)
    for k in ("plan_loss", "idm_loss", "loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_ldp_options_sample_fast_matches_jax(which, ldp_options,
                                             ldp_bf16_planner):
    """``sample_fast`` (DDPM-100 planner, then the mish IDM) against the JAX
    agent's scans with its draws: the actions at 2e-4, the JAX package's
    kernel-against-scan bar (measured: 1.0e-5). With the planner computing
    in bf16 the mean error
    within 5e-3 and closer to JAX's than the same agent computing in fp32
    is; the two update rules differ in fp32's last bits, and a bf16 net
    turns such a difference into a rounding flip now and then, which 100
    steps carry forward (measured: mean 9.3e-4, max 1.4e-2; the fp32
    planner mean 2.1e-3, max 3.3e-2), so the largest is held at 0.05."""
    _, jagent, agent = ldp_options if which == "fp32" else ldp_bf16_planner
    B, D, A = 3, agent.config.obs_dim, 7
    jobs, tobs = _both(_window("ldp_agent", B, 1, seed=2))
    key = jax.random.PRNGKey(4)
    want = np.asarray(jagent.sample_fast(jobs, key))
    draws = _jax_plan_draws(key, (B, 16, D), (B * 16, A))
    got = agent.sample_fast(tobs, draws=draws).numpy()
    assert got.shape == want.shape == (B, 16, A)
    if which == "fp32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
        return
    planner = agent.planner
    agent.planner = kunet.fp32_twin(planner)
    try:
        fp32 = agent.sample_fast(tobs, draws=draws).numpy()
    finally:
        agent.planner = planner
    err, err32 = np.abs(got - want), np.abs(fp32 - want)
    assert err.mean() <= 5e-3 and err.mean() < err32.mean()
    assert err.max() <= 0.05
