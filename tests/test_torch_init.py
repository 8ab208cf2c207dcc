"""The port's nets start from Flax's initializers.

Each net is initialised twice at a small width for each of three seeds:
by the Flax module's own ``init`` (carried into the port's layout through
``bridge.py``) and by the port's constructor drawing from a
``torch.Generator``. The two draws cannot be equal (threefry against
mt19937), so they are compared tensor by tensor in distribution:

- every bias is exactly 0 on both sides, every norm scale exactly 1;
- each weight of at least 1000 elements has a standard deviation within
  10% of the bridged Flax tensor's;
- each weight lies within its Flax initializer's bound: 2σ/0.8796 with
  σ = √(1/fan_in) for lecun-normal, √(6/(fan_in+fan_out)) for
  xavier-uniform, with Flax's fans (a ConvTranspose kernel is (k, in,
  out): fan_in = k·in).

PyTorch's default (U(±1/√fan_in) for weights and biases) fails the first
two.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from latent_diffusion_planning_tpu.models.nets.mlp import MLPDiffusion
from latent_diffusion_planning_tpu.models.nets.unet1d import ConditionalUnet1D
from latent_diffusion_planning_tpu.models.vae import KLVAE
from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
from latent_diffusion_planning_tpu_torch.models.nets import init
from latent_diffusion_planning_tpu_torch.models.nets.mlp import (
    MLPDiffusion as TorchMLPDiffusion)
from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
    ConditionalUnet1D as TorchUnet1D)
from latent_diffusion_planning_tpu_torch.models.vae import KLVAE as TorchKLVAE
from torch_thread import one_torch_thread  # noqa: F401

SEEDS = (0, 1, 2)
STD_RTOL = 0.10
MIN_ELEMENTS = 1000
TRUNC = 0.87962566103423978

UNET = dict(input_dim=6, global_cond_dim=12, diffusion_step_embed_dim=32,
            down_dims=(32, 64), kernel_size=5, n_groups=8)
MLP = dict(s_dim=16, out_dim=7, time_dim=16, cond_hidden_dims=(64, 64),
           n_blocks=2, hidden_dim=64)
VAE = dict(block_out_channels=(16, 32), latent_channels=4, norm_groups=8,
           patch_size=4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flax_unet(seed):
    net = ConditionalUnet1D(**UNET)
    x = jnp.zeros((2, 8, UNET["input_dim"]))
    g = jnp.zeros((2, UNET["global_cond_dim"]))
    params = jax.jit(net.init)(jax.random.PRNGKey(seed), x,
                               jnp.zeros((2,), jnp.int32), g)["params"]
    return bridge.unet1d_from_flax(_np(params), **UNET)


def _flax_mlp(seed):
    net = MLPDiffusion(**{k: v for k, v in MLP.items() if k != "s_dim"})
    s = jnp.zeros((2, MLP["s_dim"]))
    a = jnp.zeros((2, MLP["out_dim"]))
    params = jax.jit(net.init)(jax.random.PRNGKey(seed), s, a,
                               jnp.zeros((2, 1), jnp.int32))["params"]
    return bridge.mlp_diffusion_from_flax(_np(params), **MLP)


def _flax_vae(seed):
    net = KLVAE(**VAE)
    params = jax.jit(net.init)(jax.random.PRNGKey(seed),
                               jnp.zeros((2, 32, 32, 3)),
                               jax.random.PRNGKey(0))["params"]
    return bridge.klvae_from_flax(_np(params), **VAE)


def _unet_kind(name):
    return "xavier" if ("film" in name or "time_dense" in name) else "lecun"


def _mlp_kind(name):
    if name.startswith("cond.") or name in ("trunk.dense0", "trunk.dense1"):
        return "xavier"
    return "lecun"


NETS = {
    "unet": (_flax_unet,
             lambda g: TorchUnet1D(**UNET, generator=g), _unet_kind),
    "mlp_idm": (_flax_mlp,
                lambda g: TorchMLPDiffusion(**MLP, generator=g), _mlp_kind),
    "vae": (_flax_vae,
            lambda g: TorchKLVAE(**VAE, generator=g), lambda name: "lecun"),
}


def _flax_fans(layer):
    """Fans of the layer's kernel as Flax lays it out, from the torch
    weight's shape: Dense (in, out), Conv (k…, in, out), ConvTranspose
    (k…, in, out) where torch holds (in, out, k…)."""
    w = layer.weight
    if isinstance(layer, nn.Linear):
        return w.shape[1], w.shape[0]
    k = int(np.prod(w.shape[2:]))
    if isinstance(layer, nn.ConvTranspose1d):
        return k * w.shape[0], k * w.shape[1]
    return k * w.shape[1], k * w.shape[0]


def _bound(kind, layer):
    fan_in, fan_out = _flax_fans(layer)
    if kind == "lecun":
        return 2 * math.sqrt(1.0 / fan_in) / TRUNC
    return math.sqrt(6.0 / (fan_in + fan_out))


def _layers(net):
    return {n: m for n, m in net.named_modules()
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d,
                              nn.ConvTranspose1d))}


def _check_layer(name, kind, mine, ref):
    bound = _bound(kind, ref)
    for side, layer in (("port", mine), ("flax", ref)):
        assert layer.bias is None or not torch.any(layer.bias), (
            f"{name}: {side} bias is not 0")
        w = layer.weight.detach()
        assert w.abs().max().item() <= bound * (1 + 1e-6), (
            f"{name}: {side} |w| {w.abs().max().item()} over {bound}")
    if mine.weight.numel() >= MIN_ELEMENTS:
        s_mine = mine.weight.detach().std().item()
        s_ref = ref.weight.detach().std().item()
        assert abs(s_mine / s_ref - 1) <= STD_RTOL, (
            f"{name} ({kind}): std {s_mine:.5f} against Flax's {s_ref:.5f}")


@pytest.fixture(scope="module")
def flax_nets():
    return {(net, seed): NETS[net][0](seed) for net in NETS for seed in SEEDS}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("net", sorted(NETS))
def test_init_matches_flax(flax_nets, net, seed):
    _, build, kind = NETS[net]
    mine = build(torch.Generator().manual_seed(seed))
    ref = flax_nets[net, seed]
    layers, ref_layers = _layers(mine), _layers(ref)
    assert layers.keys() == ref_layers.keys()
    n_big = 0
    for name, layer in layers.items():
        _check_layer(name, kind(name), layer, ref_layers[name])
        n_big += layer.weight.numel() >= MIN_ELEMENTS
    assert n_big >= 5
    # norms start at scale 1, shift 0 on both sides
    for (name, p), (_, q) in zip(mine.named_parameters(),
                                 ref.named_parameters()):
        if "norm" in name:
            want = 1.0 if name.endswith("weight") else 0.0
            assert torch.all(p == want) and torch.all(q == want), name


@pytest.mark.parametrize("seed", SEEDS)
def test_unet_transposed_conv_has_flax_fan(flax_nets, seed):
    """The U-Net's up-sampling ConvTranspose: Flax's fan_in is 4·in, where
    torch's own rule would read out·4 from its (in, out, 4) weight."""
    mine = TorchUnet1D(**UNET, generator=torch.Generator().manual_seed(seed))
    ref = flax_nets["unet", seed]
    assert len(mine.ups) == 1
    for i, (up, ref_up) in enumerate(zip(mine.ups, ref.ups)):
        assert init.fans(up) == _flax_fans(ref_up) == (4 * 32, 4 * 32)
        _check_layer(f"ups.{i}", "lecun", up, ref_up)


@pytest.mark.parametrize("seed", SEEDS)
def test_transposed_conv_fan_in_is_flax_s(seed):
    """A ConvTranspose whose in and out widths differ: Flax's
    ``nn.ConvTranspose(48, (4,))`` on 16 channels has fan_in 64."""
    mod = jax.jit(fnn.ConvTranspose(48, (4,)).init)
    kernel = np.asarray(mod(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 8, 16)))["params"]["kernel"])
    mine = init.layer(nn.ConvTranspose1d, 16, 48, 4,
                      generator=torch.Generator().manual_seed(seed))
    assert init.fans(mine) == (64, 192)
    assert not torch.any(mine.bias)
    w = mine.weight.detach().numpy()
    assert abs(w.std() / kernel.std() - 1) <= STD_RTOL
    bound = 2 * math.sqrt(1 / 64) / TRUNC
    assert np.abs(w).max() <= bound and np.abs(kernel).max() <= bound


@pytest.mark.parametrize("kind,want_std", [
    ("lecun", math.sqrt(1 / 256)),
    ("xavier", math.sqrt(2 / (256 + 512))),
    ("kaiming_normal", math.sqrt(2 / 256)),
])
def test_initializer_variances(kind, want_std):
    layer = init.layer(nn.Linear, 256, 512, init=kind,
                       generator=torch.Generator().manual_seed(0))
    assert abs(layer.weight.std().item() / want_std - 1) < 0.01
    assert not torch.any(layer.bias)


def test_agent_weights_follow_the_seed_alone():
    """``create(seed=...)`` draws every weight from a generator seeded with
    ``seed``: the global torch RNG neither changes the weights nor is
    moved by them."""
    states = []
    for global_seed in (11, 12):
        torch.manual_seed(global_seed)
        before = torch.random.get_rng_state()
        agent = LDPAgent.create(configs.BENCH_AGENT, configs.SHAPE_META,
                                seed=5, device="cpu")
        assert torch.equal(torch.random.get_rng_state(), before)
        states.append({f"{i}.{k}": v.clone()
                       for i, net in enumerate((agent.planner, agent.idm,
                                                agent.vae))
                       for k, v in net.state_dict().items()})
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    other = LDPAgent.create(configs.BENCH_AGENT, configs.SHAPE_META, seed=6,
                            device="cpu")
    assert not torch.equal(other.planner.final_conv.weight,
                           states[0]["0.final_conv.weight"])
