"""The port's networks on bridged weights vs the JAX package's Flax modules.

Inputs are drawn with numpy from a seed, the Flax params come from
``init`` and reach torch through ``bridge.py``. Everything is fp32 on the
CPU with JAX matmuls at "highest" precision, so the only difference is the
order of summation: atol 1e-4.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.models.nets.mlp import MLPDiffusion
from latent_diffusion_planning_tpu.models.nets.unet1d import ConditionalUnet1D
from latent_diffusion_planning_tpu.models.vae import KLVAE
from latent_diffusion_planning_tpu.train import transfer
from latent_diffusion_planning_tpu_torch import bridge
from latent_diffusion_planning_tpu_torch.models.vae import KLVAE as TorchKLVAE
from torch_thread import one_torch_thread  # noqa: F401

ATOL = 1e-4
FIXTURE = Path(__file__).parent / "fixtures" / "transfer_golden.npz"


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("down_dims,n_groups", [((8, 16, 32), 4),
                                                ((16, 32), 8)])
def test_unet1d_matches_flax(down_dims, n_groups):
    B, T, D, Dc, d = 3, 8, 5, 7, 32
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    t = np.asarray([0, 17, 49], np.int32)
    g = rng.normal(size=(B, Dc)).astype(np.float32)
    net = ConditionalUnet1D(input_dim=D, global_cond_dim=Dc,
                            diffusion_step_embed_dim=d, down_dims=down_dims,
                            kernel_size=5, n_groups=n_groups)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                      jnp.asarray(g))["params"]
    ref = np.asarray(net.apply({"params": params}, x, t, g))
    mine = bridge.unet1d_from_flax(
        _np(params), input_dim=D, global_cond_dim=Dc,
        diffusion_step_embed_dim=d, down_dims=down_dims, n_groups=n_groups)
    with torch.no_grad():
        got = mine(torch.from_numpy(x), torch.from_numpy(t).long(),
                   torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cond_activation,learnable", [("swish", True),
                                                       ("mish", False)])
def test_mlp_diffusion_matches_flax(cond_activation, learnable):
    N, S, A = 6, 10, 7
    rng = np.random.default_rng(1)
    s = rng.normal(size=(N, S)).astype(np.float32)
    a = rng.normal(size=(N, A)).astype(np.float32)
    t = rng.integers(0, 50, size=(N, 1)).astype(np.int32)
    net = MLPDiffusion(out_dim=A, time_dim=16, cond_hidden_dims=(32, 24),
                       cond_activation=cond_activation, n_blocks=2,
                       hidden_dim=32, learnable_time=learnable)
    params = net.init(jax.random.PRNGKey(1), s, a, t)["params"]
    ref = np.asarray(net.apply({"params": params}, s, a, t))
    mine = bridge.mlp_diffusion_from_flax(
        _np(params), s_dim=S, out_dim=A, time_dim=16, cond_hidden_dims=(32, 24),
        cond_activation=cond_activation, n_blocks=2, hidden_dim=32)
    with torch.no_grad():
        got = mine(torch.from_numpy(s), torch.from_numpy(a),
                   torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("patch_size,pad", [(4, "same"), (1, "diffusers")])
def test_klvae_encode_matches_flax(patch_size, pad):
    cfg = dict(block_out_channels=(8, 16, 16), norm_groups=4,
               latent_channels=4, patch_size=patch_size, downsample_pad=pad)
    vae = KLVAE(**cfg)
    img = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    params = vae.init(jax.random.PRNGKey(2), jnp.asarray(img),
                      jax.random.PRNGKey(0))["params"]
    mean, logvar = vae.apply({"params": params}, img, method=KLVAE.encode)
    mine = bridge.load_klvae_encoder(TorchKLVAE(**cfg), _np(params))
    with torch.no_grad():
        got_mean, got_logvar = mine.encode(torch.from_numpy(img))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_logvar.numpy(), np.asarray(logvar),
                               atol=ATOL, rtol=0)


def test_transfer_golden_through_bridge():
    """The recorded reference-network outputs, reached through the JAX
    package's reference-name mapping and then this bridge (atol 1e-4: the
    JAX package's own bar is 2e-5, and torch sums in another order)."""
    data = np.load(FIXTURE)
    unet = {k[5:]: data[k] for k in data.files if k.startswith("unet:")}
    idm = {k[4:]: data[k] for k in data.files if k.startswith("idm:")}
    unet_p = _np(transfer.map_unet1d_params(transfer._unflat(unet), (8, 16)))
    idm_p = _np(transfer.map_mlp_diffusion_params(transfer._unflat(idm)))
    u = bridge.unet1d_from_flax(unet_p, input_dim=5, global_cond_dim=6,
                                down_dims=(8, 16), n_groups=8)
    m = bridge.mlp_diffusion_from_flax(
        idm_p, s_dim=10, out_dim=7, time_dim=16, cond_hidden_dims=(32, 32),
        cond_activation="mish", n_blocks=2, hidden_dim=32,
        learnable_time=False)
    with torch.no_grad():
        u_out = u(torch.from_numpy(data["x"]), torch.from_numpy(data["t"]),
                  torch.from_numpy(data["g"])).numpy()
        m_out = m(torch.from_numpy(data["s"]), torch.from_numpy(data["a"]),
                  torch.from_numpy(data["tt"])).numpy()
    np.testing.assert_allclose(u_out, data["unet_out"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(m_out, data["idm_out"], atol=ATOL, rtol=0)
