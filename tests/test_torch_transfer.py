"""Reference-checkpoint transfer in the port: ``train/transfer.py``,
``bridge.export_*`` and the three tools, against the JAX package's
``tests/test_transfer.py`` checks and its own ``transfer``.

``tests/fixtures/transfer_golden.npz`` holds the reference networks'
weights and activations at small widths; mapped through the port's
``transfer`` and ``bridge``, the port's nets reproduce them within the
fixture's tolerance (2e-5). The renames are bijections, so every round
trip (reference naming → Flax → the port's modules and back) returns the
arrays bit for bit.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.models.vae import KLVAE as JaxKLVAE
from latent_diffusion_planning_tpu.train import transfer as jtransfer
from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
from latent_diffusion_planning_tpu_torch.models.vae import KLVAE
from latent_diffusion_planning_tpu_torch.train import transfer
from latent_diffusion_planning_tpu_torch.train.checkpoint import Checkpointer
from torch_thread import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "transfer_golden.npz"
sys.path.insert(0, str(REPO / "tools"))


@pytest.fixture(scope="module")
def golden():
    data = np.load(FIXTURE)
    unet = {k[5:]: data[k] for k in data.files if k.startswith("unet:")}
    idm = {k[4:]: data[k] for k in data.files if k.startswith("idm:")}
    return data, transfer._unflat(unet), transfer._unflat(idm)


def _assert_trees_equal(a: dict, b: dict) -> None:
    fa, fb = transfer._flat(a), transfer._flat(b)
    assert set(fa) == set(fb), set(fa) ^ set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


def test_unet_golden_activations(golden):
    data, ref, _ = golden
    net = bridge.unet1d_from_flax(transfer.map_unet1d_params(ref, (8, 16)),
                                  input_dim=5, global_cond_dim=6,
                                  down_dims=(8, 16), kernel_size=5, n_groups=8)
    with torch.no_grad():
        out = net(torch.from_numpy(data["x"]), torch.from_numpy(data["t"]),
                  torch.from_numpy(data["g"]))
    np.testing.assert_allclose(out.numpy(), data["unet_out"], atol=2e-5)


def test_idm_golden_activations(golden):
    data, _, ref = golden
    net = bridge.mlp_diffusion_from_flax(
        transfer.map_mlp_diffusion_params(ref), s_dim=10, out_dim=7,
        time_dim=16, cond_hidden_dims=(32, 32), cond_activation="mish",
        n_blocks=2, hidden_dim=32, use_layer_norm=True, learnable_time=False)
    with torch.no_grad():
        out = net(torch.from_numpy(data["s"]), torch.from_numpy(data["a"]),
                  torch.from_numpy(data["tt"]))
    np.testing.assert_allclose(out.numpy(), data["idm_out"], atol=2e-5)


def test_maps_equal_the_jax_package(golden):
    """The port's copy renames exactly as the JAX package's does, both
    ways."""
    _, unet, idm = golden
    ours = transfer.map_unet1d_params(unet, (8, 16))
    _assert_trees_equal(ours, jtransfer.map_unet1d_params(unet, (8, 16)))
    _assert_trees_equal(transfer.export_unet1d_params(ours, (8, 16)),
                        jtransfer.export_unet1d_params(ours, (8, 16)))
    _assert_trees_equal(transfer.map_mlp_diffusion_params(idm),
                        jtransfer.map_mlp_diffusion_params(idm))


def test_unet_export_import_round_trip(golden):
    _, unet, _ = golden
    ours = transfer.map_unet1d_params(unet, (8, 16))
    _assert_trees_equal(transfer.export_unet1d_params(ours, (8, 16)), unet)
    # and through the port's module: Flax → torch → Flax
    net = bridge.unet1d_from_flax(ours, input_dim=5, global_cond_dim=6,
                                  down_dims=(8, 16), kernel_size=5, n_groups=8)
    _assert_trees_equal(bridge.export_unet1d(net), ours)


def test_diffusers_vae_round_trip_and_reconstruction():
    """A JAX KLVAE's weights (diffusers padding) → diffusers naming → back,
    every parameter bit for bit and the same names as the JAX package's
    map; loaded into the port's ``KLVAE(downsample_pad="diffusers")`` they
    reconstruct as the JAX VAE does, and the port's module exports them
    again unchanged."""
    bocs = (8, 16, 16)
    jvae = JaxKLVAE(block_out_channels=bocs, norm_groups=4,
                    downsample_pad="diffusers")
    img = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    params = jax.tree_util.tree_map(np.asarray, jvae.init(
        jax.random.PRNGKey(0), img, jax.random.PRNGKey(1))["params"])
    theirs = transfer.export_diffusers_vae_params(params, bocs)
    _assert_trees_equal(theirs,
                        jtransfer.export_diffusers_vae_params(params, bocs))
    mapped = transfer.map_diffusers_vae_params(theirs, bocs)
    _assert_trees_equal(mapped, params)
    vae = bridge.load_klvae(KLVAE(block_out_channels=bocs, norm_groups=4,
                                  downsample_pad="diffusers"), mapped)
    _assert_trees_equal(bridge.export_klvae(vae), params)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jvae.apply({"params": params}, img)[0])
    with torch.no_grad():
        got = vae(torch.from_numpy(img))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(ValueError, match="unmapped"):
        transfer.map_diffusers_vae_params(theirs, bocs[:2])


def _bench_agent(seed=0):
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    return LDPAgent.create(configs.bench_agent_config(), configs.SHAPE_META,
                           seed=seed, device="cpu")


def test_tools_round_trip_a_snapshot(tmp_path):
    """``export_reference_ckpt_torch`` → ``.npz`` in reference naming →
    ``import_reference_ckpt_torch`` → the snapshot's planner and IDM bit
    for bit; the JAX package's import tool reads the same ``.npz`` into the
    Flax trees the port's bridge exports."""
    import export_reference_ckpt_torch as exp_tool
    import import_reference_ckpt as jimport_tool
    import import_reference_ckpt_torch as imp_tool

    agent = _bench_agent(seed=4)
    src = Checkpointer(tmp_path / "ckpt").save_params(7, agent.get_params())
    exp_tool.main([f"src={src}", f"dst={tmp_path / 'ref.npz'}"])
    with np.load(tmp_path / "ref.npz") as f:
        flat = {k: f[k] for k in f.files}
    assert any(k.startswith("planner_params/ConditionalResidualBlock1D_0/")
               for k in flat)
    assert not any(k.startswith("vae_params") for k in flat)
    imp_tool.main([f"src={tmp_path / 'ref.npz'}",
                   f"dst={tmp_path / 'back.ckpt'}"])
    back = Checkpointer(tmp_path).restore_raw(tmp_path / "back.ckpt")
    assert set(back) == {"planner_params", "idm_params"}
    for key in back:
        mine = getattr(agent, key[:-len("_params")]).state_dict()
        for k, v in mine.items():
            assert torch.equal(v, back[key][k]), (key, k)
    down = configs.bench_agent_config()["planner"]["down_dims"]
    jax_side = jimport_tool.convert(transfer._unflat(flat), down, None)
    _assert_trees_equal(jax_side["planner_params"],
                        bridge.export_unet1d(agent.planner))
    _assert_trees_equal(jax_side["idm_params"],
                        bridge.export_mlp_diffusion(agent.idm))


def test_roundtrip_eval_scores_both_agents_alike(tmp_path):
    """``roundtrip_eval_torch.roundtrip_eval`` on the kinematic env: equal
    tensors, equal actions at every decision, a delta of exactly 0; a
    changed weight is caught."""
    import export_reference_ckpt_torch as exp_tool
    import import_reference_ckpt_torch as imp_tool
    import roundtrip_eval_torch as rt

    agent = _bench_agent(seed=5)
    reimported = imp_tool.convert(exp_tool.export(agent), agent)
    out = rt.roundtrip_eval(agent, reimported, LiftEnv(episode_len=8), 2, 7,
                            configs.BENCH_POLICY_KEYS, "cpu")
    assert out["delta_pp"] == 0.0 and out["decisions"] == 2
    with torch.no_grad():
        next(iter(reimported["idm_params"].values())).add_(1e-3)
    with pytest.raises(AssertionError, match="changed"):
        rt.compare(agent, reimported)
