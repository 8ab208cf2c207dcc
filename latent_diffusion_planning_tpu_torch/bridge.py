"""Flax parameter pytrees → the port's modules, and back.

The input is what the JAX package's checkpoints hold: nested dicts of
arrays (numpy or anything ``np.asarray`` takes), for example the
``{planner_params, idm_params, vae_params}`` snapshot that
``Checkpointer.restore_raw`` returns. This module never reads a checkpoint
itself; the caller does.

Mapping rules:
- Dense kernels (in, out) are transposed to torch's (out, in);
- Conv kernels (k, Cin, Cout) and NHWC (kh, kw, Cin, Cout) become torch's
  (Cout, Cin, k...);
- ConvTranspose taps are flipped: Flax maps ``x[t] w[j] → y[2t+2-j]``,
  torch's ``conv_transpose1d`` ``x[t] w[j] → y[2t+j-p]``;
- GroupNorm/LayerNorm ``scale`` becomes ``weight``.

``export_unet1d``, ``export_mlp_diffusion`` and ``export_klvae`` run the
same loaders in the other direction: handed an ``_Export`` tree, each leaf
helper writes the module's tensor, transformed back, where it would have
read it. One walk serves both directions, so export then load returns
every weight bit for bit (the transforms are transposes and flips).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .models.agents import common
from .models.agents.dp import DPAgent
from .models.agents.dp import build_nets as build_dp_nets
from .models.agents.dp_vae import DPVAEAgent
from .models.agents.ldp import LDPAgent
from .models.agents.ldp_hier import LDPHierAgent
from .models.nets.mlp import MLP, MLPDiffusion, MLPResNetBlock
from .models.nets.resnet import ResNetEncoder
from .models.nets.unet1d import ConditionalUnet1D, unet_from_config
from .models.vae import KLVAE


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Export(dict):
    """A Flax tree that the loaders fill from a module instead of reading
    it: a missing key is a new subtree."""

    def __missing__(self, key):
        self[key] = _Export()
        return self[key]

    def get(self, key, default=None):
        return self[key]


def _put(p: Mapping, name: str, value: torch.Tensor) -> bool:
    """In an export, ``p[name]`` = ``value`` as a float32 numpy array;
    True when ``p`` is an export (the caller then reads nothing)."""
    if isinstance(p, _Export):
        p[name] = np.ascontiguousarray(
            value.detach().to("cpu", torch.float32).numpy())
        return True
    return False


def _plain(tree: Mapping) -> dict:
    return {k: _plain(v) if isinstance(v, Mapping) else v
            for k, v in tree.items()}


def _copy(param: torch.Tensor, value: torch.Tensor) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch: {tuple(param.shape)} vs "
                         f"{tuple(value.shape)}")
    with torch.no_grad():
        param.copy_(value)


def _bias(param: torch.Tensor | None, p: Mapping) -> None:
    if param is not None and not _put(p, "bias", param):
        _copy(param, _t(p["bias"]))


def _dense(lin: nn.Linear, p: Mapping) -> None:
    if not _put(p, "kernel", lin.weight.t()):
        _copy(lin.weight, _t(p["kernel"]).t())
    _bias(lin.bias, p)


def _conv1d(conv: nn.Conv1d, p: Mapping) -> None:
    if not _put(p, "kernel", conv.weight.permute(2, 1, 0)):
        _copy(conv.weight, _t(p["kernel"]).permute(2, 1, 0))
    _bias(conv.bias, p)


def _conv2d(conv: nn.Conv2d, p: Mapping) -> None:
    if not _put(p, "kernel", conv.weight.permute(2, 3, 1, 0)):
        _copy(conv.weight, _t(p["kernel"]).permute(3, 2, 0, 1))
    _bias(conv.bias, p)


def _conv_transpose1d(conv: nn.ConvTranspose1d, p: Mapping) -> None:
    if not _put(p, "kernel", conv.weight.permute(2, 0, 1).flip(0)):
        _copy(conv.weight, _t(p["kernel"]).flip(0).permute(1, 2, 0))
    _bias(conv.bias, p)


def _norm(norm: nn.Module, p: Mapping) -> None:
    if not _put(p, "scale", norm.weight):
        _copy(norm.weight, _t(p["scale"]))
    _bias(norm.bias, p)


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------

def load_unet1d(net: ConditionalUnet1D, params: Mapping) -> ConditionalUnet1D:
    """Flax names the top level's plain convs in call order: the stride-2
    downsamples ``Conv_0``… (none when the net does not downsample), then
    the final 1×1 conv."""
    _dense(net.time_dense0, params["Dense_0"])
    _dense(net.time_dense1, params["Dense_1"])
    for i, blk in enumerate(net.blocks):
        p = params[f"FiLMResBlock1D_{i}"]
        for mine, name in ((blk.block0, "ConvBlock1D_0"),
                           (blk.block1, "ConvBlock1D_1")):
            _conv1d(mine.conv, p[name]["Conv_0"])
            _norm(mine.norm, p[name]["GroupNorm_0"])
        _dense(blk.film, p["Dense_0"])
        if blk.proj is not None:
            _conv1d(blk.proj, p["Conv_0"])
    for i, conv in enumerate(net.downs):
        _conv1d(conv, params[f"Conv_{i}"])
    for i, up in enumerate(net.ups):
        _conv_transpose1d(up, params[f"ConvTranspose_{i}"])
    _conv1d(net.final_block.conv, params["ConvBlock1D_0"]["Conv_0"])
    _norm(net.final_block.norm, params["ConvBlock1D_0"]["GroupNorm_0"])
    _conv1d(net.final_conv, params[f"Conv_{len(net.downs)}"])
    return net


def unet1d_from_flax(params: Mapping, *, input_dim: int, global_cond_dim: int,
                     diffusion_step_embed_dim: int = 256,
                     down_dims=(256, 512, 1024), kernel_size: int = 5,
                     n_groups: int = 8,
                     downsample: bool = True) -> ConditionalUnet1D:
    net = ConditionalUnet1D(input_dim, global_cond_dim,
                            diffusion_step_embed_dim, down_dims, kernel_size,
                            n_groups, downsample)
    return load_unet1d(net, params)


def load_mlp(mlp: MLP, params: Mapping) -> MLP:
    """A Flax ``MLP``'s tree: ``Dense_<i>`` and, with LayerNorm,
    ``LayerNorm_<i>`` after each activated layer."""
    for i, lin in enumerate(mlp.dense):
        _dense(lin, params[f"Dense_{i}"])
    for i, norm in enumerate(mlp.norms or ()):
        _norm(norm, params[f"LayerNorm_{i}"])
    return mlp


def load_mlp_resnet_block(blk: MLPResNetBlock,
                          params: Mapping) -> MLPResNetBlock:
    """A Flax ``MLPResNetBlock``'s tree: ``LayerNorm_0`` (when it has one),
    ``Dense_0``, ``Dense_1`` and, where its input is not ``features`` wide,
    the residual's projection ``Dense_2``."""
    if blk.proj is None and "Dense_2" in params:
        raise ValueError("the Flax block projects its residual, this one "
                         "takes an input as wide as its features")
    if isinstance(blk.norm, nn.LayerNorm):
        _norm(blk.norm, params["LayerNorm_0"])
    _dense(blk.dense0, params["Dense_0"])
    _dense(blk.dense1, params["Dense_1"])
    if blk.proj is not None:
        _dense(blk.proj, params["Dense_2"])
    return blk


def load_mlp_diffusion(net: MLPDiffusion, params: Mapping) -> MLPDiffusion:
    if net.learnable_time:
        p = params["FourierFeatures_0"]
        if not _put(p, "kernel", net.time.kernel):
            _copy(net.time.kernel, _t(p["kernel"]))
    load_mlp(net.cond, params["MLP_0"])
    trunk = params["MLPResNet_0"]
    _dense(net.trunk.dense0, trunk["Dense_0"])
    for i, blk in enumerate(net.trunk.blocks):
        load_mlp_resnet_block(blk, trunk[f"MLPResNetBlock_{i}"])
    _dense(net.trunk.dense1, trunk["Dense_1"])
    return net


def mlp_diffusion_from_flax(params: Mapping, *, s_dim: int, out_dim: int,
                            **cfg) -> MLPDiffusion:
    """``cfg``: MLPDiffusion's remaining fields (time_dim, n_blocks, ...)."""
    cfg = dict(cfg)
    cfg.setdefault("learnable_time", "FourierFeatures_0" in params)
    return load_mlp_diffusion(MLPDiffusion(s_dim, out_dim, **cfg), params)


def _resblock2d(blk, p: Mapping) -> None:
    _norm(blk.norm0, p["GroupNorm_0"])
    _conv2d(blk.conv0, p["Conv_0"])
    _norm(blk.norm1, p["GroupNorm_1"])
    _conv2d(blk.conv1, p["Conv_1"])
    if blk.shortcut is not None:
        _conv2d(blk.shortcut, p["shortcut"])


def _mid_attention(attn, p: Mapping) -> None:
    _norm(attn.norm, p["GroupNorm_0"])
    for lin, name in ((attn.q, "Dense_0"), (attn.k, "Dense_1"),
                      (attn.v, "Dense_2"), (attn.out, "Dense_3")):
        _dense(lin, p[name])


def load_klvae_encoder(vae: KLVAE, params: Mapping) -> KLVAE:
    """``params``: the KLVAE's full tree ({encoder, decoder}) or the
    encoder's alone."""
    p = params.get("encoder", params)
    enc = vae.encoder
    n_conv = 0
    if enc.stem.stride != (1, 1):       # the patchified stem
        _conv2d(enc.stem, p["patch_stem"])
    else:
        _conv2d(enc.stem, p["Conv_0"])
        n_conv = 1
    n_res = 0
    for i, blocks in enumerate(enc.levels):
        for blk in blocks:
            _resblock2d(blk, p[f"ResBlock2D_{n_res}"])
            n_res += 1
        if i < len(enc.downs):
            _conv2d(enc.downs[i], p[f"Conv_{n_conv}"])
            n_conv += 1
    _resblock2d(enc.mid0, p[f"ResBlock2D_{n_res}"])
    if enc.attn is not None:
        _mid_attention(enc.attn, p["MidAttention_0"])
    _resblock2d(enc.mid1, p[f"ResBlock2D_{n_res + 1}"])
    _norm(enc.norm_out, p["GroupNorm_0"])
    _conv2d(enc.conv_out, p[f"Conv_{n_conv}"])
    _conv2d(enc.quant_conv, p["quant_conv"])
    return vae


def load_klvae_decoder(vae: KLVAE, params: Mapping) -> KLVAE:
    """``params``: the KLVAE's full tree or the decoder's alone. Flax names
    the decoder's convs in call order (``Conv_0`` in, then one per
    upsample, then the head unless it is ``unpatch_head``); the head's
    output channels keep the JAX order, which ``Decoder.forward`` shuffles
    as the JAX head does."""
    p = params.get("decoder", params)
    dec = vae.decoder
    _conv2d(dec.post_quant_conv, p["post_quant_conv"])
    _conv2d(dec.conv_in, p["Conv_0"])
    _resblock2d(dec.mid0, p["ResBlock2D_0"])
    if dec.attn is not None:
        _mid_attention(dec.attn, p["MidAttention_0"])
    _resblock2d(dec.mid1, p["ResBlock2D_1"])
    n_res = 2
    for i, blocks in enumerate(dec.levels):
        for blk in blocks:
            _resblock2d(blk, p[f"ResBlock2D_{n_res}"])
            n_res += 1
        if i < len(dec.ups):
            _conv2d(dec.ups[i], p[f"Conv_{i + 1}"])
    _norm(dec.norm_out, p["GroupNorm_0"])
    _conv2d(dec.conv_out, p["unpatch_head"] if dec.patch_size > 1
            else p[f"Conv_{len(dec.ups) + 1}"])
    return vae


def load_klvae(vae: KLVAE, params: Mapping) -> KLVAE:
    """The whole VAE from its ``{encoder, decoder}`` tree."""
    return load_klvae_decoder(load_klvae_encoder(vae, params), params)


def klvae_from_flax(params: Mapping, **cfg) -> KLVAE:
    """``cfg``: KLVAE's fields (``configs.BENCH_AGENT["vae"]``'s keys)."""
    return load_klvae(KLVAE(**cfg), params)


def load_resnet(net: ResNetEncoder, params: Mapping) -> ResNetEncoder:
    """A ``ResNetEncoder``'s Flax tree: ``conv_init``, ``norm_init``, then
    ``<block class>_<n>`` in call order, each with ``Conv_*`` and its
    norms (``GroupNorm_*`` or ``LayerNorm_*``) in call order and, where the
    shape changes, ``conv_proj`` and ``norm_proj``; the heads'
    ``SpatialSoftmax_0`` (a learned temperature), ``SpatialLearnedEmbeddings_0``
    and ``MLP_0``; with conditioning, ``FilmConditioning_<n>`` (its
    ``Dense_0`` adds, ``Dense_1`` scales) and the gates ``Dense_<n>``."""
    _conv2d(net.conv_init, params["conv_init"])
    _norm(net.norm_init, params["norm_init"])
    for n, blk in enumerate(net.blocks):
        p = params[f"{type(blk).__name__}_{n}"]
        norm = "GroupNorm" if isinstance(blk.norm0, nn.GroupNorm) else "LayerNorm"
        convs = [blk.conv0, blk.conv1] + ([blk.conv2] if hasattr(blk, "conv2")
                                          else [])
        norms = [blk.norm0, blk.norm1] + ([blk.norm2] if hasattr(blk, "norm2")
                                          else [])
        for i, (conv, nm) in enumerate(zip(convs, norms)):
            _conv2d(conv, p[f"Conv_{i}"])
            _norm(nm, p[f"{norm}_{i}"])
        if blk.proj is not None:
            _conv2d(blk.proj, p["conv_proj"])
            _norm(blk.norm_proj, p["norm_proj"])
    for i, film in enumerate(net.films or ()):
        p = params[f"FilmConditioning_{i}"]
        _dense(film.add, p["Dense_0"])
        _dense(film.mult, p["Dense_1"])
    for i, gate in enumerate(net.gates or ()):
        _dense(gate, params[f"Dense_{i}"])
    if "SpatialSoftmax_0" in params:
        _copy(net.pool.softmax_temperature,
              _t(params["SpatialSoftmax_0"]["softmax_temperature"]))
    if "SpatialLearnedEmbeddings_0" in params:
        _copy(net.pool.kernel,
              _t(params["SpatialLearnedEmbeddings_0"]["kernel"]))
    if net.mlp is not None:
        for i, lin in enumerate(net.mlp.dense):
            _dense(lin, params["MLP_0"][f"Dense_{i}"])
    return net


def export_unet1d(net: ConditionalUnet1D) -> dict:
    """The Flax tree ``load_unet1d`` reads, of ``net``'s weights (numpy)."""
    tree = _Export()
    load_unet1d(net, tree)
    return _plain(tree)


def export_mlp_diffusion(net: MLPDiffusion) -> dict:
    """The Flax tree ``load_mlp_diffusion`` reads, of ``net``'s weights."""
    tree = _Export()
    load_mlp_diffusion(net, tree)
    return _plain(tree)


def export_klvae(vae: KLVAE) -> dict:
    """The ``{encoder, decoder}`` Flax tree ``load_klvae`` reads, of
    ``vae``'s weights."""
    tree = _Export()
    load_klvae(vae, tree)
    return _plain(tree)


def resnet_from_flax(params: Mapping, **cfg) -> ResNetEncoder:
    """``cfg``: ResNetEncoder's fields, ``image_shape`` (H, W, C) among
    them."""
    return load_resnet(ResNetEncoder(**cfg), params)


# ---------------------------------------------------------------------------
# the agents
# ---------------------------------------------------------------------------

def ldp_agent_from_flax(snapshot: Mapping, config: Mapping,
                        shape_meta: Mapping,
                        device: torch.device | str | None = None) -> LDPAgent:
    """An LDPAgent from a ``{planner_params, idm_params, vae_params}``
    snapshot and the agent config dict (``configs.BENCH_AGENT``'s keys)."""
    dev = resolve_device(device)
    obs_dim, action_dim = common.obs_dims(shape_meta, config["rgb_obs"],
                                          config["lowdim_obs"],
                                          config["vae_feature_dim"])
    planner = load_unet1d(
        unet_from_config(config["planner"], obs_dim,
                         obs_dim * config["obs_horizon"]),
        snapshot["planner_params"])
    i = config["idm_net"]
    idm = mlp_diffusion_from_flax(
        snapshot["idm_params"], s_dim=2 * obs_dim, out_dim=action_dim,
        time_dim=i.get("time_dim", 64),
        cond_hidden_dims=i.get("cond_hidden_dims", (128, 128)),
        cond_activation=i.get("cond_activation", "swish"),
        n_blocks=i.get("n_blocks", 3), hidden_dim=i.get("hidden_dim", 256),
        use_layer_norm=i.get("use_layer_norm", True),
        dropout_rate=i.get("dropout_rate"),
        compute_dtype=i.get("compute_dtype", "float32"))
    vae = load_klvae(KLVAE(**config.get("vae", {})), snapshot["vae_params"])
    return LDPAgent.assemble(planner, idm, vae, config, obs_dim, action_dim,
                             dev)


def dp_vae_agent_from_flax(snapshot: Mapping, config: Mapping,
                           shape_meta: Mapping,
                           device: torch.device | str | None = None
                           ) -> DPVAEAgent:
    """A DPVAEAgent from a ``{planner_params, vae_params}`` snapshot (and
    ``planner_ema_params`` when it holds them) and the agent config dict
    (the ``agent`` of ``configs.lift_dp_vae_train_config()``)."""
    dev = resolve_device(device)
    obs_dim, action_dim = common.obs_dims(shape_meta, config["rgb_obs"],
                                          config["lowdim_obs"],
                                          config.get("vae_feature_dim", 16))
    planner = load_unet1d(
        unet_from_config(config["planner"], action_dim,
                         obs_dim * config.get("obs_horizon", 1)),
        snapshot["planner_params"])
    vae = load_klvae(KLVAE(**config.get("vae", {})), snapshot["vae_params"])
    agent = DPVAEAgent.assemble(planner, vae, config, obs_dim, action_dim, dev)
    ema = agent.planner_state.ema
    if ema is not None and snapshot.get("planner_ema_params") is not None:
        load_unet1d(ema, snapshot["planner_ema_params"])
    return agent


def dp_agent_from_flax(snapshot: Mapping, config: Mapping, shape_meta: Mapping,
                       device: torch.device | str | None = None) -> DPAgent:
    """A DPAgent from a JAX ``get_params()`` snapshot (``planner_params``
    and ``encoder_params`` ``{<key>_params}``, each key a camera or
    ``shared``; with ``planner_ema_params`` and ``encoder_ema_params`` when
    it holds them) and the agent config dict (the ``agent`` of
    ``configs.lift_dp_train_config()``)."""
    dev = resolve_device(device)
    # the weights are loaded below: the draws go to a throwaway generator
    planner, encoders = build_dp_nets(config, shape_meta, torch.Generator())
    load_unet1d(planner, snapshot["planner_params"])
    for key, net in encoders.items():
        load_resnet(net, snapshot["encoder_params"][f"{key}_params"])
    agent = DPAgent.assemble(planner, encoders, config, shape_meta, dev)
    ema = agent.planner_state.ema
    if ema is not None and snapshot.get("planner_ema_params") is not None:
        load_unet1d(ema, snapshot["planner_ema_params"])
    for key, state in agent.encoder_states.items():
        tree = (snapshot.get("encoder_ema_params") or {}).get(f"{key}_params")
        if state.ema is not None and tree is not None:
            load_resnet(state.ema, tree)
    return agent


def ldp_hier_agent_from_flax(snapshot: Mapping, config: Mapping,
                             shape_meta: Mapping,
                             device: torch.device | str | None = None
                             ) -> LDPHierAgent:
    """An LDPHierAgent from a ``{planner_params, idm_params, vae_params}``
    snapshot (and ``planner_ema_params``, ``idm_ema_params`` when it holds
    them and the config tracks EMA copies) and the agent config dict (the
    ``agent`` of ``configs.lift_ldp_hier_train_config()``)."""
    dev = resolve_device(device)
    obs_dim, action_dim = common.obs_dims(shape_meta, config["rgb_obs"],
                                          config["lowdim_obs"],
                                          config["vae_feature_dim"])
    planner = load_unet1d(
        unet_from_config(config["planner"], obs_dim,
                         obs_dim * config["obs_horizon"]),
        snapshot["planner_params"])
    idm = load_unet1d(unet_from_config(config["idm_net"], action_dim,
                                       2 * obs_dim), snapshot["idm_params"])
    vae = load_klvae(KLVAE(**config.get("vae", {})), snapshot["vae_params"])
    agent = LDPHierAgent.assemble(planner, idm, vae, config, obs_dim,
                                  action_dim, dev)
    for name in ("planner", "idm"):
        ema = getattr(agent, f"{name}_state").ema
        if ema is not None and snapshot.get(f"{name}_ema_params") is not None:
            load_unet1d(ema, snapshot[f"{name}_ema_params"])
    return agent
