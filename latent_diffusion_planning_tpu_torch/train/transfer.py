"""Reference-checkpoint parameter naming: the map between the reference
implementation's Flax parameter trees and the JAX package's.

The port's copy of ``latent_diffusion_planning_tpu/train/transfer.py``
(plain Python over nested dicts of arrays). It works on Flax naming on both
sides; ``bridge.py`` moves a tree in the JAX package's naming into the
port's modules and back (``load_*`` / ``export_*``), so a reference
checkpoint reaches the port as reference tree → ``map_*`` → ``bridge.load_*``,
and the port's weights leave as ``bridge.export_*`` → ``export_*``
(``tools/import_reference_ckpt_torch.py``,
``tools/export_reference_ckpt_torch.py``).

- ``map_unet1d_params`` / ``export_unet1d_params``: the reference's
  ``networks/diffusion_nets_v2.ConditionalUnet1D`` (ConditionalResidualBlock1D
  / Conv1dBlock / Downsample1d / Upsample1d auto-names) ↔ the JAX package's
  ``ConditionalUnet1D`` (FiLMResBlock1D / ConvBlock1D / flat Conv_i);
- ``map_mlp_diffusion_params`` / ``export_mlp_diffusion_params``: the
  reference's ``MLPDiffusion`` has the same Flax naming, checked and passed
  through;
- ``map_diffusers_vae_params`` / ``export_diffusers_vae_params``:
  ``diffusers.FlaxAutoencoderKL`` trees (conv_in / down_blocks_i / mid_block
  / conv_norm_out / conv_out / quant_conv, NHWC kernels) ↔ ``KLVAE``, one
  table of prefix pairs (``_vae_prefix_pairs``) for both directions. An
  imported VAE runs as the port's ``KLVAE(downsample_pad="diffusers")``:
  diffusers pads its downsampling convs (0, 1), not SAME.

Every rename is a bijection, so export then import returns every array as
it was, bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence


def _flat(tree: Mapping, pre: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{pre}/{k}" if pre else str(k)
        if isinstance(v, Mapping):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _unflat(flat: Mapping[str, Any]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ---------------------------------------------------------------------------
# planner U-Net
# ---------------------------------------------------------------------------

def map_unet1d_params(ref_params: Mapping,
                      down_dims: Sequence[int]) -> dict:
    """Reference ConditionalUnet1D pytree → ours.

    Renames (structure is 1:1 — both are the Diffusion Policy U-Net):
      ConditionalResidualBlock1D_i → FiLMResBlock1D_i
      ...Conv1dBlock_j → ConvBlock1D_j       (film Dense_0/proj Conv_0 as-is)
      Downsample1d_k/Conv_0 → Conv_k
      Upsample1d_k/ConvTranspose_0 → ConvTranspose_k
      Conv1dBlock_0 (final) → ConvBlock1D_0
      Conv_0 (final 1x1) → Conv_{L-1}; time-MLP Dense_0/Dense_1 as-is.
    """
    L = len(down_dims)
    flat = _flat(ref_params)
    out = {}
    for key, v in flat.items():
        parts = key.split("/")
        head = parts[0]
        if head.startswith("ConditionalResidualBlock1D_"):
            idx = head.split("_")[-1]
            rest = "/".join(parts[1:])
            rest = rest.replace("Conv1dBlock_", "ConvBlock1D_")
            out[f"FiLMResBlock1D_{idx}/{rest}"] = v
        elif head.startswith("Downsample1d_"):
            idx = head.split("_")[-1]
            assert parts[1] == "Conv_0"
            out[f"Conv_{idx}/{parts[2]}"] = v
        elif head.startswith("Upsample1d_"):
            idx = head.split("_")[-1]
            assert parts[1] == "ConvTranspose_0"
            out[f"ConvTranspose_{idx}/{parts[2]}"] = v
        elif head == "Conv1dBlock_0":
            out["ConvBlock1D_0/" + "/".join(parts[1:])] = v
        elif head == "Conv_0":  # reference's final 1x1 conv
            out[f"Conv_{L - 1}/" + "/".join(parts[1:])] = v
        elif head in ("Dense_0", "Dense_1"):
            out[key] = v
        else:
            raise KeyError(f"unrecognized reference U-Net param {key!r}")
    return _unflat(out)


# ---------------------------------------------------------------------------
# IDM diffusion MLP
# ---------------------------------------------------------------------------

def map_mlp_diffusion_params(ref_params: Mapping) -> dict:
    """Reference MLPDiffusion pytree → ours (identical flax auto-naming)."""
    flat = _flat(ref_params)
    for key in flat:
        head = key.split("/")[0]
        assert head in ("FourierFeatures_0", "MLP_0", "MLPResNet_0"), (
            f"unrecognized reference IDM param {key!r}")
    return _unflat(dict(flat))


def export_unet1d_params(params: Mapping,
                         down_dims: Sequence[int]) -> dict:
    """Inverse of :func:`map_unet1d_params`: ours → reference naming.

    Emits the flax auto-naming the reference's
    ``networks/diffusion_nets_v2.ConditionalUnet1D`` produces, so a policy
    trained here can be restored by the reference's checkpoint protocol
    (train_bc.py:210-240 rebinds any ``*_params`` key). The rename is a
    bijection — ``map_unet1d_params(export_unet1d_params(p)) == p``.
    """
    L = len(down_dims)
    flat = _flat(params)
    out = {}
    for key, v in flat.items():
        parts = key.split("/")
        head = parts[0]
        if head.startswith("FiLMResBlock1D_"):
            idx = head.split("_")[-1]
            rest = "/".join(parts[1:]).replace("ConvBlock1D_", "Conv1dBlock_")
            out[f"ConditionalResidualBlock1D_{idx}/{rest}"] = v
        elif head.startswith("ConvTranspose_"):
            idx = head.split("_")[-1]
            out[f"Upsample1d_{idx}/ConvTranspose_0/{parts[1]}"] = v
        elif head == f"Conv_{L - 1}":  # final 1x1 conv
            out["Conv_0/" + "/".join(parts[1:])] = v
        elif head.startswith("Conv_"):
            idx = head.split("_")[-1]
            out[f"Downsample1d_{idx}/Conv_0/{parts[1]}"] = v
        elif head == "ConvBlock1D_0":  # final conv block
            out["Conv1dBlock_0/" + "/".join(parts[1:])] = v
        elif head in ("Dense_0", "Dense_1"):
            out[key] = v
        else:
            raise KeyError(f"unrecognized U-Net param {key!r}")
    return _unflat(out)


def export_mlp_diffusion_params(params: Mapping) -> dict:
    """Ours → reference MLPDiffusion (identical naming, validated)."""
    return map_mlp_diffusion_params(params)


# ---------------------------------------------------------------------------
# diffusers FlaxAutoencoderKL
# ---------------------------------------------------------------------------

def _vae_prefix_pairs(L: int, layers_per_block: int) -> list[tuple[str, str]]:
    """(ours, theirs) leaf-module prefix pairs for the KLVAE ↔ diffusers map.

    Single source of truth for both directions; theirs-side prefixes double
    as the strict-coverage universe.
    """
    pairs: list[tuple[str, str]] = []

    def put(dst, src):
        pairs.append((dst, src))

    def resblock(dst, src):
        put(f"{dst}/GroupNorm_0", f"{src}/norm1")
        put(f"{dst}/Conv_0", f"{src}/conv1")
        put(f"{dst}/GroupNorm_1", f"{src}/norm2")
        put(f"{dst}/Conv_1", f"{src}/conv2")
        put(f"{dst}/shortcut", f"{src}/conv_shortcut")

    def attention(dst, src):
        put(f"{dst}/GroupNorm_0", f"{src}/group_norm")
        put(f"{dst}/Dense_0", f"{src}/query")
        put(f"{dst}/Dense_1", f"{src}/key")
        put(f"{dst}/Dense_2", f"{src}/value")
        put(f"{dst}/Dense_3", f"{src}/proj_attn")

    # ---- encoder ----
    put("encoder/Conv_0", "encoder/conv_in")
    blk = 0
    for i in range(L):
        for j in range(layers_per_block):
            resblock(f"encoder/ResBlock2D_{blk}",
                     f"encoder/down_blocks_{i}/resnets_{j}")
            blk += 1
        if i < L - 1:
            put(f"encoder/Conv_{i + 1}",
                f"encoder/down_blocks_{i}/downsamplers_0/conv")
    resblock(f"encoder/ResBlock2D_{blk}", "encoder/mid_block/resnets_0")
    attention("encoder/MidAttention_0", "encoder/mid_block/attentions_0")
    resblock(f"encoder/ResBlock2D_{blk + 1}", "encoder/mid_block/resnets_1")
    put("encoder/GroupNorm_0", "encoder/conv_norm_out")
    put(f"encoder/Conv_{L}", "encoder/conv_out")
    put("encoder/quant_conv", "quant_conv")

    # ---- decoder ----
    put("decoder/post_quant_conv", "post_quant_conv")
    put("decoder/Conv_0", "decoder/conv_in")
    resblock("decoder/ResBlock2D_0", "decoder/mid_block/resnets_0")
    attention("decoder/MidAttention_0", "decoder/mid_block/attentions_0")
    resblock("decoder/ResBlock2D_1", "decoder/mid_block/resnets_1")
    blk = 2
    for i in range(L):
        for j in range(layers_per_block + 1):
            resblock(f"decoder/ResBlock2D_{blk}",
                     f"decoder/up_blocks_{i}/resnets_{j}")
            blk += 1
        if i < L - 1:
            put(f"decoder/Conv_{i + 1}",
                f"decoder/up_blocks_{i}/upsamplers_0/conv")
    put("decoder/GroupNorm_0", "decoder/conv_norm_out")
    put(f"decoder/Conv_{L}", "decoder/conv_out")
    return pairs


def _map_by_pairs(flat: Mapping[str, Any], prefix_map: Mapping[str, str],
                  what: str, strict: bool) -> dict:
    out = {}
    for dst, src in prefix_map.items():
        for suffix in ("kernel", "bias", "scale"):
            k = f"{src}/{suffix}"
            if k in flat:
                out[f"{dst}/{suffix}"] = flat[k]
    consumed = {f"{s}/{x}" for s in prefix_map.values()
                for x in ("kernel", "bias", "scale")}
    unmapped = set(flat) - consumed
    if unmapped:
        msg = (f"{what} left {len(unmapped)} source param(s) unmapped "
               f"(wrong block_out_channels/layers_per_block?): "
               f"{sorted(unmapped)[:8]}")
        if strict:
            raise ValueError(msg)
        import warnings
        warnings.warn(msg, stacklevel=3)
    return _unflat(out)


def map_diffusers_vae_params(ref_params: Mapping,
                             block_out_channels: Sequence[int],
                             layers_per_block: int = 2,
                             strict: bool = True) -> dict:
    """diffusers FlaxAutoencoderKL pytree → models/vae.KLVAE params.

    Both are NHWC flax convs so kernels transfer verbatim; only the module
    naming differs. Use with KLVAE(downsample_pad='diffusers') — diffusers
    downsample convs pad ((0,1),(0,1)), not SAME.

    ``strict`` raises when any source parameter is not consumed by the
    mapping — a wrong block_out_channels/layers_per_block would otherwise
    silently yield a partially mapped pytree.
    """
    pairs = _vae_prefix_pairs(len(block_out_channels), layers_per_block)
    return _map_by_pairs(_flat(ref_params), dict(pairs),
                         "map_diffusers_vae_params", strict)


def export_diffusers_vae_params(params: Mapping,
                                block_out_channels: Sequence[int],
                                layers_per_block: int = 2,
                                strict: bool = True) -> dict:
    """Inverse of :func:`map_diffusers_vae_params`: KLVAE → diffusers naming.

    Only valid for reference-shaped KLVAEs (``patch_size=1`` — the
    patchified stem has no diffusers counterpart); use
    ``downsample_pad='diffusers'`` on the module the params came from so the
    exported checkpoint is bit-equivalent under the reference's padding.
    """
    pairs = _vae_prefix_pairs(len(block_out_channels), layers_per_block)
    return _map_by_pairs(_flat(params), {src: dst for dst, src in pairs},
                         "export_diffusers_vae_params", strict)
