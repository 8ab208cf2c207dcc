"""VAE latents of welded camera frames.

Counterpart of ``tools/process_latents.py``'s ``encode_file`` as a library
function: every frame of every demo (the terminal one too) is normalized
from [0, 255] to [-1, 1] and encoded by the frozen VAE to its posterior
mean, flattened, in fixed-size shards (the last padded by repeating its
final frame) so one shape serves every call. The result goes into
``latent_<key>`` beside the frames; the global ``min_z``/``max_z`` are
returned, as the tool records them.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..models.vae import KLVAE
from ..ops import normalize as nz
from .ingest import WeldedDemos

IMAGE_STATS = {"min": 0, "max": 255}


@torch.no_grad()
def encode_latents(welded: WeldedDemos, vae: KLVAE, rgb_keys: Sequence[str],
                   shard: int = 128) -> tuple[float, float]:
    """Add ``latent_<key>`` (N_total, latent dim) float32 arrays for each of
    ``rgb_keys`` to ``welded`` (on the VAE's device) and its obs keys;
    returns (min_z, max_z) over all of them."""
    dev = next(vae.parameters()).device
    lo = hi = None
    for key in rgb_keys:
        frames = welded.arrays[key]
        zs = []
        for i in range(0, frames.shape[0], shard):
            chunk = frames[i:i + shard].to(dev)
            n = chunk.shape[0]
            if n < shard:
                chunk = torch.cat([chunk, chunk[-1:].expand(
                    shard - n, *chunk.shape[1:])])
            x = nz.normalize_tree({key: chunk}, {key: IMAGE_STATS})[key]
            mean, _ = vae.encode(x)
            zs.append(mean.reshape(shard, -1)[:n])
        z = torch.cat(zs).float()
        welded.arrays[f"latent_{key}"] = z
        lo = z.min() if lo is None else torch.minimum(lo, z.min())
        hi = z.max() if hi is None else torch.maximum(hi, z.max())
    welded.obs_keys = tuple(welded.obs_keys) + tuple(
        f"latent_{k}" for k in rgb_keys if f"latent_{k}" not in welded.obs_keys)
    return float(lo), float(hi)
