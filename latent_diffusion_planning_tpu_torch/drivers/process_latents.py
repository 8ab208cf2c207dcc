"""A dataset's camera frames → an ``.npz`` latent companion.

Counterpart of ``tools/process_latents.py``: every frame of every demo of
each ``src_paths`` file (the spliced terminal frame too) is encoded by the
frozen VAE of ``vae_snapshot_path`` (its EMA weights when it has them) to
its posterior mean (``data/latents.encode_latents``), and written demo by
demo to the matching ``dst_paths`` file with the file's ``min_z`` and
``max_z`` (``data/writer.write_latents``).
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..data.ingest import load_demos, npz_demo_names
from ..data.latents import encode_latents, load_vae
from ..data.writer import write_latents
from . import load


def main(argv: list[str] | None = None) -> None:
    cfg = load("process_latents", argv)
    vae = load_vae(cfg.vae_snapshot_path, dict(cfg.get("vae", {})),
                   resolve_device(cfg.get("device")))
    rgb_keys = list(cfg.rgb_keys)
    for src, dst in zip(cfg.src_paths, cfg.dst_paths):
        welded = load_demos(src, rgb_keys)
        lo, hi = encode_latents(welded, vae, rgb_keys,
                                shard=cfg.get("shard", 128))
        names = None
        if str(src).endswith(".npz"):
            with np.load(src) as f:
                names = npz_demo_names(f.files)
        write_latents(dst, welded, rgb_keys, lo, hi, names)
        print(f"{src} -> {dst}  min_z={lo:.3f} max_z={hi:.3f}")
