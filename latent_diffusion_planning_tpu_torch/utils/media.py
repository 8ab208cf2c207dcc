"""Images and HTML reports.

Counterpart of ``latent_diffusion_planning_tpu/utils/media.py``'s
``to_uint8_hwc``, ``save_image`` and ``HTMLReport``. The machine with the
card has no PIL, so PNGs are written here with the standard library
(``encode_png``: 8-bit gray, RGB or RGBA, unfiltered rows, zlib). Not ported
yet: ``save_video`` (it needs imageio).
"""

from __future__ import annotations

import base64
import struct
import zlib
from pathlib import Path
from typing import Sequence

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}     # channels → PNG colour type


def to_uint8_hwc(img) -> np.ndarray:
    """float [0, 1], [-1, 1] or [0, 255], or uint8; HWC or CHW → uint8
    HWC."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = img.transpose(1, 2, 0)
    if img.dtype != np.uint8:
        img = img.astype(np.float32)
        if img.min() < -0.01:            # [-1, 1]
            img = (img + 1.0) * 127.5
        elif img.max() <= 1.01:          # [0, 1]
            img = img * 255.0
        img = np.clip(img, 0, 255).astype(np.uint8)
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """The PNG file of an image (anything ``to_uint8_hwc`` takes; 2-D is
    gray)."""
    a = to_uint8_hwc(img)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"a PNG holds 1, 3 or 4 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image(path: str | Path, img) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(img))
    return path


class HTMLReport:
    """Image-grid HTML report (VAE reconstruction pages); the images are
    embedded as base64 PNGs, so the report is one self-contained file."""

    def __init__(self, title: str = "report"):
        self.title = title
        self._body: list[str] = []

    def add_header(self, text: str) -> None:
        self._body.append(f"<h2>{text}</h2>")

    def add_text(self, text: str) -> None:
        self._body.append(f"<p>{text}</p>")

    def add_images(self, images: Sequence, labels: Sequence[str] | None = None,
                   width: int = 128) -> None:
        labels = labels or [""] * len(images)
        cells = []
        for img, label in zip(images, labels):
            b64 = base64.b64encode(encode_png(img)).decode()
            cells.append(
                f'<td style="text-align:center"><img width="{width}" '
                f'src="data:image/png;base64,{b64}"/><br/>{label}</td>')
        self._body.append("<table><tr>" + "".join(cells) + "</tr></table>")

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(f"<html><head><title>{self.title}</title></head><body>"
                        f"<h1>{self.title}</h1>" + "\n".join(self._body)
                        + "</body></html>")
        return path
