"""Images, videos and HTML reports.

Counterpart of ``latent_diffusion_planning_tpu/utils/media.py``'s
``to_uint8_hwc``, ``save_image``, ``save_video`` and ``HTMLReport``. The
machine with the card has no PIL, imageio or ffmpeg, so PNGs are written
here with the standard library (``encode_png``: 8-bit gray, RGB or RGBA,
unfiltered rows, zlib) and a video is an animated PNG (APNG) of such frames
(``save_video``; ``read_video`` reads one back).
"""

from __future__ import annotations

import base64
import struct
import zlib
from pathlib import Path
from typing import Sequence

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}     # channels → PNG colour type
_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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
    header, data = _png_rows(a[:, :, None] if a.ndim == 2 else a)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", data)
            + _chunk(b"IEND", b""))


def _png_rows(a: np.ndarray) -> tuple[bytes, bytes]:
    """(IHDR payload, zlib stream of the unfiltered rows) of a uint8 HWC
    image."""
    h, w, c = a.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"a PNG holds 1, 3 or 4 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return header, zlib.compress(rows.tobytes(), 6)


def save_image(path: str | Path, img) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(img))
    return path


def save_video(path: str | Path, frames, fps: int = 10) -> Path:
    """Write ``frames`` (T, H, W, C), anything ``to_uint8_hwc`` takes per
    frame, as an animated PNG shown at ``fps`` frames a second, looping;
    returns the path written.

    The JAX package writes MP4 through imageio and falls back to GIF where
    ffmpeg is missing. Neither exists where the port runs, so the file is an
    APNG written with zlib alone, under ``path`` with its suffix swapped to
    ``.png``. The format is the only difference: APNG is lossless, so every
    pixel of every frame is kept (GIF's palette and MP4's codec are not).
    """
    path = Path(path).with_suffix(".png")
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = [to_uint8_hwc(f) for f in frames]
    arr = [a[:, :, None] if a.ndim == 2 else a for a in arr]
    if not arr:
        raise ValueError("a video needs at least one frame")
    h, w = arr[0].shape[:2]
    out = [_SIGNATURE, None, _chunk(b"acTL", struct.pack(">II", len(arr), 0))]
    seq = 0
    for i, a in enumerate(arr):
        if a.shape != arr[0].shape:
            raise ValueError(f"frame {i} is {a.shape}, frame 0 {arr[0].shape}")
        header, data = _png_rows(a)
        out[1] = _chunk(b"IHDR", header)
        # fcTL: the frame covers the canvas, shown for 1/fps s, replacing
        # what was there
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0,
                                               1, int(fps), 0, 0)))
        seq += 1
        if i == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    path.write_bytes(b"".join(out))
    return path


def read_video(path: str | Path) -> np.ndarray:
    """The frames (T, H, W, C) uint8 of an APNG that ``save_video`` wrote
    (unfiltered rows)."""
    raw = Path(path).read_bytes()
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    pos, frames = 8, []
    while pos < len(raw):
        n, kind = struct.unpack_from(">I4s", raw, pos)
        body = raw[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, _, color = struct.unpack_from(">IIBB", body)
            c = {v: k for k, v in _COLOR_TYPE.items()}[color]
        elif kind in (b"IDAT", b"fdAT"):
            rows = np.frombuffer(zlib.decompress(
                body if kind == b"IDAT" else body[4:]), np.uint8)
            rows = rows.reshape(h, 1 + w * c)
            if rows[:, 0].any():
                raise ValueError(f"{path}: filtered rows are not read here")
            frames.append(rows[:, 1:].reshape(h, w, c))
    return np.stack(frames)


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
