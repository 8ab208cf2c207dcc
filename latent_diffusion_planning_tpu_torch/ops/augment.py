"""Image augmentation: bilinear grid sampling and the DrQ random shift.

Counterpart of ``latent_diffusion_planning_tpu/ops/augment.py``. Images are
NHWC like the JAX package's. ``random_shift`` takes its offsets as a tensor
(or draws them from a ``torch.Generator``), so tests can hand in JAX's.
"""

from __future__ import annotations

import torch

from ..parallel import mesh as meshlib


def grid_sample(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample NHWC ``images`` at normalized [-1, 1] ``grid``
    coordinates, (B, Ho, Wo, 2) with ``grid[..., 0]`` indexing H and
    ``grid[..., 1]`` indexing W; out-of-range coordinates clamp to the
    border."""
    B, H, W, C = images.shape
    gy = (grid[..., 0] + 1.0) * 0.5 * (H - 1)
    gx = (grid[..., 1] + 1.0) * 0.5 * (W - 1)
    y0 = torch.clamp(torch.floor(gy), 0, H - 1)
    x0 = torch.clamp(torch.floor(gx), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy = torch.clamp(gy - y0, 0.0, 1.0)[..., None]
    wx = torch.clamp(gx - x0, 0.0, 1.0)[..., None]
    b = torch.arange(B, device=images.device)[:, None, None]
    at = lambda yi, xi: images[b, yi.long(), xi.long()]
    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def random_shift(images: torch.Tensor, pad: int,
                 shift: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Edge-pad NHWC ``images`` (H == W) by ``pad`` and crop H × W at the
    integer offsets ``shift`` (B, 2) in [0, 2·pad] (row, column), drawn
    when not given. One gather: an output pixel reads the input at its
    offset position clamped to the image, which is what the padded crop
    holds."""
    B, H, W, C = images.shape
    if H != W:
        raise ValueError("random_shift expects square images")
    if shift is None:
        shift = meshlib.draw_rows(lambda m: torch.randint(
            0, 2 * pad + 1, (m, 2), generator=generator,
            device=images.device), B)
    shift = torch.as_tensor(shift, device=images.device).long()
    ar = torch.arange(H, device=images.device)
    rows = torch.clamp(ar[None] + shift[:, :1] - pad, 0, H - 1)   # (B, H)
    cols = torch.clamp(ar[None] + shift[:, 1:] - pad, 0, W - 1)   # (B, W)
    b = torch.arange(B, device=images.device)[:, None, None]
    return images[b, rows[:, :, None], cols[:, None, :]]
