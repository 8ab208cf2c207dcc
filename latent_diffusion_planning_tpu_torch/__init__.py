"""latent_diffusion_planning_tpu_torch — the PyTorch/CUDA port of the LDP framework.

The JAX package ``latent_diffusion_planning_tpu`` beside this one is the
reference; module paths here mirror it (``ops/diffusion.py`` ↔
``ops/diffusion.py`` and so on) so every module has an obvious counterpart.
This package imports ``torch`` and numpy only, never JAX or the JAX package.

The TPU's three Pallas kernels become hand-written CUDA C++ kernels for
Hopper (``csrc/``, bound in ``ops/kernels/``). Each has a plain PyTorch twin
in the same module, which runs only for tensors on the CPU (the tests); a
CUDA tensor always goes through the kernel.

Entry points take ``device=None`` to mean the card and raise when there is
none; pass ``device="cpu"`` to run the plain versions.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev
