#!/usr/bin/env python
"""The port's ``tools/train_mixed_bc.py``: ``python tools/train_mixed_bc_torch.py
key=value ...`` runs ``latent_diffusion_planning_tpu_torch/drivers/
train_mixed_bc.py`` on the card (``device=cpu``: on the CPU)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from latent_diffusion_planning_tpu_torch.drivers.train_mixed_bc import main  # noqa: E402

if __name__ == "__main__":
    main()
