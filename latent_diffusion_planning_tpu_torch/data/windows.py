"""Device-resident window sampling over welded demos.

Counterpart of ``latent_diffusion_planning_tpu/data/windows.py``
(``DeviceDataset``, ``sample_traj``, ``action_event_weights``). The welded arrays go to the device
once (images stay uint8), with each step's demo extent; a batch is one
indexed gather per key, so sampling never touches the host.

Window semantics: a sample at index i covers steps ``[i - frame_stack + 1,
i + seq_length)`` of i's demo, with edge padding by clamping the indices to
the demo (the first frame repeats before the start, the last after the
end); obs keys get the full ``frame_stack - 1 + seq_length`` window,
dataset keys (actions) drop the stacked prefix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from .ingest import WeldedDemos


@dataclass
class DeviceDataset:
    """Welded arrays + per-step demo extents, on the device."""

    arrays: dict[str, torch.Tensor]
    step_demo_start: torch.Tensor   # (N,) int64: demo start of each step
    step_demo_end: torch.Tensor     # (N,) int64: demo end (exclusive)
    offsets: torch.Tensor           # (frame_stack - 1 + seq_length,) int64
    frame_stack: int
    seq_length: int
    obs_keys: tuple
    dataset_keys: tuple
    sample_weights: torch.Tensor | None = None   # (N,) for weighted draws

    @classmethod
    def from_welded(cls, welded: WeldedDemos, frame_stack: int,
                    seq_length: int, device: torch.device | str,
                    sample_weights: torch.Tensor | None = None
                    ) -> "DeviceDataset":
        if frame_stack < 1 or seq_length < 1:
            raise ValueError("frame_stack and seq_length must be ≥ 1")
        n = welded.total_steps
        starts = welded.demo_starts.cpu()
        lengths = welded.demo_lengths.cpu()
        if sample_weights is not None and tuple(sample_weights.shape) != (n,):
            raise ValueError(f"sample_weights shape {tuple(sample_weights.shape)}"
                             f" != ({n},)")
        put = lambda t: t.to(device)
        return cls(
            arrays={k: put(v) for k, v in welded.arrays.items()},
            step_demo_start=put(torch.repeat_interleave(starts, lengths)),
            step_demo_end=put(torch.repeat_interleave(starts + lengths,
                                                      lengths)),
            offsets=put(torch.arange(-frame_stack + 1, seq_length)),
            frame_stack=frame_stack, seq_length=seq_length,
            obs_keys=tuple(welded.obs_keys),
            dataset_keys=tuple(welded.dataset_keys),
            sample_weights=(None if sample_weights is None
                            else put(sample_weights.float())))

    @property
    def n_steps(self) -> int:
        return self.step_demo_start.shape[0]

    @property
    def device(self) -> torch.device:
        return self.step_demo_start.device

    def gather(self, idx: torch.Tensor) -> dict:
        """Windows for sample indices ``idx`` (B,) → batch dict."""
        pos = idx[:, None] + self.offsets[None, :]
        pos = torch.clamp(pos, self.step_demo_start[idx][:, None],
                          self.step_demo_end[idx][:, None] - 1)
        batch: dict = {"obs": {k: self.arrays[k][pos] for k in self.obs_keys}}
        for k in self.dataset_keys:
            batch[k] = self.arrays[k][pos[:, self.frame_stack - 1:]]
        return batch

    def sample(self, batch_size: int,
               generator: torch.Generator | None = None,
               idx: torch.Tensor | None = None) -> dict:
        """A batch of windows at uniform (or ``sample_weights``-weighted)
        indices; ``idx`` hands the indices in."""
        if idx is None:
            if self.sample_weights is not None:
                idx = torch.multinomial(self.sample_weights, batch_size,
                                        replacement=True, generator=generator)
            else:
                idx = torch.randint(0, self.n_steps, (batch_size,),
                                    generator=generator, device=self.device)
        return self.gather(torch.as_tensor(idx, device=self.device).long())

    def iter_batches(self, batch_size: int,
                     generator: torch.Generator) -> Iterator[dict]:
        """Infinite batch iterator."""
        while True:
            yield self.sample(batch_size, generator)


def sample_traj(welded: WeldedDemos, ep: int) -> dict:
    """Whole-trajectory batch of demo ``ep``, each obs key (T, 1, ...)."""
    demo = welded.demo_slice(ep)
    batch: dict = {"obs": {k: demo[k][:, None] for k in welded.obs_keys}}
    for k in welded.dataset_keys:
        batch[k] = demo[k]
    return batch


def action_event_weights(welded: WeldedDemos, channels: Sequence[int],
                         boost: float = 3.0, halfwidth: int = 8,
                         key: str = "actions") -> torch.Tensor:
    """Per-step sampling weights (N,) that upweight action-channel events.

    For each demo: the per-step activity is the summed |Δaction| over
    ``channels``, box-smoothed over ±``halfwidth`` steps and divided by its
    demo maximum, giving weight ``1 + boost·activity`` in [1, 1 + boost]. A
    demo whose channels never move keeps weight 1. Computed on the host in
    NumPy, once, as the JAX package does.
    """
    acts = welded.arrays[key].cpu().numpy().astype(np.float32)
    sel = acts[:, list(channels)]
    w = np.ones(len(acts), np.float32)
    kernel = np.ones(2 * int(halfwidth) + 1, np.float32)
    for s, n in zip(welded.demo_starts.tolist(), welded.demo_lengths.tolist()):
        d = np.abs(np.diff(sel[s:s + n], axis=0)).sum(axis=1)
        smooth = np.convolve(np.concatenate([[0.0], d]), kernel, mode="same")
        peak = smooth.max()
        if peak > 0:
            w[s:s + n] = 1.0 + float(boost) * smooth / peak
    return torch.from_numpy(w)
