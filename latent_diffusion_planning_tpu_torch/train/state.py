"""Train state of one network: Adam, warmup-cosine schedule, optional
global-norm clipping, EMA and the step.

Counterpart of ``latent_diffusion_planning_tpu/train/state.py``
(``EMATrainState``, ``make_optimizer``, ``warmup_cosine_lr``,
``global_norm``), with optax's semantics reproduced:

- the schedule is read at the update count *before* the increment, so the
  first update uses ``end_lr``; the warmup runs linearly from ``end_lr`` to
  ``lr`` over ``warmup_steps``, then a cosine over ``decay_steps -
  warmup_steps`` back to ``end_lr``;
- Adam's moments are ``b·m + (1-b)·g`` and ``b·v + (1-b)·g²``, bias-corrected
  by ``1 - b^count`` after the increment, the update ``m̂ / (sqrt(v̂) + eps)``;
- ``clip_by_global_norm`` leaves the gradients as they are when their norm
  is below ``max_norm`` and otherwise scales them by ``max_norm / norm``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm: another
  function);
- EMA after the update: ``e·d + p·(1-d)``.

Under data parallelism (``parallel/mesh.replicate`` sets ``dp_group``) the
gradients are averaged over the group's ranks first, in one flat
all-reduce, and only then clipped: the global norm is that of the averaged
gradient, which is what JAX's ``jit`` computes over a sharded global
batch. Clipping each rank's gradient before the average would give another
update.

The step is a Python int, so the learning rate and the bias corrections are
host numbers and an update never waits for the device. The moment and EMA
updates are multi-tensor (``torch._foreach_*``) ops: a few launches per net,
not a few per parameter.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..parallel import mesh as meshlib

B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adam's defaults, the ones in use


def warmup_cosine_lr(lr: float, end_lr: float, warmup_steps: int,
                     decay_steps: int):
    """optax.warmup_cosine_decay_schedule(init_value=end_lr, peak_value=lr,
    warmup_steps, decay_steps, end_value=end_lr) as a function of the
    update count."""
    alpha = 0.0 if lr == 0.0 else end_lr / lr
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (end_lr - lr) * frac + lr
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return lr * ((1.0 - alpha) * cosine + alpha)
    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (a 0-d tensor)."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class TrainState:
    """Adam + schedule (+ clip) + EMA over the parameters of ``module``.

    ``module`` is trained in place. With ``ema_decay > 0`` a copy of it
    holds the EMA weights and is the ``inference_module``; otherwise the
    trained module is.
    """

    def __init__(self, module: nn.Module, *, lr: float, end_lr: float,
                 warmup_steps: int, decay_steps: int,
                 grad_clip: float | None = None, ema_decay: float = 0.0):
        self.module = module
        self.schedule = warmup_cosine_lr(lr, end_lr, warmup_steps, decay_steps)
        self.grad_clip = grad_clip if grad_clip and grad_clip > 0 else None
        self.ema_decay = float(ema_decay)
        self.step = 0
        self.params = list(module.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.ema = None
        self.dp_group = None        # set by parallel/mesh.replicate
        if self.ema_decay > 0:
            self.ema = copy.deepcopy(module).requires_grad_(False)

    @property
    def inference_module(self) -> nn.Module:
        """EMA weights when tracked, the trained weights otherwise."""
        return self.ema if self.ema is not None else self.module

    def lr(self) -> float:
        """The learning rate the next update applies."""
        return self.schedule(self.step)

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """One optimizer step from the parameters' ``.grad`` (averaged over
        ``dp_group`` when one is set); the grads are cleared after."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.dp_group is not None:
            meshlib.all_reduce_mean_(grads, self.dp_group)
        if self.grad_clip is not None:
            norm = global_norm(grads)
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, g / norm * self.grad_clip)
                     for g in grads]
        count = self.step + 1
        lr = self.schedule(self.step)
        b1, b2 = B1, B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        bc1 = 1.0 - b1 ** count
        bc2 = 1.0 - b2 ** count
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        if self.ema is not None:
            ema = list(self.ema.parameters())
            d = self.ema_decay
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, self.params, alpha=1.0 - d)
        for p in self.params:
            p.grad = None
        self.step = count

    # -- persistence ----------------------------------------------------
    def state_dict(self) -> dict:
        """Everything an exact resume needs: the live tensors (not copies)
        and the step."""
        out = {"step": self.step, "params": self.module.state_dict(),
               "mu": list(self.mu), "nu": list(self.nu)}
        if self.ema is not None:
            out["ema"] = self.ema.state_dict()
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.module.load_state_dict(state["params"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"])
                            + list(state["nu"])):
            dst.copy_(src)
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])
        self.step = int(state["step"])

    @torch.no_grad()
    def set_params(self, params: dict) -> None:
        """Rebind the weights (and the EMA copy) from a state dict; the
        optimizer state is kept."""
        self.module.load_state_dict(params)
        if self.ema is not None:
            self.ema.load_state_dict(params)
