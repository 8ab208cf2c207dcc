"""Diffusion schedules, coefficient tables and plain reverse-process loops.

Counterpart of ``latent_diffusion_planning_tpu/ops/diffusion.py``: the same
squaredcos_cap_v2, linear and scaled_linear betas, ε/sample/v prediction,
clip_sample, fixed_small DDPM variance, η=0 strided DDIM and the forward
process the train step noises its targets with (``add_noise``,
``training_target``). The reverse processes are Python loops. They take
their initial sample and per-step noise as tensors, so a test can hand in
the JAX package's draws (torch cannot reproduce JAX's threefry stream).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch


def make_betas(num_steps: int, schedule: str = "squaredcos_cap_v2",
               beta_start: float = 0.0001,
               beta_end: float = 0.02) -> torch.Tensor:
    """Beta table (float32): ``squaredcos_cap_v2``, Nichol & Dhariwal's
    cosine schedule, computed in Python floats like the reference;
    ``linear``, evenly spaced from ``beta_start`` to ``beta_end``;
    ``scaled_linear``, the squares of evenly spaced square roots (DDPM's
    and Stable Diffusion's). The two linear ones are computed in float64
    and rounded once; the JAX package rounds its float32 ``linspace`` at
    each operation, so an entry may differ from its by an ulp or two."""
    if schedule == "squaredcos_cap_v2":
        def alpha_bar(x: float) -> float:
            return math.cos((x + 0.008) / 1.008 * math.pi / 2.0) ** 2
        betas = [min(1.0 - alpha_bar((i + 1) / num_steps)
                     / alpha_bar(i / num_steps), 0.999)
                 for i in range(num_steps)]
        return torch.tensor(betas, dtype=torch.float32)
    if schedule == "linear":
        return torch.linspace(beta_start, beta_end, num_steps,
                              dtype=torch.float64).float()
    if schedule == "scaled_linear":
        return (torch.linspace(beta_start ** 0.5, beta_end ** 0.5, num_steps,
                               dtype=torch.float64) ** 2).float()
    raise ValueError(f"unknown beta schedule {schedule!r}")


def _bcast(vals: torch.Tensor, ndim: int) -> torch.Tensor:
    return vals.reshape(vals.shape + (1,) * (ndim - vals.ndim))


@dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed float32 noise-schedule tables and the step rules."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_steps: int
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_range: float = 1.0

    @classmethod
    def create(cls, num_steps: int, schedule: str = "squaredcos_cap_v2",
               prediction_type: str = "epsilon", clip_sample: bool = True,
               clip_range: float = 1.0, beta_start: float = 0.0001,
               beta_end: float = 0.02) -> "DiffusionSchedule":
        betas = make_betas(num_steps, schedule, beta_start, beta_end)
        alphas = 1.0 - betas
        return cls(betas=betas, alphas=alphas,
                   alphas_cumprod=torch.cumprod(alphas, 0),
                   num_steps=num_steps, prediction_type=prediction_type,
                   clip_sample=clip_sample, clip_range=clip_range)

    def to(self, device: torch.device | str) -> "DiffusionSchedule":
        """The same schedule with its tables on ``device`` (the train step
        indexes them there without a copy from the host)."""
        return dataclasses.replace(
            self, betas=self.betas.to(device), alphas=self.alphas.to(device),
            alphas_cumprod=self.alphas_cumprod.to(device))

    def _abar(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return _bcast(self.alphas_cumprod.to(t.device)[t], ndim)

    # -- forward process ------------------------------------------------
    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): sqrt(abar_t) x0 + sqrt(1 - abar_t) noise; t: (B,)."""
        abar = self._abar(t.reshape(-1), x0.ndim)
        return torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * noise

    def velocity_target(self, x0: torch.Tensor, noise: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        abar = self._abar(t.reshape(-1), x0.ndim)
        return torch.sqrt(abar) * noise - torch.sqrt(1.0 - abar) * x0

    def training_target(self, x0: torch.Tensor, noise: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        """What the denoiser regresses to under this prediction type."""
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "sample":
            return x0
        if self.prediction_type == "v_prediction":
            return self.velocity_target(x0, noise, t)
        raise ValueError(f"unknown prediction_type {self.prediction_type!r}")

    def predict_x0(self, model_out: torch.Tensor, x_t: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
        abar = self._abar(t, x_t.ndim)
        if self.prediction_type == "epsilon":
            x0 = (x_t - torch.sqrt(1.0 - abar) * model_out) / torch.sqrt(abar)
        elif self.prediction_type == "v_prediction":
            x0 = torch.sqrt(abar) * x_t - torch.sqrt(1.0 - abar) * model_out
        elif self.prediction_type == "sample":
            x0 = model_out
        else:
            raise ValueError(
                f"unknown prediction_type {self.prediction_type!r}")
        if self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_range, self.clip_range)
        return x0

    def ddpm_step(self, model_out: torch.Tensor, x_t: torch.Tensor,
                  t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One ancestral step x_t → x_{t-1} (fixed_small variance); t: (B,)."""
        x0 = self.predict_x0(model_out, x_t, t)
        acp = self.alphas_cumprod.to(t.device)
        abar_t = _bcast(acp[t], x_t.ndim)
        abar_prev = _bcast(torch.where(t > 0, acp[(t - 1).clamp(min=0)],
                                       torch.ones_like(acp[t])), x_t.ndim)
        beta_t = _bcast(self.betas.to(t.device)[t], x_t.ndim)
        alpha_t = _bcast(self.alphas.to(t.device)[t], x_t.ndim)
        coef_x0 = torch.sqrt(abar_prev) * beta_t / (1.0 - abar_t)
        coef_xt = torch.sqrt(alpha_t) * (1.0 - abar_prev) / (1.0 - abar_t)
        mean = coef_x0 * x0 + coef_xt * x_t
        var = torch.clamp(beta_t * (1.0 - abar_prev) / (1.0 - abar_t),
                          min=1e-20)
        nonzero = _bcast((t > 0).to(x_t.dtype), x_t.ndim)
        return mean + nonzero * torch.sqrt(var) * noise

    def ddim_step(self, model_out: torch.Tensor, x_t: torch.Tensor,
                  t: torch.Tensor, t_prev: torch.Tensor) -> torch.Tensor:
        """One η=0 DDIM step from t to t_prev (t_prev = -1 → x0)."""
        x0 = self.predict_x0(model_out, x_t, t)
        acp = self.alphas_cumprod.to(t.device)
        abar_t = self._abar(t, x_t.ndim)
        abar_prev = _bcast(torch.where(t_prev >= 0,
                                       acp[t_prev.clamp(min=0)],
                                       torch.ones_like(acp[t])), x_t.ndim)
        eps = (x_t - torch.sqrt(abar_t) * x0) / torch.sqrt(1.0 - abar_t)
        dir_xt = torch.sqrt(torch.clamp(1.0 - abar_prev, min=0.0)) * eps
        return torch.sqrt(abar_prev) * x0 + dir_xt


DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
"""(x_t, t: (B,) int64) -> model output (ε by default)."""


# ---------------------------------------------------------------------------
# Unified per-step coefficient tables (T, 6), consumed by the fused samplers:
#   x0 = clip(c1 * (cx * x_t - c2 * y)),
#   x_prev = m_x0 * x0 + m_xt * x_t + s_var * noise,
# with y the model output. Columns [c1, c2, m_x0, m_xt, s_var, cx]: x0 is
# linear in (x_t, y) for every prediction type (``predict_x0``), and so is
# the step, since DDIM re-derives eps from the clipped x0:
#   epsilon       c1 = 1/sqrt(abar), c2 = sqrt(1 - abar), cx = 1
#   sample        c1 = 1,            c2 = -1,             cx = 0
#   v_prediction  c1 = 1,            c2 = sqrt(1 - abar), cx = sqrt(abar)
# The first five columns of an ε table are the JAX package's (T, 5) table,
# bit for bit; cx = 1 leaves the ε update as it was (1·x is x).
# ---------------------------------------------------------------------------


def _x0_columns(schedule: DiffusionSchedule, abar_t: torch.Tensor):
    """(c1, c2, cx) of the x0 rule for the schedule's prediction type."""
    ones = torch.ones_like(abar_t)
    kind = schedule.prediction_type
    if kind == "epsilon":
        return 1.0 / torch.sqrt(abar_t), torch.sqrt(1.0 - abar_t), ones
    if kind == "sample":
        return ones, -ones, torch.zeros_like(abar_t)
    if kind == "v_prediction":
        return ones, torch.sqrt(1.0 - abar_t), torch.sqrt(abar_t)
    raise ValueError(f"unknown prediction_type {kind!r}")

def ddim_timesteps(num_train_steps: int,
                   num_inference_steps: int) -> torch.Tensor:
    """Strided DDIM timestep table (descending, int64)."""
    stride = num_train_steps // num_inference_steps
    return torch.arange(num_inference_steps, dtype=torch.int64).flip(0) * stride


def ddpm_coef_table(schedule: DiffusionSchedule
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(timesteps (T,), coefs (T, 6)) for the full ancestral reverse process."""
    ts = torch.arange(schedule.num_steps - 1, -1, -1, dtype=torch.int64)
    acp = schedule.alphas_cumprod
    abar_t = acp[ts]
    abar_prev = torch.where(ts > 0, acp[(ts - 1).clamp(min=0)],
                            torch.ones_like(abar_t))
    beta_t = schedule.betas[ts]
    alpha_t = schedule.alphas[ts]
    c1, c2, cx = _x0_columns(schedule, abar_t)
    m_x0 = torch.sqrt(abar_prev) * beta_t / (1.0 - abar_t)
    m_xt = torch.sqrt(alpha_t) * (1.0 - abar_prev) / (1.0 - abar_t)
    var = torch.clamp(beta_t * (1.0 - abar_prev) / (1.0 - abar_t), min=1e-20)
    s_var = torch.sqrt(var) * (ts > 0)
    return ts, torch.stack([c1, c2, m_x0, m_xt, s_var, cx], -1).float()


def ddim_coef_table(schedule: DiffusionSchedule, num_inference_steps: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(timesteps, coefs) for the strided η=0 DDIM reverse process."""
    ts = ddim_timesteps(schedule.num_steps, num_inference_steps)
    ts_prev = torch.cat([ts[1:], torch.full((1,), -1, dtype=torch.int64)])
    acp = schedule.alphas_cumprod
    abar_t = acp[ts]
    abar_prev = torch.where(ts_prev >= 0, acp[ts_prev.clamp(min=0)],
                            torch.ones_like(abar_t))
    sq = torch.sqrt(1.0 - abar_t)
    sp = torch.sqrt(abar_prev)
    dp = torch.sqrt(torch.clamp(1.0 - abar_prev, min=0.0))
    m_x0 = sp - dp * torch.sqrt(abar_t) / sq
    m_xt = dp / sq
    c1, c2, cx = _x0_columns(schedule, abar_t)
    s_var = torch.zeros_like(c1)
    return ts, torch.stack([c1, c2, m_x0, m_xt, s_var, cx], -1).float()


def sample_ddpm(schedule: DiffusionSchedule, denoise_fn: DenoiseFn,
                x_init: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Full ancestral reverse process; ``noise`` is (num_steps, *x.shape),
    one draw per step in reverse-time order."""
    x = x_init
    for i, t in enumerate(range(schedule.num_steps - 1, -1, -1)):
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        x = schedule.ddpm_step(denoise_fn(x, tb), x, tb, noise[i])
    return x


def sample_ddim(schedule: DiffusionSchedule, denoise_fn: DenoiseFn,
                x_init: torch.Tensor,
                num_inference_steps: int) -> torch.Tensor:
    """η=0 DDIM with ``num_inference_steps`` strided steps."""
    ts = ddim_timesteps(schedule.num_steps, num_inference_steps).tolist()
    x = x_init
    for i, t in enumerate(ts):
        t_prev = ts[i + 1] if i + 1 < len(ts) else -1
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        tpb = torch.full_like(tb, t_prev)
        x = schedule.ddim_step(denoise_fn(x, tb), x, tb, tpb)
    return x


def sample_with_coefs(denoise_fn: DenoiseFn, x_init: torch.Tensor,
                      timesteps: torch.Tensor, coefs: torch.Tensor,
                      noise: torch.Tensor | None,
                      clip_range: float) -> torch.Tensor:
    """The fused samplers' update rule as a plain loop (their twins' core).

    ``coefs`` is a (T, 6) table of ``ddim_coef_table``/``ddpm_coef_table``;
    ``noise`` is (T, *x.shape) or None for DDIM.
    """
    x = x_init
    for i, t in enumerate(timesteps.tolist()):
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        y = denoise_fn(x, tb)
        c = coefs[i].tolist()
        x0 = torch.clamp(c[0] * (c[5] * x - c[1] * y), -clip_range,
                         clip_range)
        x = c[2] * x0 + c[3] * x
        if noise is not None:
            x = x + c[4] * noise[i]
    return x
