"""Training workspace of the β-VAE.

Counterpart of ``tools/train_vae.py``'s ``VAEWorkspace``: the ``Workspace``
loop (``train/loop.py``) over a ``VAEModel`` built from the config's
``model`` block (``configs.lift_vae_train_config()``'s keys) on an image
dataset. ``eval`` logs the losses averaged over ``n_eval_batches`` eval
batches and writes an HTML page (``html/recon_<step>.html`` in the run
directory) with 8 eval frames, their reconstructions and 8 decoded prior
samples. Snapshots are ``{vae_params, vae_ema_params}`` (``<step>.ckpt``),
the form an agent workspace's ``vae_pretrain_path`` reads. Under
``torchrun`` it trains data-parallel as the ``Workspace`` does (the VAE's
posterior noise drawn for the global batch, each rank its rows), and rank
0 alone evaluates.
"""

from __future__ import annotations

import torch

from ..models.vae import VAEModel
from ..utils import media
from .loop import Workspace


class VAEWorkspace(Workspace):
    def make_agent(self) -> VAEModel:
        model_cfg = dict(self.cfg["model"],
                         rgb_obs=self.data.meta["rgb_obs"],
                         obs_normalization=self.data.meta["obs_normalization"])
        return VAEModel.create(model_cfg, seed=self.cfg.get("seed", 0),
                               device=self.device)

    @torch.no_grad()
    def eval(self) -> dict:
        if not self.is_main:        # the eval is offline: rank 0 alone
            return {}
        model = self.agent
        eval_iter = self.data.eval_dataloader()
        for _ in range(self.cfg.get("n_eval_batches", 10)):
            self.logger.log_metrics(model.get_metrics(next(eval_iter),
                                                      self.generator),
                                    self.step, "eval")
        batch = next(eval_iter)
        key = model.config["rgb_obs"][0]
        report = media.HTMLReport(f"vae @ step {self.step}")
        report.add_header("reconstructions (top: input, bottom: recon)")
        report.add_images(list(batch["obs"][key][:8, 0].cpu()),
                          [f"in {i}" for i in range(8)])
        report.add_images(list(model.reconstruct(batch)[:8].cpu()),
                          [f"rec {i}" for i in range(8)])
        report.add_header("prior samples")
        report.add_images(list(model.sample(8, self.generator).cpu()),
                          [f"z~N(0,1) {i}" for i in range(8)])
        self.report_path = report.save(self.work_dir / "html"
                                       / f"recon_{self.step}.html")
        self.logger.note(f"wrote {self.report_path}")
        self.last_eval = self.logger.dump(self.step, "eval")
        return self.last_eval
