#!/bin/bash
# The reference-scale recipe through the PyTorch/CUDA port's drivers: the
# stages and overrides of tools/run_reference_scale.sh (the stable VAE,
# [128,256,256,256,256,256] at patch 1, a 16-dim latent; the
# [256,512,1024] planner at 100 diffusion steps, DDIM-25 sampling, batch
# 256) with .npz datasets and runs in experiments/$RUN. The demos come from
# the port's scripted collection when $DATA does not hold them (as
# tools/run_lift_pipeline_torch.sh collects them).
#
# Knobs: RUN=ref_scale_torch  DATA=datasets/lift  STEPS=100000 (the LDP's
# steps; evaluated and saved every EVERY=10000; warm-up WARMUP=1000)
# VAE_STEPS=8000 (saved every VAE_EVERY=4000; warm-up VAE_WARMUP=200)
# N_EVAL=256 (episodes of each eval)  ARGS="" (added to every stage, e.g.
# ARGS=device=cpu). A short run cuts the counts (a warm-up must stay below
# its run's steps), e.g.
#   STEPS=200 EVERY=200 WARMUP=50 VAE_STEPS=100 VAE_EVERY=100 VAE_WARMUP=25 \
#     N_EVAL=64 bash tools/run_reference_scale_torch.sh
# Stages whose output exists are skipped; the LDP stage resumes.
set -e
cd "$(dirname "$0")/.."
RUN=${RUN:-ref_scale_torch}
DATA=${DATA:-datasets/lift}
STEPS=${STEPS:-100000}
EVERY=${EVERY:-10000}
VAE_STEPS=${VAE_STEPS:-8000}
VAE_EVERY=${VAE_EVERY:-4000}
WARMUP=${WARMUP:-1000}
VAE_WARMUP=${VAE_WARMUP:-200}
N_EVAL=${N_EVAL:-256}
ARGS=${ARGS:-}
VAE=experiments/$RUN/vae/ckpt/$VAE_STEPS.ckpt
WIDTHS='[128,256,256,256,256,256]'

stamp() { echo "[$(date +%s)] $*"; }

if [ ! -f $DATA/demos.npz ]; then
stamp collect_demos train
python tools/collect_demos_torch.py n_episodes=256 episode_len=80 \
  out_path=$DATA/demos.npz seed=0 $ARGS
fi
if [ ! -f $DATA/demos_eval.npz ]; then
stamp collect_demos eval
python tools/collect_demos_torch.py n_episodes=32 episode_len=80 \
  out_path=$DATA/demos_eval.npz seed=77 $ARGS
fi
if [ ! -f $VAE ]; then
stamp train_vae
python tools/train_vae_torch.py data=lift/img \
  data.train_path=$DATA/demos.npz data.eval_path=$DATA/demos_eval.npz \
  "model.vae.block_out_channels=$WIDTHS" \
  model.vae.patch_size=1 model.vae.norm_groups=32 \
  batch_size=64 n_grad_steps=$VAE_STEPS warmup_steps=$VAE_WARMUP lr=3e-4 \
  eval_every=$VAE_EVERY save_every=$VAE_EVERY \
  experiment_folder=$RUN experiment_name=vae $ARGS
fi
if [ ! -f $DATA/demos_latent_ref.npz ]; then
stamp process_latents
python tools/process_latents_torch.py vae_snapshot_path=$VAE \
  "vae.block_out_channels=$WIDTHS" vae.patch_size=1 vae.norm_groups=32 \
  "src_paths=[$DATA/demos.npz,$DATA/demos_eval.npz]" \
  "dst_paths=[$DATA/demos_latent_ref.npz,$DATA/demos_eval_latent_ref.npz]" \
  $ARGS
fi
stamp train_bc
python tools/train_bc_torch.py agent=ldp_agent data=lift/latent_img \
  data.train_path=$DATA/demos.npz data.eval_path=$DATA/demos_eval.npz \
  data.train_latent_path=$DATA/demos_latent_ref.npz \
  data.eval_latent_path=$DATA/demos_eval_latent_ref.npz \
  "model_vae.block_out_channels=$WIDTHS" \
  model_vae.patch_size=1 model_vae.norm_groups=32 \
  agent.vae_pretrain_path=$VAE \
  'agent.planner.down_dims=[256,512,1024]' \
  agent.planner_n_diffusion_steps=100 agent.idm_n_diffusion_steps=100 \
  agent.planner_inference_steps=25 agent.idm_inference_steps=25 \
  'data.stats_from_data=[latent_agentview_image]' \
  data.env_params.env.episode_len=80 \
  horizon=9 obs_horizon=1 action_horizon=4 pred_horizon=8 batch_size=256 \
  n_grad_steps=$STEPS warmup_steps=$WARMUP lr=1e-4 n_eval_episodes=$N_EVAL \
  eval_every=$EVERY save_every=$EVERY resume=true \
  experiment_folder=$RUN experiment_name=ldp $ARGS
stamp done
