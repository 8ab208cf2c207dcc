#!/bin/bash
# The Can LDP pipeline on the contact-physics CanPhysicsEnv through the
# PyTorch/CUDA port's drivers: the stages and overrides of
# tools/run_can_pipeline.sh (demos at episode_len=300 -> VAE -> latents ->
# LDP, with Workspace evals of 256 episodes at the 400-step protocol), with
# .npz datasets and runs in experiments/$RUN. It writes nothing under
# assets/ (the JAX script snapshots its runs into the tracked tree).
#
# Knobs: RUN=can_pipeline  STEPS=30000  DATA=datasets/can  SEED (unset)
# VAE_SEED (SEED)  DEMO_SEED (unset)  ARGS="" (added to every stage, e.g.
# ARGS=device=cpu)  DEMO_ARGS="" (added to the two demo stages only:
# DEMO_ARGS=device=cpu collects the demos on the CPU and trains on the
# card).
# SEED, when set, seeds the LDP's training (its nets' init, batches and
# draws; unset, the configs' seed 0, as the JAX script); VAE_SEED seeds
# the VAE's training the same way, and is SEED unless it is set.
# DEMO_SEED, when set, draws the demos from seeds DEMO_SEED (train) and
# DEMO_SEED + 77 (eval); unset, the JAX script's seeds 0 and 77, so runs of
# several SEEDs then differ only in training. The latents in DATA belong
# to the run's VAE: give each RUN a DATA of its own.
# Stages whose output exists are skipped, so an interrupted run resumes.
set -e
cd "$(dirname "$0")/.."
RUN=${RUN:-can_pipeline}
STEPS=${STEPS:-30000}
DATA=${DATA:-datasets/can}
SEED_ARGS=${SEED:+seed=$SEED data.seed=$SEED}
VAE_SEED=${VAE_SEED:-${SEED:-}}
VAE_SEED_ARGS=${VAE_SEED:+seed=$VAE_SEED data.seed=$VAE_SEED}
DEMO_SEED=${DEMO_SEED:-0}
ARGS=${ARGS:-}
DEMO_ARGS=${DEMO_ARGS:-}
ENV=latent_diffusion_planning_tpu.envs.pick_place_physics.CanPhysicsEnv
VAE=experiments/$RUN/vae/ckpt/4000.ckpt

if [ ! -f $DATA/demos.npz ]; then
python tools/collect_demos_torch.py env._target_=$ENV env.episode_len=300 \
  n_episodes=256 episode_len=300 out_path=$DATA/demos.npz seed=$DEMO_SEED \
  $ARGS $DEMO_ARGS
fi
if [ ! -f $DATA/demos_eval.npz ]; then
python tools/collect_demos_torch.py env._target_=$ENV env.episode_len=300 \
  n_episodes=32 episode_len=300 out_path=$DATA/demos_eval.npz \
  seed=$((DEMO_SEED + 77)) $ARGS $DEMO_ARGS
fi
if [ ! -f $VAE ]; then
python tools/train_vae_torch.py data=can/img \
  data.train_path=$DATA/demos.npz data.eval_path=$DATA/demos_eval.npz \
  'model.vae.block_out_channels=[64,128,128,128]' model.vae.patch_size=4 \
  model.vae.norm_groups=16 \
  batch_size=64 n_grad_steps=4000 warmup_steps=100 lr=3e-4 \
  eval_every=2000 save_every=2000 \
  experiment_folder=$RUN experiment_name=vae $VAE_SEED_ARGS $ARGS
fi
if [ ! -f $DATA/demos_latent.npz ]; then
python tools/process_latents_torch.py vae_snapshot_path=$VAE \
  'vae.block_out_channels=[64,128,128,128]' vae.patch_size=4 vae.norm_groups=16 \
  "src_paths=[$DATA/demos.npz,$DATA/demos_eval.npz]" \
  "dst_paths=[$DATA/demos_latent.npz,$DATA/demos_eval_latent.npz]" $ARGS
fi
if [ ! -f experiments/$RUN/ldp/ckpt/$STEPS.ckpt ]; then
python tools/train_bc_torch.py agent=ldp_agent data=can/latent_img \
  data.train_path=$DATA/demos.npz data.eval_path=$DATA/demos_eval.npz \
  data.train_latent_path=$DATA/demos_latent.npz \
  data.eval_latent_path=$DATA/demos_eval_latent.npz \
  'model_vae.block_out_channels=[64,128,128,128]' model_vae.patch_size=4 \
  model_vae.norm_groups=16 \
  agent.vae_pretrain_path=$VAE \
  'agent.planner.down_dims=[64,128,256]' \
  agent.planner_n_diffusion_steps=50 agent.idm_n_diffusion_steps=50 \
  agent.planner_inference_steps=25 agent.idm_inference_steps=25 \
  'data.stats_from_data=[latent_agentview_image]' \
  data.env_params.env.episode_len=400 \
  horizon=9 obs_horizon=1 action_horizon=4 pred_horizon=8 batch_size=128 \
  n_grad_steps=$STEPS warmup_steps=200 lr=3e-4 n_eval_episodes=256 \
  eval_every=10000 save_every=10000 \
  experiment_folder=$RUN experiment_name=ldp $SEED_ARGS $ARGS
fi
