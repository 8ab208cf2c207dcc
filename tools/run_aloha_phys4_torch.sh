#!/bin/bash
# The ALOHA transfer-cube LDP recipe ("phys4") through the PyTorch/CUDA
# port's drivers: the stages and overrides of tools/run_aloha_phys4.sh
# (clean and DART-noised scripted demos with held noise and clean labels,
# the [128,128] patch-4 VAE, 256-wide latents, LDP with an x0-predicting
# planner, gripper-weighted action loss, handover oversampling and stats
# from the data, then the eval_bc sweep at eval_action_horizon=1 and
# plan_blend=0.7), with .npz datasets and runs in experiments/$RUN. It has
# no TPU streamed-sampler smoke and no deadline cap, and writes nothing
# under assets/.
#
# Knobs: RUN=aloha_phys4  STEPS=200000  DATA=datasets/aloha_cube_phys4
# ARGS="" (added to every stage, e.g. ARGS=device=cpu).
# Stages whose output exists are skipped, so an interrupted run resumes.
set -e
cd "$(dirname "$0")/.."
RUN=${RUN:-aloha_phys4}
STEPS=${STEPS:-200000}
DATA=${DATA:-datasets/aloha_cube_phys4}
ARGS=${ARGS:-}
ENV=latent_diffusion_planning_tpu.envs.aloha_cube.AlohaTransferCubeEnv
VAE=experiments/$RUN/vae/ckpt/4000.ckpt
SEGS="$DATA/demos.npz,$DATA/demos_n3.npz,$DATA/demos_n5.npz"
LATS="$DATA/demos_latent.npz,$DATA/demos_n3_latent.npz,$DATA/demos_n5_latent.npz"

if [ ! -f $DATA/demos.npz ]; then
python tools/collect_demos_torch.py env._target_=$ENV \
  n_episodes=128 episode_len=150 trim_success_margin=12 \
  out_path=$DATA/demos.npz seed=0 $ARGS
fi
if [ ! -f $DATA/demos_n3.npz ]; then
python tools/collect_demos_torch.py env._target_=$ENV \
  n_episodes=288 episode_len=250 noise=0.003 noise_hold=10 \
  clean_labels=true trim_success_margin=12 \
  out_path=$DATA/demos_n3.npz seed=1 $ARGS
fi
if [ ! -f $DATA/demos_n5.npz ]; then
python tools/collect_demos_torch.py env._target_=$ENV \
  n_episodes=320 episode_len=250 noise=0.005 noise_hold=10 \
  clean_labels=true trim_success_margin=12 \
  out_path=$DATA/demos_n5.npz seed=2 $ARGS
fi
if [ ! -f $DATA/demos_eval.npz ]; then
python tools/collect_demos_torch.py env._target_=$ENV \
  n_episodes=32 episode_len=150 trim_success_margin=12 \
  out_path=$DATA/demos_eval.npz seed=77 $ARGS
fi

if [ ! -f $VAE ]; then
python tools/train_vae_torch.py data=aloha_cube/wrist \
  "data.train_path=[$SEGS]" \
  data.eval_path=$DATA/demos_eval.npz \
  'model.vae.block_out_channels=[128,128]' model.vae.patch_size=4 \
  model.vae.norm_groups=32 \
  batch_size=64 n_grad_steps=4000 warmup_steps=100 lr=3e-4 \
  eval_every=2000 save_every=2000 \
  experiment_folder=$RUN experiment_name=vae $ARGS
fi
if [ ! -f $DATA/demos_latent.npz ]; then
python tools/process_latents_torch.py vae_snapshot_path=$VAE \
  'vae.block_out_channels=[128,128]' vae.patch_size=4 vae.norm_groups=32 \
  'rgb_keys=[wrist64_image]' \
  "src_paths=[$SEGS,$DATA/demos_eval.npz]" \
  "dst_paths=[$LATS,$DATA/demos_eval_latent.npz]" $ARGS
fi

if [ ! -f experiments/$RUN/ldp/ckpt/$STEPS.ckpt ]; then
python tools/train_bc_torch.py agent=ldp_agent data=aloha_cube/latent_wrist256 \
  "data.train_path=[$SEGS]" "data.train_latent_path=[$LATS]" \
  data.eval_path=$DATA/demos_eval.npz \
  data.eval_latent_path=$DATA/demos_eval_latent.npz \
  'data.oversample.channels=[6,13]' data.oversample.boost=3.0 \
  data.oversample.halfwidth=8 \
  'model_vae.block_out_channels=[128,128]' model_vae.patch_size=4 \
  model_vae.norm_groups=32 \
  agent.vae_pretrain_path=$VAE \
  agent.vae_feature_dim=256 \
  'agent.planner.down_dims=[128,256,512]' \
  agent.planner_prediction_type=sample \
  'agent.action_loss_weights=[1,1,1,1,1,1,3,1,1,1,1,1,1,3]' \
  agent.planner_n_diffusion_steps=50 agent.idm_n_diffusion_steps=50 \
  agent.planner_inference_steps=25 agent.idm_inference_steps=25 \
  data.env_params.env.episode_len=400 \
  horizon=9 obs_horizon=1 action_horizon=4 pred_horizon=8 batch_size=128 \
  n_grad_steps=$STEPS warmup_steps=500 lr=3e-4 n_eval_episodes=64 \
  eval_every=20000 save_every=10000 resume=true \
  experiment_folder=$RUN experiment_name=ldp $ARGS
fi

# the sweep over the last (up to) three checkpoints, fused into one call
CKPTS=""
NSW=0
for s in $((STEPS-20000)) $((STEPS-10000)) $STEPS; do
  if [ "$s" -gt 0 ] && [ -f experiments/$RUN/ldp/ckpt/$s.ckpt ]; then
    CKPTS="$CKPTS,$s"; NSW=$((NSW+1))
  fi
done
CKPTS=${CKPTS#,}
if [ "$NSW" -gt 0 ]; then
python tools/eval_bc_torch.py run_dir=experiments/$RUN/ldp \
  "ckpt_steps=[$CKPTS]" \
  n_eval_episodes=256 eval_action_horizon=1 plan_blend=0.7 \
  sweep_batch=$NSW $ARGS
fi
