#!/bin/bash
# The mixed-data study on the physics Lift task through the PyTorch/CUDA
# port's drivers: the stages and overrides of tools/run_lift_mixed_study.sh
# (the planner trains on `data`, the IDM on `mixed_data`):
#   expert    : both streams are the N_EXPERT expert demos
#   mixed     : the IDM's stream adds the suboptimal corpus with its actions
#   actionfree: the planner's stream adds the suboptimal corpus (whose
#               actions it never reads); the IDM's stays expert
# It reads the VAE, the latents and an intermediate LDP checkpoint of
# tools/run_lift_pipeline_torch.sh (its default run, pipeline_torch), writes
# .npz datasets and runs in experiments/$RUN, and nothing under assets/.
# The three arms train at once, one process each (their steps are
# host-bound), with OMP_NUM_THREADS=2 unless it is set; each logs to
# experiments/$RUN/<arm>.log.
#
# Knobs (the JAX script's, with its defaults):
#   RUN=mixed_study_torch  N_EXPERT=8  STEPS=30000  N_EVAL=512
#   SUBOPT_CKPT=10000.ckpt
# and DATA=datasets/lift, ARGS="" (added to every stage, e.g.
# ARGS=device=cpu). An arm whose run has its final checkpoint is skipped.
set -e
cd "$(dirname "$0")/.."
RUN=${RUN:-mixed_study_torch}
DATA=${DATA:-datasets/lift}
N_EXPERT=${N_EXPERT:-8}
STEPS=${STEPS:-30000}
N_EVAL=${N_EVAL:-512}
SUBOPT_CKPT=${SUBOPT_CKPT:-10000.ckpt}
ARGS=${ARGS:-}
VAE=experiments/pipeline_torch/vae/ckpt/4000.ckpt
VAE_ARGS="model_vae.block_out_channels=[64,128,128,128] model_vae.patch_size=4 model_vae.norm_groups=16"

# 1. the suboptimal corpus: the intermediate checkpoint rolled out with
#    action noise, its unsuccessful episodes kept
if [ ! -f $DATA/suboptimal_latent.npz ]; then
python tools/collect_data_torch.py run_dir=experiments/pipeline_torch/ldp \
  ckpt_name=$SUBOPT_CKPT n_episodes=256 episode_len=80 noise=0.1 \
  unsuccessful_only=true out_path=$DATA/suboptimal.npz seed=123 $ARGS
python tools/process_latents_torch.py vae_snapshot_path=$VAE \
  'vae.block_out_channels=[64,128,128,128]' vae.patch_size=4 vae.norm_groups=16 \
  "src_paths=[$DATA/suboptimal.npz]" \
  "dst_paths=[$DATA/suboptimal_latent.npz]" $ARGS
fi

# the .npz files of each data group (the groups name the JAX .hdf5 files)
expert_files() {  # $1: the section holding lift/latent_img
  echo "$1.train_path=$DATA/demos.npz $1.eval_path=$DATA/demos_eval.npz
  $1.train_latent_path=$DATA/demos_latent.npz
  $1.eval_latent_path=$DATA/demos_eval_latent.npz"
}
mixed_files() {   # $1: the section holding lift/mixed_latent_img
  echo "$1.train_paths=[$DATA/demos.npz,$DATA/suboptimal.npz]
  $1.eval_paths=$DATA/demos_eval.npz
  $1.train_latent_paths=[$DATA/demos_latent.npz,$DATA/suboptimal_latent.npz]
  $1.eval_latent_paths=$DATA/demos_eval_latent.npz"
}

COMMON="$VAE_ARGS agent.vae_pretrain_path=$VAE
  agent.planner.down_dims=[64,128,256]
  agent.planner_n_diffusion_steps=50 agent.idm_n_diffusion_steps=50
  agent.planner_inference_steps=25 agent.idm_inference_steps=25
  data.env_params.env.episode_len=80
  horizon=9 obs_horizon=1 action_horizon=4 pred_horizon=8 batch_size=128
  n_grad_steps=$STEPS warmup_steps=200 lr=3e-4 n_eval_episodes=$N_EVAL
  eval_every=$STEPS save_every=$STEPS experiment_folder=$RUN $ARGS"

arm() {   # $1: the arm's run name; the rest: its driver and overrides
  local name=$1; shift
  if [ -f experiments/$RUN/$name/ckpt/$STEPS.ckpt ]; then return; fi
  mkdir -p experiments/$RUN
  OMP_NUM_THREADS=${OMP_NUM_THREADS:-2} "$@" $COMMON \
    experiment_name=$name > experiments/$RUN/$name.log 2>&1 &
}

# 2. expert-only BC with N_EXPERT demos
arm expert$N_EXPERT python tools/train_bc_torch.py agent=ldp_agent \
  data=lift/latent_img data.train_n_episode_overfit=$N_EXPERT $(expert_files data)
# 3. mixed: the IDM also sees the suboptimal actions
arm mixed$N_EXPERT python tools/train_mixed_bc_torch.py \
  data=lift/latent_img data.train_n_episode_overfit=$N_EXPERT $(expert_files data) \
  mixed_data=lift/mixed_latent_img \
  "mixed_data.train_n_episode_overfit=[$N_EXPERT,null]" \
  $(mixed_files mixed_data)
# 4. action-free: the planner also sees the suboptimal latent streams
arm actionfree$N_EXPERT python tools/train_mixed_bc_torch.py \
  data=lift/mixed_latent_img "data.train_n_episode_overfit=[$N_EXPERT,null]" \
  $(mixed_files data) \
  mixed_data=lift/latent_img mixed_data.train_n_episode_overfit=$N_EXPERT \
  $(expert_files mixed_data)
for job in $(jobs -p); do
  wait $job || { echo "an arm failed: see experiments/$RUN/*.log" >&2; exit 1; }
done

RUN=$RUN python - <<'PYEOF'
import csv, glob, math, os
print("== mixed-study results (Wilson 95% interval) ==")
for f in sorted(glob.glob(f"experiments/{os.environ['RUN']}/*/eval.csv")):
    rows = list(csv.DictReader(open(f)))
    if rows:
        r = rows[-1]
        p, n = float(r["success"]), float(r["n_episodes"])
        z = 1.96
        mid = (p + z * z / (2 * n)) / (1 + z * z / n)
        half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / (1 + z * z / n)
        print(f"{f.split('/')[-2]:>16}: success {p:.4f} "
              f"[{mid - half:.4f}, {mid + half:.4f}] (n={n:.0f}) "
              f"@ step {r.get('step')}")
PYEOF
