#!/bin/bash
# The port's recipes at full length on one card, each task's chain in its
# own background job (every stage is host-bound, so the chains share the
# card with little loss), and their logs and CSVs gathered under $OUT.
#
#   lift: tools/run_lift_pipeline_torch.sh (demos -> VAE 4000 -> latents ->
#         LDP 30000, Workspace evals of 64 episodes at 10k/20k/30k), then
#         tools/eval_bc_torch.py over its checkpoints (64 episodes,
#         sweep_batch=3); then, if the 10000-step checkpoint lifts in at
#         least 0.3 of those episodes,
#         tools/run_lift_mixed_study_torch.sh with STEPS=20000 N_EVAL=512
#         (its corpus comes from that checkpoint)
#   can:  tools/run_can_pipeline_torch.sh with STEPS=30000 (Workspace evals
#         of 256 episodes x 400 steps at 10k/20k/30k) once per training
#         seed of $SEEDS, all at once, each run (build/can_s<seed>,
#         experiments/can_s<seed>) then scored by tools/run_can_ldp_torch.py
#         (4 x 256 episodes at each checkpoint, the plain loop at 30k) into
#         $OUT/can_s<seed>.json
#   can_draws: the Can recipe (SEED 0, STEPS=30000) once per demo draw of
#         $DRAWS (DEMO_SEED) and per device the demos are collected on
#         (card, and cpu: DEMO_ARGS=device=cpu; the rest on the card), all
#         at once, each run (build/can_<device>_d<draw>,
#         experiments/can_<device>_d<draw>) scored as above into
#         $OUT/can_<device>_d<draw>.json; then
#         tools/compare_can_demos.py on each draw's two demo sets
#   can_vae_draws: the Can recipe (SEED 0, STEPS=30000) once per VAE draw
#         of $VAE_SEEDS (VAE_SEED) and per device of $VAE_DEVICES the VAE
#         is trained and its latents encoded on (card; cpu: the VAE
#         snapshot and its latents made off the card beforehand, in
#         experiments/can_cpu_v<seed>/vae and build/can_cpu_v<seed>), all
#         on one set of demos collected on the card at draw 0
#         (build/can_vd, shared), all at once; each run
#         (build/can_<device>_v<seed>, experiments/can_<device>_v<seed>)
#         scored as above into $OUT/can_<device>_v<seed>.json, its latents'
#         spread into $OUT/can_<device>_v<seed>.latents.json
#         (tools/compare_vae_devices_torch.py latents); the first seed's
#         snapshot also encodes the demos on the other device
#         ($OUT/can_<device>_v<seed>.encode.json). With LOCKSTEP > 0 (the
#         card arms), beside them: tools/compare_vae_devices_torch.py's
#         lockstep of the VAE trainer on the card against the CPU's over
#         LOCKSTEP steps (arms cuda, cuda_perm, cpu, cpu_perm; the CPU arms
#         on 2 threads each), its report (k = 10, the tool's) into
#         $OUT/vae_lockstep.json
#   aloha: tools/run_aloha_phys4_torch.sh with STEPS=50000, the length the
#         JAX phys4 run reached (assets/runs/aloha_phys4: Workspace evals of
#         64 episodes at 20k/40k, then eval_bc over the 30k/40k/50k
#         checkpoints, 256 episodes at eval_action_horizon=1, plan_blend=0.7)
#
# Knobs: TASKS="lift can"  OUT=chiprun_out/full_length
# SEEDS="0" (the Can recipe's training seeds), DRAWS="0 1" (can_draws),
# VAE_SEEDS="1 2 3" VAE_DEVICES="card" LOCKSTEP=0 (can_vae_draws)
# Datasets go to build/<task>, runs to experiments/ (both git-ignored).
# Every stage's command line is echoed beside the Unix time (xtrace), so
# each stage's wall time is read off the task's log.
set -e
cd "$(dirname "$0")/.."
TASKS=${TASKS:-lift can}
OUT=${OUT:-chiprun_out/full_length}
SEEDS=${SEEDS:-0}
DRAWS=${DRAWS:-0 1}
VAE_SEEDS=${VAE_SEEDS:-1 2 3}
VAE_DEVICES=${VAE_DEVICES:-card}
LOCKSTEP=${LOCKSTEP:-0}
# the mixed study's corpus needs a checkpoint that lifts in 30% of its
# episodes or more, else it would not be comparable to the JAX study's
MIN_SUBOPT=0.3
mkdir -p "$OUT"

xtrace() {  # run a script with each command echoed beside the Unix time
  bash -c 'PS4="+ \$(date +%s.%N) "; set -x; . "$0"' "$@"
}

lift() {
  DATA=build/lift xtrace tools/run_lift_pipeline_torch.sh
  echo "+ $(date +%s.%N) eval_bc"
  python tools/eval_bc_torch.py \
    run_dir=experiments/pipeline_torch/ldp n_eval_episodes=64 sweep_batch=3
  local rate
  rate=$(python - <<'EOF'
import csv
rows = {int(float(r["step"])): r for r in csv.DictReader(
    open("experiments/pipeline_torch/ldp/eval_sweep/eval.csv"))}
print(rows[10000]["success"])
EOF
)
  echo "lift: eval_bc success at 10000 steps: $rate"
  if python -c "import sys; sys.exit(float('$rate') < $MIN_SUBOPT)"; then
    DATA=build/lift STEPS=20000 N_EVAL=512 \
      xtrace tools/run_lift_mixed_study_torch.sh
  else
    echo "lift: the 10000-step checkpoint lifts in $rate < $MIN_SUBOPT" \
         "of its episodes: the mixed study is not run"
  fi
}

can_run() {  # NAME [VAR=value ...]: one Can recipe run and its scores
  local name=$1
  shift
  { env DATA=build/$name RUN=$name STEPS=30000 "$@" \
      bash -c 'PS4="+ \$(date +%s.%N) "; set -x; . "$0"' \
      tools/run_can_pipeline_torch.sh
    echo "+ $(date +%s.%N) python tools/run_can_ldp_torch.py"
    python tools/run_can_ldp_torch.py --run experiments/$name/ldp \
      --out "$OUT/$name.json"; } > "$OUT/$name.log" 2>&1
}

can() {
  local pids=() s rc=0
  for s in $SEEDS; do
    can_run can_s$s SEED=$s &
    pids+=($!)
  done
  for s in "${pids[@]}"; do wait "$s" || rc=1; done
  echo "+ $(date +%s.%N) done"
  return $rc
}

can_draws() {
  local pids=() d dev rc=0
  for d in $DRAWS; do
    for dev in card cpu; do
      can_run can_${dev}_d$d SEED=0 DEMO_SEED=$d \
        DEMO_ARGS=$([ "$dev" = cpu ] && echo device=cpu) &
      pids+=($!)
    done
  done
  for d in "${pids[@]}"; do wait "$d" || rc=1; done
  for d in $DRAWS; do
    echo "== draw $d: demos on the card (A) and on the CPU (B)"
    python tools/compare_can_demos.py build/can_card_d$d/demos.npz \
      build/can_cpu_d$d/demos.npz || rc=1
  done
  echo "+ $(date +%s.%N) done"
  return $rc
}

vae_lockstep() {  # DEMOS_DIR: the four lockstep arms, then the report
  local d=build/vae_lockstep pids=() a rc=0
  for a in "cuda cuda" "cuda_perm cuda --permute" "cpu cpu --threads 2" \
           "cpu_perm cpu --permute --threads 2"; do
    set -- $a
    local name=$1
    shift
    python tools/compare_vae_devices_torch.py run --device "$@" \
      --train "$DEMOS/demos.npz" --eval "$DEMOS/demos_eval.npz" \
      --out $d/$name --steps "$LOCKSTEP" > "$OUT/vae_lockstep_$name.log" 2>&1 &
    pids+=($!)
  done
  for a in "${pids[@]}"; do wait "$a" || rc=1; done
  python tools/compare_vae_devices_torch.py report $d --also cuda_perm > "$OUT/vae_lockstep.log" 2>&1 || rc=1
  cp $d/report.json "$OUT/vae_lockstep.json" || rc=1
  rm -rf $d
  return $rc
}

vae_arm() {  # NAME DEVICE SEED: one VAE draw's Can arm, its latents' spread
  local name=$1 dev=$2 seed=$3 other
  can_run "$name" SEED=0 VAE_SEED="$seed" || return 1
  python tools/compare_vae_devices_torch.py latents \
    "build/$name/demos_latent.npz" --vae-run "experiments/$name/vae" \
    > "$OUT/$name.latents.json" || return 1
  if [ "$seed" = "${VAE_SEEDS%% *}" ]; then  # (b): the encode on the other
    other=$([ "$dev" = cpu ] && echo cuda || echo cpu)   # device
    python tools/process_latents_torch.py \
      vae_snapshot_path="experiments/$name/vae/ckpt/4000.ckpt" \
      'vae.block_out_channels=[64,128,128,128]' vae.patch_size=4 \
      vae.norm_groups=16 \
      "src_paths=[build/$name/demos.npz,build/$name/demos_eval.npz]" \
      "dst_paths=[build/$name/$other.npz,build/$name/${other}_eval.npz]" \
      device=$other > "$OUT/$name.encode.log" 2>&1 || return 1
    python tools/compare_vae_devices_torch.py latents \
      "build/$name/demos_latent.npz" "build/$name/$other.npz" \
      > "$OUT/$name.encode.json" || return 1
  fi
}

can_vae_draws() {
  local pids=() s dev name rc=0 DEMOS=build/can_vd
  mkdir -p $DEMOS
  # the demos once, on the card, at the JAX script's seeds (0 / 77)
  [ -f $DEMOS/demos.npz ] || python tools/collect_demos_torch.py \
    env._target_=latent_diffusion_planning_tpu.envs.pick_place_physics.CanPhysicsEnv \
    env.episode_len=300 n_episodes=256 episode_len=300 \
    out_path=$DEMOS/demos.npz seed=0 || return 1
  [ -f $DEMOS/demos_eval.npz ] || python tools/collect_demos_torch.py \
    env._target_=latent_diffusion_planning_tpu.envs.pick_place_physics.CanPhysicsEnv \
    env.episode_len=300 n_episodes=32 episode_len=300 \
    out_path=$DEMOS/demos_eval.npz seed=77 || return 1
  echo "+ $(date +%s.%N) demos"
  if [ "$LOCKSTEP" -gt 0 ]; then
    DEMOS=$DEMOS vae_lockstep &
    pids+=($!)
  fi
  for s in $VAE_SEEDS; do
    for dev in $VAE_DEVICES; do
      name=can_${dev}_v$s
      mkdir -p build/$name
      ln -sf "$PWD/$DEMOS/demos.npz" build/$name/demos.npz
      ln -sf "$PWD/$DEMOS/demos_eval.npz" build/$name/demos_eval.npz
      if [ "$dev" = cpu ] && [ ! -f build/$name/demos_latent.npz ]; then
        echo "$name: no latents of a CPU-trained VAE in build/$name"
        rc=1
        continue
      fi
      vae_arm $name $dev $s > "$OUT/$name.arm.log" 2>&1 &
      pids+=($!)
    done
  done
  for s in "${pids[@]}"; do wait "$s" || rc=1; done
  echo "+ $(date +%s.%N) done"
  return $rc
}

aloha() {
  DATA=build/aloha STEPS=50000 xtrace tools/run_aloha_phys4_torch.sh
  echo "+ $(date +%s.%N) done"
}

if [ $# -gt 0 ]; then   # one task, as the loop below starts it
  "$1"
  exit
fi
for task in $TASKS; do
  { bash "$0" "$task" > "$OUT/$task.log" 2>&1 && echo "exit 0" \
      || echo "exit $?"; } >> "$OUT/$task.log" &
done
wait

# the runs' CSVs, configs and study logs (not the checkpoints)
for f in $(find experiments -name '*.csv' -o -name 'config.json' \
             -o -name '*.log' 2>/dev/null); do
  mkdir -p "$OUT/$(dirname "$f")"
  cp "$f" "$OUT/$f"
done
for task in $TASKS; do
  echo "== $task: $(tail -n 1 "$OUT/$task.log")"
  grep -a -E "^\++ [0-9.]+ (python|eval_bc|done)|success|Wilson" \
    "$OUT/$task"*.log \
    | cut -c1-200 || true
done
! grep -q -x -v "exit 0" <(for t in $TASKS; do tail -n 1 "$OUT/$t.log"; done)
