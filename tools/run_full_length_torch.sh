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
#   aloha: tools/run_aloha_phys4_torch.sh with STEPS=50000, the length the
#         JAX phys4 run reached (assets/runs/aloha_phys4: Workspace evals of
#         64 episodes at 20k/40k, then eval_bc over the 30k/40k/50k
#         checkpoints, 256 episodes at eval_action_horizon=1, plan_blend=0.7)
#
# Knobs: TASKS="lift can"  OUT=chiprun_out/full_length
# SEEDS="0" (the Can recipe's training seeds), DRAWS="0 1" (can_draws)
# Datasets go to build/<task>, runs to experiments/ (both git-ignored).
# Every stage's command line is echoed beside the Unix time (xtrace), so
# each stage's wall time is read off the task's log.
set -e
cd "$(dirname "$0")/.."
TASKS=${TASKS:-lift can}
OUT=${OUT:-chiprun_out/full_length}
SEEDS=${SEEDS:-0}
DRAWS=${DRAWS:-0 1}
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
