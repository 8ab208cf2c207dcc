#!/bin/bash
# Reference-naming round trip of a port checkpoint, on the card: export the
# snapshot through the reference's parameter naming (a flat .npz), import
# it back, check every planner and IDM tensor bit for bit and score both
# agents closed-loop on identical seeds (their actions must agree at every
# decision, so the success delta is exactly 0).
#   tools/run_roundtrip_check_torch.sh [SNAPSHOT.ckpt] [extra key=value ...]
# The default snapshot is the bench checkpoint in the port's format, which
# tools/export_bench_torch.py writes where JAX is installed; extra keys
# (run_dir=RUN for a run of the port) go to all three tools.
set -e
cd "$(dirname "$0")/.."
SRC=${1:-build/bench_torch/30000.ckpt}
shift || true
OUT=build/roundtrip
python3 tools/export_reference_ckpt_torch.py src="$SRC" \
  dst=$OUT/ref_format.npz "$@"
python3 tools/import_reference_ckpt_torch.py src=$OUT/ref_format.npz \
  dst=$OUT/reimported.ckpt "$@"
python3 tools/roundtrip_eval_torch.py original="$SRC" \
  reimported=$OUT/reimported.ckpt n_episodes=512 "$@" | tee $OUT/result.json
