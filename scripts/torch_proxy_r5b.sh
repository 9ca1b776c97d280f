#!/bin/bash
# The r5b recipe of the accuracy proxy (scripts/tpu_r5b.sh) on the
# PyTorch port, cut at a step: the v4 sequences rendered with the urban
# speed profile (one build process a sequence, as scripts/r5_build_v4.sh),
# each middle trained from scratch on r5b's 25000-step schedule
# (--remat 0, an eval every 1500 steps) up to --leg_until, its best
# checkpoint evaluated with --refine --refine_loops, then the report.
# Runs on one CUDA card.
#
#   scripts/torch_proxy_r5b.sh OUT [UNTIL] [MIDDLE ...]
#
# OUT gets the small artifacts (logs, the train log's json-lines,
# best_ckpt.json, the result JSONs, the report, the learning curves, the
# card's nvidia-smi line); UNTIL defaults to 3000; MIDDLE defaults to
# PillarMiddleCov SparseMiddleCov, trained side by side on the card (so
# their step times are not those of one run alone).  RSLO_PROXY_ROOT
# (default build/proxy_v4) holds the tree, the store and the runs.
set -u
cd "$(dirname "$0")/.."
OUT=${1:?usage: $0 OUT [UNTIL] [MIDDLE ...]}
UNTIL=${2:-3000}
shift $(( $# < 2 ? $# : 2 ))
MIDDLES=("$@")
[ ${#MIDDLES[@]} -eq 0 ] && MIDDLES=(PillarMiddleCov SparseMiddleCov)
export RSLO_PROXY_SEQSET=v4
export RSLO_PROXY_ROOT=${RSLO_PROXY_ROOT:-$PWD/build/proxy_v4}
PROXY="python -u scripts/torch_accuracy_proxy.py"
START=$(date +%s)
mkdir -p "$OUT" "$RSLO_PROXY_ROOT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
  | tee "$OUT/smi.txt"
stamp() { echo "$(date +%H:%M:%S) +$(( $(date +%s) - START ))s $*" \
  | tee -a "$OUT/timeline.txt"; }

# 1. render + store: one process a sequence, each into the one
# directory store
stamp build start
pids=()
for s in 0 1 2 3 7; do
  $PROXY build --seqs $s --profile urban > "$OUT/build_seq$s.log" 2>&1 &
  pids+=($!)
done
for p in "${pids[@]}"; do
  wait "$p" || { stamp "build FAILED"; exit 1; }
done
stamp build done

# 2-3. train each middle, evaluate its best checkpoint; the middles run
# side by side on the card
run_middle() {
  local m=$1 mdir="$RSLO_PROXY_ROOT/model_${1}_r5b"
  stamp "$m train start"
  $PROXY train --middle "$m" --steps 25000 --remat 0 --tag r5b \
    --steps_per_eval 1500 --leg_until "$UNTIL" > "$OUT/train_$m.log" 2>&1
  local rc=$?
  cp "$mdir/log.json.lst" "$OUT/train_log_$m.json.lst" 2>/dev/null
  cp "$mdir/log.txt" "$OUT/train_$m.log.txt" 2>/dev/null
  cp "$mdir/best_ckpt.json" "$OUT/best_ckpt_$m.json" 2>/dev/null
  [ $rc -eq 0 ] || { stamp "$m train FAILED ($rc)"; return 1; }
  stamp "$m eval start"
  $PROXY eval --middle "$m" --tag r5b --ckpt_step best --refine \
    --refine_loops > "$OUT/eval_$m.log" 2>&1 \
    || { stamp "$m eval FAILED"; return 1; }
  cp "$RSLO_PROXY_ROOT/result_${m}_r5b_sbest_refine_loops.json" "$OUT/"
  stamp "$m done"
}
pids=()
for m in "${MIDDLES[@]}"; do
  run_middle "$m" &
  pids+=($!)
done
for p in "${pids[@]}"; do wait "$p"; done

# 4. report; the learning curves
$PROXY report | tee "$OUT/proxy_report.txt"
python scripts/torch_proxy_curve.py "$OUT"/train_log_*.json.lst \
  | tee "$OUT/curve.txt"
stamp all done
