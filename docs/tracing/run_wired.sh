#!/bin/bash
# The span readings of PERF.md on one card: from the root of a checkout with
# benchmark-wiring.patch applied (git apply docs/tracing/benchmark-wiring.patch),
#     bash docs/tracing/run_wired.sh <output directory> [first seed]
# runs every cell of the wired benchmark with --trace 1 on three seeds, then
# recorder_checks.py. Each run's result line and standard error go to
# <output directory>/<cell>.<seed>.{out,err}; the readings of the program's
# spans are the "reading ..." and "set-up kernels.load" lines of the .err files.
set -u
D=$1; S=${2:-3221225100}; mkdir -p "$D"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$D/smi.txt" 2>&1
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' >> "$D/smi.txt" 2>&1
for k in 0 1 2; do
  for c in sc-eval-b1 m-eval-b8 sc-eval-b8 m-train-b16; do
    s=$((S + 10 * k)); S0=$(date +%s)
    python3 benchmark/run.py --workload $c --seed $s --seconds 10 --trace 1 > "$D/$c.$s.out" 2> "$D/$c.$s.err"
    echo "$c $s rc=$? $(( $(date +%s) - S0 ))s" >> "$D/log.txt"
    S=$((S + 1))
  done
  S=$((S - 4))
done
S0=$(date +%s)
python3 docs/tracing/recorder_checks.py $((S + 900)) > "$D/checks.out" 2> "$D/checks.err"
echo "checks rc=$? $(( $(date +%s) - S0 ))s" >> "$D/log.txt"
cat "$D/log.txt" "$D/smi.txt" "$D/checks.out"
grep -h "^reading\|^set-up kernels" "$D"/*.err | cut -c1-400
