#!/usr/bin/env bash
# The f64 `-t --timer` sweep (the reference's 36 sizes, the default
# options) from several checkouts in turns on one card: for each ROOT
# given, in order, one CLI process whose wall the shell times, then
# `sweep_table` on its CSVs, its table written to OUT/sweepI_NAME.md and
# its stdout to OUT/sweepI_NAME_stdout.txt; prints each run's wall, the
# CLI's own total ("Benchmark finished in") and the sum of its 36 solves'
# seconds.
#
#   bash tools/sweep_turns.sh OUT parent=_checkout/parent change=. \
#        change=. parent=_checkout/parent
set -o pipefail
out=$(realpath -m "$1"); shift
mkdir -p "$out"
here=$(pwd)
i=0
for arg in "$@"; do
  i=$((i + 1)); who=${arg%%=*}; root=$(realpath "${arg#*=}")
  d=$(mktemp -d); t0=$(date +%s.%N)
  (cd "$root" && python -m simplex_tpu_torch.cli -t --timer --data-dir "$d" \
     > "$d/stdout.txt" 2>&1); rc=$?
  t1=$(date +%s.%N)
  (cd "$here" && python -m simplex_tpu_torch.sweep_table --ours "$d/measures" \
     > "$out/sweep${i}_$who.md" 2>&1)
  cp "$d/stdout.txt" "$out/sweep${i}_${who}_stdout.txt"
  solves=$(python3 -c "
t = 0.0
for line in open('$out/sweep${i}_$who.md'):
    p = [x.strip() for x in line.split('|')]
    if len(p) > 5 and '×' in p[1] and p[4].replace('.', '').isdigit():
        t += float(p[4])
print(round(t, 2))")
  total=$(grep -o 'Benchmark finished in [0-9.]*s' "$d/stdout.txt")
  echo "sweep $i $who rc $rc wall $(python3 -c "print(round($t1 - $t0, 1))") s, $total, solves $solves s"
  rm -rf "$d"
done
