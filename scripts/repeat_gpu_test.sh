#!/bin/bash
# Repeat one GPU test on this tree, and on a parent checkout if given,
# alternating, to tell a flaky test from a regression:
#
#   bash scripts/repeat_gpu_test.sh <test name> <runs> [<parent checkout>]
#
# Prints each run's pytest summary and the assertion's numbers.
set -u
name=$1; runs=$2; parent=${3:-}
here=$(cd "$(dirname "$0")/.." && pwd)
for i in $(seq 1 "$runs"); do
  for tree in ${parent:+"$parent"} "$here"; do
    out=$(cd "$tree" && python3 -m pytest --noconftest -p no:cacheprovider \
      tests/test_torch_gpu.py -m gpu -q -k "$name" 2>&1)
    echo "$tree run $i: $(echo "$out" | tail -1)"
    echo "$out" | grep -E "^E .*(Mismatched|Max absolute|Max relative|ACTUAL|DESIRED)" | head -5
  done
done
