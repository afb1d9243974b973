#!/bin/bash
# Whole chip_smoke.py runs of two trees in turns on one card: PARENT_ROOT,
# this tree, this tree, PARENT_ROOT, each in its own process. Logs go to
# chiprun_out/ab_<turn>_<tree>.log; the host-side lines of each (route
# builds, subscribes, the server's figures, the native cores' lines, the
# run's seconds) are printed at the end.
#
#   bash tools/chip_smoke_ab.sh build/ab/parent   # on one card
set -u
parent=${1:?usage: tools/chip_smoke_ab.sh PARENT_ROOT}
mkdir -p chiprun_out
rc=0
i=0
for t in parent this this parent; do
  i=$((i + 1))
  if [ "$t" = parent ]; then root=$parent; else root=.; fi
  log=chiprun_out/ab_${i}_${t}.log
  ( cd "$root" && python3 chip_smoke.py ) > "$log" 2>&1 || rc=1
  echo "turn $i $t: $(tail -n 1 "$log" | cut -c1-200)"
done
for f in chiprun_out/ab_*.log; do
  echo "== $f"
  grep -E "^[^ ]*H100|host_build_s|host_routes_s|subscribes/s|native build|native vs twin|churn core|native cores|^run:" "$f" | cut -c1-700
done
exit $rc
