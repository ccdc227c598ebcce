#!/bin/bash
# The three 100-world batteries on one card, side by side, and their join.
#
#   bash armour_tpu_torch/run_batteries.sh [OUT]     (from the repository root)
#
# Each battery (the comparison's ARMOUR and ARMTD halves: straight guidance,
# rescue 0; the rrt_connect battery under r5_100worlds_selfgen.json's
# protocol: rescue 2) runs over assets/worlds as two disjoint 50-world
# subsets (even and odd positions of the sorted suite), six processes at
# once with one host thread each, every part writing its record every 10
# iterations. Beside them run the late-slice host profile of a straight
# battery (iterations 200-229 profiled) and the rollout kernel's card tests.
# The parts are then joined world by world into results/. OUT (default
# armour_tpu_torch/build/batteries, git-ignored) receives the logs, the parts
# and the profile.
set -u
OUT=${1:-armour_tpu_torch/build/batteries}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/smi.txt"
python -c "import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)"
export OMP_NUM_THREADS=1 MKL_NUM_THREADS=1 OPENBLAS_NUM_THREADS=1
python - > "$OUT/subsets.txt" <<'PY'
import glob, os
f = sorted(os.path.basename(x) for x in glob.glob("assets/worlds/*.csv"))
print(",".join(f[0::2])); print(",".join(f[1::2]))
PY
EVEN=$(sed -n 1p "$OUT/subsets.txt"); ODD=$(sed -n 2p "$OUT/subsets.txt")
python -c "
from armour_tpu_torch.sim import rollout_kernel as r
from armour_tpu_torch.collision import kernels, mesh_oracle
print(r.build()['seconds'], kernels.build()['seconds'], mesh_oracle.build())"
T=3250
date +%s > "$OUT/t_start.txt"
for part in even odd; do
  if [ $part = even ]; then W=$EVEN; else W=$ODD; fi
  timeout $T python -m armour_tpu_torch.run_armtd_comparison --halves armour --worlds "$W" \
    --progress-every 10 --out "$OUT/cmp_armour_$part.json" > "$OUT/armour_$part.log" 2>&1 &
  timeout $T python -m armour_tpu_torch.run_armtd_comparison --halves armtd --worlds "$W" \
    --progress-every 10 --out "$OUT/cmp_armtd_$part.json" > "$OUT/armtd_$part.log" 2>&1 &
  timeout $T python -m armour_tpu_torch.run_worlds --hlp rrt_connect --stop-rescue 2 --worlds "$W" \
    --progress-every 10 --out "$OUT/rrt_$part.json" > "$OUT/rrt_$part.log" 2>&1 &
done
timeout 2400 python -m armour_tpu_torch.profile_battery --iterations 230 --profile-from 200 \
  > "$OUT/profile_late.json" 2> "$OUT/profile_late.err" &
timeout 900 python -m pytest --noconftest -m cuda tests/test_torch_rollout_cuda.py -q \
  -p no:cacheprovider > "$OUT/card_tests.txt" 2>&1 &
wait
date +%s > "$OUT/t_end.txt"
tail -3 "$OUT/card_tests.txt"
for f in "$OUT"/*.log; do echo "== $f"; tail -12 "$f"; done
cut -c1-600 "$OUT/profile_late.json"

# the parts joined world by world into the committed records
python -m armour_tpu_torch.run_worlds --join "$OUT"/cmp_armour_{even,odd}.json \
  "$OUT"/cmp_armtd_{even,odd}.json --out results/torch_armtd_vs_armour.json
python -m armour_tpu_torch.run_worlds --join "$OUT"/rrt_{even,odd}.json \
  --out results/torch_100worlds_selfgen.json
