#!/usr/bin/env bash
# Strategy-variant regression rows — the equivalent of the reference's
# batchSim_rbphdslam_{emptyStrat,singleStrat,clusterProc}.bash: sed the
# weighting-strategy key into a copy of the reference XML (exactly as the
# reference scripts do, batchSim_rbphdslam_emptyStrat.bash:25) and run the
# batchsim harness per variant.
#
# Usage: scripts/batch_strategies.sh [out.dat] [steps] [seeds]
set -euo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-batch_rbphd_strategies.dat}
STEPS=${2:-1500}
SEEDS=${3:-3}
SRC=cfg/rbphdslam2dSim.xml
TMP=$(mktemp -d)

sed -e "s/<nEvalPt>.*<\/nEvalPt>/<nEvalPt>0<\/nEvalPt>/" \
    "$SRC" > "$TMP/emptyStrat.xml"
sed -e "s/<nEvalPt>.*<\/nEvalPt>/<nEvalPt>1<\/nEvalPt>/" \
    "$SRC" > "$TMP/singleStrat.xml"
sed -e "s/<useClusterProcess>.*<\/useClusterProcess>/<useClusterProcess>1<\/useClusterProcess>/" \
    "$SRC" > "$TMP/clusterProc.xml"

for strat in emptyStrat singleStrat clusterProc; do
  echo "# strategy=$strat" >> "$OUT"
  "${PYTHON:-python}" -m rfs_slam_tpu.apps.batchsim --cfg "$TMP/$strat.xml" \
      --filter rbphd --pd 0.9 0.5 --clutter 1e-2 \
      --seeds "$SEEDS" --steps "$STEPS" --out "$OUT"
done
rm -rf "$TMP"
echo "strategy rows -> $OUT"
