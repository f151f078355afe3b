#!/bin/sh
# The port's physics tables on the card, as they were run (from the
# repository root, on a machine with one CUDA card):
#
#   sh docs/physics_tables_torch.sh packed        # 16 rows, packed refined
#   sh docs/physics_tables_torch.sh packed64      # its 64x64 demo row alone
#   sh docs/physics_tables_torch.sh fulld S1 S2.. # full-D f64 rows
#   sh docs/physics_tables_torch.sh mass          # the two critical-mass scans
#
# Every crossvalidation point runs in its own process and writes its row to
# OUT/<table>/<Nx>_<beta>_<m0>.json (OUT defaults to the git-ignored
# _scratch/physics); `fulld` takes streams, each a comma list
# of points Nx:beta:m0, run one after another, the streams at once. Each
# line printed names the run and its wall seconds. The tables are then
# assembled with
#
#   python -m schwingermodel_tpu_torch.tools.crossvalidate --from-json ROWS.. \
#       [--plaquette-only] --json tests/golden/crosscheck_torch_X.json \
#       --markdown docs/CROSSCHECK_torch_X.md
export PYTHONPATH="$(pwd)"
OUT=${OUT:-_scratch/physics}
CV="python3 -m schwingermodel_tpu_torch.tools.crossvalidate"
CM="python3 -m schwingermodel_tpu_torch.tools.critical_mass"
PACKED="8:1:0.2 8:2:0.2 8:3:0.2 8:4:0.2 8:5:0.2 8:6:0.2 8:2:-0.19 16:1:0.2 16:2:0.2
16:3:0.2 16:4:0.2 16:5:0.2 16:6:0.2 16:2:-0.19 32:2:0.2 64:4:0.2"

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

point() {  # table point extra-flags..
  table=$1; dir=$OUT/$1; pt=$2; shift 2
  L=${pt%%:*}; r=${pt#*:}; B=${r%%:*}; M=${r#*:}
  mkdir -p $dir
  t0=$(date +%s)
  $CV "$@" --lattice $L --beta $B --m0=$M --json $dir/${L}_${B}_${M}.json \
    > $dir/${L}_${B}_${M}.log 2>&1
  echo "$table $pt rc=$? $(( $(date +%s) - t0 )) s: $(grep -h 'PASS\|FAIL' $dir/${L}_${B}_${M}.log | head -1)"
}

case $1 in
packed)
  for pt in $PACKED; do point packed $pt --even-odd --plaquette-only; done ;;
packed64)
  point packed 64:4:0.2 --even-odd --plaquette-only ;;
fulld)
  shift
  for s in "$@"; do
    (for pt in $(echo $s | tr ',' ' '); do
       point fulld $pt --dtype float64 --chains 32 --nmeas 63
     done) &
  done
  wait ;;
mass)
  mkdir -p $OUT
  t0=$(date +%s)
  $CM --beta 2 --chains 16 --md-steps 36 \
    --json $OUT/critical_mass_torch_b2.json --markdown $OUT/CRITICAL_MASS_torch_b2.md \
    > $OUT/cm_b2.log 2>&1
  echo "critical mass beta=2 rc=$? $(( $(date +%s) - t0 )) s"
  t0=$(date +%s)
  $CM --beta 1 --chains 8 --md-steps 20 --m0-list=-0.305,-0.29,-0.275,-0.26,-0.245 \
    --json $OUT/critical_mass_torch_b1.json --markdown $OUT/CRITICAL_MASS_torch_b1.md \
    > $OUT/cm_b1.log 2>&1
  echo "critical mass beta=1 rc=$? $(( $(date +%s) - t0 )) s" ;;
*)
  echo "usage: $0 packed | fulld STREAM.. | mass" >&2; exit 2 ;;
esac
