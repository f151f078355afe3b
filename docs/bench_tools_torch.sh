#!/bin/sh
# The port's four bench tools on the card at the JAX tools' defaults, as
# they were run (from the repository root, on a machine with one CUDA card):
#
#   sh docs/bench_tools_torch.sh [sharded] [kernels] [points [NAME..]] [scaling]
#
# With no argument it runs all four, one process per tool run:
# bench_sharded_kernel at the 32x32 block (64x64 over 2x2) and at the 64x64
# block (128x128 over 2x2, where K7's route changes); bench_kernels at 64x64;
# bench_points one process per --only filter (default: 128x128, 64x64_b4_tau1
# (a substring of three points: hand-set, tuned, MRE), 32x32_b2, 64x64_b2;
# `points 64x64_b2` runs one alone); bench_scaling's meshes at 64x64 and
# --chain-scaling 1,2,4. Each run's stdout goes to OUT/<run>.log (OUT
# defaults to the git-ignored _scratch/bench_tools) and its rows to
# OUT/<run>.json; each line printed here names the run, its exit status and
# its wall seconds. The committed files docs/BENCH_*_torch.json are these
# rows, one file a tool (bench_points' and bench_sharded_kernel's runs
# concatenated, bench_scaling's as {"rows": meshes, "chain_scaling": ...}).
export PYTHONPATH="$(pwd)"
OUT=${OUT:-_scratch/bench_tools}
T="python3 -m schwingermodel_tpu_torch.tools"
mkdir -p $OUT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

rows() {  # the JSON lines of a log -> a JSON list
  python3 -c "import json, sys; print(json.dumps([json.loads(l) for l in open(sys.argv[1])
                                                  if l.startswith('{')], indent=1))" "$1"
}

run() {  # name command..
  name=$1; shift
  t0=$(date +%s)
  "$@" > $OUT/$name.log 2>&1
  rc=$?
  echo "$name rc=$rc $(( $(date +%s) - t0 )) s"
  [ -f $OUT/$name.json ] || rows $OUT/$name.log > $OUT/$name.json
}

[ $# -eq 0 ] && set -- sharded kernels points scaling
while [ $# -gt 0 ]; do
  case $1 in
  sharded)
    run sharded_32 $T.bench_sharded_kernel --local-nx 32 --local-nt 32 --json $OUT/sharded_32.json
    run sharded_64 $T.bench_sharded_kernel --local-nx 64 --local-nt 64 --json $OUT/sharded_64.json ;;
  kernels)
    run kernels $T.bench_kernels ;;
  points)
    names=""
    while [ $# -gt 1 ] && ! echo "sharded kernels points scaling" | grep -qw "$2"; do
      names="$names $2"; shift
    done
    for n in ${names:-128x128 64x64_b4_tau1 32x32_b2 64x64_b2}; do
      run points_$n $T.bench_points --only $n --json $OUT/points_$n.json
    done ;;
  scaling)
    run scaling $T.bench_scaling
    run chain_scaling $T.bench_scaling --chain-scaling 1,2,4 --json $OUT/chain_scaling.json ;;
  *)
    echo "usage: $0 [sharded] [kernels] [points [NAME..]] [scaling]" >&2; exit 2 ;;
  esac
  shift
done
