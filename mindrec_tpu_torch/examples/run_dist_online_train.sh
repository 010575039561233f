#!/bin/bash
# Distributed online training on one host: the port's counterpart of
# examples/run_dist_online_train.sh.  One trainer per rank
# (dist_online_train), each tailing its shard of a FileChannel spool that
# a producer fills, training one model data-parallel.
#
# Usage: bash mindrec_tpu_torch/examples/run_dist_online_train.sh [RANKS] [SPOOL_DIR] [args...]
#   e.g. ... 2 /tmp/mindrec_spool --device cpu --final-params final.npz
#
# Each rank logs to online_logs/rank_<r>.log and checkpoints into
# online_ckpt/rank_<r>/.  When a rank fails the others are stopped and
# the script exits non-zero.  The backend: MR_BACKEND (nccl or gloo).
set -e
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$HERE/../..${PYTHONPATH:+:$PYTHONPATH}"
PY="${PYTHON:-python3}"
RANKS=${1:-2}
SPOOL=${2:-/tmp/mindrec_spool}
shift 2 2>/dev/null || true
export MR_SCHED_HOST=${MR_SCHED_HOST:-127.0.0.1}
export MR_SCHED_PORT=${MR_SCHED_PORT:-11274}
export MR_WORKER_NUM=$RANKS
# one CPU thread per rank for PyTorch's CPU operators unless set
export OMP_NUM_THREADS=${OMP_NUM_THREADS:-1}

rm -rf online_logs && mkdir -p online_logs
pids=()
trap 'kill "${pids[@]}" 2>/dev/null || true' EXIT
for ((i = 0; i < RANKS; i++)); do
  MR_WORKER_ID=$i "$PY" -m mindrec_tpu_torch.examples.dist_online_train \
    --spool "$SPOOL" --ckpt-dir online_ckpt "$@" \
    >online_logs/rank_$i.log 2>&1 &
  pids+=($!)
  echo "rank $i pid $!"
done
rc=0
for ((i = 0; i < RANKS; i++)); do
  if ! wait -n; then  # a rank failed: the others would wait for it
    rc=1
    kill "${pids[@]}" 2>/dev/null || true
  fi
done
trap - EXIT
if [ "$rc" -ne 0 ]; then
  for ((i = 0; i < RANKS; i++)); do
    echo "--- rank $i"; tail -n 20 "online_logs/rank_$i.log"
  done
fi
exit $rc
