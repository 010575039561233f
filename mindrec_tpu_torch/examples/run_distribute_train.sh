#!/bin/bash
# Multi-process train + eval on one host: the port's counterpart of
# examples/run_distribute_train.sh.  N ranks of train_criteo join one
# process group through the MR_* bootstrap (parallel/dist.py) and train
# on a (data, model) mesh; --mesh_model M makes M of them the model axis
# (sliced tables with --deep_table_slice_mode), the rest the data axis.
# On the card each rank replays its step as CUDA graphs cut at every
# collective (RecModel's jit), as one card replays its captured step.
#
#   bash mindrec_tpu_torch/examples/run_distribute_train.sh 2 --device cpu
#   bash mindrec_tpu_torch/examples/run_distribute_train.sh 4 --sparse 1 \
#       --mesh_model 2 --deep_table_slice_mode table_row_slice
#
# The backend: MR_BACKEND (nccl or gloo); by default NCCL when every rank
# has a card of its own and gloo otherwise (ranks that share a card take
# card rank % cards).  Each rank logs to $MR_LOG_DIR/worker_<rank>.log
# (default dp_logs); when a rank fails the others are stopped and the
# script exits non-zero.  Multi-host: run the ranks of each host with
# MR_WORKER_ID set and MR_SCHED_HOST pointing at rank 0's host.
set -e
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$HERE/../..${PYTHONPATH:+:$PYTHONPATH}"
PY="${PYTHON:-python3}"
WORKERS=${1:-2}
shift 1 2>/dev/null || true
export MR_SCHED_HOST=${MR_SCHED_HOST:-127.0.0.1}
export MR_SCHED_PORT=${MR_SCHED_PORT:-11273}
export MR_WORKER_NUM=$WORKERS
# one CPU thread per rank for PyTorch's CPU operators unless set: ranks on
# one host would each start a thread per core
export OMP_NUM_THREADS=${OMP_NUM_THREADS:-1}
LOGS=${MR_LOG_DIR:-dp_logs}

rm -rf "$LOGS" && mkdir -p "$LOGS"
pids=()
trap 'kill "${pids[@]}" 2>/dev/null || true' EXIT
for ((i = 0; i < WORKERS; i++)); do
  MR_WORKER_ID=$i "$PY" -m mindrec_tpu_torch.examples.train_criteo "$@" \
    >"$LOGS/worker_$i.log" 2>&1 &
  pids+=($!)
  echo "worker $i pid $!"
done
rc=0
for ((i = 0; i < WORKERS; i++)); do
  if ! wait -n; then  # a rank failed: the others would wait for it
    rc=1
    kill "${pids[@]}" 2>/dev/null || true
  fi
done
trap - EXIT
if [ "$rc" -ne 0 ]; then
  for ((i = 0; i < WORKERS; i++)); do
    echo "--- worker $i"; tail -n 20 "$LOGS/worker_$i.log"
  done
fi
exit $rc
