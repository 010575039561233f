#!/bin/bash
# Elastic recovery on one host: the port's counterpart of
# examples/run_elastic_train.sh.  A failure is the trainer's exit; the
# recovery is a restart from its latest checkpoint (train_criteo
# --resume), at most MAX_RESTARTS times.  Checkpoints every
# MR_CKPT_INTERVAL steps (default 100).
#
# Usage: bash mindrec_tpu_torch/examples/run_elastic_train.sh [MAX_RESTARTS] [train args...]
set -u
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$HERE/../..${PYTHONPATH:+:$PYTHONPATH}"
PY="${PYTHON:-python3}"
MAX_RESTARTS=${1:-3}
shift 1 2>/dev/null || true

attempt=0
while true; do
  "$PY" -m mindrec_tpu_torch.examples.train_criteo \
    --ckpt_interval "${MR_CKPT_INTERVAL:-100}" --resume "$@" && break
  rc=$?
  attempt=$((attempt + 1))
  if [ "$attempt" -gt "$MAX_RESTARTS" ]; then
    echo "elastic: giving up after $MAX_RESTARTS restarts (rc=$rc)" >&2
    exit "$rc"
  fi
  echo "elastic: trainer exited rc=$rc; restart $attempt/$MAX_RESTARTS from latest checkpoint" >&2
done
