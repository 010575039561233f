#!/bin/bash
# PS-mode launch on one host: S table servers and W workers (the port's
# counterpart of examples/run_ps_train.sh).  The servers run
# parallel/ps.py:run_role (MR_ROLE=MR_PSERVER), the workers train_criteo
# with MR_SERVER_HOSTS pointing at them (S = 0: no servers, host tiers);
# W > 1 workers join one process group (gloo on the CPU or when they share
# a card; MR_BACKEND picks): the card cache trains one model per worker
# over the ids it owns, host tables and the hash vocabulary one model
# data-parallel (train_criteo.py's docstring).  The servers are stopped
# when the workers end; the exit code is the first failing worker's.
#
# Usage: bash mindrec_tpu_torch/examples/run_ps_train.sh [SERVER_NUM] [WORKER_NUM] [train args...]
# Pick the regime with train_criteo flags: --vocab_cache_size N (card
# cache over remote tiers), --parameter_server 1 (host-target, the
# optimizer on the servers' rows) or --dynamic_embedding 1 (the hash
# vocabulary on the servers).
set -e
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$HERE/../..${PYTHONPATH:+:$PYTHONPATH}"
PY="${PYTHON:-python3}"
export MR_SERVER_NUM=${1:-1}
export MR_WORKER_NUM=${2:-1}
shift 2 2>/dev/null || true
export MR_SCHED_HOST=${MR_SCHED_HOST:-127.0.0.1}
export MR_SCHED_PORT=${MR_SCHED_PORT:-11272}
export MR_SERVER_PORT_BASE=${MR_SERVER_PORT_BASE:-18900}
# the servers' RAM cap (GB) before SSD spill
export MR_EMBEDDING_REMOTE_CACHE_MEMORY_SIZE=${MR_EMBEDDING_REMOTE_CACHE_MEMORY_SIZE:-10}

rm -rf ps_logs && mkdir -p ps_logs
servers=()
trap '[ ${#servers[@]} -eq 0 ] || { kill "${servers[@]}" 2>/dev/null; wait "${servers[@]}" 2>/dev/null; } || true' EXIT
for ((i = 0; i < MR_SERVER_NUM; i++)); do
  MR_ROLE=MR_PSERVER MR_SERVER_PORT=$((MR_SERVER_PORT_BASE + i)) \
    "$PY" -c "from mindrec_tpu_torch.parallel.ps import run_role; run_role()" \
    >ps_logs/server_$i.log 2>&1 &
  servers+=($!)
  echo "server $i pid $! port $((MR_SERVER_PORT_BASE + i))"
done

hosts=""
for ((i = 0; i < MR_SERVER_NUM; i++)); do
  port=$((MR_SERVER_PORT_BASE + i))
  for ((t = 0; t < 600; t++)); do  # up to 120 s for the build and listen
    (exec 3<>"/dev/tcp/$MR_SCHED_HOST/$port") 2>/dev/null && break
    sleep 0.2
  done
  hosts+="${hosts:+,}${MR_SCHED_HOST}:${port}"
done
export MR_SERVER_HOSTS=$hosts

workers=()
for ((i = 0; i < MR_WORKER_NUM; i++)); do
  MR_ROLE=MR_WORKER MR_WORKER_ID=$i \
    "$PY" -m mindrec_tpu_torch.examples.train_criteo "$@" \
    >ps_logs/worker_$i.log 2>&1 &
  workers+=($!)
  echo "worker $i pid $!"
done
rc=0
for w in "${workers[@]}"; do wait "$w" || rc=$?; done
exit $rc
