#!/bin/bash
# Dynamic (hash) embedding training: the port's counterpart of
# examples/run_dynamic_embedding_train.sh.  With wide_deep_config.yaml's
# sparse: false the tables are plain row-major specs, which the sparse
# step trains on its generic path.  With MR_SERVER_HOSTS set the id ->
# slot map lives on table servers (RemoteHashStore).
#
# Usage: bash mindrec_tpu_torch/examples/run_dynamic_embedding_train.sh [args...]
set -e
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$HERE/../..${PYTHONPATH:+:$PYTHONPATH}"
"${PYTHON:-python3}" -m mindrec_tpu_torch.examples.train_criteo \
  --dynamic_embedding 1 "$@"
