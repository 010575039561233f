#!/bin/bash
# Single-card Wide&Deep train + eval: the port's counterpart of
# examples/run_standalone_train.sh (one process, one device, the log in a
# work dir).  Every train_criteo flag passes through, e.g.:
#
#   bash mindrec_tpu_torch/examples/run_standalone_train.sh --epochs 2
#   bash mindrec_tpu_torch/examples/run_standalone_train.sh --device cpu
#
# The defaults are the accuracy recipe of wide_deep_config.yaml.
set -eo pipefail
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$HERE/../..${PYTHONPATH:+:$PYTHONPATH}"
mkdir -p standalone_train
"${PYTHON:-python3}" -m mindrec_tpu_torch.examples.train_criteo \
  --model wide_deep "$@" 2>&1 | tee standalone_train/train.log
