#!/bin/bash
# TB-scale single-worker training: the port's counterpart of
# examples/run_terabyte_train.sh (vocab 900M x emb 240 behind a 4.6M-row
# card cache, a host RAM cap and SSD spill).
# MR_EMBEDDING_REMOTE_CACHE_MEMORY_SIZE (GB) is the RAM cap.
#
#   bash mindrec_tpu_torch/examples/run_terabyte_train.sh            # quick
#   FULL=1 bash mindrec_tpu_torch/examples/run_terabyte_train.sh     # the point
set -eo pipefail
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
export PYTHONPATH="$HERE/../..${PYTHONPATH:+:$PYTHONPATH}"
RAM_GB=${MR_EMBEDDING_REMOTE_CACHE_MEMORY_SIZE:-10}
mkdir -p terabyte_train
if [ "${FULL:-0}" = "1" ]; then
  "${PYTHON:-python3}" -m mindrec_tpu_torch.examples.train_terabyte \
    --vocab 900000000 --emb-dim 240 --cache-rows 4600000 \
    --ram-gb "$RAM_GB" "$@" 2>&1 | tee terabyte_train/train.log
else
  "${PYTHON:-python3}" -m mindrec_tpu_torch.examples.train_terabyte \
    --ram-gb "$RAM_GB" "$@" 2>&1 | tee terabyte_train/train.log
fi
