"""Multi-process bootstrap on ``torch.distributed``.

Port of ``mindrec_tpu/parallel/dist.py``: reads either the JAX-style env
vars or the reference-style ``MR_SCHED_HOST``/``MR_SCHED_PORT``/
``MR_WORKER_NUM``/``MR_WORKER_ID`` set (name parity with the reference's
``MS_*`` family, so launch scripts translate one to one), and joins the
process group at ``tcp://<coordinator>``: NCCL on the card, gloo when the
caller asks for the CPU.  Sharding and collectives are not here yet
(``ROADMAP.md`` section 1 item 9).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as tdist


def initialize_from_env(timeout_s: int = 300, device="cuda") -> dict:
    """Join the process group if the env declares a cluster.

    Recognised (first match wins):

    * ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``;
    * ``MR_SCHED_HOST`` / ``MR_SCHED_PORT`` (default 11272) /
      ``MR_WORKER_NUM`` / ``MR_WORKER_ID``.

    With neither set the process stays single and nothing is touched.
    Returns the reference's keys: ``process_index``, ``process_count``,
    ``local_devices``, ``global_devices`` (one device per process) and
    ``coordinator``."""
    coord = os.environ.get("COORDINATOR_ADDRESS")
    nproc = os.environ.get("NUM_PROCESSES")
    pid = os.environ.get("PROCESS_ID")
    if coord is None and "MR_SCHED_HOST" in os.environ:
        coord = (f"{os.environ['MR_SCHED_HOST']}:"
                 f"{os.environ.get('MR_SCHED_PORT', '11272')}")
        nproc = os.environ.get("MR_WORKER_NUM")
        pid = os.environ.get("MR_WORKER_ID")
    on_card = torch.device(device).type == "cuda"
    if coord is not None and not tdist.is_initialized():
        rank = int(pid)
        if on_card:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        tdist.init_process_group(
            backend="nccl" if on_card else "gloo",
            init_method=f"tcp://{coord}", world_size=int(nproc), rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    joined = tdist.is_initialized()
    local = torch.cuda.device_count() if on_card else 1
    return {
        "process_index": tdist.get_rank() if joined else 0,
        "process_count": tdist.get_world_size() if joined else 1,
        "local_devices": local,
        "global_devices": (tdist.get_world_size() if joined else 1) * local,
        "coordinator": coord,
    }
