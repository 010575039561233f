"""Multi-process bootstrap on ``torch.distributed``.

Port of ``mindrec_tpu/parallel/dist.py``: reads either the JAX-style env
vars or the reference-style ``MR_SCHED_HOST``/``MR_SCHED_PORT``/
``MR_WORKER_NUM``/``MR_WORKER_ID`` set (name parity with the reference's
``MS_*`` family, so launch scripts translate one to one), and joins the
process group at ``tcp://<coordinator>``.

The backend is an argument (``MR_BACKEND`` in the env for the
launchers): NCCL by default on the card, when every rank has a card of
its own; gloo on the CPU, and on the card when ranks share cards (NCCL
refuses two ranks on one device).  Under gloo rank ``r`` takes card
``r % device_count``; NCCL asked for with more ranks than cards raises.
The mesh and its collectives are in :mod:`mindrec_tpu_torch.parallel.mesh`.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as tdist

BACKENDS = ("nccl", "gloo")


def pick_backend(backend: str | None, device, world: int) -> str:
    """The process group's backend: ``backend``, else ``MR_BACKEND``,
    else NCCL on the card when every rank has a card of its own and gloo
    otherwise.  Raises for NCCL asked for on the CPU or with more ranks
    than this host's cards."""
    on_card = torch.device(device).type == "cuda"
    backend = backend or os.environ.get("MR_BACKEND")
    if not backend:
        own_cards = on_card and world <= torch.cuda.device_count()
        backend = "nccl" if own_cards else "gloo"
    backend = backend.lower()
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if not on_card:
            raise ValueError("NCCL runs on the card; take gloo on the CPU")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"NCCL needs a card per rank: {world} ranks, {cards} "
                f"card(s); take backend='gloo' (MR_BACKEND=gloo), whose "
                f"ranks share cards")
    return backend


def initialize_from_env(timeout_s: int = 300, device="cuda",
                        backend: str | None = None) -> dict:
    """Join the process group if the env declares a cluster.

    Recognised (first match wins):

    * ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``;
    * ``MR_SCHED_HOST`` / ``MR_SCHED_PORT`` (default 11272) /
      ``MR_WORKER_NUM`` / ``MR_WORKER_ID``.

    With neither set the process stays single and nothing is touched.
    Returns the reference's keys: ``process_index``, ``process_count``,
    ``local_devices``, ``global_devices`` (one device per process) and
    ``coordinator``; ``torch.distributed.get_backend()`` names the
    backend."""
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
        rank, world = int(pid), int(nproc)
        backend = pick_backend(backend, device, world)
        if on_card:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        tdist.init_process_group(
            backend=backend, init_method=f"tcp://{coord}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    joined = tdist.is_initialized()
    local = torch.cuda.device_count() if on_card else 1
    return {
        "process_index": tdist.get_rank() if joined else 0,
        "process_count": tdist.get_world_size() if joined else 1,
        "local_devices": local,
        "global_devices": (tdist.get_world_size() if joined else 1) * local,
        "coordinator": coord,
    }


def rank_device(device="cuda") -> torch.device:
    """This rank's device: under a joined group on the card, the card it
    was given (``rank % device_count``); else ``device`` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and tdist.is_initialized():
        return torch.device("cuda", tdist.get_rank() % torch.cuda.device_count())
    return dev
