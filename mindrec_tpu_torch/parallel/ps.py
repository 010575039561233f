"""Three-role cluster topology (scheduler / table servers / workers).

Port of ``mindrec_tpu/parallel/ps.py``.  The reference's launch scripts
start one scheduler, S parameter servers and W workers, all running one
entry point told apart by env vars.  Here:

* **scheduler** -> the ``torch.distributed`` rendezvous (worker 0's
  address; table servers do not join the process group);
* **server** -> the port's ``native/table_server.cc`` process holding
  table shards (RAM cap + SSD spill on the server);
* **worker** -> trainer processes, whose tiers are
  :class:`~mindrec_tpu_torch.ops.remote.RemoteTier` on the servers.

Env contract (the reference's names):

=====================  ==========================================
``MR_ROLE``            ``MR_SCHED`` | ``MR_PSERVER`` | ``MR_WORKER``
``MR_SCHED_HOST/PORT`` the rendezvous endpoint (workers)
``MR_SERVER_NUM``      number of table servers
``MR_SERVER_HOSTS``    comma list "host:port,..." of table servers
                       (default: sched host, ports base..base+S-1,
                       base ``MR_SERVER_PORT_BASE`` or 18900)
``MR_SERVER_PORT``     this server's listen port (server role)
``MR_SPILL_DIR``       this server's spill directory (server role)
``MR_EMBEDDING_REMOTE_CACHE_MEMORY_SIZE``  RAM cap per table, GB
``MR_WORKER_NUM``      number of worker processes
``MR_WORKER_ID``       this worker's rank
=====================  ==========================================

One entry point calls :func:`run_role`: the server role becomes the table
server (``execv``, never returns); the scheduler and worker roles join
the process group and return to train.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from mindrec_tpu_torch.ops.remote import server_binary_path
from mindrec_tpu_torch.parallel.dist import initialize_from_env


@dataclass
class PsTopology:
    role: str  # "sched" | "server" | "worker"
    server_addrs: list[str] = field(default_factory=list)
    worker_id: int = 0
    worker_num: int = 1
    dist: dict | None = None


def topology_from_env() -> PsTopology:
    role = {"MR_SCHED": "sched", "MR_PSERVER": "server", "MR_WORKER": "worker"}.get(
        os.environ.get("MR_ROLE", "MR_WORKER").upper(), "worker")
    n_srv = int(os.environ.get("MR_SERVER_NUM", "0"))
    hosts = os.environ.get("MR_SERVER_HOSTS")
    if hosts:
        addrs = [h.strip() for h in hosts.split(",") if h.strip()]
    elif n_srv:
        base_host = os.environ.get("MR_SCHED_HOST", "127.0.0.1")
        base_port = int(os.environ.get("MR_SERVER_PORT_BASE", "18900"))
        addrs = [f"{base_host}:{base_port + i}" for i in range(n_srv)]
    else:
        addrs = []
    return PsTopology(
        role=role, server_addrs=addrs,
        worker_id=int(os.environ.get("MR_WORKER_ID", "0")),
        worker_num=int(os.environ.get("MR_WORKER_NUM", "1")),
    )


def run_role(topo: PsTopology | None = None, device="cuda") -> PsTopology:
    """Act on the role.  Server: build the table server and ``execv`` it
    (never returns; its port is ``MR_SERVER_PORT``, else the first server
    address's, else 18900).  Scheduler or worker: join the process group
    (:func:`initialize_from_env` on ``device``) and return."""
    topo = topo or topology_from_env()
    if topo.role == "server":
        port = os.environ.get(
            "MR_SERVER_PORT",
            topo.server_addrs[0].rsplit(":", 1)[1] if topo.server_addrs
            else "18900")
        cmd = [str(server_binary_path()), "--port", str(int(port))]
        if d := os.environ.get("MR_SPILL_DIR"):
            cmd += ["--spill-dir", d]
        os.execv(cmd[0], cmd)  # the RAM cap's env var reaches the binary
    topo.dist = initialize_from_env(device=device)
    return topo
