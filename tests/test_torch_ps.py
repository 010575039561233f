"""PS mode's topology (``parallel/ps.py``) and bootstrap
(``parallel/dist.py``) against the reference's env contract: roles and
server addresses from the env, the server role as a real table-server
process, the single-process default, and a 2-process gloo rendezvous
through ``MR_SCHED_HOST`` / ``MR_SCHED_PORT`` on the CPU."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from mindrec_tpu.parallel import ps as jps
from mindrec_tpu_torch.ops import remote
from mindrec_tpu_torch.parallel import dist, ps
from test_torch_remote import _free_port

REPO = Path(__file__).resolve().parents[1]
ENV_KEYS = ("MR_ROLE", "MR_SERVER_NUM", "MR_SERVER_HOSTS", "MR_SCHED_HOST",
            "MR_SCHED_PORT", "MR_SERVER_PORT_BASE", "MR_WORKER_ID",
            "MR_WORKER_NUM", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
            "PROCESS_ID", "MR_SERVER_PORT", "MR_SPILL_DIR")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", [
    {},
    {"MR_ROLE": "MR_PSERVER", "MR_SERVER_NUM": "2", "MR_SCHED_HOST": "10.0.0.1"},
    {"MR_ROLE": "mr_sched", "MR_SERVER_NUM": "3", "MR_SERVER_PORT_BASE": "7000"},
    {"MR_ROLE": "MR_WORKER", "MR_SERVER_HOSTS": "a:1, b:2,", "MR_WORKER_ID": "3",
     "MR_WORKER_NUM": "4", "MR_SERVER_NUM": "9"},
    {"MR_ROLE": "MS_WORKER"},
])
def test_topology_from_env_matches_reference(clean_env, env):
    """The reference's cases (``tests/test_remote_tier.py:137``) and more:
    the port's topology equals the reference's field for field."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    got, want = ps.topology_from_env(), jps.topology_from_env()
    assert (got.role, got.server_addrs, got.worker_id, got.worker_num) == (
        want.role, want.server_addrs, want.worker_id, want.worker_num)
    if env.get("MR_SCHED_HOST") == "10.0.0.1":
        assert got.role == "server"
        assert got.server_addrs == ["10.0.0.1:18900", "10.0.0.1:18901"]


def test_run_role_server_accepts_a_connection(clean_env, tmp_path):
    """``MR_ROLE=MR_PSERVER`` turns the entry point into the port's table
    server (execv) on ``MR_SERVER_PORT``, spilling into ``MR_SPILL_DIR``
    under the RAM cap of ``MR_EMBEDDING_REMOTE_CACHE_MEMORY_SIZE``."""
    remote.server_binary_path()  # built here, not in the child
    port = _free_port()
    env = {**os.environ, "MR_ROLE": "MR_PSERVER", "MR_SERVER_PORT": str(port),
           "MR_SPILL_DIR": str(tmp_path),
           "MR_EMBEDDING_REMOTE_CACHE_MEMORY_SIZE": str(4096 / 2**30)}
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from mindrec_tpu_torch.parallel.ps import run_role; run_role()"],
        cwd=REPO, env=env)
    addr = f"127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                tier = remote.RemoteTier(addr, "t", 8, init_std=0.0,
                                         init_bias=0.5)
                break
            except OSError:
                assert proc.poll() is None, f"server exited rc={proc.returncode}"
                assert time.monotonic() < deadline, "server did not come up"
                time.sleep(0.05)
        rows = tier.read(np.arange(300))
        assert (rows == 0.5).all()
        assert tier.stats() == [(128, 172)]  # 4 KiB of 32-byte rows in RAM
        tier.close()
    finally:
        remote.stop_table_server(addr, proc)
    assert proc.returncode == 0


def test_initialize_from_env_single_process(clean_env):
    """No cluster declared: one process, nothing initialised."""
    import torch.distributed as tdist

    out = dist.initialize_from_env(device="cpu")
    assert out == {"process_index": 0, "process_count": 1, "local_devices": 1,
                   "global_devices": 1, "coordinator": None}
    assert not tdist.is_initialized()
    topo = ps.run_role(ps.PsTopology(role="worker"), device="cpu")
    assert topo.dist == out


CHILD = """
import torch, torch.distributed as tdist
from mindrec_tpu_torch.parallel.ps import run_role
topo = run_role(device="cpu")
x = torch.tensor([float(topo.dist["process_index"] + 1)])
tdist.all_reduce(x)
print("RESULT", topo.role, topo.dist["process_index"], topo.dist["process_count"],
      topo.dist["coordinator"], float(x[0]), flush=True)
tdist.destroy_process_group()
"""


def test_gloo_rendezvous_two_processes(clean_env):
    """Two processes (the scheduler as rank 0 and a worker) join one gloo
    group at ``tcp://MR_SCHED_HOST:MR_SCHED_PORT`` and all-reduce."""
    port = _free_port()
    procs = []
    for rank, role in enumerate(("MR_SCHED", "MR_WORKER")):
        env = {**os.environ, "MR_ROLE": role, "MR_SCHED_HOST": "127.0.0.1",
               "MR_SCHED_PORT": str(port), "MR_WORKER_NUM": "2",
               "MR_WORKER_ID": str(rank)}
        procs.append(subprocess.Popen([sys.executable, "-c", CHILD], cwd=REPO,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = [next(line.split()[1:] for line in o.splitlines()
                if line.startswith("RESULT")) for o in outs]
    assert got == [["sched", "0", "2", f"127.0.0.1:{port}", "3.0"],
                   ["worker", "1", "2", f"127.0.0.1:{port}", "3.0"]]
