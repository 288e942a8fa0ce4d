"""Multi-process execution (relp_tpu/parallel/multihost.py): two local
processes join via ``jax.distributed.initialize`` on the CPU backend,
build the global solver mesh ('batch' across processes, 'cols' within),
and run ONE sharded batched solve whose scenario axis spans processes.

No reference counterpart (the reference is single-process); this is the
SURVEY §2.8 "host orchestration" row made executable.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_solve():
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        RELP_TPU_COORD=f"localhost:{port}",
        RELP_TPU_NPROC="2",
    )
    procs = []
    for pid in range(2):
        env_i = dict(env, RELP_TPU_PROC_ID=str(pid))
        procs.append(
            subprocess.Popen(
                [sys.executable, _WORKER],
                env=env_i,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
        # each process must see the GLOBAL mesh and report the shared
        # optimal objective of its local scenario shard
        assert "devices=8 processes=2" in out, out
        assert "mesh=(2, 4)" in out, out
        assert "objective_ok=True" in out, out
