"""REAL multi-process execution of the distributed glue: two OS
processes, 4 virtual CPU devices each, one global 8-device mesh via ``initialize_distributed`` + ``global_mesh``, the
unmodified jitted batched solver running SPMD with genuine cross-process
collectives (Gloo — the CPU stand-in for a multi-host cluster's network).

The workers assert lane parity and identical iteration counts against
single-device local solves; this test asserts both workers succeed.
"""

import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multiprocess_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_global_mesh_solve():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker pins its own 4-device count
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multiprocess workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert "multiprocess solve OK" in out
