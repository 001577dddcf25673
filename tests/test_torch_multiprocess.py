"""The port's production multi-process entry: two subprocess workers
(tests/_torch_mp_worker.py) brought up by ``initialize_distributed`` with
coordinator kwargs over gloo on the CPU, a hybrid ``(dcn, ici)`` mesh, a
batch sharded from per-process rows.  Their lool value, gradient, posterior
sums and scale agree with each other (rtol 1e-12), with the port's serial
evaluation (rtol 1e-9) and with JAX's serial oracle on the same problem
(rtol 1e-8, the port's serial objective limit), as in
tests/test_multiprocess.py."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mp_results():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT
    env["LOCAL_WORLD_SIZE"] = "1"
    port = _free_port()
    script = os.path.join(REPO_ROOT, "tests", "_torch_mp_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(pid), str(NPROC), str(port)],
            env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for pid in range(NPROC)
    ]
    # the oracles while the workers run
    _ORACLES.update(serial=_port_serial(), jax=_jax_oracle())
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (
            f"worker failed rc={p.returncode}\nstdout={out}\n"
            f"stderr={err[-3000:]}"
        )
        outs.append(out)
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("MPRESULT ")]
        assert lines, f"no MPRESULT in worker output: {out!r}"
        results.append(json.loads(lines[0][len("MPRESULT "):]))
    return results


_ORACLES = {}


def _jax_oracle():
    from test_multiprocess import _serial_oracle

    return _serial_oracle()


def _port_serial():
    import _torch_mp_worker as W

    model, tensors = W.build_problem()
    out = W.evaluate(model, tensors)
    _, rtensors = W.build_problem(batch=61)
    ragged = W.evaluate(model, rtensors)
    out.update(obj_ragged=ragged["obj"],
               grad_ls_ragged=ragged["grad_length_scale"])
    return out


def test_processes_agree(mp_results):
    ref = mp_results[0]
    for r in mp_results[1:]:
        for key in ref:
            if key == "process":
                continue
            np.testing.assert_allclose(
                r[key], ref[key], rtol=1e-12,
                err_msg=f"cross-process mismatch on {key}",
            )


def test_matches_serial_oracle(mp_results):
    """Sharded over two processes == the port's serial values (rtol 1e-9)
    == JAX's serial oracle (rtol 1e-8)."""
    serial, jax_oracle = _ORACLES["serial"], _ORACLES["jax"]
    for r in mp_results:
        for key, want in serial.items():
            np.testing.assert_allclose(
                r[key], want, rtol=1e-9,
                err_msg=f"process {r['process']} vs serial on {key}",
            )
        for key, want in jax_oracle.items():
            np.testing.assert_allclose(
                r[key], want, rtol=1e-8,
                err_msg=f"process {r['process']} vs JAX on {key}",
            )
