"""Gloo worlds for the port's parallel tests: each test file is its own
worker (``python tests/test_torch_<x>.py --worker <scenario> <out_dir>``
under the environment contract of ``tools/launch.py``), started by the
file's module fixture and run under a hard limit, so a hang fails that
file's tests instead of eating the suite's clock. Imports no JAX."""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(path, scenario, n, out_dir):
    """``n`` ranks of ``path --worker scenario out_dir``, one thread
    each."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                   MXTPU_NUM_PROCESSES=str(n), MXTPU_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1")
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(path), "--worker", scenario,
             out_dir], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
    return procs


def finish(procs, deadline, limit):
    """Each rank's (return code, output); a world past ``deadline`` is
    killed, every process group of it."""
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                                0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                try:
                    os.killpg(q.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            text, _ = p.communicate()
            text = (text or "") + f"\n[killed after {limit} s]"
        out.append((p.returncode, text))
    return out


def results(out_dir, scenario, logs):
    """Each rank's saved ``<scenario>_rank<r>.npz`` as a dict; raises with
    the ranks' output when one failed."""
    ranks, bad = [], []
    for r, (rc, text) in enumerate(logs):
        path = os.path.join(out_dir, f"{scenario}_rank{r}.npz")
        if rc != 0 or not os.path.exists(path):
            bad.append(f"{scenario} rank {r} rc={rc}:\n{text[-3000:]}")
            continue
        ranks.append(dict(np.load(path, allow_pickle=False)))
    assert not bad, "\n".join(bad)
    return ranks


def join(backend="gloo"):
    """Join the world from the environment contract; ``(mx, rank)``."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx

    assert mx.kv.init_distributed(backend=backend, timeout=60) == backend
    return mx, int(os.environ["MXTPU_PROCESS_ID"])


def imports_only():
    """The ``imports`` scenario: the worker's import set holds no JAX."""
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch  # noqa: F401

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
    print(bad)
    sys.exit(1 if bad else 0)
