"""Build and load the port's hand-written CUDA kernels.

Every ``mxnet_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
at first use, into ``mxnet_tpu_torch/_build/`` (git-ignored). The library
name carries a hash of its source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source is
rebuilt and a checkout that holds no build builds everything on its first
call. All sources are compiled at once, one ``nvcc`` process each. Nothing
outside the repository is used but the CUDA toolkit. A failed build
raises; there is no fallback to the plain PyTorch versions.

Every source exports ``const char* mxtpu_cuda_error_string(int)`` for
:func:`check`. Wrappers call :func:`library` for their ``ctypes.CDLL`` and
call :func:`count` each time they launch a kernel, so a run can show
which kernels its main path went through. Inside a CUDA-graph capture a
wrapper launches nothing: its count goes to the capture, and each replay
adds the capture's counts to ``LAUNCHES`` (``gluon/_capture.py``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..base import MXNetError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

#: kernel launches per wrapper name since the last ``LAUNCHES.clear()``
LAUNCHES = collections.Counter()
#: held by every update of ``LAUNCHES`` and of a capture's counts
_count_lock = threading.Lock()
#: the counts of the CUDA-graph capture under way, or None (captures run
#: one at a time, ``gluon/_capture.py``)
_capture_counts = [None]

_lock = threading.Lock()
_libs = {}

#: the FLOP tallies of the ``observability.introspect.site`` runs under
#: way (one-element lists); empty, a wrapper notes nothing
FLOP_SINKS = []


def count(name: str) -> None:
    """Count one launch of the kernel ``name``: into the capture under way
    when the calling thread's current stream is capturing (the capturing
    thread, or the autograd thread of a captured backward, whose current
    stream is the capture's), else into ``LAUNCHES``. An eager launch in
    another thread during a capture is thus counted as it ran."""
    with _count_lock:
        into = _capture_counts[0]
        if into is None or not torch.cuda.is_current_stream_capturing():
            into = LAUNCHES
        into[name] += 1


def note_flops(n) -> None:
    """Add ``n`` operations of a hand-written kernel just launched to the
    introspection runs under way (the FLOP counter sees only aten ops)."""
    for sink in FLOP_SINKS:
        sink[0] += n


def add(counts) -> None:
    """Add ``counts`` (one replay of a captured graph) to ``LAUNCHES``."""
    with _count_lock:
        LAUNCHES.update(counts)


def capture_counts(counts) -> None:
    """Send the counts of captured launches to ``counts`` (a capture
    begins) or, given None, back to ``LAUNCHES`` (it ends)."""
    with _count_lock:
        _capture_counts[0] = counts


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``,
    or ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError("nvcc not found (set CUDA_HOME); the port's CUDA "
                     "kernels are built from mxnet_tpu_torch/csrc at first use")


def sources() -> dict:
    """``{stem: path}`` of every ``.cu`` source under ``csrc/``."""
    return {f[:-3]: os.path.join(CSRC, f)
            for f in sorted(os.listdir(CSRC)) if f.endswith(".cu")}


def _target(stem: str, path: str) -> str:
    """Library path keyed by a hash of the flags, the source and every
    shared header (``csrc/*.cuh``) it may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = [os.path.join(CSRC, f) for f in sorted(os.listdir(CSRC))
               if f.endswith(".cuh")]
    for p in [path] + headers:
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_all() -> dict:
    """Compile every source whose library is missing, all ``nvcc``
    processes running together; return ``{stem: library path}``. Each
    library is written to a private name and renamed into place, so
    concurrent builds never load a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {stem: _target(stem, p) for stem, p in sources().items()}
    todo = {s: t for s, t in targets.items() if not os.path.exists(t)}
    if not todo:
        return targets
    nvcc = nvcc_path()
    procs = {}
    for stem, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, sources()[stem]]
        procs[stem] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for stem, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise MXNetError("nvcc failed to build the port's kernels:\n"
                         + "\n".join(failed))
    return targets


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built first if
    needed; cached for the process)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = _libs[stem] = ctypes.CDLL(build_all()[stem])
        return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise when a launcher returned a non-zero ``cudaError_t``."""
    if err:
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.mxtpu_cuda_error_string(err).decode()
        raise MXNetError(f"{what}: CUDA error {err} ({msg})")
