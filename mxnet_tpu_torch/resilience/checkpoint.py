"""Training checkpoints (``MXTPU_CHECKPOINT=<dir>[:every_n]``).

PyTorch counterpart of ``mxnet_tpu/resilience/checkpoint.py``, for one
process. What ``Block.save_parameters`` misses is what a preemption
loses: the Trainer's optimizer state (fused and eager), the fp32 master
weights and the loss scaler's counters, the update counts, the random
state and the input position. A :class:`CheckpointManager` snapshots all
of it at a step boundary (a copy of every tensor on the device, on the
training thread) and a writer thread moves the copies to the host and
writes them, so the loop pays only for the device copies.

The layout is the JAX package's ``mxtpu-checkpoint-v1``, read and
written by both packages:

- ``<dir>/.tmp-step_<n>-<pid>-<seq>/`` first gets ``data.bin`` (the raw
  tensors one after another) and ``MANIFEST.json`` (shape, dtype, offset
  and crc32 of each tensor, and the scalar extras), fsynced;
- the tmp dir is renamed to ``<dir>/step_<n>/`` (a checkpoint exists
  completely or not at all), then ``<dir>/LATEST`` is updated by an
  atomic rename (advisory: discovery falls back to the highest committed
  ``step_*``);
- retention (``keep``, default 3) removes the oldest committed steps.

The random state is the port's own: the CPU generator's state and the
current card's under ``rng::torch_cpu`` and ``rng::torch_cuda``. The JAX
package's key (``rng::key``) is not read by the port, nor the port's by
it. On SIGTERM one final checkpoint is written synchronously before the
signal's disposition runs (deferred to the end of a step's critical
section when it lands inside one). ``tools/verify_checkpoint.py`` and
:func:`verify` re-checksum a checkpoint; :mod:`.resume` restores one.
"""

from __future__ import annotations

import atexit
import itertools
import json
import logging
import os
import queue
import shutil
import signal
import threading
import time
import zlib

import numpy as _np
import torch

from ..base import MXNetError, getenv

_logger = logging.getLogger("mxnet_tpu_torch.checkpoint")

FORMAT = "mxtpu-checkpoint-v1"
MANIFEST = "MANIFEST.json"
PAYLOAD = "data.bin"
LATEST = "LATEST"

_KEEP_DEFAULT = 3

#: the tensors of the port's random state in a checkpoint
RNG_CPU = "rng::torch_cpu"
RNG_CUDA = "rng::torch_cuda"


# ---------------------------------------------------------------------------
# state flattening: any optimizer-state shape (fused flat tuples, eager
# (master, (m, v)) nests, None) round-trips through (structure, tensors)
# ---------------------------------------------------------------------------

def _flatten_state(obj, key_prefix, sink, _counter=None):
    """Tuples/lists/NDArrays/tensors/None -> a JSON structure descriptor;
    tensor leaves land in ``sink`` under ``<key_prefix>::<n>``."""
    if _counter is None:
        _counter = itertools.count()
    if obj is None:
        return None
    if isinstance(obj, (tuple, list)):
        return [_flatten_state(o, key_prefix, sink, _counter) for o in obj]
    if isinstance(obj, (int, float)):
        return {"__v": obj}
    raw = obj.data if hasattr(obj, "data") and not callable(obj.data) \
        and not isinstance(obj, torch.Tensor) else obj
    key = f"{key_prefix}::{next(_counter)}"
    sink[key] = raw
    return {"__t": key}


def _unflatten_state(desc, tensors, wrap=None):
    """Inverse of :func:`_flatten_state`; ``wrap`` converts each tensor
    leaf (to an NDArray for eager states)."""
    if desc is None:
        return None
    if isinstance(desc, list):
        return tuple(_unflatten_state(d, tensors, wrap) for d in desc)
    if "__v" in desc:
        return desc["__v"]
    raw = tensors[desc["__t"]]
    return wrap(raw) if wrap is not None else raw


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _torch_dtype(name):
    dt = getattr(torch, name, None)
    return dt if isinstance(dt, torch.dtype) else None


def _itemsize(name):
    dt = _torch_dtype(name)
    if dt is not None:
        return torch.empty((), dtype=dt).element_size()
    return _np.dtype(name).itemsize


def _host_bytes(t):
    """``(shape, dtype name, bytes)`` of a host tensor or array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        name = _dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return list(t.shape), name, t.numpy().tobytes()
    a = _np.asarray(t)
    return list(a.shape), str(a.dtype), a.tobytes()


# ---------------------------------------------------------------------------
# snapshot assembly
# ---------------------------------------------------------------------------

class _Snapshot(dict):
    """The device copies of a snapshot (key -> tensor), with the event
    recorded after them on each card's stream."""

    events = ()


def _rng_tensors():
    out = {RNG_CPU: torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out[RNG_CUDA] = torch.cuda.get_rng_state()
    return out


def snapshot_trainer(trainer, net=None, step=None, cursor=None,
                     reuse=None):
    """The complete state of a Gluon training loop as ``(tensors,
    extras)``: the parameters, each parameter's optimizer state (fused
    tuples or eager states, whichever path owns it; the fp32 masters with
    it), the loss scaler's counters, the update counts and the random
    state. Every tensor is copied on its device on the calling thread's
    stream (later steps write the live tensors in place); nothing waits
    for the device. ``reuse``: an earlier snapshot no longer read, whose
    copies of the same shape, type and device are written in place of
    new ones. Call it at a step boundary."""
    from ..gluon.trainer import Trainer

    if not isinstance(trainer, Trainer):
        raise MXNetError("snapshot_trainer needs a gluon.Trainer")
    tensors = {}
    extras = {"kind": "trainer", "opt_kind": {}, "eager_structs": {},
              "fused_leaves": {}}
    # structural keys when the net is known ("0.weight" survives a
    # rebuild; the global prefixed names do not)
    struct = {}
    if net is not None:
        for sname, p in net._collect_params_with_prefix().items():
            struct.setdefault(id(p), sname)

    def keyof(p):
        return struct.get(id(p), p.name)

    params = list(trainer._params)
    if net is not None:
        seen = {id(p) for p in params}
        for _, p in sorted(net.collect_params().items()):
            if id(p) not in seen:
                params.append(p)
    for p in params:
        if p._data is None:
            continue
        tensors[f"param::{keyof(p)}"] = p.data().data
    for p in trainer._params:
        key = keyof(p)
        st = trainer._fused_states.get(p.name)
        if st is not None:
            extras["opt_kind"][key] = "fused"
            extras["fused_leaves"][key] = len(st)
            for i, leaf in enumerate(st):
                tensors[f"fused::{key}::{i}"] = leaf
            continue
        est = getattr(p, "_opt_state", None)
        if est is not None:
            extras["opt_kind"][key] = "eager"
            extras["eager_structs"][key] = _flatten_state(
                est, f"eager::{key}", tensors)
    o = trainer._optimizer
    extras["update_counts"] = {str(k): int(v)
                               for k, v in o._index_update_count.items()}
    extras["num_update"] = int(o.num_update)
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is not None:
        extras["scaler"] = {"factor": scaler._factor,
                            "window": scaler._window}
        tensors["scaler::scale"] = scaler._scale_arr
        tensors["scaler::unskipped"] = scaler._unskipped_arr
        tensors["scaler::overflow_total"] = scaler._overflow_total_arr
    else:
        extras["scaler"] = None
    tensors.update(_rng_tensors())
    if step is not None:
        extras["step"] = int(step)
    if cursor is not None:
        extras["cursor"] = dict(cursor) if isinstance(cursor, dict) \
            else int(cursor)
    out = _Snapshot()
    reuse = reuse or {}
    pairs = {}  # device -> (copies written over, their sources)
    with torch.no_grad():
        for k in sorted(tensors):
            t = tensors[k]
            if not isinstance(t, torch.Tensor):
                out[k] = t
                continue
            t, old = t.detach(), reuse.get(k)
            if old is not None and old.shape == t.shape \
                    and old.dtype == t.dtype and old.device == t.device:
                out[k] = old
                dst, src = pairs.setdefault(t.device, ([], []))
                dst.append(old)
                src.append(t)
            else:
                out[k] = t.clone()
        for dst, src in pairs.values():
            torch._foreach_copy_(dst, src)
    devices = {t.device for t in out.values()
               if isinstance(t, torch.Tensor) and t.is_cuda}
    events = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append((dev, ev))
    out.events = tuple(events)
    return out, extras


def _to_host(tensors):
    """Host copies of a snapshot's tensors. The device-to-host copies run
    on a side stream of each card that waits only for the snapshot's own
    copies, so a writer thread does not wait for the steps enqueued
    after them."""
    events = getattr(tensors, "events", ())
    if not events:
        return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in tensors.items()}
    out = {}
    for dev, ev in events:
        side = torch.cuda.Stream(device=dev)
        side.wait_event(ev)
        with torch.cuda.stream(side):
            for k, v in tensors.items():
                if isinstance(v, torch.Tensor) and v.device == dev:
                    out[k] = v.cpu()
        side.synchronize()
    for k, v in tensors.items():
        out.setdefault(k, v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


# ---------------------------------------------------------------------------
# directory protocol
# ---------------------------------------------------------------------------

def _step_dirname(step):
    return f"step_{int(step):010d}"


def _committed_steps(directory):
    """Sorted committed step numbers (a step counts only with a
    manifest: half-written tmp dirs never match)."""
    steps = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for n in names:
        if n.startswith("step_") and os.path.exists(
                os.path.join(directory, n, MANIFEST)):
            try:
                steps.append(int(n[5:]))
            except ValueError:
                continue
    return sorted(steps)


def latest_checkpoint(directory):
    """Path of the newest committed checkpoint under ``directory`` (the
    LATEST pointer when valid, else the highest committed step), or
    None."""
    try:
        with open(os.path.join(directory, LATEST)) as f:
            name = f.read().strip()
        if name and os.path.exists(os.path.join(directory, name, MANIFEST)):
            return os.path.join(directory, name)
    except OSError:
        pass
    steps = _committed_steps(directory)
    if not steps:
        return None
    return os.path.join(directory, _step_dirname(steps[-1]))


_TMP_SEQ = [0]  # per-process uniquifier for the temporary names
# re-entrant: the SIGTERM handler runs on the main thread and may
# interrupt a frame already inside the lock
_TMP_SEQ_LOCK = threading.RLock()


def _next_seq():
    with _TMP_SEQ_LOCK:
        _TMP_SEQ[0] += 1
        return _TMP_SEQ[0]


def atomic_replace(path, write_fn):
    """``write_fn(tmp_path)`` produces the content, which is fsynced and
    renamed over ``path``; the temporary name is unique per call, so
    concurrent savers of one path never clobber each other's half-written
    file. The commit primitive of the manifests, ``LATEST`` and
    ``Block.save_parameters``."""
    tmp = f"{path}.tmp{os.getpid()}-{_next_seq()}"
    try:
        write_fn(tmp)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _atomic_write(path, data):
    def write(tmp):
        with open(tmp, "w") as f:
            f.write(data)

    atomic_replace(path, write)


# ---------------------------------------------------------------------------
# step-boundary critical sections: a SIGTERM landing while a step or a
# superstep mutates state must not snapshot a half-applied update.
# Trainer.step and Superstep.step bracket their state-mutating window
# with step_critical_section(); the SIGTERM handler defers the final
# save to the section's exit. Handlers and the bracketing code both run
# on the main thread, so a counter suffices.
# ---------------------------------------------------------------------------

_CRITICAL = [0]
_DEFERRED = []


def in_step_critical():
    return _CRITICAL[0] > 0


class _StepCritical:
    def __enter__(self):
        _CRITICAL[0] += 1
        return self

    def __exit__(self, *exc):
        _CRITICAL[0] -= 1
        if _CRITICAL[0] == 0 and _DEFERRED:
            # also on an exception's exit: dropping the signal would
            # leave the process alive after a SIGTERM it never saw
            pending = list(_DEFERRED)
            del _DEFERRED[:]
            for fn, args in pending:
                fn(*args)
        return False


def step_critical_section():
    """Mark a train step's state-mutating window: a SIGTERM final
    checkpoint that fires inside it waits for its exit, so the final save
    always commits at a completed step (or K-step boundary). Reentrant."""
    return _StepCritical()


def require_one_process(what):
    """Raise where ``what`` would do the wrong thing in a world of several
    ranks (every rank writing one directory, each restoring alone): the
    multi-process checkpoint is ROADMAP A11's."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise MXNetError(
            f"{what} in a world of {dist.get_world_size()} ranks: the "
            "multi-process checkpoint (one commit for every rank) is not "
            "ported yet (ROADMAP A11); checkpoint in a world of one")


def default_commit_barrier():
    """The commit barrier of a sharded checkpoint: in one process, a
    no-op (the multi-process barrier is ROADMAP A11's)."""
    return lambda: None


def write_checkpoint(directory, tensors, extras, step, reason="manual",
                     extra_files=None):
    """Write one snapshot into ``<directory>/step_<step>/`` with the
    tmp-dir + rename commit. ``tensors`` maps keys to tensors (on any
    device) or arrays; ``extra_files`` maps names to files to move in.
    Returns the committed directory."""
    t0 = time.perf_counter()
    tensors = _to_host(tensors)
    os.makedirs(directory, exist_ok=True)
    seq = _next_seq()
    tmp = os.path.join(
        directory, f".tmp-{_step_dirname(step)}-{os.getpid()}-{seq}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    manifest = {"format": FORMAT, "step": int(step),
                "time_unix": time.time(), "reason": reason,
                "payload": PAYLOAD, "tensors": {}, "extras": extras,
                "files": {},
                "world": {"backend": "cuda" if torch.cuda.is_available()
                          else "cpu",
                          "process_count": 1, "process_index": 0,
                          "device_count": max(1, torch.cuda.device_count())}}
    with open(os.path.join(tmp, PAYLOAD), "wb") as f:
        offset = 0
        for key in sorted(tensors):
            shape, dtype, buf = _host_bytes(tensors[key])
            manifest["tensors"][key] = {
                "shape": shape, "dtype": dtype, "offset": offset,
                "nbytes": len(buf), "crc32": zlib.crc32(buf) & 0xFFFFFFFF}
            f.write(buf)
            offset += len(buf)
        f.flush()
        os.fsync(f.fileno())
    nbytes_total = offset
    manifest["payload_bytes"] = nbytes_total
    for rel, src in (extra_files or {}).items():
        dst = os.path.join(tmp, rel)
        shutil.move(src, dst)
        crc, n = 0, 0
        with open(dst, "rb") as f:
            while True:
                chunk = f.read(1 << 24)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
                n += len(chunk)
        manifest["files"][rel] = {"nbytes": n, "crc32": crc & 0xFFFFFFFF}
        nbytes_total += n
    _atomic_write(os.path.join(tmp, MANIFEST),
                  json.dumps(manifest, indent=1) + "\n")
    final = os.path.join(directory, _step_dirname(step))
    old = None
    if os.path.exists(final):
        # a re-checkpoint of the same step moves the old commit aside
        # first (one rename), so the step is never without a checkpoint
        old = os.path.join(directory,
                           f".old-{_step_dirname(step)}-{os.getpid()}-{seq}")
        try:
            os.replace(final, old)
        except OSError:
            old = None
    os.replace(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    # LATEST only moves forward: a slow background write landing after
    # the final save of a later step must not point resume backwards
    cur = -1
    try:
        with open(os.path.join(directory, LATEST)) as f:
            cur = int(f.read().strip()[5:])
    except (OSError, ValueError):
        pass
    if int(step) >= cur:
        _atomic_write(os.path.join(directory, LATEST), _step_dirname(step))
    _logger.info("checkpoint: committed %s (%d bytes, %.3fs, %s)",
                 final, nbytes_total, time.perf_counter() - t0, reason)
    return final


def read_checkpoint(path, verify_checksums=True):
    """A committed checkpoint -> ``(manifest, tensors)``, the tensors on
    the host (torch tensors; a type torch lacks stays a numpy array).
    ``path`` is the checkpoint root (its latest step is read) or one
    ``step_*`` dir."""
    if not os.path.exists(os.path.join(path, MANIFEST)):
        latest = latest_checkpoint(path)
        if latest is None:
            raise MXNetError(f"no committed checkpoint under {path!r}")
        path = latest
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise MXNetError(
            f"{path}: unknown checkpoint format {manifest.get('format')!r}")
    with open(os.path.join(path, manifest["payload"]), "rb") as f:
        blob = bytearray(f.read())
    view = memoryview(blob)
    tensors = {}
    for key, meta in manifest["tensors"].items():
        start, n = meta["offset"], meta["nbytes"]
        if verify_checksums and \
                (zlib.crc32(view[start:start + n]) & 0xFFFFFFFF) \
                != meta["crc32"]:
            raise MXNetError(
                f"{path}: checksum mismatch for tensor {key!r}: the "
                "checkpoint is corrupt")
        dt = _torch_dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        if dt is None:
            tensors[key] = _np.frombuffer(
                blob, dtype=meta["dtype"], count=n // _itemsize(
                    meta["dtype"]), offset=start).reshape(shape)
        elif n == 0:
            tensors[key] = torch.empty(shape, dtype=dt)
        else:
            tensors[key] = torch.frombuffer(
                blob, dtype=dt, count=n // _itemsize(meta["dtype"]),
                offset=start).reshape(shape)
    manifest["_path"] = path
    return manifest, tensors


def verify(path):
    """Integrity and completeness lint of a checkpoint: a list of
    problems (empty: verified). Never raises on corrupt input."""
    problems = []
    if not os.path.exists(os.path.join(path, MANIFEST)):
        latest = latest_checkpoint(path)
        if latest is None:
            return [f"{path}: no committed checkpoint "
                    f"(no step_*/{MANIFEST})"]
        path = latest
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable manifest: {e}"]
    if manifest.get("format") != FORMAT:
        problems.append(f"unknown format {manifest.get('format')!r}")
    payload = os.path.join(path, manifest.get("payload", PAYLOAD))
    try:
        with open(payload, "rb") as f:
            blob = f.read()
    except OSError as e:
        return problems + [f"payload unreadable: {e}"]
    expect = manifest.get("payload_bytes")
    if expect is not None and expect != len(blob):
        problems.append(
            f"payload is {len(blob)} bytes, manifest says {expect}")
    view = memoryview(blob)
    for key, meta in manifest.get("tensors", {}).items():
        end = meta["offset"] + meta["nbytes"]
        if end > len(blob):
            problems.append(f"tensor {key!r} extends past payload end")
            continue
        if (zlib.crc32(view[meta["offset"]:end]) & 0xFFFFFFFF) \
                != meta["crc32"]:
            problems.append(f"tensor {key!r} checksum mismatch")
        size = 1
        for d in meta["shape"]:
            size *= d
        try:
            if size * _itemsize(meta["dtype"]) != meta["nbytes"]:
                problems.append(
                    f"tensor {key!r} shape/dtype disagree with nbytes")
        except TypeError:
            problems.append(f"tensor {key!r} has unknown dtype "
                            f"{meta['dtype']!r}")
    for rel, meta in manifest.get("files", {}).items():
        try:
            with open(os.path.join(path, rel), "rb") as f:
                fblob = f.read()
        except OSError as e:
            problems.append(f"file {rel!r} unreadable: {e}")
            continue
        if len(fblob) != meta["nbytes"]:
            problems.append(f"file {rel!r} is {len(fblob)} bytes, "
                            f"manifest says {meta['nbytes']}")
        elif (zlib.crc32(fblob) & 0xFFFFFFFF) != meta["crc32"]:
            problems.append(f"file {rel!r} checksum mismatch")
    # completeness: every optimizer-state leaf the manifest declares
    extras = manifest.get("extras", {})
    leaves = extras.get("fused_leaves", {})
    have = manifest.get("tensors", {})
    for name, kind in extras.get("opt_kind", {}).items():
        if kind == "fused":
            n = leaves.get(name)
            want = [f"fused::{name}::{i}" for i in range(n)] \
                if n is not None else [f"fused::{name}::0"]
        elif kind == "eager":
            want = []

            def _refs(desc, out):
                if isinstance(desc, list):
                    for d in desc:
                        _refs(d, out)
                elif isinstance(desc, dict) and "__t" in desc:
                    out.append(desc["__t"])

            _refs(extras.get("eager_structs", {}).get(name), want)
        else:
            continue
        for key in want:
            if key not in have:
                problems.append(
                    f"opt state for {name!r} declared {kind} but "
                    f"tensor {key!r} is missing")
    return [f"{path}: {p}" for p in problems]


DESCRIPTOR_FORMAT = "mxtpu-snapshot-v1"


def verify_descriptor(desc):
    """Integrity and completeness lint of an in-memory snapshot
    descriptor (the record a runtime resize hands over; the resize itself
    is ROADMAP A11's). Same contract as :func:`verify`."""
    if not isinstance(desc, dict):
        return [f"descriptor is {type(desc).__name__}, not a dict"]
    if desc.get("format") != DESCRIPTOR_FORMAT:
        return [f"unknown snapshot format {desc.get('format')!r}"]
    problems = []
    tensors = desc.get("tensors", {})
    if not tensors:
        problems.append("descriptor lists no tensors")
    keys = set()
    for k, meta in tensors.items():
        keys.add(k.rpartition("|")[0] or k)
        size = 1
        for d in meta.get("shape", []):
            size *= int(d)
        try:
            itemsize = _itemsize(meta.get("dtype"))
        except (TypeError, ValueError):
            problems.append(
                f"tensor {k!r} has unknown dtype {meta.get('dtype')!r}")
            continue
        if size * itemsize != meta.get("nbytes"):
            problems.append(
                f"tensor {k!r} shape/dtype disagree with nbytes")
        if not isinstance(meta.get("crc32"), int):
            problems.append(f"tensor {k!r} missing crc32")
    extras = desc.get("extras", {})
    for name in extras.get("param_names", []):
        if f"param::{name}" not in keys:
            problems.append(f"param::{name} declared but has no chunk")
    for name, n in extras.get("opt_leaves", {}).items():
        for i in range(int(n)):
            if f"opt::{name}::{i}" not in keys:
                problems.append(
                    f"opt state leaf opt::{name}::{i} declared but "
                    "has no chunk")
    return problems


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Interval-driven checkpointing of a Gluon training loop.

    >>> mgr = CheckpointManager("/ckpt", every_n_steps=100, net=net,
    ...                         trainer=trainer).attach()
    ... train: Trainer.step / Superstep.step tick it ...
    >>> mgr.close()                # flush and join the writer

    or ``MXTPU_CHECKPOINT=<dir>[:every_n]`` with
    ``resilience.maybe_checkpointing(net, trainer)``.

    At an interval boundary the step hook snapshots on the training
    thread (device copies, :func:`snapshot_trainer`) and hands the copies
    to a writer thread; a snapshot still queued when the next one comes
    is replaced (latest wins). The copies of a written or replaced
    snapshot are kept (one set) and written over by the next snapshot, so
    a checkpoint allocates no device memory once one has been taken.
    ``snapshot_seconds`` and
    ``write_seconds`` keep the host time of each snapshot (charged to
    the loop) and each write (the writer thread's). A SIGTERM writes one
    final checkpoint synchronously.
    """

    def __init__(self, directory, every_n_steps=100, keep=_KEEP_DEFAULT,
                 net=None, trainer=None, ring=None, install_sigterm=True):
        require_one_process("CheckpointManager")
        self.directory = str(directory)
        self.every_n_steps = max(1, int(every_n_steps))
        self.keep = max(1, int(keep))
        self._net = net
        self._trainer = trainer
        self._ring = ring
        self._step = 0
        self._cursor = None
        self._last_saved = None
        self.commits = 0
        self.last_error = None
        self.snapshot_seconds = []
        self.write_seconds = []
        self._queue = queue.Queue(maxsize=1)
        # pending-snapshot accounting under one condition variable;
        # re-entrant, as the SIGTERM final save may interrupt a frame
        # that holds it
        self._cv = threading.Condition(threading.RLock())
        self._pending = 0
        self._spare = None  # a snapshot's copies, free to write over
        self._closed = False
        self._sig_state = {"installed": False, "prev": None, "done": False}
        self._writer = threading.Thread(target=self._write_loop,
                                        name="mxtpu-checkpoint-writer",
                                        daemon=True)
        self._writer.start()
        if install_sigterm:
            self._install_sigterm()
        atexit.register(self.close)

    # -- step hook -------------------------------------------------------
    def attach(self, trainer=None):
        """Register on the trainer, so ``Trainer.step`` and ``Superstep``
        tick this manager. Returns self."""
        tr = trainer or self._trainer
        if tr is None:
            raise MXNetError("CheckpointManager.attach: no trainer")
        self._trainer = tr
        tr._ckpt_manager = self
        return self

    def on_step(self, n=1, cursor=None):
        """Advance the step counter by ``n`` (a superstep passes its K);
        snapshot and enqueue when an interval boundary is crossed."""
        before = self._step
        self._step += int(n)
        if cursor is not None:
            self._cursor = cursor
        if self._step // self.every_n_steps > before // self.every_n_steps:
            self.save_async(reason="interval")
        return self._step

    @property
    def step(self):
        return self._step

    def restore_step(self, step):
        """Align the interval counter with a resumed run
        (``ResumeReport.step``). Returns self."""
        self._step = int(step)
        return self

    @property
    def last_saved(self):
        """Directory of the most recently committed checkpoint."""
        return self._last_saved

    def _cursor_value(self, cursor=None):
        if cursor is not None:
            return cursor if isinstance(cursor, dict) else int(cursor)
        if self._ring is not None:
            c = getattr(self._ring, "cursor", None)
            if c is not None:
                return c if isinstance(c, dict) else int(c)
        return self._cursor

    # -- save paths ------------------------------------------------------
    def _snapshot(self, cursor=None):
        if self._trainer is None:
            raise MXNetError("CheckpointManager: no trainer to snapshot")
        t0 = time.perf_counter()
        with self._cv:
            spare, self._spare = self._spare, None
        snap = snapshot_trainer(self._trainer, net=self._net,
                                step=self._step,
                                cursor=self._cursor_value(cursor),
                                reuse=spare)
        self.snapshot_seconds.append(time.perf_counter() - t0)
        return snap

    def _release(self, tensors):
        """A snapshot's copies are read no more: keep them for the next."""
        with self._cv:
            self._spare = tensors

    def save_async(self, reason="manual", cursor=None):
        """Snapshot now (device copies), write on the writer thread."""
        if self._closed:
            return
        try:
            snap = (self._snapshot(cursor), self._step, reason)
        except Exception as e:
            self.last_error = e
            _logger.error("checkpoint snapshot failed: %s: %s",
                          type(e).__name__, e)
            return
        with self._cv:
            self._pending += 1
        while True:  # latest wins: drop a stale queued snapshot
            try:
                self._queue.put_nowait(snap)
                return
            except queue.Full:
                try:
                    dropped = self._queue.get_nowait()
                except queue.Empty:
                    continue
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()
                if dropped is not None:
                    self._release(dropped[0][0])
                if dropped is None:
                    # close()'s stop sentinel: hand it back, drop ours
                    self._queue.put(dropped)
                    return

    def save_sync(self, reason="manual", cursor=None):
        """Snapshot and write now on the calling thread (after the queued
        writes). Returns the committed path."""
        self.flush()
        (tensors, extras), step = self._snapshot(cursor), self._step
        t0 = time.perf_counter()
        path = write_checkpoint(self.directory, tensors, extras, step,
                                reason=reason)
        self.write_seconds.append(time.perf_counter() - t0)
        self._release(tensors)
        self._last_saved = path
        self.commits += 1
        self._trim()
        return path

    def flush(self, timeout=60.0):
        """Wait until the writer finished everything queued. True when
        drained, False on timeout."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0, timeout)

    # -- writer thread ---------------------------------------------------
    def _write_loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                with self._cv:
                    self._cv.notify_all()
                return
            (tensors, extras), step, reason = item
            try:
                t0 = time.perf_counter()
                self._last_saved = write_checkpoint(
                    self.directory, tensors, extras, step, reason=reason)
                self.write_seconds.append(time.perf_counter() - t0)
                self.commits += 1
                self._trim()
                self.last_error = None
            except Exception as e:  # a full disk must not kill training
                self.last_error = e
                _logger.error("checkpoint write failed: %s: %s",
                              type(e).__name__, e)
            finally:
                self._release(tensors)
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def _trim(self):
        steps = _committed_steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, _step_dirname(s)),
                          ignore_errors=True)
        # leftovers of crashed commits of other processes, an hour old
        try:
            now = time.time()
            for n in os.listdir(self.directory):
                if not (n.startswith(".tmp-") or n.startswith(".old-")) \
                        or f"-{os.getpid()}-" in n:
                    continue
                p = os.path.join(self.directory, n)
                try:
                    if now - os.path.getmtime(p) > 3600:
                        shutil.rmtree(p, ignore_errors=True)
                except OSError:
                    pass
        except OSError:
            pass

    # -- SIGTERM final checkpoint ---------------------------------------
    def _final_save(self, reason="sigterm"):
        """One synchronous final checkpoint on the way down; once per
        process, and never raises (a failed save must not mask the
        signal)."""
        if self._sig_state["done"] or self._closed:
            return
        self._sig_state["done"] = True
        try:
            self.save_sync(reason=reason)
        except Exception as e:  # pragma: no cover - last-breath path
            try:
                _logger.error("final checkpoint failed: %s: %s",
                              type(e).__name__, e)
            except Exception:
                pass

    def _install_sigterm(self):
        """Chain a SIGTERM handler (main thread only) in front of the one
        installed before."""
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            if signal.getsignal(signal.SIGTERM) is signal.SIG_IGN:
                return
            prev = signal.signal(signal.SIGTERM, self._sigterm_handler)
            self._sig_state["installed"] = True
            if prev not in (signal.SIG_DFL, self._sigterm_handler):
                self._sig_state["prev"] = prev
        except (ValueError, OSError) as e:  # pragma: no cover
            _logger.warning("checkpoint: cannot hook SIGTERM: %s", e)

    def _sigterm_handler(self, signum, frame):
        if _CRITICAL[0] > 0:
            # mid-step: defer the final save and the re-raise to the
            # step's end, so the checkpoint holds a completed step
            _DEFERRED.append((self._sigterm_handler, (signum, None)))
            return
        self._final_save()
        prev = self._sig_state["prev"]
        if callable(prev):
            prev(signum, frame)
            return
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    def _uninstall_sigterm(self):
        if self._sig_state["installed"]:
            try:
                if signal.getsignal(signal.SIGTERM) is self._sigterm_handler:
                    signal.signal(signal.SIGTERM,
                                  self._sig_state["prev"] or signal.SIG_DFL)
            except (ValueError, OSError):  # pragma: no cover
                pass
            self._sig_state["installed"] = False

    # -- lifecycle -------------------------------------------------------
    def close(self):
        """Flush queued writes, stop the writer, restore the signal
        handler."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._writer.join(timeout=60.0)
        atexit.unregister(self.close)
        self._uninstall_sigterm()
        if self._trainer is not None and \
                getattr(self._trainer, "_ckpt_manager", None) is self:
            self._trainer._ckpt_manager = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def parse_env(value=None):
    """``MXTPU_CHECKPOINT=<dir>[:every_n]`` -> ``(dir, every_n)`` or
    None."""
    v = value if value is not None else getenv("MXTPU_CHECKPOINT", None)
    if not v:
        return None
    v = str(v)
    every = 100
    if ":" in v:
        head, _, tail = v.rpartition(":")
        if tail.isdigit():
            v, every = head, int(tail)
    return v, max(1, every)


def maybe_checkpointing(net=None, trainer=None, ring=None):
    """A :class:`CheckpointManager` built from ``MXTPU_CHECKPOINT`` and
    attached to ``trainer`` (None when the variable is unset)::

        mgr = mx.resilience.maybe_checkpointing(net, trainer)
    """
    cfg = parse_env()
    if cfg is None:
        return None
    d, every = cfg
    keep = int(getenv("MXTPU_CHECKPOINT_KEEP", _KEEP_DEFAULT, dtype=int))
    mgr = CheckpointManager(d, every_n_steps=every, keep=keep, net=net,
                            trainer=trainer, ring=ring)
    if trainer is not None:
        mgr.attach(trainer)
    return mgr
