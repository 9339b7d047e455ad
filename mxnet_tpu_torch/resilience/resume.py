"""Resume a training loop from a checkpoint, onto the current topology.

PyTorch counterpart of ``mxnet_tpu/resilience/resume.py``:

- **Trainer checkpoints** (the Gluon loop): a :mod:`.checkpoint`
  directory's parameters, optimizer state (fused or eager, fp32 masters
  included), loss scaler, update counts and random state land back in a
  net and its Trainer, bit for bit on one device, and on every rank of a
  world (the trainer's state is replicated; rank 0 wrote it). A tensor
  that already exists with the checkpoint's shape and type is written in
  place, so a hybridized block's captured graphs, a Trainer's plan and a
  ``Superstep``'s captured graph over it stay valid. The learning-rate
  schedule continues from the restored update counts.
- **SPMD checkpoints** (``save_spmd_checkpoint``): every rank's shard
  file of an ``SPMDTrainStep`` (``parallel.spmd_save_states``), committed
  once by rank 0; a restore reads the chunks each rank's blocks need and
  re-shards them onto the step's current mesh, whatever its dp, tp or
  world size was at save time (``ResumeReport.elastic`` compares the
  mesh sizes).
"""

from __future__ import annotations

import logging
import os

import torch

from ..base import MXNetError
from . import checkpoint as _ckpt

_logger = logging.getLogger("mxnet_tpu_torch.resume")


def _current_world():
    from .checkpoint import _world

    return {"backend": "cuda" if torch.cuda.is_available() else "cpu",
            "process_count": _world()[1],
            "device_count": max(1, torch.cuda.device_count())}


class ResumeReport:
    """What a restore did: the ``step`` and ``cursor`` to continue from,
    and the saved and current world shapes (``elastic``: the device count
    changed, which a replicated trainer checkpoint allows)."""

    def __init__(self, path, step, cursor, saved_world, kind):
        self.path = path
        self.step = step
        self.cursor = cursor
        self.saved_world = saved_world or {}
        self.kind = kind
        self.current_world = _current_world()
        self.elastic = bool(
            self.saved_world
            and self.saved_world.get("device_count") is not None
            and self.saved_world.get("device_count")
            != self.current_world.get("device_count"))

    def __repr__(self):
        return (f"ResumeReport(step={self.step}, kind={self.kind!r}, "
                f"elastic={self.elastic}, "
                f"saved_devices={self.saved_world.get('device_count')}, "
                f"current_devices={self.current_world.get('device_count')})")


def _param_keys(net, trainer):
    """checkpoint key -> Parameter: structural names from the net (the
    save-time scheme), then global names."""
    by_key = {}
    if net is not None:
        for sname, p in net._collect_params_with_prefix().items():
            by_key.setdefault(sname, p)
        for _, p in net.collect_params().items():
            by_key.setdefault(p.name, p)
    if trainer is not None:
        for p in trainer._params:
            by_key.setdefault(p.name, p)
    return by_key


def _restore_params(tensors, net, trainer):
    by_key = _param_keys(net, trainer)
    missing, matched = [], 0
    for key, host in tensors.items():
        if not key.startswith("param::"):
            continue
        name = key[len("param::"):]
        p = by_key.get(name)
        if p is None:
            missing.append(name)
            continue
        matched += 1
        p._load_init(torch.as_tensor(host))
    if missing and matched == 0:
        raise MXNetError(
            f"resume: none of the {len(missing)} checkpoint params "
            f"match the current model (first: {missing[:3]}). "
            "Checkpoints saved with net= use structural names: pass the "
            "same net= to load_checkpoint (or the model differs).")
    if missing:
        _logger.warning("resume: %d checkpoint params have no match in "
                        "the current model (first: %s)", len(missing),
                        missing[:3])


def _into(old, host, device):
    """``host`` on ``device``: written into ``old`` when it is a tensor
    of the same shape and type there (its identity kept), else new."""
    t = torch.as_tensor(host)
    if isinstance(old, torch.Tensor) and old.shape == t.shape \
            and old.dtype == t.dtype and old.device == device:
        with torch.no_grad():
            old.copy_(t)
        return old
    return t.to(device, copy=True)


def _restore_trainer(manifest, tensors, trainer, net=None):
    from ..ndarray.ndarray import NDArray

    extras = manifest.get("extras", {})
    o = trainer._optimizer
    o._index_update_count = {int(k): int(v) for k, v in
                             extras.get("update_counts", {}).items()}
    o.num_update = int(extras.get("num_update", o.num_update))
    opt_kind = extras.get("opt_kind", {})
    by_key = _param_keys(net, trainer)
    key_of = {id(p): k for k, p in reversed(list(by_key.items()))}
    fused = {}
    kinds_matched = 0
    for p in trainer._params:
        key = key_of.get(id(p), p.name)
        kind = opt_kind.get(key) or opt_kind.get(p.name)
        if kind is not None:
            kinds_matched += 1
        device = trainer._device_of(p)
        if kind == "fused":
            kk = key if f"fused::{key}::0" in tensors \
                or extras.get("fused_leaves", {}).get(key) is not None \
                else p.name
            old = trainer._fused_states.get(p.name) or ()
            leaves = []
            i = 0
            while f"fused::{kk}::{i}" in tensors:
                leaves.append(_into(old[i] if i < len(old) else None,
                                    tensors[f"fused::{kk}::{i}"], device))
                i += 1
            # an unchanged tuple keeps its identity, so plans over it
            # (and a captured superstep) stay valid
            same = len(leaves) == len(old) and all(
                a is b for a, b in zip(leaves, old))
            fused[p.name] = old if same else tuple(leaves)
            if hasattr(p, "_opt_state"):
                del p._opt_state
        elif kind == "eager":
            desc = extras.get("eager_structs", {}).get(key) \
                or extras.get("eager_structs", {}).get(p.name)
            p._opt_state = _ckpt._unflatten_state(
                desc, tensors,
                wrap=lambda raw, d=device: NDArray(
                    torch.as_tensor(raw).to(d, copy=True)))
        elif hasattr(p, "_opt_state"):
            del p._opt_state
    if opt_kind and trainer._params and kinds_matched == 0:
        raise MXNetError(
            "resume: the checkpoint carries optimizer state but none "
            "of its keys match this trainer's params; restoring would "
            "reset momentum and Adam's t. Pass the net= the checkpoint "
            "was saved with (structural names), or check the model.")
    if kinds_matched < len(opt_kind):
        _logger.warning(
            "resume: %d of %d optimizer-state entries in the checkpoint "
            "matched no param; those params restart with fresh state",
            len(opt_kind) - kinds_matched, len(opt_kind))
    trainer._fused_states = fused
    trainer._invalidate_fused()
    trainer._restores += 1
    scaler_meta = extras.get("scaler")
    if scaler_meta is not None:
        scaler = getattr(trainer, "_amp_loss_scaler", None)
        if scaler is None:
            from ..amp import LossScaler

            scaler = LossScaler(scale_factor=scaler_meta["factor"],
                                scale_window=scaler_meta["window"])
            trainer._amp_loss_scaler = scaler
        scaler._factor = float(scaler_meta["factor"])
        scaler._window = int(scaler_meta["window"])
        dev = trainer._device_of(trainer._params[0]) \
            if trainer._params else scaler._scale_arr.device
        scaler._scale_arr = _into(scaler._scale_arr,
                                  tensors["scaler::scale"], dev)
        scaler._unskipped_arr = _into(scaler._unskipped_arr,
                                      tensors["scaler::unskipped"], dev)
        scaler._overflow_total_arr = _into(
            scaler._overflow_total_arr, tensors["scaler::overflow_total"],
            dev)


def _restore_rng(tensors):
    """The port's generator states (the JAX package's ``rng::key`` is
    not read)."""
    if _ckpt.RNG_CPU in tensors:
        torch.set_rng_state(torch.as_tensor(tensors[_ckpt.RNG_CPU]).clone())
    if _ckpt.RNG_CUDA in tensors and torch.cuda.is_available():
        torch.cuda.set_rng_state(
            torch.as_tensor(tensors[_ckpt.RNG_CUDA]).clone())


def load_checkpoint(path, net=None, trainer=None, spmd_step=None,
                    verify_checksums=True, restore_rng=True):
    """Restore ``path`` (a checkpoint root or one ``step_*`` dir) into
    ``net`` and ``trainer`` (a Gluon loop, on every rank of a world), or
    into ``spmd_step`` (a sharded ``SPMDTrainStep`` checkpoint, re-sharded
    onto the step's current mesh). Returns a :class:`ResumeReport`."""
    manifest, tensors = _ckpt.read_checkpoint(
        path, verify_checksums=verify_checksums)
    extras = manifest.get("extras", {})
    kind = extras.get("kind", "trainer")
    if spmd_step is not None:
        if kind != "spmd":
            raise MXNetError(
                f"{manifest['_path']}: checkpoint kind is {kind!r}, not a "
                "sharded SPMD checkpoint; pass net/trainer instead")
        from ..parallel.spmd import spmd_load_states

        prefix = os.path.join(manifest["_path"],
                              extras.get("spmd_prefix", "spmd"))
        spmd_load_states(spmd_step, prefix)
        # elastic detection for the SPMD kind compares MESH sizes
        saved_mesh = extras.get("mesh_devices")
        cur_mesh = (spmd_step.mesh.devices.size
                    if spmd_step.mesh is not None else 1)
        world = dict(manifest.get("world") or {})
        if saved_mesh is not None:
            world["device_count"] = saved_mesh
        report = ResumeReport(manifest["_path"], extras.get("step"),
                              extras.get("cursor"), world, kind)
        report.current_world["device_count"] = cur_mesh
        report.elastic = saved_mesh is not None and saved_mesh != cur_mesh
        if report.elastic:
            _logger.warning(
                "resume: ELASTIC restore: checkpoint sharded over %s "
                "devices, restored onto %s (%s)", saved_mesh, cur_mesh,
                report.path)
        _logger.info("resume: restored %s", report)
        return report
    if kind != "trainer":
        raise MXNetError(f"{manifest['_path']}: checkpoint kind is "
                         f"{kind!r}; pass spmd_step= to restore it")
    world = manifest.get("world") or {}
    _restore_params(tensors, net, trainer)
    if trainer is not None:
        _restore_trainer(manifest, tensors, trainer, net=net)
    if restore_rng:
        _restore_rng(tensors)
    report = ResumeReport(manifest["_path"], extras.get("step"),
                          extras.get("cursor"), world, kind)
    _logger.info("resume: restored %s", report)
    return report


def save_spmd_checkpoint(directory, spmd_step, step, reason="manual",
                         barrier=None):
    """Write an ``SPMDTrainStep``'s sharded state as one committed
    checkpoint. Every rank calls it with ``directory`` on a filesystem
    they share: each stages its shard file (``spmd.shard<rank>.npz``) in
    one staging directory, then, after a barrier, rank 0 alone writes the
    manifest of exactly this run's shard set (a stale shard of an earlier
    or differently sized run is not swept in) and commits once; a second
    barrier keeps every rank until the commit landed. ``barrier=None``
    takes :func:`checkpoint.default_commit_barrier`. Returns the
    committed path on rank 0 (and in one process), None elsewhere."""
    import shutil

    from ..parallel.spmd import spmd_save_states

    if spmd_step._state is None:
        raise MXNetError("save_spmd_checkpoint: run a step (or "
                         "init_state()) first")
    rank, nproc = _ckpt._world()
    extras = {"kind": "spmd", "spmd_prefix": "spmd", "step": int(step),
              "mesh_devices": (int(spmd_step.mesh.devices.size)
                               if spmd_step.mesh is not None else 1),
              "process_count": nproc,
              "tensor_names": list(spmd_step._names or [])}
    if nproc == 1:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="spmd-ckpt-",
                                         dir=str(directory)
                                         if os.path.isdir(str(directory))
                                         else None) as scratch:
            fname = spmd_save_states(spmd_step,
                                     os.path.join(scratch, "spmd"))
            return _ckpt.write_checkpoint(
                directory, {}, extras, step, reason=reason,
                extra_files={os.path.basename(fname): fname})
    if barrier is None:
        barrier = _ckpt.default_commit_barrier()
    staging = os.path.join(str(directory),
                           f".shards-{_ckpt._step_dirname(step)}")
    os.makedirs(staging, exist_ok=True)
    spmd_save_states(spmd_step, os.path.join(staging, "spmd"))
    barrier()  # every rank's shard is staged past this point
    out = None
    if rank == 0:
        shards = {}
        for r in range(nproc):
            p = os.path.join(staging, f"spmd.shard{r}.npz")
            if not os.path.exists(p):
                raise MXNetError(
                    f"save_spmd_checkpoint: rank {r}'s shard file is "
                    f"missing from {staging} after the barrier")
            shards[os.path.basename(p)] = p
        out = _ckpt.write_checkpoint(directory, {}, extras, step,
                                     reason=reason, extra_files=shards)
        shutil.rmtree(staging, ignore_errors=True)
    barrier()  # nobody proceeds (or exits) before the commit landed
    return out


def skip_batches(source, n):
    """An iterator over ``source`` positioned after batch ``n`` (the
    checkpoint's data ``cursor``), so a resumed epoch does not train on
    consumed data again."""
    it = iter(source)
    for i in range(int(n)):
        try:
            next(it)
        except StopIteration:
            _logger.warning("resume: cursor %d past the end of the "
                            "source (epoch boundary?); %d skipped", n, i)
            break
    return it


def restore_cursor(source, cursor):
    """Position ``source`` at a checkpoint's ``cursor``: a structured
    cursor (a dict) through ``source.restore()``, an integer through
    :func:`skip_batches`. Returns an iterator at the first unconsumed
    batch."""
    if cursor is None:
        return iter(source)
    if isinstance(cursor, dict):
        restore = getattr(source, "restore", None)
        if callable(restore):
            restore(cursor)
            return iter(source)
        raise MXNetError(
            f"restore_cursor: checkpoint carries a structured "
            f"{cursor.get('kind', '?')!r} cursor but source "
            f"{type(source).__name__} has no restore()")
    return skip_batches(source, int(cursor))


def list_checkpoints(directory):
    """Committed ``(step, path)`` pairs under a checkpoint root."""
    return [(s, os.path.join(directory, _ckpt._step_dirname(s)))
            for s in _ckpt._committed_steps(directory)]
