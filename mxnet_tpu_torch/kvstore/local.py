"""The store of one process: sums the copies a value has on several
contexts.

PyTorch counterpart of ``mxnet_tpu/kvstore/local.py``
(``local``/``device``). ``push`` sums a key's per-context values on the
first value's device (one add after another, in context order, as the
reference's tree sum does) and hands the sum to the updater, to the
optimizer (update on the store) or to the store itself; ``pull`` writes
the stored value into every output. ``pushpull`` sums and writes the sum
into its outputs without touching the stored value: ``gluon.Trainer``'s
allreduce. A multi-key ``pushpull`` packs the keys into flat
dtype-homogeneous buckets (``parallel.overlap.build_bucket_plan``, target
``MXTPU_BUCKET_BYTES``), quantizes each bucket under 2-bit compression
with its residual carried from step to step, reduces one collective per
bucket (the identity in one process; ``dist_tpu_sync`` overrides
``_reduce_raw``) and unpacks; where there is nothing to reduce it takes a
grouped path, and where it cannot group, the per-key path.
"""

from __future__ import annotations

import pickle

import torch

from .. import fusedstep as _fusedstep
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .base import KVStoreBase, register_kvstore


def _as_list(value):
    return value if isinstance(value, (list, tuple)) else [value]


def _place(raw, o):
    """``raw`` moved and cast for writing into ``o``."""
    return raw.to(device=o.data.device, dtype=o.data.dtype)


def _write(outs, raw):
    for o in _as_list(outs):
        if o.data is not raw:
            o._set_data(_place(raw, o))


def _sum(raws):
    """The sum of one key's per-context tensors, on the first one's
    device, added in context order."""
    acc = raws[0]
    for a in raws[1:]:
        acc = acc + a.to(acc.device)
    return acc


@register_kvstore("local", "device")
class KVStoreLocal(KVStoreBase):
    """In-process store; ``device`` and ``local`` are one implementation:
    the sum runs on the first context's device either way."""

    def __init__(self):
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._opt_states = {}
        self._compression = None
        self._residuals = {}
        self._bucket_plans = {}  # signature -> plan
        self._bucket_residuals = {}  # signature -> per-bucket 2-bit carry

    @staticmethod
    def _key(key):
        return str(key)

    def init(self, key, value):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        self._store[self._key(key)] = value.copy()

    def _merge(self, values):
        if isinstance(values, NDArray):
            return values
        if len(values) == 1:
            return values[0]
        return NDArray(_sum([v.data.detach() for v in values]),
                       values[0].context)

    def push(self, key, value, priority=0):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.push(k, v, priority)
            return
        k = self._key(key)
        if k not in self._store:
            raise MXNetError(f"key {key} has not been initialized")
        merged = self._reduce(k, self._compress(k, self._merge(value)))
        idx = int(key) if k.isdigit() else k
        if self._updater is not None:
            self._updater(idx, merged, self._store[k])
        elif self._optimizer is not None:
            if idx not in self._opt_states:
                self._opt_states[idx] = \
                    self._optimizer.create_state_multi_precision(
                        idx, self._store[k])
            self._optimizer.update_multi_precision(
                idx, self._store[k], merged, self._opt_states[idx])
        else:
            self._store[k]._set_data(_place(merged.data, self._store[k]))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if isinstance(key, (list, tuple)):
            for k, o in zip(key, out):
                self.pull(k, out=o, priority=priority)
            return
        _write(out, self._store[self._key(key)].data)

    def pushpull(self, key, value, out=None, priority=0):
        """Sum ``value`` over its contexts and write the sum into ``out``
        without touching the stored value (the Trainer's allreduce); with
        an updater or optimizer set, push then pull."""
        if isinstance(key, (list, tuple)):
            eligible = (out is not None and self._updater is None
                        and self._optimizer is None)
            if eligible and _fusedstep.ENABLED \
                    and self._bucketed_pushpull(key, value, out):
                return
            if eligible and self._compression is None \
                    and self._grouped_pushpull(value, out):
                return
            for i, k in enumerate(key):
                self.pushpull(k, value[i],
                              out=None if out is None else out[i],
                              priority=priority)
            return
        if self._updater is not None or self._optimizer is not None:
            self.push(key, value, priority)
            if out is not None:
                self.pull(key, out=out, priority=priority)
            return
        if out is None:
            self.push(key, value, priority)
            return
        k = self._key(key)
        merged = self._reduce(k, self._compress(k, self._merge(value)))
        _write(out, merged.data)

    @staticmethod
    def _gather_groups(values):
        """Each key's per-context tensors, moved to the first value's
        device."""
        groups = [[x.data.detach() for x in _as_list(v)] for v in values]
        dev = next((g[0].device for g in groups if g), None)
        return [[t.to(dev) for t in g] for g in groups]

    def _grouped_pushpull(self, values, outs):
        """Every key's sum in one pass (nothing crosses a process: the
        dist store reduces per key instead). Returns False when the per-key
        path must run."""
        if type(self)._reduce is not KVStoreLocal._reduce:
            return False
        groups = self._gather_groups(values)
        for g, out in zip(groups, outs):
            _write(out, _sum(g))
        return True

    # -- bucketed multi-key pushpull ----------------------------------
    def _bucketed_pushpull(self, keys, values, outs):
        groups = self._gather_groups(values)
        thr = self._compression["threshold"] if self._compression \
            else None
        if self._reduce_raw_is_identity() \
                and all(len(g) == 1 for g in groups) and thr is None:
            # one context and no process to reduce with: the identity,
            # and a bucket round trip would only copy every gradient
            return False
        # the reduced wire type matters only when a reduction runs
        comm = "" if self._reduce_raw_is_identity() \
            else _fusedstep.amp_allreduce_dtype()
        key_sig = tuple((tuple(g[0].shape), str(g[0].dtype).split(".")[1],
                         len(g)) for g in groups)
        sig = (comm, thr) + key_sig
        plan = self._bucket_plans.get(sig)
        if plan is None:
            plan = self._bucket_plans[sig] = self._build_bucket_plan(
                key_sig, comm)
        res = self._bucket_residuals.get(sig) if thr is not None else None
        if thr is not None and res is None:
            dev = groups[0][0].device
            res = [torch.zeros(n, dtype=getattr(torch, dt), device=dev)
                   for n, dt in plan["res_shapes"]]
        from ..parallel import overlap as _overlap

        op = plan["plan"]
        merged = [None] * len(groups)
        new_res = []
        for bi, idxs in enumerate(op.buckets):
            b = _overlap.pack_bucket(
                op, bi, {i: _sum(groups[i]) for i in idxs}, False)
            if b.data_ptr() == groups[idxs[0]][0].data_ptr():
                b = b.clone()  # a one-key bucket: reduce a copy
            if thr is not None:
                b, r = _overlap.compress_bucket(b, thr, res[bi])
                new_res.append(r)
            if plan["cast_down"][bi]:
                b = b.to(getattr(torch, comm))
            b = self._reduce_raw(b)
            if plan["cast_down"][bi]:
                b = b.to(torch.float32)
            _overlap.unpack_bucket(op, bi, b, merged, False)
        if thr is not None:
            self._bucket_residuals[sig] = new_res
        for m, out in zip(merged, outs):
            _write(out, m)
        return True

    def _build_bucket_plan(self, sig, comm=""):
        """The bucket plan of a key signature: the reference's greedy
        packing (``parallel.overlap.build_bucket_plan``, keys in reverse
        order: the last parameter's gradient is produced first), which
        buckets go on the wire as ``comm`` (float32 ones only), and the
        residual lengths of the 2-bit carry."""
        from ..parallel import overlap as _overlap

        shapes = [s for s, _, _ in sig]
        dtypes = [dt for _, dt, _ in sig]
        op = _overlap.build_bucket_plan(
            shapes, dtypes, bucket_bytes=max(_fusedstep.bucket_bytes(), 1))
        bucket_dtypes = [dtypes[b[0]] for b in op.buckets]
        return {"plan": op,
                "cast_down": [bool(comm) and dt == "float32"
                              for dt in bucket_dtypes],
                "res_shapes": [(sum(op.sizes[k] for k in b), bucket_dtypes[i])
                               for i, b in enumerate(op.buckets)]}

    def _reduce_raw(self, raw):
        """The reduction across processes of one flat bucket: the identity
        in one process."""
        return raw

    def _reduce_raw_is_identity(self) -> bool:
        return type(self)._reduce_raw is KVStoreLocal._reduce_raw

    def _reduce(self, key, merged):
        """The reduction across processes of one key (the identity here),
        after ``_compress``: compression happens before the wire."""
        return merged

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull needs the sparse NDArray, which "
                         "is not ported yet (ROADMAP A13)")

    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Update on the store: a push runs ``optimizer`` on the stored
        value with the summed gradient."""
        self._optimizer = optimizer

    def set_gradient_compression(self, compression_params):
        """2-bit gradient compression (reference:
        ``gradient_compression.cc``): each pushed value is quantized to
        ``{-t, 0, +t}`` before the reduction, the error carried per key
        (per bucket on the bucketed path)."""
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise MXNetError(f"unsupported compression type {ctype}")
        self._compression = {
            "threshold": float(compression_params.get("threshold", 0.5))}
        self._residuals = {}
        self._bucket_residuals = {}

    def _compress(self, key, merged):
        if self._compression is None:
            return merged
        from ..parallel.overlap import compress_bucket

        raw = merged.data.detach()
        res = self._residuals.get(key)
        if res is None:
            res = torch.zeros_like(raw)
        q, self._residuals[key] = compress_bucket(
            raw, self._compression["threshold"], res)
        return NDArray(q, merged.context)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Pickle the store's optimizer states (update on the store); an
        NDArray pickles as its host values and its context."""
        with open(fname, "wb") as f:
            pickle.dump(self._opt_states, f)

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            self._opt_states = pickle.load(f)
