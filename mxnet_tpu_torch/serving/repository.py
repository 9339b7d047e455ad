"""ModelRepository: multiple named+versioned models on one device,
live swap/rollback with a checkpoint's commit protocol applied in memory.

PyTorch counterpart of ``mxnet_tpu/serving/repository.py``.
``resilience.checkpoint.atomic_replace`` commits a checkpoint as
write-to-tmp -> verify -> atomic rename; a model swap is the same
shape with the filesystem swapped for a pointer:

  stage   build the new engine OFF to the side (its CUDA-graph captures,
          warm executions and canary verification) while the live
          version keeps serving;
  flip    one pointer assignment under the repository lock — the
          indivisible "rename". Requests that already captured the old
          engine finish on it; new submits land on the new one;
  drain   the old engine stops accepting work and completes its
          in-flight requests (``pause()``), then parks as a standby
          (weights resident) inside the keep window — ``rollback()``
          is a pointer flip back + ``resume()``, not a recapture;
  release standbys beyond the keep window close fully (graphs and
          weight references dropped).

A corrupt/failed staged load NEVER becomes visible: any exception
during build/warmup/verify discards the stage and raises
:class:`StagedLoadError` while the previous version keeps answering —
the serving analog of "a torn checkpoint never gets the rename".
"""

from __future__ import annotations

import threading

import numpy as _np

from .. import observability as _obs
from .engine import InferenceEngine
from .errors import EngineClosed, ServingError, StagedLoadError


def _default_verify(engine):
    """Canary: one zero-filled row through every bucket, results must
    be finite. Catches NaN/garbage weights before the flip. Engines
    exposing their own ``canary()`` (GenerationEngine: a short greedy
    generation must stay in-vocabulary) delegate to it."""
    if hasattr(engine, "canary"):
        engine.canary()
        return
    for bucket in engine.buckets:
        out = engine.predict(_np.zeros(tuple(bucket), engine._dtype),
                             timeout=30.0)
        for leaf in (out if isinstance(out, tuple) else (out,)):
            if not _np.all(_np.isfinite(leaf)):
                raise ServingError(
                    f"canary produced non-finite outputs on bucket "
                    f"{bucket} — refusing to serve this version")


class ModelRepository:
    """Host many models; swap versions live; roll back instantly.

    >>> repo = ModelRepository()
    >>> repo.load("clf", net_v1, shapes=[(16,)], version="v1")
    >>> repo.predict("clf", x)
    >>> repo.load("clf", net_v2, shapes=[(16,)], version="v2")
    >>> repo.rollback("clf")          # v1 again, no recapture

    ``keep``: standby versions retained per model for rollback
    (default 1 — the previous version).
    """

    def __init__(self, keep=1):
        self._keep = max(0, int(keep))
        self._lock = threading.Lock()
        self._models = {}  # name -> {"live": engine, "standby": [engines]}

    # -- staged load + atomic flip ----------------------------------------
    def load(self, name, net_or_factory, shapes, *, version=None,
             verify=None, **engine_kwargs):
        """Stage -> verify -> flip. Returns the new live engine.

        ``net_or_factory``: a block (a HybridBlock), a decode-capable net (``decode_step_fn`` — served by a
        :class:`~.generation.GenerationEngine` instead), or a zero-arg
        callable building one (the factory runs inside the stage, so a
        crash there also never touches the live version).
        ``verify``: optional callable(engine) raising to veto; the
        default canary checks finite outputs on every bucket (greedy
        in-vocabulary generation for generation engines)."""
        with self._lock:
            prev = (self._models.get(name) or {}).get("live")
        if version is None:
            version = f"v{self._version_seq(name) + 1}"
        engine = None
        try:
            net = net_or_factory() if callable(net_or_factory) \
                and not hasattr(net_or_factory, "aot_predict_fn") \
                and not hasattr(net_or_factory, "decode_step_fn") \
                else net_or_factory
            if hasattr(net, "decode_step_fn"):
                from .generation import GenerationEngine as _cls
            else:
                _cls = InferenceEngine
            engine = _cls(net, shapes, name=name,
                          version=version, **engine_kwargs)
            (verify or _default_verify)(engine)
        except BaseException as e:
            if engine is not None:
                engine.close()
            if _obs.ENABLED:
                _obs.record_serve_swap(
                    name, "aborted", version=version,
                    prev_version=prev.version if prev else None)
            raise StagedLoadError(
                f"staged load of {name}:{version} failed and was "
                f"discarded ({type(e).__name__}: {e}); "
                f"{'version ' + prev.version + ' keeps serving' if prev else 'no version is live'}"
            ) from e
        # the atomic "rename": one pointer flip under the lock
        with self._lock:
            entry = self._models.setdefault(name,
                                            {"live": None, "standby": []})
            prev = entry["live"]
            entry["live"] = engine
            if prev is not None:
                entry["standby"].append(prev)
            trim = entry["standby"][:-self._keep] if self._keep \
                else list(entry["standby"])
            entry["standby"] = entry["standby"][len(trim):]
        # outside the lock: drain the old version, release beyond keep
        if prev is not None:
            prev.pause()  # drain in-flight, weights stay for rollback
        for old in trim:
            old.close()  # released: graphs + weights dropped
        if _obs.ENABLED:
            _obs.record_serve_swap(
                name, "committed", version=version,
                prev_version=prev.version if prev else None)
            _obs.SERVE_LIVE_MODELS.set(self._live_count())
        return engine

    def _version_seq(self, name) -> int:
        with self._lock:
            entry = self._models.get(name)
            if not entry:
                return 0
            return len(entry["standby"]) + (1 if entry["live"] else 0)

    def _live_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._models.values() if e["live"])

    # -- rollback ----------------------------------------------------------
    def rollback(self, name):
        """Flip back to the most recent standby version (drains the
        version being demoted; it becomes the standby, so rolling
        forward again is another ``rollback``)."""
        with self._lock:
            entry = self._models.get(name)
            if not entry or not entry["standby"]:
                raise ServingError(
                    f"no standby version of {name!r} to roll back to")
            demoted = entry["live"]
            restored = entry["standby"].pop()
            restored.resume()
            entry["live"] = restored
            if demoted is not None:
                entry["standby"].append(demoted)
        if demoted is not None:
            demoted.pause()
        if _obs.ENABLED:
            _obs.record_serve_swap(
                name, "rolled_back", version=restored.version,
                prev_version=demoted.version if demoted else None)
        return restored

    # -- request routing ---------------------------------------------------
    def engine(self, name) -> InferenceEngine:
        with self._lock:
            entry = self._models.get(name)
            live = entry["live"] if entry else None
        if live is None:
            raise ServingError(f"no live version of model {name!r}")
        return live

    def live_version(self, name):
        """Version string of the live engine (None when nothing is
        live) — the fleet's zero-stale-version assertions read this."""
        with self._lock:
            entry = self._models.get(name)
            live = entry["live"] if entry else None
        return live.version if live is not None else None

    def submit(self, name, x, **kwargs):
        """Submit to the CURRENT live version. A swap between the
        pointer read and the submit is retried onto the new version, so
        continuous traffic across a swap never fails spuriously — each
        request is answered by exactly one coherent version."""
        for _ in range(8):
            engine = self.engine(name)
            try:
                return engine.submit(x, **kwargs)
            except EngineClosed:
                with self._lock:
                    entry = self._models.get(name)
                    still_live = entry and entry["live"] is engine
                if still_live:
                    raise  # genuinely closed, not a swap race
        raise ServingError(
            f"model {name!r} kept swapping during submit; giving up")

    def predict(self, name, x, timeout=None, **kwargs):
        return self.submit(name, x, **kwargs).result(timeout)

    # -- inventory ---------------------------------------------------------
    def models(self) -> dict:
        """{name: {"live": version|None, "standby": [versions...]}}"""
        with self._lock:
            return {
                name: {
                    "live": e["live"].version if e["live"] else None,
                    "standby": [s.version for s in e["standby"]],
                }
                for name, e in self._models.items()
            }

    def stats(self, name) -> dict:
        return self.engine(name).stats()

    def unload(self, name):
        """Drain and fully release every version of ``name``."""
        with self._lock:
            entry = self._models.pop(name, None)
        if entry is None:
            return
        for eng in [entry["live"]] + entry["standby"]:
            if eng is not None:
                eng.close()
        if _obs.ENABLED:
            _obs.SERVE_LIVE_MODELS.set(self._live_count())

    def close(self):
        """Unload everything (idempotent)."""
        with self._lock:
            names = list(self._models)
        for name in names:
            self.unload(name)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
