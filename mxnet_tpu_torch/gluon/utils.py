"""Gluon utilities of the port: carrying weights in from numpy."""

from __future__ import annotations

from ..base import MXNetError


def load_numpy(params, arrays):
    """Copy ``{name: np.ndarray}`` into ``params`` (a ``ParameterDict``,
    e.g. ``net.collect_params()``) in place, each array cast to its
    parameter's type. The names must match exactly: a missing or extra
    name, or a shape that differs, raises before anything is written.
    A parameter whose initialisation is still deferred takes the array's
    shape and is initialised by it."""
    missing = sorted(set(params.keys()) - set(arrays))
    extra = sorted(set(arrays) - set(params.keys()))
    if missing or extra:
        raise MXNetError(f"load_numpy: missing {missing[:5]} (of "
                         f"{len(missing)}), extra {extra[:5]} (of "
                         f"{len(extra)})")
    for name, a in arrays.items():
        shape = params[name].shape
        if shape is not None and (len(a.shape) != len(shape) or any(
                s > 0 and s != n for s, n in zip(shape, a.shape))):
            raise MXNetError(f"load_numpy: {name} has shape {a.shape}, the "
                             f"parameter {shape}")
    for name, a in arrays.items():
        params[name].set_data(a)
