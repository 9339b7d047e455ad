"""CUDA-graph capture for the cached graphs of ``gluon/block.py``.

A hybridized block's entry captures its forward (and, when it records,
its backward) once per input signature and replays them after. This
module owns what every capture needs, so that other captured paths (the
K-step superstep, the serving decode chunk) can reuse it:

- :func:`warm_up` runs a function once, uncaptured, on a side stream.
  That loads every lazily loaded CUDA module (the port's ``ctypes``
  libraries, cuBLAS and cuDNN handles and workspaces) and finishes
  cuDNN's algorithm search, none of which may happen during a capture.
- :class:`Graph` captures a function into a ``torch.cuda.CUDAGraph``
  whose memory comes from a pool the caller may share between graphs
  (an entry's forward and backward share one, so the residuals the
  forward saves stay where the backward reads them), and replays it.
- Launch accounting: a kernel wrapper counts its launch with
  ``ops._kernels.count``, which during a capture (on the capturing
  thread, and on the autograd thread of a captured backward) goes to the
  graph's own count; each replay adds that count to
  ``ops._kernels.LAUNCHES``. So ``LAUNCHES`` counts the launches that
  ran, captured or not, and an eager launch or a replay in another thread
  while a capture runs (an engine serving while the next version stages)
  is counted as it ran.
- Random streams: the device's default generator is registered with
  every capture (torch does that); a capture that draws from generators
  of its own (the serving engine's sampler) names them, and each replay
  then draws the next numbers of each stream.
- Captures run while other threads use the card: serving captures while
  another engine serves, a hybridized block's first step while a data
  thread stages the next batches (pinned allocations, event records and
  queries). Every capture runs in ``"thread_local"`` error mode, so
  another thread's calls that a stream capture forbids (a device-to-host
  copy of its results, a pinned allocation) do not invalidate it, as
  they would in torch's default ``"global"`` mode (C19).

Python's garbage collector is off while a graph is captured: blocks sit
in reference cycles, and a collection that frees a dropped block's
graphs in the middle of a capture releases their memory pool, which the
stream capture refuses (``cudaErrorStreamCaptureInvalidated``).

A capture that fails (an operation that synchronises with the host, such
as ``.item()``, or anything else the stream capture refuses) raises
``MXNetError``; nothing falls back to the eager path. torch ends a
registered generator's capture mode only when a capture ends well; after
a failed one every later random draw would raise, so the capture gives
each generator it registered a fresh state at the same seed and offset.
"""

from __future__ import annotations

import collections
import gc
import threading

import torch

from ..base import MXNetError
from ..ops import _kernels


# One capture at a time: torch.cuda.graph captures on one capture stream
# shared by every capture, and the wrappers count into one capture's
# counts (ops._kernels.count).
_CAPTURE_LOCK = threading.Lock()


def warm_up(fn):
    """``fn()`` once on a side stream that waits for the current one,
    which then waits for it; returns what ``fn`` returns."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


def _release_generator(gen=None):
    """Give ``gen`` (the current device's default generator by default) a
    state out of capture mode, at its seed and offset."""
    if gen is None:
        gen = torch.cuda.default_generators[torch.cuda.current_device()]
    fresh = torch.Generator(device=gen.device)
    fresh.manual_seed(gen.initial_seed())
    fresh.set_offset(gen.get_offset())
    gen.graphsafe_set_state(fresh)


class Graph:
    """One captured CUDA graph over the memory pool ``pool``; ``what``
    names it in the errors a failed capture or replay raises.
    ``generators``: CUDA generators other than the default one that the
    captured function draws from."""

    def __init__(self, pool, what, generators=()):
        self._graph = torch.cuda.CUDAGraph()
        self._pool = pool
        self._what = what
        self._generators = tuple(generators)
        for gen in self._generators:
            self._graph.register_generator_state(gen)
        #: the kernel launches one replay makes, by wrapper name
        self.launches = collections.Counter()

    def capture(self, fn):
        """Capture ``fn()`` and return what it returned (tensors in the
        pool, rewritten by every replay)."""
        with _CAPTURE_LOCK:
            counts = collections.Counter()
            _kernels.capture_counts(counts)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self._graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    out = fn()
            except Exception as err:
                _release_generator()
                for gen in self._generators:
                    _release_generator(gen)
                raise MXNetError(
                    f"capturing {self._what} as a CUDA graph failed: "
                    f"{type(err).__name__}: {err}") from err
            finally:
                if collecting:
                    gc.enable()
                _kernels.capture_counts(None)
            self.launches = counts
        return out

    def replay(self):
        try:
            self._graph.replay()
        except Exception as err:
            raise MXNetError(f"replaying {self._what} failed: "
                             f"{type(err).__name__}: {err}") from err
        _kernels.add(self.launches)
