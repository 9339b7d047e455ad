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
- Launch accounting: the kernel wrappers add to
  ``ops._kernels.LAUNCHES`` when Python runs them, which during a
  capture launches nothing. A capture takes back what it added and keeps
  it as the graph's own count; each replay adds that count. So
  ``LAUNCHES`` counts the launches that ran, captured or not.

Python's garbage collector is off while a graph is captured: blocks sit
in reference cycles, and a collection that frees a dropped block's
graphs in the middle of a capture releases their memory pool, which the
stream capture refuses (``cudaErrorStreamCaptureInvalidated``).

A capture that fails (an operation that synchronises with the host, such
as ``.item()``, or anything else the stream capture refuses) raises
``MXNetError``; nothing falls back to the eager path. torch ends the
device's default generator's capture mode only when a capture ends well;
after a failed one every later random draw would raise, so the capture
gives the generator a fresh state at the same seed and offset.
"""

from __future__ import annotations

import collections
import gc

import torch

from ..base import MXNetError
from ..ops import _kernels


def warm_up(fn):
    """``fn()`` once on a side stream that waits for the current one,
    which then waits for it; returns what ``fn`` returns."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


def _release_generator():
    """Give the current device's default generator a state out of capture
    mode, at its seed and offset."""
    gen = torch.cuda.default_generators[torch.cuda.current_device()]
    fresh = torch.Generator(device=gen.device)
    fresh.manual_seed(gen.initial_seed())
    fresh.set_offset(gen.get_offset())
    gen.graphsafe_set_state(fresh)


class Graph:
    """One captured CUDA graph over the memory pool ``pool``; ``what``
    names it in the errors a failed capture or replay raises."""

    def __init__(self, pool, what):
        self._graph = torch.cuda.CUDAGraph()
        self._pool = pool
        self._what = what
        #: the kernel launches one replay makes, by wrapper name
        self.launches = collections.Counter()

    def capture(self, fn):
        """Capture ``fn()`` and return what it returned (tensors in the
        pool, rewritten by every replay)."""
        before = collections.Counter(_kernels.LAUNCHES)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self._graph, pool=self._pool):
                out = fn()
        except Exception as err:
            _release_generator()
            raise MXNetError(f"capturing {self._what} as a CUDA graph failed: "
                             f"{type(err).__name__}: {err}") from err
        finally:
            if collecting:
                gc.enable()
            self.launches = _kernels.LAUNCHES - before
            _kernels.LAUNCHES.clear()
            _kernels.LAUNCHES.update(before)
        return out

    def replay(self):
        try:
            self._graph.replay()
        except Exception as err:
            raise MXNetError(f"replaying {self._what} failed: "
                             f"{type(err).__name__}: {err}") from err
        _kernels.LAUNCHES.update(self.launches)
