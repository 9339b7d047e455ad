"""Autoregressive decode fast path: chunked decode with on-device
sampling and token-level continuous batching, on PyTorch.

PyTorch counterpart of ``mxnet_tpu/serving/generation.py``. A generative
request is hundreds of sequential steps, so the host round trip per
token — not the math — would dominate. The engine keeps the host out of
the loop:

- **one host round trip per chunk**: ``chunk`` decode steps (model step
  + sampling + EOS/budget bookkeeping) run back to back on the device
  with every piece of slot state a device tensor; the host reads the
  chunk's tokens and the new slot state in ONE device-to-host copy at
  the end. On a CUDA device the chunk is ONE captured CUDA graph (the
  JAX package seals the same loop as one ``lax.scan`` executable): the
  host mirrors go to static device buffers in one pinned host-to-device
  copy, and a replay runs every step's launches;
- **on-device sampling** (:func:`sample_tokens`): greedy / temperature
  / top-k / top-p per SLOT, drawn from an explicit ``torch.Generator``
  on the device — no sync to pick a token;
- **token-level continuous batching**: the decode batch is ``slots``
  slots; requests JOIN an idle slot between chunks (after a per-prompt
  prefill) and LEAVE the moment EOS or their token budget retires them.

K/V state lives in the :class:`~.kvcache.PagedKVCache` block pool,
updated in place by every prefill and decode step. Slot liveness is an
operand, never a shape. On a CUDA device every decode step launches the
Hopper paged-decode kernel (its split kernel and its combine kernel) once
per layer. The pools are updated in place and never reallocated, since
the graphs read them through fixed addresses. On a CUDA device each prompt
bucket's prefill is one captured CUDA graph too (the JAX package seals one
prefill executable per bucket): the request's padded prompt, table row
and length go to the bucket's static buffer in one pinned host-to-device
copy, and a replay writes the pools and the logits.

Sampling reproducibility: a request's first token is drawn from its own
``seed``; later tokens draw from the engine's generator (registered with
the chunk's graph, so each replay draws the stream's next numbers), which
advances per chunk — deterministic for a fixed admission order. ``greedy=True``
(the default) is always bit-stable. The draws are not those of
``jax.random``.

Knobs: ``MXTPU_DECODE_SLOTS`` / ``MXTPU_DECODE_CHUNK`` /
``MXTPU_DECODE_MAX_NEW``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

import numpy as _np
import torch

from .. import base
from .. import observability as _obs
from ..base import MXNetError
from ..context import resolve_device
from .engine import serve_queue_cap
from .errors import (
    EngineClosed,
    KVCacheOOM,
    ReplicaDead,
    RequestCancelled,
    RequestTimeout,
    RetraceForbidden,
    ServerOverloaded,
    ServingError,
)
from .kvcache import PagedKVCache

_SLOTS_DEFAULT = 8
_CHUNK_DEFAULT = 8
_MAX_NEW_DEFAULT = 32


def decode_slots() -> int:
    """Decode-batch width in slots (``MXTPU_DECODE_SLOTS``, default 8)."""
    return max(1, base.getenv("MXTPU_DECODE_SLOTS", _SLOTS_DEFAULT,
                              dtype=int))


def decode_chunk() -> int:
    """Decode steps per host round trip (``MXTPU_DECODE_CHUNK``, default
    8). Raising it amortizes the round trip over more tokens but delays
    join/retire scheduling to chunk boundaries."""
    return max(1, base.getenv("MXTPU_DECODE_CHUNK", _CHUNK_DEFAULT,
                              dtype=int))


def decode_max_new() -> int:
    """Default per-request new-token budget when ``submit`` doesn't
    pass ``max_new_tokens`` (``MXTPU_DECODE_MAX_NEW``, default 32)."""
    return max(1, base.getenv("MXTPU_DECODE_MAX_NEW", _MAX_NEW_DEFAULT,
                              dtype=int))


# ---------------------------------------------------------------------------
# on-device sampling
# ---------------------------------------------------------------------------

def sample_tokens(logits, generator, temperature, top_k, top_p, greedy):
    """Sample one token per row on the logits' device, without a host
    sync. ``logits`` is ``(B, V)``; every knob is a ``(B,)`` tensor so
    each batch slot applies ITS OWN policy:

    - ``greedy`` (bool): argmax of the raw logits (ignores the rest);
    - ``temperature`` (float): logit scale before filtering;
    - ``top_k`` (int): keep the k highest-scoring tokens (0 = off);
    - ``top_p`` (float): nucleus — keep the smallest prefix of the
      sorted distribution with cumulative probability >= p (1.0 = off;
      the argmax always survives, so filtering can never empty a row).

    Filters compose (top-k first, then top-p) by masking to ``-inf``; the
    draw is Gumbel-max with uniforms from ``generator`` (how
    ``jax.random.categorical`` draws, from another bit stream)."""
    v = logits.shape[-1]
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kk = torch.where(top_k > 0, torch.clamp(top_k, 1, v), v).long()
    kth = torch.gather(sorted_desc, 1, (kk - 1)[:, None])
    limited = torch.where(scaled < kth, -torch.inf, scaled)
    probs = torch.softmax(sorted_desc, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep = mass_before < top_p[:, None]
    thresh = torch.where(keep, sorted_desc, torch.inf).amin(
        dim=-1, keepdim=True)
    limited = torch.where(scaled < thresh, -torch.inf, limited)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(limited.shape, generator=generator,
                   device=limited.device).clamp_(min=tiny)
    drawn = torch.argmax(limited - torch.log(-torch.log(u)), dim=-1)
    return torch.where(greedy, torch.argmax(logits, dim=-1),
                       drawn).to(torch.int32)


# ---------------------------------------------------------------------------
# request/future plumbing
# ---------------------------------------------------------------------------

class _GenRequest:
    __slots__ = ("prompt", "max_new", "temperature", "top_k", "top_p",
                 "greedy", "seed", "eos", "deadline", "t_submit",
                 "tokens", "t_first", "t_last", "event", "result",
                 "error", "version", "claimed", "cancelled",
                 "_state_lock")

    def __init__(self, prompt, max_new, temperature, top_k, top_p,
                 greedy, seed, eos, deadline):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.greedy = bool(greedy)
        self.seed = int(seed)
        self.eos = int(eos)
        self.deadline = deadline  # absolute perf_counter time, or None
        self.t_submit = time.perf_counter()
        self.tokens = []
        self.t_first = None
        self.t_last = None
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.version = None
        self.claimed = False     # admission won the CAS
        self.cancelled = False
        self._state_lock = threading.Lock()

    def claim(self) -> bool:
        """Admission-side CAS: exactly one of {admit, cancel} wins."""
        with self._state_lock:
            if self.cancelled:
                return False
            self.claimed = True
            return True

    def cancel(self) -> bool:
        with self._state_lock:
            if self.claimed or self.event.is_set():
                return False
            self.cancelled = True
        self.error = RequestCancelled(
            "generation request cancelled while queued — never admitted")
        self.event.set()
        return True

    def finish(self, result=None, error=None, version=None):
        if self.event.is_set():
            return
        self.result = result
        self.error = error
        self.version = version
        self.event.set()


class GenerateFuture:
    """Client handle for a generation request. ``result()`` returns the
    generated token ids as ``np.int32`` (prompt NOT included; the EOS
    token, when hit, IS the last element)."""

    def __init__(self, req: _GenRequest):
        self._req = req

    def done(self) -> bool:
        return self._req.event.is_set()

    @property
    def version(self):
        return self._req.version

    def cancel(self) -> bool:
        """Withdraw a still-queued request (True iff it was never
        admitted to a slot)."""
        return self._req.cancel()

    def cancelled(self) -> bool:
        return self._req.cancelled

    def result(self, timeout=None):
        if not self._req.event.wait(timeout):
            raise TimeoutError(
                f"generation result not ready within {timeout}s (the "
                "request itself is still running; cancel() to withdraw "
                "a queued one)")
        if self._req.error is not None:
            raise self._req.error
        return self._req.result

    def token_times(self):
        """(t_first_token, t_last_token) perf_counter stamps."""
        return self._req.t_first, self._req.t_last


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class GenerationEngine:
    """Continuous-batching generation server over a paged KV cache.

    ``shapes`` are PROMPT-LENGTH buckets (ints, or 1-tuples): a prompt is
    padded to the smallest bucket that holds it, and a prompt longer than
    every bucket is refused. The engine runs on the net's device.

    >>> net = TransformerDecoderLM(vocab_size=64)        # on cuda:0
    >>> eng = GenerationEngine(net, [8, 16], slots=4, chunk=4)
    >>> toks = eng.predict(np.array([5, 3, 9]), max_new_tokens=12)

    ``_queue``, ``_closing``, ``_killed`` and ``_paused`` are guarded by
    ``_lock``; slot state belongs to the scheduler thread."""

    def __init__(self, net, shapes, *, slots=None, chunk=None,
                 queue_cap=None, cache_blocks=None, cache_block_size=None,
                 max_new_default=None, seed=0, name="model", version="v1",
                 autostart=True, device=None):
        for attr in ("decode_step_fn", "prefill_fn", "params",
                     "decode_dims"):
            if not hasattr(net, attr):
                raise MXNetError(
                    f"{type(net).__name__} has no {attr} — generation "
                    "needs a decode-capable net (e.g. "
                    "serving.TransformerDecoderLM)")
        self.device = resolve_device(net.device if device is None
                                     else device)
        if self.device != net.device:
            raise MXNetError(f"engine device {self.device} differs from the "
                             f"net's {net.device}")
        self._name = str(name)
        self._version = str(version)
        self._net = net
        dims = net.decode_dims()
        self.max_seq = int(dims["max_seq"])
        self.vocab_size = int(dims["vocab_size"])
        self._slots = int(slots) if slots is not None else decode_slots()
        self._chunk = int(chunk) if chunk is not None else decode_chunk()
        self._max_new_default = (int(max_new_default) if max_new_default
                                 is not None else decode_max_new())
        self._queue_cap = (int(queue_cap) if queue_cap is not None
                           else serve_queue_cap())
        self._buckets = self._normalize_buckets(shapes)
        # float32 pools whatever the net's type, as in the JAX engine
        self.cache = PagedKVCache(
            dims["layers"], dims["kv_heads"], dims["head_dim"],
            max_seq=self.max_seq, num_blocks=cache_blocks,
            block_size=cache_block_size, name=self._name,
            device=self.device)
        self._mb = self.cache.max_blocks_per_seq
        self._lock = threading.Lock()
        self._queue = collections.deque()
        self._closing = False
        self._closed = False
        self._killed = False
        self._paused = False
        self._work = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        # engine-local SLO state (real numbers with telemetry off)
        self._itl = collections.deque(maxlen=8192)
        self._tokens = 0
        self._chunks = 0
        self._prefills = 0
        self._requests_ok = 0
        self._refused = 0
        self._shed = 0
        self._timeouts = 0
        self._failed = 0
        self._compiles = 0
        self._decode_wall = 0.0
        self._sealed = False
        # slot state: host mirrors, read back once per chunk
        n = self._slots
        self._slot_req = [None] * n
        self._slot_tables = [None] * n
        self._lens = _np.zeros(n, _np.int32)
        self._token = _np.zeros(n, _np.int32)
        self._active = _np.zeros(n, bool)
        self._remaining = _np.zeros(n, _np.int32)
        self._temp = _np.ones(n, _np.float32)
        self._topk = _np.zeros(n, _np.int32)
        self._topp = _np.ones(n, _np.float32)
        self._greedy = _np.ones(n, bool)
        self._eos = _np.full(n, -1, _np.int32)
        with self._on_device():
            self._deploy(seed)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"mxtpu-genserve-{self._name}")
        if autostart:
            self._thread.start()

    @staticmethod
    def _normalize_buckets(shapes):
        if base.is_int(shapes):
            shapes = [shapes]
        out = set()
        for s in shapes:
            if isinstance(s, (tuple, list)):
                if len(s) != 1:
                    raise MXNetError(
                        "generation buckets are PROMPT LENGTHS (ints or "
                        f"1-tuples); got {s!r}")
                s = s[0]
            out.add(int(s))
        buckets = sorted(out)
        if not buckets or buckets[0] <= 0:
            raise MXNetError(f"invalid prompt buckets {shapes!r}")
        return buckets

    @contextlib.contextmanager
    def _on_device(self):
        """Bind the calling thread to the engine's card (CUDA work is
        launched on that thread's current stream) and turn autograd off."""
        with contextlib.ExitStack() as stack:
            if self.device.type == "cuda":
                stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.inference_mode())
            yield

    def _dev(self, a, dtype=None):
        """Host array -> tensor on the engine's device."""
        return torch.as_tensor(_np.asarray(a), dtype=dtype).to(self.device)

    # -- deploy: build + warm + seal ---------------------------------------
    def _deploy(self, seed):
        """Seal the decode chunk, and warm every path once with nothing
        live. On a CUDA device the chunk body is captured as one CUDA
        graph over the static slot buffers and the cache's pools (after a
        warm-up run that builds the kernel) and replayed once; on the CPU
        it runs once. Then each prompt bucket's prefill: on a CUDA device
        captured as one CUDA graph per bucket over a static buffer (the
        padded prompt, the table row and the length; the pools written in
        place) and replayed once, on the CPU run once eagerly. Every
        sealing run has length 0, so it writes only to the null block."""
        self._step = self._net.decode_step_fn()
        self._prefill_step = self._net.prefill_fn()
        self._params = self._net.params()
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        cuda = self.device.type == "cuda"
        # the slot mirrors packed as int32 (floats by their bits, bools as
        # 0/1): one host-to-device copy a chunk
        n, mb = self._slots, self._mb
        self._layout = {}
        off = 0
        for key, size in (("tables", n * mb), ("lens", n), ("token", n),
                          ("active", n), ("remaining", n), ("temp", n),
                          ("top_k", n), ("top_p", n), ("greedy", n),
                          ("eos", n)):
            self._layout[key] = (off, size)
            off += size
        self._host_in = torch.zeros(off, dtype=torch.int32,
                                    pin_memory=cuda)
        self._dev_in = torch.zeros(off, dtype=torch.int32,
                                   device=self.device)
        self._chunk_graph = None
        self._chunk_out = None
        if cuda:
            from ..gluon import _capture

            self._graph_pools = self.cache.pools()
            _capture.warm_up(self._chunk_body)
            self._chunk_graph = _capture.Graph(
                torch.cuda.graph_pool_handle(),
                f"the decode chunk of {self._name}:{self._version}",
                generators=(self._gen,))
            self._chunk_out = self._chunk_graph.capture(self._chunk_body)
            self._chunk_graph.replay()
            self._host_out = torch.empty(self._chunk_out.shape,
                                         dtype=torch.int32, pin_memory=True)
        else:
            self._run_chunk(_np.zeros((self._slots, self._mb), _np.int32))
        self._compiles += 1
        self._prefill_graphs = {}
        for tb in self._buckets:
            if tb > self.max_seq:
                raise MXNetError(
                    f"prompt bucket {tb} exceeds the net's max_seq "
                    f"{self.max_seq}")
            if cuda:
                self._prefill_graphs[tb] = self._capture_prefill(tb)
            else:
                k, v = self.cache.pools()
                self._prefill_step(
                    self._params, self._dev(_np.zeros((1, tb)), torch.long),
                    k, v, self._dev(_np.zeros((1, self._mb), _np.int32)),
                    self._dev([0], torch.int32))
            self._compiles += 1
        if cuda:
            torch.cuda.synchronize(self.device)
        self._sealed = True

    def _prefill_body(self, buf, tb):
        """One prefill from the static buffer ``buf`` (int64: the padded
        prompt ``(tb,)``, the table row ``(mb,)``, the length ``(1,)``)
        over the cache's pools, written in place; returns the logits
        ``(1, V)`` at the last real position."""
        mb = self._mb
        k, v = self.cache.pools()
        logits, _, _ = self._prefill_step(
            self._params, buf[:tb].view(1, tb), k, v,
            buf[tb:tb + mb].to(torch.int32).view(1, mb),
            buf[tb + mb:].to(torch.int32))
        return logits

    def _capture_prefill(self, tb):
        """Capture bucket ``tb``'s prefill as one CUDA graph (after a
        warm-up run), replay it once, and return ``(graph, device buffer,
        logits, pinned host buffer)``."""
        from ..gluon import _capture

        buf = torch.zeros(tb + self._mb + 1, dtype=torch.long,
                          device=self.device)
        body = functools.partial(self._prefill_body, buf, tb)
        _capture.warm_up(body)
        graph = _capture.Graph(
            torch.cuda.graph_pool_handle(),
            f"the prefill of bucket {tb} of {self._name}:{self._version}")
        logits = graph.capture(body)
        graph.replay()
        host = torch.zeros(buf.shape, dtype=torch.long, pin_memory=True)
        return graph, buf, logits, host

    def _check_pools(self, what):
        """Refuse to replay ``what`` over pools other than those the
        graphs were captured over."""
        k, v = self.cache.pools()
        if k is not self._graph_pools[0] or v is not self._graph_pools[1]:
            raise MXNetError(f"the KV cache's pools are not the ones {what} "
                             "was captured over")

    def _slot_inputs(self):
        """The static slot buffers (views of ``_dev_in``) in their types."""
        buf, lay = self._dev_in, self._layout

        def part(key):
            off, size = lay[key]
            return buf[off:off + size]

        off, size = lay["tables"]
        return (buf[off:off + size].view(self._slots, self._mb),
                part("lens"), part("token"), part("active") != 0,
                part("remaining"), part("temp").view(torch.float32),
                part("top_k"), part("top_p").view(torch.float32),
                part("greedy") != 0, part("eos"))

    def _chunk_body(self):
        """``chunk`` decode steps from the static slot buffers over the
        cache's pools, written in place: the chunk's tokens ``(chunk,
        slots)``, the emitted flags, and the new lens/token/active/
        remaining, packed into one int32 tensor. No host sync, so a CUDA
        graph captures it whole."""
        (tables, lens, token, active, remaining, temp, top_k, top_p,
         greedy, eos) = self._slot_inputs()
        k_pool, v_pool = self.cache.pools()
        toks, flags = [], []
        for _ in range(self._chunk):
            logits, k_pool, v_pool = self._step(
                self._params, token, lens, k_pool, v_pool, tables, active)
            nxt = sample_tokens(logits, self._gen, temp, top_k, top_p,
                                greedy)
            emitted = active
            nxt = torch.where(emitted, nxt, 0)
            lens = lens + active.to(lens.dtype)
            remaining = remaining - active.to(remaining.dtype)
            hit_eos = (nxt == eos) & (eos >= 0)
            active = active & ~hit_eos & (remaining > 0)
            token = nxt
            toks.append(nxt)
            flags.append(emitted)
        self.cache.update_pools(k_pool, v_pool)
        return torch.cat([torch.stack(toks).reshape(-1),
                          torch.stack(flags).to(torch.int32).reshape(-1),
                          lens, token, active.to(torch.int32), remaining])

    def _pack(self, tables):
        """The host slot mirrors into the (pinned, on a card) input
        buffer, in ``_layout``'s order."""
        host = self._host_in.numpy()
        parts = {"tables": tables, "lens": self._lens, "token": self._token,
                 "active": self._active, "remaining": self._remaining,
                 "temp": self._temp.view(_np.int32), "top_k": self._topk,
                 "top_p": self._topp.view(_np.int32),
                 "greedy": self._greedy, "eos": self._eos}
        for key, (off, size) in self._layout.items():
            host[off:off + size] = _np.asarray(parts[key]).reshape(-1)

    def _run_chunk(self, tables):
        """One chunk from the host slot mirrors: pack them into the static
        buffers with one host-to-device copy, run the body (a replay of
        its captured graph on a card, the body itself on the CPU), and
        read the chunk's tokens ``(chunk, slots)``, emitted flags, and the
        new lens/token/active/remaining in ONE device-to-host copy."""
        self._pack(tables)
        self._dev_in.copy_(self._host_in, non_blocking=True)
        if self._chunk_graph is None:
            packed = self._chunk_body().cpu().numpy()
        else:
            self._check_pools("the decode chunk")
            self._chunk_graph.replay()
            self._host_out.copy_(self._chunk_out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            packed = self._host_out.numpy()
        n = self._slots
        c = self._chunk * n
        rest = packed[2 * c:].reshape(4, n)
        return (packed[:c].reshape(self._chunk, n).copy(),
                packed[c:2 * c].reshape(self._chunk, n).astype(bool),
                rest[0].copy(), rest[1].copy(), rest[2].astype(bool),
                rest[3].copy())

    # -- submit path -------------------------------------------------------
    def _bucket_for(self, plen):
        for tb in self._buckets:
            if plen <= tb:
                return tb
        return None

    def submit(self, x, max_new_tokens=None, temperature=1.0, top_k=0,
               top_p=1.0, greedy=True, seed=None, eos=None,
               deadline_ms=None, **_ignored) -> GenerateFuture:
        """Queue one prompt (1-D int token array; a leading singleton
        batch axis is squeezed). Typed refusals: :class:`EngineClosed`,
        :class:`ServerOverloaded` (queue full), :class:`RetraceForbidden`
        (no prompt bucket fits). ``max_new_tokens`` is clipped so
        ``prompt + generated <= max_seq``."""
        prompt = _np.asarray(x)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1 or prompt.size == 0:
            raise ServingError(
                "generation takes ONE 1-D prompt of token ids per "
                f"submit; got shape {prompt.shape}")
        prompt = prompt.astype(_np.int32)
        plen = int(prompt.size)
        bucket = self._bucket_for(plen)
        if bucket is None or plen >= self.max_seq:
            self._refused += 1
            if _obs.ENABLED:
                _obs.record_serve_request(self._name, "error")
            raise RetraceForbidden(
                f"sealed generation engine {self._name}:{self._version} "
                f"has no prefill bucket for prompt length {plen} "
                f"(cause: shape). Known buckets: {self._buckets}, "
                f"max_seq {self.max_seq}. Truncate the prompt, or add a "
                "bucket and redeploy.")
        max_new = int(max_new_tokens) if max_new_tokens else \
            self._max_new_default
        max_new = max(1, min(max_new, self.max_seq - plen))
        deadline = (time.perf_counter() + float(deadline_ms) / 1e3
                    if deadline_ms else None)
        req = _GenRequest(
            prompt, max_new, temperature, top_k, top_p, greedy,
            seed if seed is not None else _np.random.randint(1 << 30),
            eos if eos is not None else -1, deadline)
        with self._lock:
            if self._closing or self._killed or self._paused:
                if _obs.ENABLED:
                    _obs.record_serve_request(self._name, "closed")
                raise EngineClosed(
                    f"generation engine {self._name}:{self._version} is "
                    "not accepting requests "
                    f"({'paused' if self._paused else 'closed'})")
            if len(self._queue) >= self._queue_cap:
                self._shed += 1
                if _obs.ENABLED:
                    _obs.record_serve_request(self._name, "shed")
                raise ServerOverloaded(
                    f"generation queue full ({self._queue_cap}) on "
                    f"{self._name}:{self._version} — retry with backoff")
            self._queue.append(req)
            self._idle.clear()
        self._work.set()
        return GenerateFuture(req)

    def predict(self, x, timeout=None, **kwargs):
        """Synchronous generation: submit + wait; returns np.int32
        generated token ids."""
        return self.submit(x, **kwargs).result(timeout)

    # -- scheduler loop ----------------------------------------------------
    def _loop(self):
        with self._on_device():
            while True:
                with self._lock:
                    killed = self._killed
                if killed:
                    self._abort_all(ReplicaDead(
                        f"generation engine {self._name}:{self._version} "
                        "was killed (host-death simulation)"))
                    return
                self._admit()
                if self._active.any():
                    self._step_chunk()
                    continue
                with self._lock:
                    drained = not self._queue
                    closing = self._closing
                if drained:
                    self._idle.set()
                    if closing:
                        return
                self._work.wait(0.02)
                self._work.clear()

    def _fail(self, req, err, code):
        self._failed += 1
        if _obs.ENABLED:
            _obs.record_serve_request(self._name, code)
        req.finish(error=err, version=self._version)

    def _admit(self):
        """Join queued requests to idle slots: sweep deadlines, then
        prefill into free slots while the cache can back the prompt."""
        now = time.perf_counter()
        with self._lock:
            q = list(self._queue)
        for req in q:
            if req.deadline is not None and now > req.deadline \
                    and not req.claimed:
                with self._lock:
                    try:
                        self._queue.remove(req)
                    except ValueError:
                        continue
                self._timeouts += 1
                self._fail(req, RequestTimeout(
                    "generation deadline expired before a slot opened"),
                    "timeout")
        while True:
            free = [s for s in range(self._slots) if not self._active[s]
                    and self._slot_req[s] is None]
            if not free:
                return
            with self._lock:
                req = self._queue.popleft() if self._queue else None
            if req is None:
                return
            if not req.claim():  # lost to cancel()
                continue
            try:
                table = self.cache.allocate(len(req.prompt))
            except KVCacheOOM as e:
                if self._active.any():
                    # blocks free as running sequences retire: put the
                    # request back and retry after the next chunk
                    with req._state_lock:
                        req.claimed = False
                    with self._lock:
                        self._queue.appendleft(req)
                    return
                self._fail(req, e, "shed")
                continue
            try:
                self._prefill(req, table, free[0])
            except Exception as e:  # noqa: BLE001 - typed to the waiter
                self.cache.release(table)
                self._fail(req, e if isinstance(e, ServingError) else
                           ServingError(f"prefill failed: {e}"), "error")

    def _prefill_logits(self, prompt, table):
        """Prefill ``prompt`` into ``table``'s blocks and return the logits
        ``(1, V)`` at its last position. On the card: one host-to-device
        copy into the bucket's static buffer and one replay of its graph;
        the logits are the graph's output, rewritten by the next replay,
        and the pinned host buffer may be rewritten only after the caller
        has synchronised on them. On the CPU: the eager prefill."""
        plen = len(prompt)
        tb = self._bucket_for(plen)
        padded = _np.zeros((1, tb), _np.int64)
        padded[0, :plen] = prompt
        if self._prefill_graphs:
            self._check_pools("the prefill")
            graph, buf, logits, host = self._prefill_graphs[tb]
            host[:tb] = torch.from_numpy(padded[0])
            host[tb:tb + self._mb] = torch.from_numpy(
                _np.asarray(table.device_row(self._mb), _np.int64))
            host[-1] = plen
            buf.copy_(host, non_blocking=True)
            graph.replay()
            return logits
        dev = self._dev
        k, v = self.cache.pools()
        logits, k, v = self._prefill_step(
            self._params, dev(padded), k, v,
            dev(table.device_row(self._mb)[None, :]),
            dev([plen], torch.int32))
        self.cache.update_pools(k, v)
        return logits

    def _prefill(self, req, table, slot):
        plen = len(req.prompt)
        dev = self._dev
        t0 = time.perf_counter()
        logits = self._prefill_logits(req.prompt, table)
        gen = torch.Generator(device=self.device).manual_seed(req.seed)
        tok = sample_tokens(
            logits, gen, dev([max(req.temperature, 1e-6)], torch.float32),
            dev([req.top_k], torch.int32), dev([req.top_p], torch.float32),
            dev([req.greedy], torch.bool))
        # the ONE deliberate per-request sync: the first token decides
        # retire-or-seat before the next chunk can include this slot
        first = int(tok.cpu()[0])
        dt = time.perf_counter() - t0
        table.length = plen
        self._prefills += 1
        now = time.perf_counter()
        req.tokens.append(first)
        req.t_first = req.t_last = now
        self._tokens += 1
        if _obs.ENABLED:
            _obs.record_xla_dispatch("decode_prefill")
            _obs.DECODE_PREFILL_SECONDS.observe(dt, model=self._name)
            _obs.DECODE_TOKENS_TOTAL.inc(1, model=self._name)
        done = (req.max_new <= 1
                or (req.eos >= 0 and first == req.eos))
        if done:
            self._retire(req, table)
            return
        self._slot_req[slot] = req
        self._slot_tables[slot] = table
        self._lens[slot] = plen  # next decode step writes position plen
        self._token[slot] = first
        self._active[slot] = True
        self._remaining[slot] = req.max_new - 1
        self._temp[slot] = max(req.temperature, 1e-6)
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        self._greedy[slot] = req.greedy
        self._eos[slot] = req.eos

    def _step_chunk(self):
        """One chunk: every active slot advances up to ``chunk`` tokens;
        retirements free their slots and cache blocks at the boundary
        (where the NEXT _admit can seat a newcomer)."""
        # back the chunk's cache growth per slot; a pool too full to
        # grow a sequence retires that request early (typed OOM)
        for s in range(self._slots):
            if not self._active[s]:
                continue
            need = int(self._lens[s]) + min(self._chunk,
                                             int(self._remaining[s]))
            try:
                self.cache.ensure(self._slot_tables[s],
                                  min(need, self.max_seq))
            except KVCacheOOM as e:
                req = self._slot_req[s]
                self.cache.release(self._slot_tables[s])
                self._clear_slot(s)
                self._fail(req, e, "shed")
        if not self._active.any():
            return
        tables = _np.zeros((self._slots, self._mb), _np.int32)
        for s in range(self._slots):
            if self._slot_tables[s] is not None:
                tables[s] = self._slot_tables[s].device_row(self._mb)
        t0 = time.perf_counter()
        (toks, flags, self._lens, self._token, self._active,
         self._remaining) = self._run_chunk(tables)
        dt = time.perf_counter() - t0
        self._decode_wall += dt
        self._chunks += 1
        now = time.perf_counter()
        emitted_total = 0
        for s in range(self._slots):
            req = self._slot_req[s]
            if req is None:
                continue
            mask = flags[:, s]
            n = int(mask.sum())
            if n:
                req.tokens.extend(int(t) for t in toks[mask, s])
                # tokens of one chunk arrive together: the honest
                # inter-token latency is the amortized chunk wall time
                per_tok = dt / n
                if req.t_first is None:
                    req.t_first = now
                req.t_last = now
                for _ in range(n):
                    self._itl.append(per_tok)
                if _obs.ENABLED:
                    _obs.DECODE_ITL_SECONDS.observe(per_tok,
                                                    model=self._name)
                emitted_total += n
            if not self._active[s]:
                table = self._slot_tables[s]
                self._clear_slot(s)
                self._retire(req, table)
        self._tokens += emitted_total
        if _obs.ENABLED:
            _obs.record_xla_dispatch("decode_chunk")
            _obs.DECODE_CHUNKS_TOTAL.inc(1, model=self._name)
            if emitted_total:
                _obs.DECODE_TOKENS_TOTAL.inc(emitted_total,
                                             model=self._name)
            _obs.DECODE_ACTIVE_SLOTS.set(int(self._active.sum()),
                                         model=self._name)

    def _clear_slot(self, s):
        self._slot_req[s] = None
        self._slot_tables[s] = None
        self._active[s] = False
        self._lens[s] = 0
        self._token[s] = 0
        self._remaining[s] = 0

    def _retire(self, req, table):
        self.cache.release(table)
        self._requests_ok += 1
        if _obs.ENABLED:
            _obs.record_serve_request(self._name, "ok")
            _obs.SERVE_LATENCY_SECONDS.observe(
                time.perf_counter() - req.t_submit, model=self._name)
        req.finish(result=_np.asarray(req.tokens, _np.int32),
                   version=self._version)

    def _abort_all(self, err):
        with self._lock:
            queued = list(self._queue)
            self._queue.clear()
        for req in queued:
            self._fail(req, err, "closed")
        for s in range(self._slots):
            req = self._slot_req[s]
            if req is not None:
                if self._slot_tables[s] is not None:
                    self.cache.release(self._slot_tables[s])
                self._clear_slot(s)
                self._fail(req, err, "closed")
        self._idle.set()

    # -- introspection -----------------------------------------------------
    @property
    def version(self):
        return self._version

    @property
    def buckets(self):
        """Prompt-length buckets, 1-tuples."""
        return [(b,) for b in self._buckets]

    @property
    def sealed(self):
        return self._sealed

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def active_slots(self) -> int:
        return int(self._active.sum())

    def stats(self) -> dict:
        """Engine-local snapshot (plain floats). ``dispatches`` counts
        host round trips (chunks + prefills); ``compiles`` counts the
        deploy-time warm runs (nothing is compiled after deploy)."""
        itl = _np.asarray(self._itl, _np.float64) if self._itl else None
        dispatches = self._chunks + self._prefills
        return {
            "model": self._name,
            "version": self._version,
            "engine": "generation",
            "buckets": list(self._buckets),
            "slots": self._slots,
            "chunk": self._chunk,
            "requests_ok": self._requests_ok,
            "refused": self._refused,
            "shed": self._shed,
            "timeouts": self._timeouts,
            "failed": self._failed,
            "tokens_generated": self._tokens,
            "prefills": self._prefills,
            "decode_chunks": self._chunks,
            "dispatches": dispatches,
            "tokens_per_dispatch": self._tokens / max(1, dispatches),
            "tokens_per_s": (self._tokens / self._decode_wall
                             if self._decode_wall else 0.0),
            "itl_p50_ms": (float(_np.percentile(itl, 50)) * 1e3
                           if itl is not None else None),
            "itl_p99_ms": (float(_np.percentile(itl, 99)) * 1e3
                           if itl is not None else None),
            "queue_depth": self.queue_depth(),
            "active_slots": self.active_slots(),
            "compiles": self._compiles,
            "retraces_after_warmup": 0 if self._sealed else None,
            "recompiles_after_warmup": 0 if self._sealed else None,
            "cache": self.cache.stats(),
        }

    def canary(self):
        """Deploy-time verification: a short greedy generation must
        return in-vocabulary token ids (the repository's staged-load veto
        for generation engines; NaN logits give out-of-range or
        degenerate ids through the argmax)."""
        if not self._thread.is_alive():
            self._thread.start()
        toks = self.predict(_np.array([1, 2], _np.int32),
                            max_new_tokens=2, greedy=True, timeout=60.0)
        if len(toks) == 0 or _np.any(toks < 0) \
                or _np.any(toks >= self.vocab_size):
            raise ServingError(
                f"generation canary produced out-of-vocabulary ids "
                f"{toks!r} — refusing to serve this version")
        return toks

    # -- lifecycle ---------------------------------------------------------
    def pause(self):
        """Stop accepting work and drain: queued + in-flight generations
        complete, weights and pools stay resident (resume() is a flag
        flip)."""
        with self._lock:
            if self._paused or self._closing:
                return
            self._paused = True
        self._work.set()
        self._idle.wait(timeout=120.0)

    def resume(self):
        with self._lock:
            if self._closing or self._killed:
                raise EngineClosed(
                    f"engine {self._name}:{self._version} was released; "
                    "reload instead of resume")
            self._paused = False

    def kill(self):
        """Abrupt host-death simulation: queued AND in-flight requests
        fail with typed :class:`ReplicaDead`; nothing drains.
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._killed = True
            self._closing = True
        self._work.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)
        else:
            self._abort_all(ReplicaDead(
                f"generation engine {self._name}:{self._version} killed"))
        self._release()

    def close(self):
        """Drain queued + in-flight generations, then release pools and
        weight references. Idempotent."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
        self._work.set()
        if self._thread.is_alive():
            self._thread.join(timeout=120.0)
        self._abort_all(EngineClosed(
            f"generation engine {self._name}:{self._version} closed"))
        self._release()

    def _release(self):
        self._closed = True
        self._chunk_graph = None
        self._chunk_out = None
        self._prefill_graphs = {}
        self._graph_pools = None
        self._params = None
        self.cache.k_pool = None
        self.cache.v_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
