"""``mxnet_tpu_torch.serving`` — single-process serving on PyTorch.

The port of ``mxnet_tpu.serving`` but its fleet (ROADMAP A13):

- :class:`InferenceEngine`: one captured CUDA graph per shape bucket of
  a HybridBlock's ``aot_predict_fn``, sealed (an off-bucket signature is
  refused with :class:`RetraceForbidden`), fed by a
  :class:`ContinuousBatcher` (bucket grouping, ``max_wait``, per-request
  deadlines, bounded-queue load shed, draining close);
- :class:`ModelRepository`: named, versioned models on one device;
  staged load -> canary -> atomic pointer flip, drain, rollback without
  a recapture; decode-capable nets get a :class:`GenerationEngine`;
- the autoregressive decode fast path: :class:`GenerationEngine`
  (token-level continuous batching with on-device sampling; on a card
  its decode chunk is one captured CUDA graph) runs
  :class:`TransformerDecoderLM` over :class:`PagedKVCache`, and every
  decode step reads the cache through the hand-written Hopper
  paged-decode kernel.

Knobs: ``MXTPU_SERVE_MAX_BATCH``, ``MXTPU_SERVE_MAX_WAIT_MS``,
``MXTPU_SERVE_QUEUE``, ``MXTPU_KVCACHE_BLOCKS``,
``MXTPU_KVCACHE_BLOCK_SIZE``, ``MXTPU_DECODE_SLOTS``,
``MXTPU_DECODE_CHUNK``, ``MXTPU_DECODE_MAX_NEW``.
"""

from __future__ import annotations

from .batcher import ContinuousBatcher, ServeFuture  # noqa: F401
from .engine import (  # noqa: F401
    InferenceEngine,
    serve_max_batch,
    serve_max_wait_ms,
    serve_queue_cap,
)
from .errors import (  # noqa: F401
    BrownoutShed,
    EngineClosed,
    KVCacheOOM,
    ReplicaDead,
    ReplicaLost,
    RequestCancelled,
    RequestTimeout,
    RequestTooLarge,
    RetraceForbidden,
    ServerOverloaded,
    ServingError,
    StagedLoadError,
)
from .kvcache import (  # noqa: F401
    BlockTable,
    PagedKVCache,
    kvcache_block_size,
    kvcache_blocks,
)
from .decoder import TransformerDecoderLM, params_from_numpy  # noqa: F401
from .generation import (  # noqa: F401
    GenerateFuture,
    GenerationEngine,
    decode_chunk,
    decode_max_new,
    decode_slots,
    sample_tokens,
)
from .repository import ModelRepository  # noqa: F401
