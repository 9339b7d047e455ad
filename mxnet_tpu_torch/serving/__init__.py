"""``mxnet_tpu_torch.serving`` — generation serving on PyTorch.

The first slice of the port of ``mxnet_tpu.serving``: the autoregressive
decode fast path. :class:`GenerationEngine` (token-level continuous
batching with on-device sampling) runs :class:`TransformerDecoderLM`
over :class:`PagedKVCache`, and every decode step reads the cache through
the hand-written Hopper paged-decode kernel. The one-shot
``InferenceEngine``, the model repository and the fleet come later.

Knobs: ``MXTPU_SERVE_QUEUE``, ``MXTPU_KVCACHE_BLOCKS``,
``MXTPU_KVCACHE_BLOCK_SIZE``, ``MXTPU_DECODE_SLOTS``,
``MXTPU_DECODE_CHUNK``, ``MXTPU_DECODE_MAX_NEW``.
"""

from __future__ import annotations

from .engine import serve_queue_cap  # noqa: F401
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
