"""``mx.observability``: run-scoped runtime telemetry.

PyTorch counterpart of ``mxnet_tpu/observability/``, with the same
metric catalog (names, types, help texts and labels; the few metrics
whose reference counts an XLA artefact say in their help what they
count here), the same tracer, exporters and record helpers. A metrics
registry (Counter/Gauge/Histogram with labels), a ring-buffer event
tracer with chrome://tracing + JSONL exporters, and Prometheus text
exposition.

Instrumented hot paths (each behind ONE ``ENABLED`` boolean check):

- ``ops/dispatch.py``: per-op dispatch count + wall time,
- ``gluon/block.py``: captured-graph builds, cache hits, trace wall
  time, retrace-cause diagnosis,
- ``kvstore/local.py`` / ``kvstore/dist.py``: push/pull counts and
  bytes, allreduce latency, barrier count and wait,
- ``gluon/trainer.py``: step count/latency spans, grad-norm gauge,
  the superstep's series,
- ``engine.py::wait``: sync-probe latency,
- ``parallel/`` (the SPMD step, its buckets, pipelines),
  ``resilience/`` (checkpoints, chaos, elastic), ``serving/``.

Switch: ``MXTPU_TELEMETRY=1`` at process start, or
``observability.set_enabled(True)`` at runtime. Off by default: the
disabled cost at every site is a single module-attribute boolean read.

Sibling layers:

- ``observability.introspect``: per-site FLOPs and CUDA memory
  accounting, MFU against the card's stated peak (``MXTPU_INTROSPECT``)
  and step-bounded ``torch.profiler`` windows (``MXTPU_PROFILE``),
- ``observability.flight``: crash flight recorder
  (``MXTPU_DUMP_ON_CRASH``): excepthook + SIGTERM/SIGABRT handlers
  dumping trace ring, metrics, cost table and in-flight dispatch sites,
- ``observability.serve``: background-thread Prometheus endpoint
  (``MXTPU_METRICS_PORT`` / ``serve_metrics(port)``),
- ``observability.federation`` / ``watchdog`` / ``attribution``: the
  cluster view over ``torch.distributed``, anomaly detectors, and the
  per-step phase budget.

Quickstart::

    import mxnet_tpu_torch as mx
    mx.observability.set_enabled(True)
    ... train ...
    print(mx.observability.summary())
    print(mx.observability.dump_prometheus())
    mx.observability.tracer().dump_chrome_trace("trace.json")
"""

from __future__ import annotations

import time as _time

from ..base import getenv
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SeriesGauge,
    DEFAULT_BUCKETS,
)
from .tracing import Span, Tracer, load_jsonl  # noqa: F401

#: THE switch. Hot paths read this module attribute and skip all
#: recording when False. Seeded from MXTPU_TELEMETRY (default off).
ENABLED = bool(getenv("MXTPU_TELEMETRY", False, dtype=bool))

_REGISTRY = MetricsRegistry()
_TRACER = Tracer()


def registry() -> MetricsRegistry:
    return _REGISTRY


def tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return ENABLED


def set_enabled(on: bool) -> bool:
    """Flip telemetry at runtime; returns the previous state."""
    global ENABLED
    prev, ENABLED = ENABLED, bool(on)
    return prev


def enable():
    set_enabled(True)


def disable():
    set_enabled(False)


def reset():
    """Clear every recorded metric value and all trace events."""
    _REGISTRY.reset()
    _TRACER.clear()


def span(name, cat="default", **args) -> Span:
    return _TRACER.span(name, cat=cat, **args)


# ---------------------------------------------------------------------------
# metric catalog (module-level singletons so instrumented sites pay no
# registry lookup per record) — see docs/observability.md
# ---------------------------------------------------------------------------

OP_DISPATCH_TOTAL = _REGISTRY.counter(
    "mxtpu_op_dispatch_total", "imperative op dispatches, by op name")
OP_DISPATCH_SECONDS = _REGISTRY.counter(
    "mxtpu_op_dispatch_seconds_total",
    "wall time spent in op dispatch (async: excludes device time), by op")

CACHEDOP_COMPILE_TOTAL = _REGISTRY.counter(
    "mxtpu_cachedop_compile_total",
    "CachedGraph builds (trace+compile), by block")
CACHEDOP_CACHE_HITS = _REGISTRY.counter(
    "mxtpu_cachedop_cache_hit_total",
    "CachedGraph signature-cache hits, by block")
CACHEDOP_TRACE_SECONDS = _REGISTRY.counter(
    "mxtpu_cachedop_trace_seconds_total",
    "wall time of CachedGraph build + first compiled call, by block")
CACHEDOP_RETRACE_TOTAL = _REGISTRY.counter(
    "mxtpu_cachedop_retrace_total",
    "recompiles after the first, by block and cause key-diff")

KV_PUSH_TOTAL = _REGISTRY.counter(
    "mxtpu_kvstore_push_total", "kvstore push operations (per key)")
KV_PUSH_BYTES = _REGISTRY.counter(
    "mxtpu_kvstore_push_bytes_total", "gradient bytes entering aggregation")
KV_PULL_TOTAL = _REGISTRY.counter(
    "mxtpu_kvstore_pull_total", "kvstore pull operations (per key)")
KV_PULL_BYTES = _REGISTRY.counter(
    "mxtpu_kvstore_pull_bytes_total", "bytes written into pull outputs")
KV_PUSHPULL_TOTAL = _REGISTRY.counter(
    "mxtpu_kvstore_pushpull_total", "fused pushpull aggregations (per key)")
KV_ALLREDUCE_SECONDS = _REGISTRY.histogram(
    "mxtpu_kvstore_allreduce_seconds",
    "dispatch latency of the global-mesh allreduce")
KV_ALLREDUCE_BYTES = _REGISTRY.counter(
    "mxtpu_kvstore_allreduce_bytes_total",
    "payload bytes through the global-mesh allreduce")
KV_BARRIER_TOTAL = _REGISTRY.counter(
    "mxtpu_kvstore_barrier_total", "cross-process barrier entries")

XLA_DISPATCH_TOTAL = _REGISTRY.counter(
    "mxtpu_xla_dispatch_total",
    "device-program dispatches, by site (op / cachedop_fwd / "
    "cachedop_bwd / kv_grouped / kv_bucket / trainer_fused / "
    "superstep / superstep_stage / serving); in the port a CUDA-graph "
    "replay, or one eager call of the site where nothing is captured")

FUSED_FALLBACK_TOTAL = _REGISTRY.counter(
    "mxtpu_fused_fallback_total",
    "fused-train-step fast-path declines, by site and reason")

KV_BUCKET_BUILD_TOTAL = _REGISTRY.counter(
    "mxtpu_kvstore_bucket_build_total",
    "gradient-bucket plans built (one per pushpull signature)")
KV_BUCKET_PUSHPULL_TOTAL = _REGISTRY.counter(
    "mxtpu_kvstore_bucket_pushpull_total",
    "bucketed multi-key pushpull aggregations (per call, not per key)")

TRAINER_STEP_TOTAL = _REGISTRY.counter(
    "mxtpu_trainer_step_total", "Trainer.step calls")
TRAINER_STEP_SECONDS = _REGISTRY.histogram(
    "mxtpu_trainer_step_seconds", "Trainer.step wall time")
TRAINER_GRAD_NORM = _REGISTRY.gauge(
    "mxtpu_trainer_grad_norm",
    "global L2 norm of the (post-allreduce) gradients at the last step")

ENGINE_WAIT_TOTAL = _REGISTRY.counter(
    "mxtpu_engine_wait_total", "engine.wait sync probes, by path")
ENGINE_WAIT_SECONDS = _REGISTRY.counter(
    "mxtpu_engine_wait_seconds_total",
    "wall time blocked in engine.wait, by path")

PROFILE_COUNTER = _REGISTRY.gauge(
    "mxtpu_profile_counter",
    "user-defined profiler.ProfileCounter values, by counter name")

DATA_PREFETCH_QUEUE_DEPTH = _REGISTRY.gauge(
    "mxtpu_data_prefetch_queue_depth",
    "batches currently staged ahead in the DevicePrefetcher queue")
DATA_PREFETCH_BATCHES = _REGISTRY.counter(
    "mxtpu_data_prefetch_batches_total",
    "batches staged to device by the DevicePrefetcher")
DATA_PREFETCH_WAIT_SECONDS = _REGISTRY.counter(
    "mxtpu_data_prefetch_wait_seconds_total",
    "consumer wall time blocked waiting on the prefetch queue (the "
    "'accelerator idles on the host' signal — near-zero when overlapped)")
DATA_H2D_BYTES = _REGISTRY.counter(
    "mxtpu_data_h2d_bytes_total",
    "host->device batch payload bytes staged by the input pipeline")
DATA_H2D_SECONDS = _REGISTRY.histogram(
    "mxtpu_data_h2d_seconds",
    "host->device staging latency per batch (convert + device_put "
    "dispatch; async backends may finish the copy later)")
DATA_PREFETCH_WAIT_DELTA = _REGISTRY.gauge(
    "mxtpu_data_prefetch_wait_delta_seconds",
    "consumer prefetch-queue wait attributed to the LAST step (the "
    "per-step delta of the _total counter, set by the attribution "
    "plane) — an input-wait spike is visible here where the running "
    "total hides it; the watchdog's input_wait detector reads this")

# -- streaming data plane (gluon/data/stream.py) -------------------------
STREAM_READ_BYTES = _REGISTRY.counter(
    "mxtpu_stream_read_bytes_total",
    "raw bytes read from storage by the streaming shard reader, by "
    "shard (divide by _seconds for the per-shard read rate)")
STREAM_READ_SECONDS = _REGISTRY.counter(
    "mxtpu_stream_read_seconds_total",
    "wall time the read-ahead thread spent in storage reads, by shard "
    "(includes emulated MXTPU_STREAM_LATENCY_MS slow-storage latency)")
STREAM_RECORDS_TOTAL = _REGISTRY.counter(
    "mxtpu_stream_records_total",
    "records fetched from shards by the streaming reader, by shard")
STREAM_DECODE_SECONDS = _REGISTRY.counter(
    "mxtpu_stream_decode_seconds_total",
    "wall time the decode pool spent decoding records (busy time; "
    "utilization = busy / (busy + wait))")
STREAM_DECODE_WAIT_SECONDS = _REGISTRY.counter(
    "mxtpu_stream_decode_wait_seconds_total",
    "wall time decode-pool workers spent idle waiting on the raw-record "
    "queue — high means storage (not decode) is the bottleneck")
STREAM_CONSUMER_WAIT_SECONDS = _REGISTRY.counter(
    "mxtpu_stream_consumer_wait_seconds_total",
    "train-thread wall time blocked waiting on the streaming reader "
    "for a full batch — the 'input-bound' signal; ≈0 when the decode "
    "pool keeps up with the superstep")
STREAM_QUEUE_DEPTH = _REGISTRY.gauge(
    "mxtpu_stream_queue_depth",
    "streaming-reader staging depth, by queue (raw = undecoded "
    "records awaiting the decode pool; reorder = decoded samples "
    "awaiting in-order consumption)")
STREAM_BATCHES_TOTAL = _REGISTRY.counter(
    "mxtpu_stream_batches_total",
    "batches delivered in deterministic global order by StreamReader")
STREAM_REPARTITIONS_TOTAL = _REGISTRY.counter(
    "mxtpu_stream_repartitions_total",
    "elastic re-partitions of the streaming cursor (resize events "
    "rebasing base_batch so no sample is skipped or replayed)")

COMPILE_CACHE_HITS = _REGISTRY.counter(
    "mxtpu_compile_cache_hit_total",
    "executables served from a persistent compilation cache; the port "
    "has none (it captures CUDA graphs in process), so this stays 0")
COMPILE_CACHE_MISSES = _REGISTRY.counter(
    "mxtpu_compile_cache_miss_total",
    "compiles that missed a persistent compilation cache; the port has "
    "none, so this stays 0")

SHAPE_WOBBLE_TOTAL = _REGISTRY.counter(
    "mxtpu_shape_wobble_total",
    "CachedGraph shape-signature count exceeded MXTPU_RETRACE_BUDGET, "
    "by block — pad/bucket the inputs (docs/performance.md)")

SUPERSTEP_TOTAL = _REGISTRY.counter(
    "mxtpu_superstep_total",
    "K-step on-device superstep dispatches, by k")
SUPERSTEP_ITERATIONS_TOTAL = _REGISTRY.counter(
    "mxtpu_superstep_iterations_total",
    "training iterations executed inside superstep dispatches (the "
    "denominator for dispatches-per-step amortization)")
SUPERSTEP_STEP_SECONDS = _REGISTRY.histogram(
    "mxtpu_superstep_amortized_step_seconds",
    "superstep wall time divided by its K — the amortized per-step "
    "time the host observes (gauges update once per superstep, so "
    "per-step series have K-step cadence; docs/observability.md)")

# -- step-time attribution plane (observability/attribution.py) ------------

STEP_PHASE_SECONDS = _REGISTRY.histogram(
    "mxtpu_step_phase_seconds",
    "per-step wall time by phase (input_wait / h2d / ckpt_overhead / "
    "comm_exposed / compute / host_gap) from the attribution plane's "
    "budget decomposition of each step period — phases are >= 0 and "
    "sum to the period by construction; superstep dispatches are "
    "amortized over their K (docs/observability.md, 'Reading an "
    "attribution report')")
STEP_PHASE_LAST = _REGISTRY.series_gauge(
    "mxtpu_step_phase_last_seconds",
    "the last-N per-step phase records, by phase — stored as a LAZY "
    "view over the attribution ring (materializes at read/exposition "
    "time, zero per-step list building); slot 0 is the oldest retained "
    "step")

# -- scale-out: overlapped allreduce + ZeRO sharding (parallel/) ----------

OVERLAP_BUCKETS = _REGISTRY.gauge(
    "mxtpu_overlap_buckets",
    "gradient buckets in the current bucket-ready comm plan, by site "
    "(readiness-ordered ~MXTPU_OVERLAP_BUCKET_BYTES buckets; each is "
    "one in-graph collective)")
OVERLAP_EXPOSED_COMM_SECONDS = _REGISTRY.gauge(
    "mxtpu_overlap_exposed_comm_seconds",
    "per-step wall time NOT hidden behind compute, by comm mode "
    "(step time minus the compute-only probe's; set by the overlap "
    "measurement probe — bench.py overlap / measure_overlap)")
OVERLAP_HIDDEN_FRACTION = _REGISTRY.gauge(
    "mxtpu_overlap_hidden_fraction",
    "fraction of the staged baseline's exposed comm time the "
    "bucket-ready overlapped step hides (1 - exposed_ready/"
    "exposed_staged, from the overlap measurement probe)")
ZERO_STATE_BYTES = _REGISTRY.gauge(
    "mxtpu_zero_state_bytes",
    "per-device at-rest bytes of the SPMD step's state, by kind "
    "(param / opt) — the ZeRO sharding saving vs a replicated layout "
    "is visible as this gauge dropping ~1/dp at stage 2/3")


def record_overlap_probe(exposed_by_mode, hidden_fraction):
    """Publish an overlap measurement (exposed comm seconds per mode +
    the hidden fraction) into the registry, and hand the per-mode
    exposed figures to the attribution plane as its comm hint (in-graph
    comm schedules leave no host timestamp to delta)."""
    for mode, sec in (exposed_by_mode or {}).items():
        OVERLAP_EXPOSED_COMM_SECONDS.set(float(sec), mode=str(mode))
    if hidden_fraction is not None:
        OVERLAP_HIDDEN_FRACTION.set(float(hidden_fraction))
    from . import attribution as _attr  # late: submodule binds at bottom

    _attr.set_comm_hint(exposed_by_mode)


PIPELINE_BUBBLE_FRACTION = _REGISTRY.gauge(
    "mxtpu_pipeline_bubble_fraction",
    "fraction of (rank, tick) slots with no scheduled work in the "
    "realized pipeline schedule table, by schedule (gpipe / 1f1b / "
    "interleaved) — measured from the dependency-simulated tick "
    "program, not a closed-form estimate; 1 - bubble is the "
    "pipeline-overlap criterion")
PIPELINE_STASH_SLOTS = _REGISTRY.gauge(
    "mxtpu_pipeline_stash_slots",
    "peak live forward-activation stash entries on any pipeline rank, "
    "by schedule — the 1F1B memory win over fill-drain gpipe is this "
    "gauge dropping from ~M (microbatches) to ~S (stages)")
MOE_A2A_EXPOSED_SECONDS = _REGISTRY.gauge(
    "mxtpu_moe_a2a_exposed_seconds",
    "per-step wall time of the MoE all-to-all NOT hidden behind expert "
    "compute, by dispatch mode (serial / chunked; step time minus the "
    "comm-free probe's — set by measure_moe_overlap)")
MOE_A2A_HIDDEN_FRACTION = _REGISTRY.gauge(
    "mxtpu_moe_a2a_hidden_fraction",
    "fraction of the serial baseline's exposed all-to-all time the "
    "chunked (comm/compute interleaved) MoE dispatch hides "
    "(1 - exposed_chunked/exposed_serial, from measure_moe_overlap)")


def record_pipeline_schedule(schedule, bubble_fraction, stash_slots,
                             ticks=None):
    """Publish a realized pipeline schedule's measured shape (bubble +
    stash depth gauges, by schedule) and drop a ``pipeline.schedule``
    instant on the trace so mxtpu-doctor can join it with step-phase
    attribution."""
    PIPELINE_BUBBLE_FRACTION.set(float(bubble_fraction),
                                 schedule=str(schedule))
    PIPELINE_STASH_SLOTS.set(float(stash_slots), schedule=str(schedule))
    _TRACER.instant("pipeline.schedule", cat="parallel",
                    schedule=str(schedule),
                    bubble_fraction=float(bubble_fraction),
                    stash_slots=int(stash_slots),
                    ticks=int(ticks) if ticks is not None else None)


def record_moe_probe(exposed_by_mode, hidden_fraction):
    """Publish a MoE all-to-all overlap measurement (exposed seconds
    per dispatch mode + the hidden fraction)."""
    for mode, sec in (exposed_by_mode or {}).items():
        MOE_A2A_EXPOSED_SECONDS.set(float(sec), mode=str(mode))
    if hidden_fraction is not None:
        MOE_A2A_HIDDEN_FRACTION.set(float(hidden_fraction))
    _TRACER.instant("moe.a2a_probe", cat="parallel",
                    hidden_fraction=float(hidden_fraction or 0.0))


AMP_LOSS_SCALE = _REGISTRY.gauge(
    "mxtpu_amp_loss_scale",
    "current dynamic loss scale (fp16 AMP); under the fused step this "
    "holds a LAZY device scalar that syncs only when read")
AMP_OVERFLOW_TOTAL = _REGISTRY.gauge(
    "mxtpu_amp_overflow_total",
    "gradient-overflow (skip-update + scale-backoff) events since the "
    "scaler was created — monotonic; a gauge, not a counter, so the "
    "fused step can record the in-graph total as a lazy device scalar")

# -- resilience: async checkpointing + chaos (mxnet_tpu_torch/resilience) --------

CHECKPOINT_TOTAL = _REGISTRY.counter(
    "mxtpu_checkpoint_total",
    "committed training checkpoints, by reason "
    "(interval / manual / sigterm)")
CHECKPOINT_SECONDS = _REGISTRY.histogram(
    "mxtpu_checkpoint_seconds",
    "wall time of one checkpoint serialize+write+commit (runs on the "
    "background writer thread — NOT training-loop time)")
CHECKPOINT_TICK_SECONDS = _REGISTRY.counter(
    "mxtpu_checkpoint_tick_seconds_total",
    "training-LOOP time spent entering checkpoints (interval bookkeeping "
    "+ snapshot dispatch + writer-queue handoff) — the in-loop cost the "
    "attribution plane charges to ckpt_overhead; the background write "
    "itself stays in mxtpu_checkpoint_seconds")
CHECKPOINT_BYTES_TOTAL = _REGISTRY.counter(
    "mxtpu_checkpoint_bytes_total",
    "payload bytes committed to checkpoint storage")
CHECKPOINT_LAST_STEP = _REGISTRY.gauge(
    "mxtpu_checkpoint_last_step",
    "training step of the most recently committed checkpoint (the "
    "recovery point a preemption right now would resume from)")
CHECKPOINT_ERRORS_TOTAL = _REGISTRY.counter(
    "mxtpu_checkpoint_errors_total",
    "failed checkpoint snapshots/writes (training continues; the "
    "recovery point goes stale — alert on this)")
CHECKPOINT_DROPPED_TOTAL = _REGISTRY.counter(
    "mxtpu_checkpoint_dropped_total",
    "queued snapshots replaced by a newer one before the writer got to "
    "them (latest-wins backpressure: storage slower than the cadence)")

CHAOS_INJECTIONS_TOTAL = _REGISTRY.counter(
    "mxtpu_chaos_injections_total",
    "faults injected by the chaos harness (MXTPU_CHAOS), by kind and "
    "site — nonzero outside a test run means someone left chaos armed")

# -- live elasticity: runtime grow/shrink (resilience/elastic.py) ----------

ELASTIC_RESIZES_TOTAL = _REGISTRY.counter(
    "mxtpu_elastic_resizes_total",
    "runtime mesh resizes completed WITHOUT a process restart, by "
    "reason (chaos / notice / preempt / straggler / dead_peer / "
    "manual / signal)")
ELASTIC_RESIZE_SECONDS = _REGISTRY.histogram(
    "mxtpu_elastic_resize_seconds",
    "wall time of one in-process resize: snapshot-in-memory + mesh "
    "rebuild + pad-clipped logical re-shard + re-entry (training is "
    "paused exactly this long — the die->restore-from-disk "
    "alternative costs a full restart + recompile storm)")
ELASTIC_WORLD_SIZE = _REGISTRY.gauge(
    "mxtpu_elastic_world_size",
    "devices in the elastic trainer's current mesh (watch it shrink "
    "on eviction/preemption and grow on spot add)")
ELASTIC_STRAGGLER_EVICTIONS_TOTAL = _REGISTRY.counter(
    "mxtpu_elastic_straggler_evictions_total",
    "peers proactively resized out by the straggler policy "
    "(MXTPU_STRAGGLER_FACTOR) before the barrier watchdog timeout "
    "would have fired")
ELASTIC_PEER_LATENCY_SECONDS = _REGISTRY.histogram(
    "mxtpu_elastic_peer_latency_seconds",
    "per-rank barrier/heartbeat latency samples feeding the straggler "
    "policy, by rank (the membership monitor's barrier-latency "
    "histogram)")
KV_BARRIER_SECONDS = _REGISTRY.histogram(
    "mxtpu_kvstore_barrier_seconds",
    "wall time this process spent inside one kvstore barrier sync "
    "(the watchdog-timed wait; a rising tail here is the straggler "
    "signal the elastic monitor consumes)")

# -- executable introspection (MXTPU_INTROSPECT; observability/introspect) --

EXEC_FLOPS = _REGISTRY.gauge(
    "mxtpu_executable_flops",
    "FLOPs per invocation at each site, counted on its first run "
    "(torch.utils.flop_counter, plus the hand-written kernels' counts "
    "from their shapes; a superstep site's figure covers its K "
    "iterations)")
EXEC_BYTES_ACCESSED = _REGISTRY.gauge(
    "mxtpu_executable_bytes_accessed",
    "device bytes a site's first run allocated at its peak "
    "(torch.cuda memory statistics; no HBM traffic counter), by site")
EXEC_ARITH_INTENSITY = _REGISTRY.gauge(
    "mxtpu_executable_arith_intensity",
    "flops / bytes_accessed per site — position on the roofline "
    "(compare against the device ridge point; docs/observability.md)")
EXEC_TEMP_BYTES = _REGISTRY.gauge(
    "mxtpu_executable_temp_bytes",
    "temporary device bytes of a site's first run (peak minus what it "
    "held before and after; torch.cuda memory statistics), by site")
EXEC_ARG_BYTES = _REGISTRY.gauge(
    "mxtpu_executable_argument_bytes",
    "device bytes allocated when a site's first run began (its "
    "arguments and everything else live; torch.cuda), by site")
EXEC_OUT_BYTES = _REGISTRY.gauge(
    "mxtpu_executable_output_bytes",
    "device bytes a site's first run left allocated (its outputs; "
    "torch.cuda), by site")
EXEC_ALIAS_BYTES = _REGISTRY.gauge(
    "mxtpu_executable_alias_bytes",
    "bytes aliased input->output by buffer donation, by site; torch "
    "has no donation, so the port records none")
DONATION_UNALIASED_TOTAL = _REGISTRY.counter(
    "mxtpu_donation_unaliased_total",
    "executables that donated buffers but aliased 0 bytes; torch has "
    "no donation, so this stays 0 in the port")

# -- inference serving SLOs (mxnet_tpu_torch/serving) ----------------------------

SERVE_REQUESTS_TOTAL = _REGISTRY.counter(
    "mxtpu_serving_requests_total",
    "serving requests by model and terminal code (ok / shed / timeout / "
    "too_large / error / closed) — the SLO numerator/denominator pair")
SERVE_LATENCY_SECONDS = _REGISTRY.histogram(
    "mxtpu_serving_latency_seconds",
    "end-to-end request latency (submit -> result ready), by model — "
    "p50/p99 via Histogram.quantile / histogram_quantile")
SERVE_QUEUE_DEPTH = _REGISTRY.gauge(
    "mxtpu_serving_queue_depth",
    "requests waiting in the continuous-batching queue, by model "
    "(sampled at each batch dispatch; sustained depth near the bound "
    "means load-shedding is imminent)")
SERVE_BATCH_FILL = _REGISTRY.histogram(
    "mxtpu_serving_batch_fill",
    "valid-row fraction of each dispatched batch, by model (sum/count "
    "gives mean fill; low fill under load means max-wait is too short "
    "or buckets too fragmented)",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
SERVE_BATCHES_TOTAL = _REGISTRY.counter(
    "mxtpu_serving_batches_total",
    "batches dispatched to a bucket executable, by model and bucket")
SERVE_SHED_TOTAL = _REGISTRY.counter(
    "mxtpu_serving_shed_total",
    "requests rejected at submit because the bounded queue was full "
    "(backpressure / load shedding), by model")
SERVE_TIMEOUT_TOTAL = _REGISTRY.counter(
    "mxtpu_serving_timeout_total",
    "requests whose deadline expired before dispatch (typed timeout — "
    "never a stale result), by model")
SERVE_COMPILE_TOTAL = _REGISTRY.counter(
    "mxtpu_serving_compile_total",
    "bucket CUDA-graph captures at deploy time (eager buckets on the "
    "CPU count none), by model — FLAT after seal(); any increase after "
    "warmup is a no-retrace-contract violation")
SERVE_LIVE_MODELS = _REGISTRY.gauge(
    "mxtpu_serving_live_models",
    "model versions currently live in the ModelRepository")
SERVE_SWAPS_TOTAL = _REGISTRY.counter(
    "mxtpu_serving_swaps_total",
    "repository version transitions, by model and outcome (committed / "
    "rolled_back / aborted — aborted = staged load failed verification "
    "and never became visible)")

# -- in-scan superstep device metrics (per-iteration, K-slot series) -------

SUPERSTEP_ITER_LOSS = _REGISTRY.series_gauge(
    "mxtpu_superstep_iter_loss",
    "per-iteration mean loss of the LAST superstep dispatch, one slot "
    "per scan iteration (lazy device array; syncs only when read) — "
    "K-step capture keeps per-step metric cadence")
SUPERSTEP_ITER_GRAD_NORM = _REGISTRY.series_gauge(
    "mxtpu_superstep_iter_grad_norm",
    "per-iteration in-graph global grad norm of the last superstep "
    "dispatch, one slot per scan iteration (lazy device array)")
SUPERSTEP_ITER_OVERFLOW = _REGISTRY.series_gauge(
    "mxtpu_superstep_iter_overflow",
    "per-iteration fp16 overflow flag (1 = that iteration skipped its "
    "update) of the last superstep dispatch (lazy device array)")

# -- cluster-scope federation (observability/federation.py) ----------------

FEDERATION_PUBLISH_TOTAL = _REGISTRY.counter(
    "mxtpu_federation_publish_total",
    "registry snapshot publishes by this rank: local heartbeat beats "
    "plus successful step-beat cross-rank exchanges")
FEDERATION_ERRORS_TOTAL = _REGISTRY.counter(
    "mxtpu_federation_errors_total",
    "failed federation exchanges (the step-beat poll degraded to a "
    "local-only publish; the cluster view goes stale, never dark)")
FEDERATION_RANKS = _REGISTRY.gauge(
    "mxtpu_federation_ranks",
    "ranks with a snapshot in the cluster table (compare against the "
    "world size: fewer means someone stopped publishing)")
FEDERATION_SNAPSHOT_AGE_SECONDS = _REGISTRY.gauge(
    "mxtpu_federation_snapshot_age_seconds",
    "age of each rank's latest federated snapshot, by rank")
FEDERATION_STALE_RANKS = _REGISTRY.gauge(
    "mxtpu_federation_stale_ranks",
    "1 when the rank's snapshot age exceeds MXTPU_FEDERATION_STALE_S "
    "(its last series stay exposed — marked, never silently dropped), "
    "by rank")
FEDERATION_LAST_STEP = _REGISTRY.gauge(
    "mxtpu_federation_last_step",
    "step-epoch id carried by each rank's latest snapshot, by rank — "
    "the cross-rank skew/straggler picture (max - min = steps of lag)")

# -- anomaly watchdog (observability/watchdog.py, MXTPU_WATCHDOG) ----------

ANOMALY_TOTAL = _REGISTRY.counter(
    "mxtpu_anomaly_total",
    "watchdog detector firings, by kind (nan / loss_spike / "
    "grad_explosion / step_time / queue_saturation / input_wait) — "
    "detection only, training numerics are never touched")

# -- serving request-phase decomposition (correlated tracing) --------------

SERVE_PHASE_SECONDS = _REGISTRY.histogram(
    "mxtpu_serving_phase_seconds",
    "per-request latency by phase (queue / batch / dispatch / slice), "
    "by model — decomposes the end-to-end p99 into where the time "
    "actually went",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5))
SERVE_SCHED_WAIT_SECONDS = _REGISTRY.counter(
    "mxtpu_serving_sched_wait_seconds_total",
    "scheduler-loop wall time blocked waiting for work on the admission "
    "queue, by model — the serving-side analogue of the prefetch-wait "
    "counter (high fraction = the batcher idles, not the device)")

# -- self-healing serving fleet (the fleet, ROADMAP A13 (h)) ---------------

FLEET_REPLICAS = _REGISTRY.gauge(
    "mxtpu_fleet_replicas",
    "replicas in the serving fleet by model and health state (live / "
    "suspect / dead / warm) — live below the autoscaler minimum means "
    "recovery is in progress")
FLEET_DISPATCH_TOTAL = _REGISTRY.counter(
    "mxtpu_fleet_dispatch_total",
    "router dispatches by model and replica index — a skewed "
    "distribution under uniform load means the depth feed sees a "
    "straggler (or the consistent-hash fallback is active)")
FLEET_RETRY_TOTAL = _REGISTRY.counter(
    "mxtpu_fleet_retry_total",
    "failover retries onto a surviving replica, by model and reason "
    "(dead / closed / pipe) — each is one request that would have hung "
    "on a dead host without the router")
FLEET_REPLICA_LOST_TOTAL = _REGISTRY.counter(
    "mxtpu_fleet_replica_lost_total",
    "requests that exhausted EVERY candidate replica and surfaced a "
    "typed ReplicaLost, by model — nonzero while any replica survives "
    "is a router bug")
FLEET_BROWNOUT = _REGISTRY.gauge(
    "mxtpu_fleet_brownout",
    "latched degraded-mode level by model: 0 normal, 1 shedding bulk, "
    "2 shedding bulk+interactive (critical always admitted) — the loud "
    "signal that the fleet is trading work for survival")
FLEET_SHED_TOTAL = _REGISTRY.counter(
    "mxtpu_fleet_shed_total",
    "requests refused by the brownout policy, by model and priority "
    "class — sheds must appear at bulk before interactive before "
    "critical (strict priority order)")
FLEET_AUTOSCALE_TOTAL = _REGISTRY.counter(
    "mxtpu_fleet_autoscale_total",
    "autoscaler actuations by model and action (grow / shrink / "
    "replace / to_zero / restore), routed through the elastic "
    "membership signal queue")
FLEET_HEDGED_TOTAL = _REGISTRY.counter(
    "mxtpu_fleet_hedged_total",
    "hedged duplicate dispatches (MXTPU_FLEET_HEDGE_MS > 0), by model "
    "— first result wins, the loser is discarded (inference is "
    "idempotent)")
FLEET_RECOVERY_SECONDS = _REGISTRY.gauge(
    "mxtpu_fleet_recovery_seconds",
    "wall time from the last detected replica death to the autoscaler's "
    "replacement replica serving again, by model — the chaos "
    "certification budget in bench.py fleet")

# -- autoregressive decode fast path (serving/generation.py, kvcache.py) ---

DECODE_TOKENS_TOTAL = _REGISTRY.counter(
    "mxtpu_decode_tokens_total",
    "tokens generated (prefill first-tokens + decode-chunk emissions), "
    "by model — with mxtpu_decode_chunks_total this is the "
    "dispatches-per-token certification pair")
DECODE_CHUNKS_TOTAL = _REGISTRY.counter(
    "mxtpu_decode_chunks_total",
    "single-dispatch decode-chunk executions (each advances EVERY "
    "active slot up to MXTPU_DECODE_CHUNK tokens in one CUDA-graph "
    "replay, eagerly on the CPU), by model")
DECODE_ITL_SECONDS = _REGISTRY.histogram(
    "mxtpu_decode_inter_token_seconds",
    "amortized inter-token latency: decode-chunk wall time / tokens the "
    "slot emitted in that chunk (tokens of one chunk arrive together), "
    "by model — p50/p99 are the bench's ITL baselines",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25))
DECODE_PREFILL_SECONDS = _REGISTRY.histogram(
    "mxtpu_decode_prefill_seconds",
    "prompt-ingestion dispatch wall time (per-bucket prefill executable "
    "+ first-token sample), by model — the join cost of token-level "
    "continuous batching")
DECODE_ACTIVE_SLOTS = _REGISTRY.gauge(
    "mxtpu_decode_active_slots",
    "decode-batch slots holding a live sequence (of MXTPU_DECODE_SLOTS), "
    "by model — sustained low fill under queue depth means prompts are "
    "stuck on cache admission (see mxtpu_kvcache_occupancy_ratio)")
KVCACHE_BLOCKS_USED = _REGISTRY.gauge(
    "mxtpu_kvcache_blocks_used",
    "paged KV cache blocks currently allocated (of the usable pool — "
    "block 0 is the reserved null sink), by model")
KVCACHE_OCCUPANCY = _REGISTRY.gauge(
    "mxtpu_kvcache_occupancy_ratio",
    "allocated fraction of the usable KV block pool, by model — near "
    "1.0 admission starts shedding (mxtpu_kvcache_oom_total) and "
    "MXTPU_KVCACHE_BLOCKS needs raising")
KVCACHE_FORKS_TOTAL = _REGISTRY.counter(
    "mxtpu_kvcache_forks_total",
    "block-table forks (shared-prefix refcount bumps; copy-on-write "
    "copies exactly one block on first divergent append), by model")
KVCACHE_OOM_TOTAL = _REGISTRY.counter(
    "mxtpu_kvcache_oom_total",
    "block allocations refused because the pool was exhausted (typed "
    "KVCacheOOM — admission backpressure or early retirement, never a "
    "partially-backed sequence), by model")


# ---------------------------------------------------------------------------
# hot-path record helpers (called only after an ENABLED check at the site)
# ---------------------------------------------------------------------------

def record_op_dispatch(name: str, dt: float):
    """Per-op dispatch accounting (ops/dispatch.py seam)."""
    key = (("op", name),)
    v = OP_DISPATCH_TOTAL._values
    v[key] = v.get(key, 0.0) + 1
    s = OP_DISPATCH_SECONDS._values
    s[key] = s.get(key, 0.0) + dt
    record_xla_dispatch("op")


def record_xla_dispatch(site: str, count: int = 1):
    """One compiled-executable invocation (jit call) at ``site`` — the
    unit the dispatch-count regression tests assert O(1) per step on."""
    key = (("site", site),)
    v = XLA_DISPATCH_TOTAL._values
    v[key] = v.get(key, 0.0) + count


def record_kv(kind: str, nbytes: int, count: int = 1):
    """kvstore traffic accounting: kind in {push, pull, pushpull}."""
    if kind == "push":
        tot, byt = KV_PUSH_TOTAL, KV_PUSH_BYTES
    elif kind == "pull":
        tot, byt = KV_PULL_TOTAL, KV_PULL_BYTES
    else:
        KV_PUSHPULL_TOTAL.inc(count)
        return
    tot.inc(count)
    byt.inc(nbytes)


def record_allreduce(dt: float, nbytes: int):
    KV_ALLREDUCE_SECONDS.observe(dt)
    KV_ALLREDUCE_BYTES.inc(nbytes)
    _TRACER.record("kvstore.allreduce", cat="comms",
                   ts=_time.perf_counter() - dt, dur=dt,
                   args={"bytes": nbytes})


def record_engine_wait(path: str, dt: float):
    key = (("path", path),)
    v = ENGINE_WAIT_TOTAL._values
    v[key] = v.get(key, 0.0) + 1
    s = ENGINE_WAIT_SECONDS._values
    s[key] = s.get(key, 0.0) + dt


def record_trainer_step(t0: float, t1: float, grad_norm=None):
    """One Trainer.step: advances the tracer step, records the span."""
    dt = t1 - t0
    TRAINER_STEP_TOTAL.inc()
    TRAINER_STEP_SECONDS.observe(dt)
    if grad_norm is not None:
        # lazy: the fused step hands a device scalar; it syncs only when
        # the gauge is read (value()/exposition), never per step
        TRAINER_GRAD_NORM.set_lazy(grad_norm)
    step = _TRACER.mark_step()
    args = {"step": step}
    if isinstance(grad_norm, float):
        # only plain floats go into the ring buffer: storing a lazy
        # device scalar per event would pin one live device buffer per
        # step for the lifetime of the 65536-event ring (the gauge above
        # keeps the latest lazy value; trace events just omit it)
        args["grad_norm"] = grad_norm
    _TRACER.record("trainer.step", cat="trainer", ts=t0, dur=dt, args=args)
    if attribution.ENABLED:
        attribution.record_step(t0, t1, site="trainer")


def record_superstep(k: int, t0: float, t1: float, grad_norm=None):
    """One K-step superstep dispatch: counts K iterations, observes the
    AMORTIZED per-step time, and advances the tracer step by K (host
    telemetry runs once per superstep — K-step cadence by design)."""
    dt = t1 - t0
    SUPERSTEP_TOTAL.inc(1, k=str(k))
    SUPERSTEP_ITERATIONS_TOTAL.inc(k)
    SUPERSTEP_STEP_SECONDS.observe(dt / max(k, 1))
    if grad_norm is not None:
        # lazy device scalar from the scan's last iteration — syncs only
        # at gauge-read time, never per superstep
        TRAINER_GRAD_NORM.set_lazy(grad_norm)
    step = None
    for _ in range(k):
        step = _TRACER.mark_step()
    _TRACER.record("trainer.superstep", cat="trainer", ts=t0, dur=dt,
                   args={"k": int(k), "step": step})
    if attribution.ENABLED:
        attribution.record_step(t0, t1, k=k, site="superstep")


def record_superstep_series(losses, gnorms=None, overflows=None):
    """Publish the per-iteration device series one superstep dispatch
    produced (scan ys: loss, in-graph grad norm, fp16 overflow flag).
    The arrays are stored WHOLE and LAZY — no slicing, no sync, zero
    added dispatches on the hot path; elements materialize only when a
    series gauge is read (summary/exposition/``superstep_series()``).
    This is what keeps K-step capture at per-step metric cadence."""
    SUPERSTEP_ITER_LOSS.set_series(losses)
    if gnorms is not None:
        SUPERSTEP_ITER_GRAD_NORM.set_series(gnorms)
    if overflows is not None:
        SUPERSTEP_ITER_OVERFLOW.set_series(overflows)


def superstep_series() -> dict:
    """The last superstep's per-iteration metrics as plain float lists
    (one device sync per series, here at read time): ``{"loss": [...],
    "grad_norm": [...], "overflow": [...]}`` — empty lists before the
    first superstep (or for series the capture did not produce)."""
    return {"loss": SUPERSTEP_ITER_LOSS.series(),
            "grad_norm": SUPERSTEP_ITER_GRAD_NORM.series(),
            "overflow": SUPERSTEP_ITER_OVERFLOW.series()}


def record_amp_scale(scale, overflow_total, overflow: bool):
    """One host-side loss-scale update (the eager AMP fallback — the
    fused step sets the gauges lazily via ``record_amp_lazy`` instead
    and emits no per-step trace event, keeping zero syncs)."""
    AMP_LOSS_SCALE.set(scale)
    AMP_OVERFLOW_TOTAL.set(float(overflow_total))
    _TRACER.record("amp.scale_update", cat="amp", ts=_time.perf_counter(),
                   dur=0.0, args={"scale": float(scale),
                                  "overflow_total": int(overflow_total),
                                  "overflow": bool(overflow)})


def record_amp_lazy(scale, overflow_total):
    """Fused-step AMP accounting: both values are device scalars stored
    WITHOUT syncing (they materialize at gauge-read time)."""
    AMP_LOSS_SCALE.set_lazy(scale)
    AMP_OVERFLOW_TOTAL.set_lazy(overflow_total)


def record_compile(block: str, dt: float, cause=None):
    """One CachedGraph build (gluon/block.py)."""
    CACHEDOP_COMPILE_TOTAL.inc(1, block=block)
    CACHEDOP_TRACE_SECONDS.inc(dt, block=block)
    if cause:
        CACHEDOP_RETRACE_TOTAL.inc(1, block=block, cause=cause)
    _TRACER.record(f"cachedop.compile[{block}]", cat="compile",
                   ts=_time.perf_counter() - dt, dur=dt,
                   args={"cause": cause or "first"})


def record_h2d(nbytes: int, dt: float, depth: int):
    """One prefetched batch staged to device (gluon/data/prefetcher.py)."""
    DATA_PREFETCH_BATCHES.inc()
    DATA_H2D_BYTES.inc(nbytes)
    DATA_H2D_SECONDS.observe(dt)
    DATA_PREFETCH_QUEUE_DEPTH.set(depth)
    _TRACER.record("data.h2d", cat="io", ts=_time.perf_counter() - dt,
                   dur=dt, args={"bytes": nbytes, "queue_depth": depth})


def record_stream_read(shard: str, nbytes: int, dt: float):
    """One storage read op by the streaming shard reader
    (gluon/data/stream.py ShardIndex.read)."""
    STREAM_READ_BYTES.inc(nbytes, shard=shard)
    STREAM_READ_SECONDS.inc(dt, shard=shard)
    STREAM_RECORDS_TOTAL.inc(1, shard=shard)


def record_stream_decode(dt: float):
    """One record decoded by the stream decode pool (busy time)."""
    STREAM_DECODE_SECONDS.inc(dt)


def record_stream_batch(wait: float, reorder_depth: int):
    """One batch delivered by StreamReader: consumer-wait accounting
    + the per-batch trace span telemetry_report joins against steps.
    Every 16th batch also emits a ``stream.stats`` instant carrying
    the cumulative per-shard read totals and decode-pool busy/wait so
    an exported trace is self-contained for the Input-pipeline
    section (registry counters don't travel with the JSONL)."""
    STREAM_BATCHES_TOTAL.inc()
    STREAM_CONSUMER_WAIT_SECONDS.inc(wait)
    STREAM_QUEUE_DEPTH.set(reorder_depth, queue="reorder")
    _TRACER.record("stream.batch", cat="io",
                   ts=_time.perf_counter() - wait, dur=wait,
                   args={"consumer_wait": wait,
                         "reorder_depth": reorder_depth})
    n = STREAM_BATCHES_TOTAL.total()
    if n % 16 == 1:
        per_shard = {}
        for labels in STREAM_READ_BYTES.labelsets():
            shard = labels.get("shard", "-")
            per_shard[shard] = {
                "bytes": STREAM_READ_BYTES.value(**labels),
                "seconds": STREAM_READ_SECONDS.value(**labels),
                "records": STREAM_RECORDS_TOTAL.value(**labels)}
        _TRACER.record(
            "stream.stats", cat="io", ph="i",
            args={"per_shard": per_shard,
                  "decode_busy": STREAM_DECODE_SECONDS.total(),
                  "decode_wait": STREAM_DECODE_WAIT_SECONDS.total(),
                  "consumer_wait": STREAM_CONSUMER_WAIT_SECONDS.total(),
                  "depth_raw": STREAM_QUEUE_DEPTH.value(queue="raw"),
                  "depth_reorder": reorder_depth,
                  "batches": n})


def record_ckpt_tick(dt: float):
    """In-LOOP checkpoint entry cost (resilience/checkpoint.py on_step:
    interval bookkeeping + snapshot dispatch + writer-queue handoff) —
    the slice the attribution plane charges to ckpt_overhead."""
    CHECKPOINT_TICK_SECONDS.inc(dt)
    _TRACER.record("checkpoint.tick", cat="resilience",
                   ts=_time.perf_counter() - dt, dur=dt)


def record_serve_batch(model: str, bucket, n_valid: int, capacity: int,
                       dt: float, depth: int, span_id=None):
    """One continuous-batching dispatch (serving/): batch-fill
    + queue-depth accounting and the per-batch trace span. ``span_id``
    (minted by the engine) parents the batch's per-request phase
    spans."""
    fill = n_valid / max(capacity, 1)
    SERVE_BATCHES_TOTAL.inc(1, model=model, bucket=str(bucket))
    SERVE_BATCH_FILL.observe(fill, model=model)
    SERVE_QUEUE_DEPTH.set(depth, model=model)
    _TRACER.record("serving.batch", cat="serving",
                   ts=_time.perf_counter() - dt, dur=dt, span_id=span_id,
                   args={"model": model, "bucket": str(bucket),
                         "n_valid": int(n_valid), "capacity": int(capacity),
                         "fill": round(fill, 4), "queue_depth": int(depth)})


def record_serve_request(model: str, code: str, latency=None):
    """Terminal accounting for one serving request. ``code`` is the
    typed outcome (ok / shed / timeout / too_large / error / closed);
    ``latency`` (submit -> result, seconds) only accompanies ok."""
    SERVE_REQUESTS_TOTAL.inc(1, model=model, code=code)
    if latency is not None:
        SERVE_LATENCY_SECONDS.observe(latency, model=model)
    if code == "shed":
        SERVE_SHED_TOTAL.inc(1, model=model)
        _TRACER.instant("serving.shed", cat="serving", model=model)
    elif code == "timeout":
        SERVE_TIMEOUT_TOTAL.inc(1, model=model)
        _TRACER.instant("serving.timeout", cat="serving", model=model)


def record_serve_swap(model: str, outcome: str, version=None,
                      prev_version=None):
    """One ModelRepository version transition (committed / rolled_back /
    aborted)."""
    SERVE_SWAPS_TOTAL.inc(1, model=model, outcome=outcome)
    _TRACER.instant("serving.swap", cat="serving", model=model,
                    outcome=outcome, version=str(version),
                    prev_version=str(prev_version))


def record_serve_submit(model: str, req_id: int):
    """Request-id birth: one instant event at ``submit`` so the id is
    traceable from ingress, before any batcher thread touches it."""
    _TRACER.instant("serving.submit", cat="serving", model=model,
                    req=int(req_id))


def record_serve_phases(model: str, req_id: int, t_submit: float,
                        phases: dict, parent=None):
    """Per-request phase decomposition (queue-wait -> batch-assembly ->
    dispatch -> slice-out): observes each phase into
    ``mxtpu_serving_phase_seconds`` and records one ``serving.request``
    child span carrying the request id + its parent batch span id —
    the correlated-trace leg that makes p99 decomposable."""
    args = {"model": model, "req": int(req_id)}
    if parent is not None:
        args["parent"] = int(parent)
    total = 0.0
    for phase, dur in phases.items():
        if dur is None:
            continue
        dur = max(float(dur), 0.0)
        total += dur
        SERVE_PHASE_SECONDS.observe(dur, model=model, phase=phase)
        args[f"{phase}_ms"] = round(dur * 1e3, 3)
    _TRACER.record("serving.request", cat="serving", ts=t_submit,
                   dur=total, args=args)


def record_fleet_states(model: str, counts: dict):
    """Publish the fleet's replica census: ``counts`` maps health state
    (live / suspect / dead / warm) -> replica count. States absent from
    ``counts`` are zeroed so a recovered fleet stops advertising dead
    rows."""
    for state in ("live", "suspect", "dead", "warm"):
        FLEET_REPLICAS.set(float(counts.get(state, 0)), model=model,
                           state=state)


def record_fleet_brownout(model: str, level: int, prev: int):
    """One brownout state-machine transition: the latched level gauge
    plus a loud trace instant (direction says entering vs draining)."""
    FLEET_BROWNOUT.set(float(level), model=model)
    _TRACER.instant("fleet.brownout", cat="serving", model=model,
                    level=int(level), prev=int(prev),
                    direction="enter" if level > prev else "exit")


def record_fleet_autoscale(model: str, action: str, n: int):
    """One autoscaler actuation (grow / shrink / replace / to_zero /
    restore) with the resulting replica target."""
    FLEET_AUTOSCALE_TOTAL.inc(1, model=model, action=action)
    _TRACER.instant("fleet.autoscale", cat="serving", model=model,
                    action=action, target=int(n))


def serve_phase_snapshot(model: str) -> dict:
    """p50/p99 per phase for ``model`` from the request-span histogram
    (empty until the engine served its first batch)."""
    out = {}
    for phase in ("queue", "batch", "dispatch", "slice"):
        n = SERVE_PHASE_SECONDS.value(model=model, phase=phase)
        if not n:
            continue
        out[phase] = {
            "p50_s": SERVE_PHASE_SECONDS.quantile(0.5, model=model,
                                                  phase=phase),
            "p99_s": SERVE_PHASE_SECONDS.quantile(0.99, model=model,
                                                  phase=phase),
            "count": n,
        }
    return out


def serve_slo_snapshot(model: str) -> dict:
    """p50/p99 latency + request/batch counters for ``model`` as plain
    floats (reads the histograms — off the hot path by construction)."""
    p50 = SERVE_LATENCY_SECONDS.quantile(0.5, model=model)
    p99 = SERVE_LATENCY_SECONDS.quantile(0.99, model=model)
    n = SERVE_BATCH_FILL.value(model=model)
    return {
        "model": model,
        "requests_ok": SERVE_REQUESTS_TOTAL.value(model=model, code="ok"),
        "latency_p50_s": p50,
        "latency_p99_s": p99,
        "latency_count": SERVE_LATENCY_SECONDS.value(model=model),
        "batches": n,
        "mean_batch_fill": (SERVE_BATCH_FILL.sum(model=model) / n) if n else None,
        "shed": SERVE_SHED_TOTAL.value(model=model),
        "timeouts": SERVE_TIMEOUT_TOTAL.value(model=model),
        "compiles": SERVE_COMPILE_TOTAL.value(model=model),
        "phases": serve_phase_snapshot(model),
    }


# ---------------------------------------------------------------------------
# exporters / summaries
# ---------------------------------------------------------------------------

def dump_prometheus() -> str:
    """Prometheus text exposition of the whole registry."""
    return _REGISTRY.dump_prometheus()


def dump_chrome_trace(path=None) -> str:
    return _TRACER.dump_chrome_trace(path)


def dump_jsonl(path=None) -> str:
    return _TRACER.dump_jsonl(path)


def summary() -> str:
    """Human-readable snapshot of the key run metrics (the per-epoch
    body logged by the estimator handler / callback hook)."""
    lines = ["telemetry summary:"]
    n_ops = OP_DISPATCH_TOTAL.total()
    if n_ops:
        top = sorted(OP_DISPATCH_SECONDS._values.items(),
                     key=lambda kv: kv[1], reverse=True)[:5]
        lines.append(f"  op dispatches: {int(n_ops)} "
                     f"({OP_DISPATCH_SECONDS.total() * 1e3:.2f} ms dispatch)")
        for key, secs in top:
            name = dict(key).get("op", "?")
            cnt = int(OP_DISPATCH_TOTAL._values.get(key, 0))
            lines.append(f"    {name:<28}{cnt:>8} calls"
                         f"{secs * 1e3:>12.3f} ms")
    compiles = CACHEDOP_COMPILE_TOTAL.total()
    if compiles or CACHEDOP_CACHE_HITS.total():
        lines.append(
            f"  cachedop: {int(compiles)} compiles, "
            f"{int(CACHEDOP_CACHE_HITS.total())} cache hits, "
            f"{CACHEDOP_TRACE_SECONDS.total() * 1e3:.1f} ms tracing, "
            f"{int(CACHEDOP_RETRACE_TOTAL.total())} retraces")
    if KV_PUSH_TOTAL.total() or KV_PULL_TOTAL.total() \
            or KV_PUSHPULL_TOTAL.total():
        lines.append(
            f"  kvstore: {int(KV_PUSH_TOTAL.total())} pushes "
            f"({int(KV_PUSH_BYTES.total())} B), "
            f"{int(KV_PULL_TOTAL.total())} pulls "
            f"({int(KV_PULL_BYTES.total())} B), "
            f"{int(KV_PUSHPULL_TOTAL.total())} pushpulls, "
            f"{int(KV_BARRIER_TOTAL.total())} barriers")
    staged = DATA_PREFETCH_BATCHES.total()
    if staged:
        lines.append(
            f"  input pipeline: {int(staged)} batches staged "
            f"({int(DATA_H2D_BYTES.total())} B h2d, "
            f"{DATA_PREFETCH_WAIT_SECONDS.total() * 1e3:.1f} ms "
            f"consumer wait)")
    cc_h, cc_m = COMPILE_CACHE_HITS.total(), COMPILE_CACHE_MISSES.total()
    if cc_h or cc_m:
        lines.append(f"  compile cache: {int(cc_h)} hits, {int(cc_m)} misses")
    ss = SUPERSTEP_TOTAL.total()
    if ss:
        iters = SUPERSTEP_ITERATIONS_TOTAL.total()
        mean_ms = (SUPERSTEP_STEP_SECONDS.sum() / max(ss, 1)) * 1e3
        lines.append(
            f"  superstep: {int(ss)} dispatches covering {int(iters)} "
            f"steps ({iters / ss:.1f} steps/dispatch, "
            f"{mean_ms:.2f} ms/step amortized)")
    steps = TRAINER_STEP_TOTAL.total()
    if steps:
        mean_ms = TRAINER_STEP_SECONDS.sum() / max(steps, 1) * 1e3
        lines.append(f"  trainer: {int(steps)} steps, "
                     f"{mean_ms:.2f} ms/step mean, "
                     f"last grad norm {TRAINER_GRAD_NORM.value():.4g}")
    if AMP_LOSS_SCALE._values or AMP_OVERFLOW_TOTAL._values:
        lines.append(
            f"  amp: loss scale {AMP_LOSS_SCALE.value():.4g}, "
            f"{int(AMP_OVERFLOW_TOTAL.value())} overflows (skipped steps)")
    waits = ENGINE_WAIT_TOTAL.total()
    if waits:
        lines.append(
            f"  engine.wait: {int(waits)} probes, "
            f"{ENGINE_WAIT_SECONDS.total() * 1e3:.1f} ms blocked")
    if len(lines) == 1:
        lines.append("  (no events recorded)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# performance introspection / crash flight recorder / scrape endpoint
# (submodules bind as attributes: observability.introspect / .flight)
# ---------------------------------------------------------------------------

from . import flight  # noqa: E402,F401
from . import introspect  # noqa: E402,F401
from .introspect import (  # noqa: E402,F401
    cost_table,
    mfu_estimate,
    profile_window,
)
from .serve import (  # noqa: E402,F401
    metrics_port,
    serve_metrics,
    stop_metrics_server,
)
from . import federation  # noqa: E402,F401
from . import watchdog  # noqa: E402,F401
from . import attribution  # noqa: E402,F401

# MXTPU_DUMP_ON_CRASH: hooks install at import (opt-in via env only —
# without the var this is a dict read and nothing else)
flight.maybe_install()


def __getattr__(name):
    # TelemetryHandler subclasses the estimator's event mixins, and the
    # port has no gluon.contrib.estimator yet (ROADMAP A13 (d))
    if name == "TelemetryHandler":
        raise AttributeError(
            "observability.TelemetryHandler needs gluon.contrib.estimator, "
            "which the port does not have yet (ROADMAP A13 (d)); "
            "callback.TelemetryLogger logs the same summary")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
