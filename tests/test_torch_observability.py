"""The port's telemetry layer (``mxnet_tpu_torch.observability``) against
the JAX package's (``mxnet_tpu.observability``), host side, exact.

- The metric catalog: the reference's 119 metrics under the same names,
  types, histogram buckets and help texts; the metrics whose reference
  counts an XLA artefact (``PORT_HELP``) say in their help what they
  count in the port instead.
- The registry, the tracer and every ``record_*`` helper: the same
  operations give the same ``dump_prometheus()`` text, the same trace
  events but for their time fields, the same ``summary()``;
  ``tools/telemetry_report.py`` reads the port's JSONL.
- The live sites: a small hybridized MLP trained 3 steps with a
  ``device`` kvstore in both packages with telemetry on gives the same
  event counters (``LIVE_EQUAL``); the families compared only by
  presence are ``LIVE_PRESENT``, each with its reason.
- With telemetry off nothing is recorded; the scrape endpoint serves
  ``/metrics`` and ``/healthz``; introspection counts a site's FLOPs.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import observability as jobs
from mxnet_tpu_torch import observability as obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: metrics whose reference help names an XLA artefact; the port's says
#: what it counts (a CUDA-graph replay, torch's FLOP counter and memory
#: statistics, no persistent compile cache, no donation)
PORT_HELP = {
    "mxtpu_xla_dispatch_total", "mxtpu_compile_cache_hit_total",
    "mxtpu_compile_cache_miss_total", "mxtpu_executable_flops",
    "mxtpu_executable_bytes_accessed", "mxtpu_executable_temp_bytes",
    "mxtpu_executable_argument_bytes", "mxtpu_executable_output_bytes",
    "mxtpu_executable_alias_bytes", "mxtpu_donation_unaliased_total",
    "mxtpu_decode_chunks_total", "mxtpu_serving_compile_total"}


@pytest.fixture(autouse=True)
def both_clean():
    prev = obs.set_enabled(True), jobs.set_enabled(True)
    obs.reset()
    jobs.reset()
    obs.attribution.reset()
    jobs.attribution.reset()
    yield
    obs.set_enabled(prev[0])
    jobs.set_enabled(prev[1])
    obs.reset()
    jobs.reset()


def _kind(m):
    return type(m).__name__


def _catalog_metrics(o):
    """The metrics the module defines (the registry may also hold ones a
    test process registered itself)."""
    kinds = (o.Counter, o.Gauge, o.Histogram, o.SeriesGauge)
    return {m.name: m for m in vars(o).values() if isinstance(m, kinds)}


def _catalog(o):
    return {name: (_kind(m), m.help, tuple(getattr(m, "buckets", ())))
            for name, m in _catalog_metrics(o).items()}


def test_catalog_equals_the_reference():
    got, want = _catalog(obs), _catalog(jobs)
    assert len(want) == 119 and sorted(got) == sorted(want)
    for name in want:
        assert got[name][0] == want[name][0], name
        assert got[name][2] == want[name][2], name
        if name in PORT_HELP:
            assert got[name][1] != want[name][1], name
        else:
            assert got[name][1] == want[name][1], name


def _registry_script(metrics):
    reg = metrics.MetricsRegistry()
    c = reg.counter("t_requests_total", "requests")
    g = reg.gauge("t_depth", "queue depth")
    h = reg.histogram("t_latency_seconds", "latency")
    hb = reg.histogram("t_fill", "fill", buckets=(0.25, 0.5, 1.0))
    s = reg.series_gauge("t_iter_loss", "per-iteration loss")
    c.inc()
    c.inc(2, model="a", code="ok")
    c.inc(1, model='b"q\\', code="shed")
    g.set(3.5)
    g.set(7, model="a")
    g.set_lazy(torch.tensor(2.25), model="lazy")
    for v in (0.0001, 0.003, 0.04, 0.7, 12.0, 100.0):
        h.observe(v)
        h.observe(v * 2, model="a")
    for v in (0.1, 0.3, 0.3, 0.9, 1.5):
        hb.observe(v)
    s.set_series(torch.tensor([1.0, 0.5, 0.25]))
    quant = [h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)] + \
        [hb.quantile(q) for q in (0.5, 0.99)]
    return reg.dump_prometheus(), quant, c.total(), h.sum(model="a")


def test_registry_operations_give_identical_exposition():
    from mxnet_tpu.observability import metrics as jmetrics
    from mxnet_tpu_torch.observability import metrics

    got = _registry_script(metrics)
    want = _registry_script(jmetrics)
    assert got == want
    assert "t_fill_bucket" in got[0] and 't_iter_loss{slot="2"}' in got[0]


def _events(o):
    """The trace events but for their times and ids (the ids count every
    event a process recorded)."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "id")}
            for e in o.tracer().events()]


def _tracer_script(o):
    with o.span("trainer.step", cat="trainer", step=1):
        pass
    o.tracer().instant("serving.shed", cat="serving", model="m")
    o.tracer().record("kvstore.allreduce", cat="comms", ts=1.0, dur=0.5,
                      args={"bytes": 64})
    o.tracer().mark_step()
    sid = o.tracer().new_span_id()
    o.tracer().record("serving.batch", cat="serving", ts=2.0, dur=0.1,
                      span_id=sid, args={"n": 3})
    with o.span("cachedop.compile[net]", cat="compile"):
        pass


def test_tracer_gives_the_same_events_but_time(tmp_path):
    _tracer_script(obs)
    _tracer_script(jobs)
    assert _events(obs) == _events(jobs)
    assert len(_events(obs)) == 5
    path = str(tmp_path / "t.jsonl")
    obs.dump_jsonl(path)
    assert [{k: v for k, v in e.items() if k not in ("ts", "dur", "id")}
            for e in jobs.load_jsonl(path)] == _events(jobs)
    chrome = json.loads(obs.dump_chrome_trace())
    assert len(chrome["traceEvents"]) == 5


def test_telemetry_report_reads_the_port_jsonl(tmp_path):
    for _ in range(3):
        with obs.span("trainer.step", cat="trainer"):
            pass
    with obs.span("cachedop.compile[net]", cat="compile"):
        pass
    path = str(tmp_path / "t.jsonl")
    obs.dump_jsonl(path)
    tool = os.path.join(ROOT, "tools", "telemetry_report.py")
    res = subprocess.run([sys.executable, tool, path, "--steps"],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("trainer.step")][0]
    assert int(line.split()[1]) == 3


def _helpers_script(o):
    """Every record helper once or twice, with fixed times."""
    o.record_op_dispatch("dot", 0.001)
    o.record_op_dispatch("relu", 0.0005)
    o.record_xla_dispatch("cachedop_fwd", 2)
    o.record_kv("push", 4096, count=3)
    o.record_kv("pull", 2048)
    o.record_kv("pushpull", 0, count=3)
    o.record_allreduce(0.002, 1024)
    o.record_engine_wait("native", 0.003)
    o.record_trainer_step(10.0, 10.02, 1.5)
    o.record_trainer_step(10.03, 10.05, 1.25)
    o.record_superstep(4, 11.0, 11.08)
    o.record_superstep_series([1.0, 0.9, 0.8, 0.7], [2.0, 1.0, 1.0, 0.5],
                              [0.0, 0.0, 1.0, 0.0])
    o.record_amp_scale(1024.0, 2, True)
    o.record_compile("net", 0.25, None)
    o.record_compile("net", 0.1, "shapes")
    o.record_h2d(1 << 20, 0.004, 2)
    o.record_ckpt_tick(0.006)
    o.record_serve_batch("bert", 128, 3, 8, 0.012, 4)
    for code in ("ok", "ok", "shed", "timeout", "too_large"):
        o.record_serve_request("bert", code,
                               latency=0.02 if code == "ok" else None)
    o.record_serve_swap("bert", "committed", version=2, prev_version=1)
    o.record_serve_phases("bert", 7, 20.0, {"queue": 0.001,
                                            "batch": 0.0002,
                                            "dispatch": 0.01,
                                            "slice": 0.0003})
    o.record_pipeline_schedule("1f1b", 0.25, 2, ticks=10)
    o.record_moe_probe({"serial": 0.01, "chunked": 0.004}, 0.6)
    o.record_overlap_probe({"staged": 0.02, "ready": 0.005}, 0.75)
    o.ELASTIC_RESIZES_TOTAL.inc(1, reason="chaos")
    o.ELASTIC_WORLD_SIZE.set(2)
    return (o.dump_prometheus(), o.summary(),
            o.serve_slo_snapshot("bert"), o.superstep_series())


def _family(line, names):
    """The metric family an exposition line belongs to."""
    if line.startswith("# "):
        return line.split()[2]
    name = line.split("{")[0].split(" ")[0]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[:-len(suffix)] in names:
            return name[:-len(suffix)]
    return name


def _catalog_exposition(o, text):
    """The exposition of the module's own metrics (no other family a test
    process registered), but for the HELP lines of ``PORT_HELP`` (checked
    by the catalog test)."""
    names = set(_catalog_metrics(o))
    return "\n".join(ln for ln in text.splitlines()
                     if _family(ln, names) in names
                     and not (ln.startswith("# HELP ")
                              and ln.split()[2] in PORT_HELP))


def test_record_helpers_give_identical_exposition_and_summary():
    got, want = _helpers_script(obs), _helpers_script(jobs)
    assert _catalog_exposition(obs, got[0]) == \
        _catalog_exposition(jobs, want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert "mxtpu_serving_phase_seconds_bucket" in got[0]
    assert _events(obs) == _events(jobs)


def _mlp(mxmod, ctx):
    from_nn = mxmod.gluon.nn
    net = from_nn.HybridSequential()
    net.add(from_nn.Dense(16, activation="relu", in_units=8))
    net.add(from_nn.Dense(4, in_units=16))
    net.initialize(mxmod.initializer.Constant(0.01), **ctx)
    net.hybridize()
    return net


def _live_counters(mxmod, o, tmp_path, ctx):
    net = _mlp(mxmod, ctx)
    tr = mxmod.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1}, kvstore="device")
    mgr = mxmod.resilience.CheckpointManager(
        str(tmp_path), every_n_steps=2, net=net, trainer=tr,
        install_sigterm=False).attach(tr)
    lf = mxmod.gluon.loss.SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(0)
    x = mxmod.nd.array(rs.rand(6, 8).astype(np.float32), **ctx)
    y = mxmod.nd.array(rs.randint(0, 4, (6,)).astype(np.float32), **ctx)
    try:
        for _ in range(3):
            with mxmod.autograd.record():
                loss = lf(net(x), y)
            loss.backward()
            tr.step(6)
        mgr.flush(timeout=60)
    finally:
        mgr.close()
    return {
        "compiles": o.CACHEDOP_COMPILE_TOTAL.total(),
        "cache_hits": o.CACHEDOP_CACHE_HITS.total(),
        "retraces": o.CACHEDOP_RETRACE_TOTAL.total(),
        "trainer_steps": o.TRAINER_STEP_TOTAL.total(),
        "step_observations": o.TRAINER_STEP_SECONDS.value(),
        "kv_push": o.KV_PUSH_TOTAL.total(),
        "kv_push_bytes": o.KV_PUSH_BYTES.total(),
        "kv_pull": o.KV_PULL_TOTAL.total(),
        "kv_pull_bytes": o.KV_PULL_BYTES.total(),
        "kv_pushpull": o.KV_PUSHPULL_TOTAL.total(),
        "checkpoints": o.CHECKPOINT_TOTAL.total(),
        "checkpoint_last_step": o.CHECKPOINT_LAST_STEP.value(),
        "ckpt_ticks": int(o.CHECKPOINT_TICK_SECONDS.total() > 0),
        "trace_steps": o.tracer().step,
        "_present": {
            "checkpoint_bytes": o.CHECKPOINT_BYTES_TOTAL.total(),
            "grad_norm": o.TRAINER_GRAD_NORM.value(),
            "op_dispatch": o.OP_DISPATCH_TOTAL.total(),
            "dispatch_sites": sorted(
                ls.get("site") for ls in o.XLA_DISPATCH_TOTAL.labelsets()),
            "phase_records": len(o.attribution.records()),
        },
    }


#: event counters equal between the packages
LIVE_EQUAL = ("compiles", "cache_hits", "retraces", "trainer_steps",
              "step_observations", "kv_push", "kv_push_bytes", "kv_pull",
              "kv_pull_bytes", "kv_pushpull", "checkpoints",
              "checkpoint_last_step", "ckpt_ticks",
              "trace_steps")
#: compared by presence only, and why
LIVE_PRESENT = {
    # each package's checkpoint writes its own extras (the port's carry
    # torch's random state and the fused update's counters)
    "checkpoint_bytes": "each package's own payload",
    # the same norm of different float32 gradients' sums: within 1e-5
    "grad_norm": "a float of the summed gradients, to float32 rounding",
    # the port runs a hybridized block's ops inside its captured graph
    # (or eagerly through torch, never through nd dispatch), the
    # reference its own op set: how many nd ops a loop dispatches is
    # each package's own
    "op_dispatch": "each package's own op dispatches",
    # an XLA executable per site against a replay or eager call: the
    # sites differ in count (the reference's fused update folds the
    # cached backward in)
    "dispatch_sites": "sites named as the reference's, counted per call",
    # one attribution record a step in both; its phase seconds are time
    "phase_records": "one a step; the seconds are time",
}


def test_live_sites_count_the_same_events(tmp_path):
    got = _live_counters(mx, obs, tmp_path / "port", {"ctx": mx.cpu()})
    want = _live_counters(jmx, jobs, tmp_path / "ref", {})
    for key in LIVE_EQUAL:
        assert got[key] == want[key], (key, got[key], want[key])
    # one context: the Trainer sums nothing through the store in either
    # package (``test_kvstore_accounting`` drives the store itself)
    assert got["trainer_steps"] == 3 and got["checkpoints"] == 1
    p, w = got["_present"], want["_present"]
    assert set(p) == set(LIVE_PRESENT)
    np.testing.assert_allclose(p["grad_norm"], w["grad_norm"], rtol=1e-5)
    assert p["checkpoint_bytes"] > 0 and w["checkpoint_bytes"] > 0
    assert p["op_dispatch"] >= 0 and w["op_dispatch"] >= 0
    assert set(p["dispatch_sites"]) <= {"cachedop_fwd", "cachedop_bwd",
                                        "trainer_fused", "kv_grouped",
                                        "kv_bucket", "op"}
    assert "trainer_fused" in p["dispatch_sites"]
    assert p["phase_records"] == w["phase_records"] == 3


def _kv_script(mxmod, o, ctx):
    kv = mxmod.kv.create("device")
    shape = (4, 5)  # float32: 80 bytes
    kv.init(3, mxmod.nd.ones(shape, **ctx))
    kv.push(3, mxmod.nd.ones(shape, **ctx))
    out = mxmod.nd.zeros(shape, **ctx)
    kv.pull(3, out=out)
    kv.push(3, [mxmod.nd.ones(shape, **ctx), mxmod.nd.ones(shape, **ctx)])
    kv.init(["a", "b"], [mxmod.nd.ones((2, 8), **ctx),
                         mxmod.nd.ones((3,), **ctx)])
    g = [mxmod.nd.ones((2, 8), **ctx), mxmod.nd.ones((3,), **ctx)]
    kv.pushpull(["a", "b"], g, out=g)
    kv.pushpull("a", g[0], out=g[0])
    return [m.total() for m in (o.KV_PUSH_TOTAL, o.KV_PUSH_BYTES,
                                o.KV_PULL_TOTAL, o.KV_PULL_BYTES,
                                o.KV_PUSHPULL_TOTAL)]


def test_kvstore_accounting():
    got = _kv_script(mx, obs, {"ctx": mx.cpu()})
    assert got == _kv_script(jmx, jobs, {})
    assert got == [5, 80 + 160 + 76 + 64, 4, 80 + 76 + 64, 3]


def test_disabled_path_records_nothing(tmp_path):
    obs.set_enabled(False)
    _live_counters(mx, obs, tmp_path, {"ctx": mx.cpu()})
    assert all(not m._values for m in obs.registry().metrics())
    assert len(obs.tracer()) == 0


def test_elastic_resize_writes_the_telemetry():
    from mxnet_tpu_torch.resilience import chaos, elastic

    net = _mlp(mx, {"ctx": mx.cpu()})
    chaos.configure("resize:2:1")
    et = elastic.ElasticTrainer(net, mx.gluon.loss.L2Loss(), "sgd", {})
    x = mx.nd.ones((2, 8), ctx=mx.cpu())
    y = mx.nd.ones((2, 4), ctx=mx.cpu())
    try:
        for _ in range(3):
            et.step(x, y)
    finally:
        chaos.reset()
        et.close()
    # a pool of one: the target is the topology already, no resize
    assert et.resize_events == []
    assert obs.ELASTIC_WORLD_SIZE.value() == 1.0
    assert obs.CHAOS_INJECTIONS_TOTAL.value(kind="resize",
                                            site="elastic") == 1.0


def test_scrape_endpoint_serves_metrics_and_health():
    obs.KV_BARRIER_TOTAL.inc(3)
    port = obs.serve_metrics(0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{port}"
        body = urllib.request.urlopen(base + "/metrics", timeout=10) \
            .read().decode()
        assert "mxtpu_kvstore_barrier_total 3" in body
        assert urllib.request.urlopen(base + "/healthz",
                                      timeout=10).status == 200
        assert obs.metrics_port() == port
    finally:
        obs.stop_metrics_server()
    obs.stop_metrics_server()  # idempotent
    assert obs.metrics_port() is None


def test_introspect_counts_a_sites_flops():
    from mxnet_tpu_torch.ops import _kernels

    intro = obs.introspect
    prev = intro.set_enabled(True)
    intro.reset()
    try:
        a, b = torch.randn(16, 32), torch.randn(32, 8)
        with intro.site("probe"):
            (a @ b).relu()
            _kernels.note_flops(1000)  # a hand-written kernel's count
        with intro.site("probe"):  # registered: not counted again
            a @ b
        rec = intro.site_cost("probe")
        assert rec["flops"] == 2 * 16 * 32 * 8 + 1000
        assert obs.EXEC_FLOPS.value(site="probe") == rec["flops"]
        assert intro.flops_per_step(["probe"]) == (rec["flops"], None)
        assert "probe" in intro.cost_table()
        est = intro.mfu_estimate("probe", 0.001)
        assert est["achieved_tflops"] == pytest.approx(
            rec["flops"] / 0.001 / 1e12)
        assert est["mfu"] is None and "CPU" in est["reason"]
        assert [e for e in obs.tracer().events()
                if e["name"] == "introspect.cost"]
    finally:
        intro.set_enabled(prev)
        intro.reset()


def test_introspect_off_is_one_shared_null_context():
    intro = obs.introspect
    assert not intro.ENABLED
    assert intro.site("a") is intro.site("b")


def test_op_dispatch_counts_by_op_name():
    a = mx.nd.ones((2, 2), ctx=mx.cpu())
    mx.nd.relu(mx.nd.dot(a, a))
    ja = jmx.nd.ones((2, 2))
    jmx.nd.relu(jmx.nd.dot(ja, ja))
    for o in (obs, jobs):
        assert o.OP_DISPATCH_TOTAL.value(op="dot") == 1.0
        assert o.OP_DISPATCH_TOTAL.value(op="relu") == 1.0
        assert o.XLA_DISPATCH_TOTAL.value(site="op") >= 2.0


def test_telemetry_handler_waits_for_the_estimator():
    with pytest.raises(AttributeError, match="A13"):
        obs.TelemetryHandler
