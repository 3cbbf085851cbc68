"""The port's observability, held against the JAX package's.

- the metrics text equals the JAX text for the same instrument
  operations, and the serving series equal the JAX engine's for the same
  script on the same weights;
- ``export_trace`` writes Chrome events of the JAX structure, and an
  incident record has the JAX keys and timeline;
- the ring bound, the dropped counter and the disabled no-op behave as
  the JAX ring does;
- a gateway-driven speculative run exports a trace in which one request
  id links the gateway span to the engine's and scheduler's records, and
  a chaos delay leaves an incident whose timeline ends at the faulted
  site.
"""
import json
import weakref

import numpy as np
import pytest

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.serving import engine as jax_engine_mod
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.utils.deadline import DeadlineExceeded as JaxDeadline
from paddle_tpu_torch.distributed import chaos
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.inference.serving import engine as port_engine_mod
from paddle_tpu_torch.inference.serving.gateway import (GatewayClient,
                                                        ServingGateway)
from paddle_tpu_torch.observability import metrics, trace
from paddle_tpu_torch.utils.deadline import DeadlineExceeded, RequestTimeout
from torch_pairs import pair, prompt


@pytest.fixture
def tracing():
    for t in (trace, jtrace):
        t.trace_clear()
        t.clear_incidents()
        t.enable(True)
    yield
    for t in (trace, jtrace):
        t.enable(False)
        t.trace_clear()
        t.clear_incidents()


def _instrument_ops(m, tag):
    c = m.Counter(f"pt_{tag}_total", "a test counter")
    c.inc()
    c.inc(4, kind="x")
    g = m.Gauge(f"pt_{tag}_gauge", "a gauge")
    g.set(2.5)
    g.inc(0.5)
    g.dec(1.0, kind="y")
    h = m.Histogram(f"pt_{tag}_seconds", "a histogram", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 9.0):
        h.observe(v)
    h.observe(0.2, kind="z")
    with pytest.raises(ValueError):
        c.inc(-1)
    text = m.render_prometheus()
    lines = [ln for ln in text.splitlines() if f"pt_{tag}" in ln]
    snap = {k: v for k, v in m.metrics_snapshot().items()
            if k.startswith(f"pt_{tag}")}
    return lines, snap


def test_metrics_text_equals_the_jax_text_for_the_same_operations():
    want = _instrument_ops(jmetrics, "obsparity")
    got = _instrument_ops(metrics, "obsparity")
    assert got == want
    lines = got[0]
    assert "# TYPE pt_obsparity_total counter" in lines
    assert 'pt_obsparity_seconds_bucket{le="+Inf"} 3' in lines
    assert metrics.render_prometheus() == metrics.render_prometheus()


def test_registry_rejects_kind_conflict_and_takes_a_collector():
    metrics.Counter("pt_obsconflict", "first")
    with pytest.raises(ValueError):
        metrics.Gauge("pt_obsconflict", "second")
    metrics.register_collector(
        "obsunit", lambda: [("pt_obsunit_pull", "gauge", "pulled", {}, 7)])
    try:
        assert "pt_obsunit_pull 7" in metrics.render_prometheus()
    finally:
        metrics.unregister_collector("obsunit")


def test_serving_series_equal_the_jax_engines(monkeypatch):
    """The same script on the same weights, each package's collector
    reading its one engine: the ``pt_serving_*`` lines are equal, except
    the host-time rate and the capture tier's counters (the JAX engine
    lowers, the port runs eagerly on the CPU)."""
    jm, pm = pair(seed=13)
    prompts = [prompt(5, seed=1), prompt(9, seed=2), prompt(20, seed=3)]
    kw = dict(max_batch=2, max_seq_len=64, page_size=8, max_queue=2)
    engines = []
    for mod, cls, model in ((jax_engine_mod, JaxEngine, jm),
                            (port_engine_mod, ServingEngine, pm)):
        eng = cls(model, **kw)
        monkeypatch.setattr(mod, "_ENGINES", weakref.WeakSet([eng]))
        for p in prompts[:2]:
            eng.submit(p, max_new_tokens=4)
        with pytest.raises(Exception, match="max_queue"):
            eng.submit(prompts[2], max_new_tokens=4)
        eng.run()
        engines.append(eng)

    def serving_lines(m):
        return [ln for ln in m.render_prometheus().splitlines()
                if "pt_serving_" in ln and "tokens_per_sec" not in ln
                and "pt_serving_step_" not in ln]

    want, got = serving_lines(jmetrics), serving_lines(metrics)
    assert got == want
    assert 'pt_serving_pressure_shed{engine="0"} 1' in got
    assert 'pt_serving_tokens_generated{engine="0"} 8' in got


def _span_script(t):
    with t.span("outer", rid=7) as sp:
        sp.set(late="attr", ids=(1, np.int64(2)))
        with t.span("inner", rid=7):
            t.event("tick", rid=7)
    t.event("after")


def _normalised(events):
    out = []
    for e in events:
        e = dict(e, args=dict(e["args"]))
        for k in ("ts", "dur", "pid", "tid"):
            e.pop(k, None)
        out.append(e)
    ids = {e["args"]["span_id"]: i for i, e in enumerate(out)}
    for e in out:
        e["args"]["span_id"] = ids[e["args"]["span_id"]]
        if "parent_id" in e["args"]:
            e["args"]["parent_id"] = ids[e["args"]["parent_id"]]
    return out


def test_export_trace_chrome_events_have_the_jax_structure(tracing,
                                                           tmp_path):
    files = []
    for t, name in ((jtrace, "jax.json"), (trace, "port.json")):
        _span_script(t)
        files.append(json.load(open(t.export_trace(str(tmp_path / name)))))
    want, got = files
    assert got.keys() == want.keys() == {"traceEvents", "displayTimeUnit"}
    assert _normalised(got["traceEvents"]) == \
        _normalised(want["traceEvents"])
    evs = got["traceEvents"]
    assert [e["name"] for e in evs] == ["tick", "inner", "outer", "after"]
    assert evs[2]["ph"] == "X" and evs[2]["dur"] >= 0
    assert evs[0]["ph"] == "i" and evs[0]["s"] == "t"
    assert evs[1]["args"]["parent_id"] == evs[2]["args"]["span_id"]
    assert evs[2]["args"]["ids"] == [1, 2]


def test_incident_records_have_the_jax_structure(tracing):
    recs = []
    for t, exc in ((jtrace, JaxDeadline), (trace, DeadlineExceeded)):
        with t.span("some.site", step=3):
            pass
        try:
            raise exc("unit-test wait", 2.5)
        except exc:
            pass
        inc = t.last_incident()
        recs.append((sorted(inc), inc["error"], inc["what"], inc["timeout"],
                     [(s["name"], s["args"]) for s in inc["spans"]],
                     sorted(inc["spans"][-1]), len(t.incidents()),
                     t.trace_info()["incidents"]))
    assert recs[1] == recs[0]
    assert recs[1][4] == [("some.site", {"step": 3})]


def test_ring_bound_and_dropped_counter_like_jax(tracing):
    out = []
    for t in (jtrace, trace):
        t.set_ring_size(4)
        try:
            for i in range(10):
                t.event(f"e{i}")
            out.append(([r["name"] for r in t.trace_records()],
                        {k: v for k, v in t.trace_info().items()}))
        finally:
            t.set_ring_size(4096)
    assert out[1] == out[0]
    assert out[1][0] == ["e6", "e7", "e8", "e9"]
    assert out[1][1]["dropped"] == 6


def test_disabled_tracing_is_a_noop():
    trace.enable(False)
    trace.trace_clear()
    with trace.span("x", rid=1) as sp:
        assert sp.set(a=1) is sp
        trace.event("y")
    assert trace.trace_records() == []
    assert trace.trace_info()["enabled"] is False


def test_gateway_run_exports_a_rid_linked_trace(tracing, tmp_path):
    _, pm = pair(seed=17)
    eng = ServingEngine(pm, max_batch=2, max_seq_len=64, spec_k=2)
    gw = ServingGateway(eng)
    try:
        cli = GatewayClient("127.0.0.1", gw.port)
        cli.generate(prompt(6, seed=5), max_new_tokens=6)
        cli.close()
    finally:
        gw.stop(drain=True, timeout=10.0)
    path = trace.export_trace(str(tmp_path / "serve.json"))
    evs = json.load(open(path))["traceEvents"]
    req = [e for e in evs if e["name"] == "gateway.request"]
    assert len(req) == 1
    rid = req[0]["args"]["rid"]
    by_name = {}
    for e in evs:
        a = e["args"]
        if a.get("rid") == rid or rid in (a.get("rids") or ()):
            by_name.setdefault(e["name"], []).append(e)
    for site in ("engine.submit", "scheduler.join", "engine.prefill",
                 "engine.decode_step", "engine.verify_step",
                 "scheduler.evict"):
        assert site in by_name, site
    decode_ids = {e["args"]["span_id"] for e in by_name["engine.decode_step"]}
    assert all(e["args"]["parent_id"] in decode_ids
               for e in by_name["engine.verify_step"])
    submit = by_name["engine.submit"][0]
    assert submit["args"]["parent_id"] == req[0]["args"]["span_id"]


def test_chaos_delay_incident_ends_at_the_faulted_site(tracing,
                                                       monkeypatch):
    _, pm = pair(seed=19)
    gw = ServingGateway(ServingEngine(pm, max_batch=2, max_seq_len=64))
    try:
        cli = GatewayClient("127.0.0.1", gw.port)
        chaos.reset_hits()
        monkeypatch.setenv("PT_FAULTPOINT", "gateway.read")
        monkeypatch.setenv("PT_FAULTPOINT_MODE", "delay:1.0")
        monkeypatch.setenv("PT_FAULTPOINT_HITS", "inf")
        trace.clear_incidents()
        with pytest.raises(RequestTimeout):
            cli.generate(prompt(4, seed=2), max_new_tokens=4, timeout=0.3)
        inc = trace.last_incident()
        assert inc is not None and inc["error"] == "RequestTimeout"
        last = inc["spans"][-1]
        assert last["name"] == "gateway.read"
        assert last["cat"] == "chaos.fault"
        assert last["args"]["mode"].startswith("delay")
        cli.close()
    finally:
        monkeypatch.delenv("PT_FAULTPOINT")
        chaos.reset_hits()
        gw.stop(drain=False)
