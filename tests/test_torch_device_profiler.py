"""The measurement API against the JAX package's, on the CPU.

- ``make_scheduler``: the state of each of 12 steps equals the JAX one for
  several (closed, ready, record, repeat, skip_first);
- a profiled 3-step eager loop on the same tiny model records the same
  spans (names and counts: the dispatch's ops and the user's
  ``RecordEvent``s) as the JAX ``Profiler``, each op span inside its
  step's user span, and the dispatch hook is off again after ``stop()``;
- ``export_chrome_tracing``, ``export_protobuf`` (the ``PTPF`` container)
  and ``load_profiler_result`` round trips; ``summary`` rows;
- ``timer.benchmark()``'s arithmetic on a stubbed clock, against the JAX
  timer on the same clock;
- ``device.*`` on the CPU answers as the JAX functions do on a backend
  without counters (``{}`` and 0), and a ``Stream`` is refused there.
"""
import collections
import json
import struct

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.profiler import profiler as jprof
from paddle_tpu.profiler import timer as jtimer
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.ops import dispatch as pdispatch
from paddle_tpu_torch.profiler import profiler as pprof
from paddle_tpu_torch.profiler import timer as ptimer


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=3),
    dict(closed=0, ready=0, record=1),
    dict(closed=2, ready=1, record=2, repeat=2),
    dict(closed=1, ready=0, record=2, skip_first=3),
    dict(closed=0, ready=2, record=4, repeat=1, skip_first=1),
])
def test_make_scheduler_states_equal_jax(kw):
    got = pprof.make_scheduler(**kw)
    want = jprof.make_scheduler(**kw)
    assert [got(i).name for i in range(12)] == \
        [want(i).name for i in range(12)]


def _loop(pkg, prof, steps=3):
    F = pkg.nn.functional
    r = np.random.default_rng(0)
    w1 = pkg.to_tensor(r.normal(size=(4, 8)).astype("f4"),
                       stop_gradient=False)
    b1 = pkg.to_tensor(np.zeros(8, "f4"), stop_gradient=False)
    w2 = pkg.to_tensor(r.normal(size=(8, 3)).astype("f4"),
                       stop_gradient=False)
    x = pkg.to_tensor(r.normal(size=(5, 4)).astype("f4"))
    prof.start()
    for _ in range(steps):
        with pkg.profiler.RecordEvent("forward"):
            h = F.linear(F.gelu(F.linear(x, w1, b1)), w2)
            loss = pkg.mean(pkg.square(F.softmax(h)))
        with pkg.profiler.RecordEvent("backward"):
            loss.backward()
        prof.step(num_samples=5)
    prof.stop()
    return prof.events()


def test_profiled_loop_records_the_jax_spans(tmp_path):
    pe = _loop(P, P.profiler.Profiler(
        on_trace_ready=P.profiler.export_chrome_tracing(str(tmp_path))))
    je = _loop(J, J.profiler.Profiler())
    count = collections.Counter
    assert count(e["name"] for e in pe) == count(e["name"] for e in je)
    assert count(e["cat"] for e in pe) == count(e["cat"] for e in je)
    assert pdispatch._quiet and pdispatch._profile_cb is None
    # every op span lies inside a "forward" span
    fwd = [(e["ts"], e["ts"] + e["dur"]) for e in pe
           if e["name"] == "forward"]
    for e in pe:
        if e["cat"] == "op":
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                       for a, b in fwd), e
    files = list(tmp_path.glob("*.paddle_trace.json"))
    assert len(files) == 1
    loaded = P.profiler.load_profiler_result(str(files[0]))
    assert loaded["traceEvents"] == pe
    table = P.profiler.Profiler.summary.__get__(
        type("_", (), {"_events": pe})())()
    rows = {line.split()[0]: int(line.split()[1])
            for line in table.splitlines()[2:]}
    assert rows == {k: v for k, v in count(e["name"] for e in pe).items()}


def test_scheduled_windows_and_protobuf_export(tmp_path):
    seen = []
    handler = P.profiler.export_protobuf(str(tmp_path), "w0")

    def ready(prof):
        seen.append((prof.step_num, len(prof.events())))
        handler(prof)
    _loop(P, P.profiler.Profiler(
        scheduler=P.profiler.make_scheduler(closed=1, ready=1, record=2),
        on_trace_ready=ready), steps=6)
    # the first window closes entering step 4, stop() closes the second
    # (opened at step 6)
    assert [s for s, _ in seen] == [4, 6]
    per_step = seen[0][1] // 2
    assert seen[0][1] == 2 * per_step and per_step == 8
    path = sorted(tmp_path.glob("w0_*.pb"))[-1]
    blob = path.read_bytes()
    assert blob[:5] == b"PTPF\x01"
    n = struct.unpack("<Q", blob[5:13])[0]
    assert len(json.loads(blob[13:13 + n])["traceEvents"]) == seen[-1][1]


def test_summary_matches_the_jax_rendering():
    events = [{"name": "a", "dur": 3.0, "cat": "op"},
              {"name": "a", "dur": 1.0, "cat": "op"},
              {"name": "b", "dur": 2.5, "cat": "UserDefined"}]
    from paddle_tpu.profiler import statistic as jstat
    from paddle_tpu_torch.profiler import statistic as pstat
    assert pstat.aggregate(events) == jstat.aggregate(events)
    for by in ("total", "avg", "calls"):
        assert pstat.summary(events, by, "us") == \
            jstat.summary(events, by, "us")
    assert pstat.op_cache_summary().startswith("op cache: none")


def test_benchmark_arithmetic_equals_jax(monkeypatch):
    out = []
    for mod in (ptimer, jtimer):
        ticks = iter([0.0, 1.0, 1.5, 2.5, 4.0])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        b = mod.Benchmark()
        b.begin()
        for _ in range(4):
            b.step(num_samples=8)
        b.end()
        out.append((b.step_cost.count, b.step_cost.total, b.samples,
                    b.ips(), b.step_info()))
    assert out[0] == out[1]
    assert out[0][:3] == (3, 3.0, 24) and out[0][3] == 24 / 3.0


def test_device_on_the_cpu_answers_as_jax():
    import paddle_tpu.device as jd
    d = P.device
    for name in ("memory_stats", "memory_allocated", "max_memory_allocated",
                 "memory_reserved", "max_memory_reserved"):
        assert getattr(d, name)("cpu") == getattr(jd, name)("cpu"), name
    assert d.memory_stats("cpu") == {}
    d.synchronize("cpu")
    d.empty_cache()
    assert d.device_count("cpu") == 1
    assert d.get_available_custom_device() == []
    props = d.cuda.get_device_properties("cpu")
    assert (props.name, props.total_memory, props.multi_processor_count) \
        == ("cpu", 0, 1)
    assert not P.is_compiled_with_tpu()
    assert pdev.current_jax_device().type == "cpu"
    with pdev.portable_trace():
        pass
    with pytest.raises(RuntimeError, match="card"):
        d.Stream("cpu")
    with pytest.raises(RuntimeError, match="card"):
        d.current_stream("cpu")
