"""The port's serving gateway: the engine behind a real socket.

Tokens over the wire must be bitwise the in-process engine's and the JAX
engine's (same weights, fp32, CPU). The typed errors travel as their
frames: 429 EngineOverloaded with ``retry-after-ms``, 408 RequestTimeout
(the request's TTL, and the gateway's own bound on the wait), 503
GatewayDraining; METRICS and HEALTH answer; the client's breaker opens
and closes. Overload is made deterministic by holding the gateway's
driver thread between engine steps (``_Held``), never by racing it.
"""
import threading
import time

import numpy as np
import pytest

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.inference.serving.gateway import (
    CircuitOpen, GatewayClient, GatewayDraining, ServingGateway)
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.utils.deadline import (DeadlineExceeded,
                                             EngineOverloaded, RequestTimeout)
from torch_pairs import assert_same_outputs, pair, prompt


@pytest.fixture(scope="module")
def models():
    return pair(seed=7)


class _Held:
    """Hold an engine's driver thread at the top of ``step()`` until
    ``release()``: submitted requests stay queued, deterministically."""

    def __init__(self, eng):
        self._gate = threading.Event()
        self._step = eng.step
        eng.step = self._held_step

    def _held_step(self):
        if not self._gate.wait(30.0):
            raise RuntimeError("engine held for 30 s")
        return self._step()

    def release(self):
        self._gate.set()


def _wait_for(cond, what, timeout=30.0):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.002)


def _in_thread(fn):
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised by the test
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def test_gateway_round_trip_bitwise_inprocess_and_jax(models):
    jm, pm = models
    prompts = [prompt(5, seed=1), prompt(9, seed=2), prompt(14, seed=3)]
    want = JaxEngine(jm, max_batch=4, max_seq_len=64).generate(
        prompts, max_new_tokens=6)
    local = ServingEngine(pm, max_batch=4, max_seq_len=64).generate(
        prompts, max_new_tokens=6)
    assert_same_outputs(want, local)
    gw = ServingGateway(ServingEngine(pm, max_batch=4, max_seq_len=64))
    try:
        cli = GatewayClient("127.0.0.1", gw.port)
        got = [cli.generate(p, max_new_tokens=6) for p in prompts]
        assert_same_outputs(local, got)
        # parallel clients (one stream each) land in one batch, same tokens
        clis = [GatewayClient("127.0.0.1", gw.port) for _ in prompts]
        runs = [_in_thread(lambda c=c, p=p: c.generate(p, max_new_tokens=6))
                for c, p in zip(clis, prompts)]
        for t, _ in runs:
            t.join(60.0)
        assert_same_outputs(local, [box["out"] for _, box in runs])
        assert gw.info()["responses"] == 6
        for c in [cli] + clis:
            c.close()
    finally:
        assert gw.stop(drain=True, timeout=10.0)
    assert gw.threads() == []


def test_shared_and_chunked_engine_behind_the_gateway_bitwise(models):
    _, pm = models
    rng = np.random.RandomState(8)
    common = rng.randint(0, 64, (32,))
    prompts = [np.concatenate([common, rng.randint(0, 64, (2 + i,))])
               for i in range(4)]
    local = ServingEngine(pm, max_batch=4, max_seq_len=64,
                          page_size=16).generate(prompts, max_new_tokens=5)
    eng = ServingEngine(pm, max_batch=4, max_seq_len=64, page_size=16,
                        prefix_sharing=True, prefill_chunk=16)
    gw = ServingGateway(eng)
    try:
        cli = GatewayClient("127.0.0.1", gw.port)
        got = [cli.generate(p, max_new_tokens=5) for p in prompts]
        assert_same_outputs(local, got)
        info = eng.info()
        assert info["shared_prefix_joins"] == 3
        assert info["prefill_pages_saved"] == 6
        assert info["prefill_chunks"] >= 3
        cli.close()
    finally:
        gw.stop(drain=True, timeout=10.0)


def test_429_with_retry_after_then_breaker_opens_and_closes(models,
                                                            monkeypatch):
    _, pm = models
    monkeypatch.setenv("PT_GATEWAY_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("PT_GATEWAY_BREAKER_COOLDOWN", "0.3")
    eng = ServingEngine(pm, max_batch=1, max_seq_len=64, max_queue=1)
    held = _Held(eng)
    gw = ServingGateway(eng)
    cli_a = GatewayClient("127.0.0.1", gw.port)
    cli = GatewayClient("127.0.0.1", gw.port)
    try:
        ta, box = _in_thread(lambda: cli_a.generate(
            prompt(4, seed=60), max_new_tokens=4, timeout=60.0))
        _wait_for(lambda: eng.scheduler.queue_depth == 1, "A queued")
        for _ in range(2):
            with pytest.raises(EngineOverloaded) as ei:
                cli.generate(prompt(4, seed=62), max_new_tokens=4,
                             retries=0, timeout=10.0)
            assert ei.value.retry_after_ms == 100   # a cold engine's advice
        with pytest.raises(CircuitOpen) as ci:
            cli.generate(prompt(4, seed=62), max_new_tokens=4, retries=0,
                         timeout=10.0)
        assert ci.value.retry_after_ms >= 1 and cli.breaker_open
        assert gw.info()["status_counts"] == {429: 2}
        # HEALTH is breaker-exempt and answered from bookkeeping alone
        h = cli.health()
        assert h == {"ready": True, "draining": False, "pressure": 0,
                     "queued": 1, "active": 0}
        held.release()
        ta.join(60.0)
        assert box["out"].size == 8
        time.sleep(0.35)                        # ride out the cooldown
        assert cli.generate(prompt(4, seed=63), max_new_tokens=4,
                            retries=0, timeout=30.0).size == 8
        assert not cli.breaker_open
        text = cli.metrics()
        assert "pt_serving_pressure_shed" in text
        assert 'status="429"} 2' in text
    finally:
        held.release()
        cli_a.close()
        cli.close()
        gw.stop(drain=True, timeout=10.0)


def test_client_backoff_rides_out_a_transient_overload(models):
    _, pm = models
    eng = ServingEngine(pm, max_batch=1, max_seq_len=64, max_queue=1)
    held = _Held(eng)
    gw = ServingGateway(eng)
    cli_a = GatewayClient("127.0.0.1", gw.port)
    cli = GatewayClient("127.0.0.1", gw.port)
    try:
        ta, box = _in_thread(lambda: cli_a.generate(
            prompt(4, seed=70), max_new_tokens=4, timeout=60.0))
        _wait_for(lambda: eng.scheduler.queue_depth == 1, "A queued")
        tb, boxb = _in_thread(lambda: cli.generate(
            prompt(4, seed=72), max_new_tokens=4, retries=50, timeout=60.0))
        _wait_for(lambda: gw.info()["status_counts"].get(429, 0) >= 1,
                  "the first 429")
        held.release()
        ta.join(60.0)
        tb.join(60.0)
        assert box["out"].size == 8 and boxb["out"].size == 8
    finally:
        held.release()
        cli_a.close()
        cli.close()
        gw.stop(drain=True, timeout=10.0)


def test_ttl_travels_as_typed_408(models):
    _, pm = models
    eng = ServingEngine(pm, max_batch=1, max_seq_len=64)
    held = _Held(eng)
    gw = ServingGateway(eng)
    cli = GatewayClient("127.0.0.1", gw.port)
    try:
        t, box = _in_thread(lambda: cli.generate(
            prompt(4, seed=3), max_new_tokens=4, ttl=0.01))
        _wait_for(lambda: eng.scheduler.queue_depth == 1, "queued")
        time.sleep(0.05)                       # the TTL lapses in the queue
        held.release()
        t.join(30.0)
        assert isinstance(box["err"], RequestTimeout)
        assert isinstance(box["err"], DeadlineExceeded)
        assert gw.info()["status_counts"] == {408: 1}
    finally:
        held.release()
        cli.close()
        gw.stop(drain=True, timeout=10.0)


def test_gateway_bounds_its_own_wait_with_a_typed_408(models, monkeypatch):
    """A TTL-less request the engine does not serve within the gateway's
    budget (``PT_GATEWAY_REQUEST_TIMEOUT``) is answered 408, typed; the
    request itself is finished once the engine moves again."""
    _, pm = models
    monkeypatch.setenv("PT_GATEWAY_REQUEST_TIMEOUT", "0.2")
    eng = ServingEngine(pm, max_batch=1, max_seq_len=64)
    held = _Held(eng)
    gw = ServingGateway(eng)
    cli = GatewayClient("127.0.0.1", gw.port)
    try:
        with pytest.raises(RequestTimeout, match="RequestTimeout"):
            cli.generate(prompt(4, seed=4), max_new_tokens=2, timeout=10.0)
        assert gw.info()["status_counts"] == {408: 1}
        held.release()
        _wait_for(lambda: eng.scheduler.idle, "the engine to drain")
        assert eng.info()["finished"] == 1
    finally:
        held.release()
        cli.close()
        gw.stop(drain=True, timeout=10.0)


def test_sizing_and_sampling_errors_re_raise_typed(models):
    from paddle_tpu_torch.inference.serving import SamplingUnsupported
    _, pm = models
    gw = ServingGateway(ServingEngine(pm, max_batch=2, max_seq_len=32))
    cli = GatewayClient("127.0.0.1", gw.port)
    try:
        with pytest.raises(ValueError, match="max_seq_len"):
            cli.generate(prompt(30), max_new_tokens=8)
        with pytest.raises(SamplingUnsupported):
            cli.generate(prompt(4), max_new_tokens=2, top_p=0.5)
        assert gw.info()["status_counts"] == {413: 1, 400: 1}
    finally:
        cli.close()
        gw.stop(drain=True, timeout=10.0)


def test_draining_gateway_answers_typed_503_and_health_says_so(models):
    _, pm = models
    eng = ServingEngine(pm, max_batch=2, max_seq_len=64)
    gw = ServingGateway(eng)
    cli = GatewayClient("127.0.0.1", gw.port)
    try:
        assert cli.health() == {"ready": True, "draining": False,
                                "pressure": 0, "queued": 0, "active": 0}
        assert "pt_gateway_requests" in cli.metrics()
        assert gw.drain(timeout=5.0)
        h = cli.health()
        assert h["ready"] is False and h["draining"] is True
        with pytest.raises(GatewayDraining):
            cli.generate(prompt(4, seed=12), max_new_tokens=2)
        with pytest.raises(GatewayDraining):
            cli.metrics()
        assert gw.info()["status_counts"][503] == 2
    finally:
        cli.close()
        gw.stop(drain=False)
    assert gw.threads() == []


def test_metrics_verb_equals_the_local_render_on_engine_lines(models,
                                                             monkeypatch):
    """The wire scrape equals the in-process render on the engine's lines,
    taken over a quiet engine (the collector is pinned to this engine:
    the garbage collector may retire other tests' engines between two
    renders)."""
    import weakref
    from paddle_tpu_torch.inference.serving import engine as engine_mod
    _, pm = models
    eng = ServingEngine(pm, max_batch=2, max_seq_len=64)
    monkeypatch.setattr(engine_mod, "_ENGINES", weakref.WeakSet([eng]))
    gw = ServingGateway(eng)
    cli = GatewayClient("127.0.0.1", gw.port)
    try:
        cli.generate(prompt(5, seed=1), max_new_tokens=6)
        cli.generate(prompt(9, seed=2), max_new_tokens=4)
        wire = cli.metrics()
        local = metrics.render_prometheus()

        def engine_lines(text):
            return [ln for ln in text.splitlines()
                    if ln.startswith("pt_serving_")]

        assert engine_lines(wire) == engine_lines(local)
        assert any(ln.startswith("pt_serving_tokens_generated")
                   for ln in engine_lines(wire))
        assert "pt_step_capture_eager_calls" in wire
        assert gw.info()["metrics_scrapes"] == 1
    finally:
        cli.close()
        gw.stop(drain=True, timeout=10.0)
