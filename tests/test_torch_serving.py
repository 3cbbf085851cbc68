"""The PyTorch port's serving engine, held against the JAX package's.

Both engines serve the same weights (a JAX LLaMA's parameters carried
across with ``load_paddle_tpu_state``) in fp32 on the CPU. Greedy results
must be equal token for token to the JAX engine's and to the port's own
sequential ``generate()``, including a request that joins after two
steps. Inside the JAX engine's traced step the decode attention resolves
to ``_ragged_ref`` (decode_attention.py:127-134), which the port's plain
version mirrors. The typed errors and counters are checked as
tests/test_serving.py checks them for the JAX engine.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.inference.serving import (
    KVPagePool, PoolExhausted, RequestState, SamplingUnsupported,
    ServingEngine)
from paddle_tpu_torch.models.llama import (
    LlamaConfig, LlamaForCausalLM, load_paddle_tpu_state)
from paddle_tpu_torch.utils.deadline import (
    DeadlineExceeded, EngineOverloaded, RequestTimeout)

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, inter=64, seq=64)


def _pair(seed=7, kv_heads=4):
    P.seed(seed)
    jcfg = JaxConfig.tiny(**TINY)
    jcfg.num_key_value_heads = kv_heads
    jm = JaxLlama(jcfg)
    cfg = LlamaConfig.tiny(**TINY)
    cfg.num_key_value_heads = kv_heads
    pm = LlamaForCausalLM(cfg, device="cpu")
    load_paddle_tpu_state(
        pm, {n: np.asarray(p._value) for n, p in jm.named_parameters()})
    return jm, pm


def _port(seed=7):
    return _pair(seed)[1]


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, TINY["vocab"], (n,))


def _oracle(pm, prompt, n):
    return pm.generate(torch.from_numpy(prompt.reshape(1, -1)),
                       max_new_tokens=n).numpy()[0]


def _serve_with_late_join(make_engine, prompts, late, new):
    eng = make_engine()
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.step()
    eng.step()
    reqs.append(eng.submit(late, max_new_tokens=new))
    eng.run()
    return eng, [r.result() for r in reqs]


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_engine_matches_jax_engine_and_generate_with_late_join(kv_heads):
    jm, pm = _pair(kv_heads=kv_heads)
    prompts = [_prompt(5, seed=1), _prompt(8, seed=2), _prompt(11, seed=3)]
    late = _prompt(6, seed=4)
    new = 7
    _, want = _serve_with_late_join(
        lambda: JaxEngine(jm, max_batch=3, max_seq_len=64, page_size=8),
        prompts, late, new)
    eng, got = _serve_with_late_join(
        lambda: ServingEngine(pm, max_batch=3, max_seq_len=64, page_size=8),
        prompts, late, new)
    for w, g, p in zip(want, got, prompts + [late]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _oracle(pm, p, new))
    info = eng.info()
    assert info["finished"] == 4 and info["timed_out"] == 0
    assert info["prefills"] == 4
    assert info["tokens_generated"] == 4 * new
    assert info["pool"]["active_pages"] == 0


def test_engine_eos_stops_request():
    pm = _port(seed=11)
    p = _prompt(6, seed=4)
    base = _oracle(pm, p, 8)
    eos = int(base[6 + 2])   # the 3rd generated token, forced to be "EOS"
    eng = ServingEngine(pm, max_batch=2, max_seq_len=64, eos_token_id=eos)
    req = eng.submit(p, max_new_tokens=8)
    eng.run()
    out = req.result()
    assert req.finish_reason == "eos"
    assert out.size == 6 + 3 and out[-1] == eos
    np.testing.assert_array_equal(out, base[:9])


def test_oversized_request_rejected_with_value_error():
    eng = ServingEngine(_port(), max_batch=2, max_seq_len=32)
    with pytest.raises(ValueError):
        eng.submit(_prompt(30), max_new_tokens=8)
    assert eng.info()["rejected"] == 1
    assert eng.info()["submitted"] == 0


def test_queued_request_ttl_times_out_and_returns_pages():
    eng = ServingEngine(_port(), max_batch=1, max_seq_len=64, page_size=8)
    base_active = eng.pool.info()["active_pages"]
    head = eng.submit(_prompt(5, seed=1), max_new_tokens=20)
    queued = eng.submit(_prompt(5, seed=2), max_new_tokens=4, ttl=0.01)
    assert queued.pages                      # reserved while queued
    time.sleep(0.05)
    eng.run()
    assert head.state is RequestState.FINISHED
    assert queued.state is RequestState.TIMED_OUT
    with pytest.raises(RequestTimeout) as ei:
        queued.result()
    assert isinstance(ei.value, DeadlineExceeded)
    info = eng.info()
    assert info["timed_out"] == 1 and info["finished"] == 1
    assert info["pool"]["active_pages"] == base_active


def test_max_queue_overflow_raises_engine_overloaded():
    eng = ServingEngine(_port(), max_batch=1, max_seq_len=64, max_queue=2)
    eng.submit(_prompt(4, seed=1), max_new_tokens=2)
    eng.submit(_prompt(4, seed=2), max_new_tokens=2)
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(_prompt(4, seed=3), max_new_tokens=2)
    assert ei.value.retry_after_ms >= 1
    info = eng.info()
    assert info["pressure"]["shed"] == 1 and info["rejected"] == 1
    eng.run()
    assert eng.info()["finished"] == 2


FEATURES = {
    # feature: (engine keyword, environment variable and value)
    "spec": ({"spec_k": 2}, ("PT_SERVE_SPEC_K", "2")),
    "prefix": ({"prefix_sharing": True}, ("PT_SERVE_PREFIX_SHARE", "1")),
    "chunk": ({"prefill_chunk": 8}, ("PT_SERVE_PREFILL_CHUNK", "8")),
}
_COUNTERS = ("prefills", "decode_steps", "tokens_generated",
             "prefill_chunks", "chunked_prefills", "shared_prefix_joins",
             "prefill_pages_saved")


def _feature_run(make_engine):
    """Two prompts over a common 16-token prefix, then a late join of a
    third: every feature has something to do (a verify window, a shared
    page, a 20-token prompt cut into windows of 8)."""
    common = _prompt(16, seed=9)
    prompts = [np.concatenate([common, _prompt(n, seed=s)])
               for n, s in ((4, 1), (7, 2))]
    late = np.concatenate([common, _prompt(5, seed=3)])
    eng, outs = _serve_with_late_join(make_engine, prompts, late, 6)
    info = eng.info()
    return outs, {k: info[k] for k in _COUNTERS}, info


def _check_feature(feature, jax_kw, port_kw):
    jm, pm = _pair()
    want, want_c, _ = _feature_run(lambda: JaxEngine(
        jm, max_batch=2, max_seq_len=64, page_size=8, **jax_kw))
    got, got_c, info = _feature_run(lambda: ServingEngine(
        pm, max_batch=2, max_seq_len=64, page_size=8, **port_kw))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got_c == want_c
    if feature == "spec":
        assert info["spec"]["verify_steps"] > 0
    elif feature == "prefix":
        assert info["shared_prefix_joins"] > 0
    else:
        assert info["chunked_prefills"] > 0


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_feature_by_keyword_matches_jax_engine(feature):
    """Each serving feature turned on by its engine keyword: tokens bitwise
    the JAX engine's (fp32, CPU) and the counters equal."""
    kw = FEATURES[feature][0]
    _check_feature(feature, kw, kw)


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_feature_env_knob_matches_jax_engine(monkeypatch, feature):
    """The same, each feature turned on by its environment variable, which
    both engines read at construction."""
    monkeypatch.setenv(*FEATURES[feature][1])
    _check_feature(feature, {}, {})


def test_sampled_request_reproducible_and_greedy_neighbour_unchanged():
    pm = _port(seed=5)
    greedy_p, sampled_p = _prompt(6, seed=1), _prompt(7, seed=2)
    want_greedy = _oracle(pm, greedy_p, 10)

    def serve():
        eng = ServingEngine(pm, max_batch=2, max_seq_len=64)
        g = eng.submit(greedy_p, max_new_tokens=10)
        s = eng.submit(sampled_p, max_new_tokens=10, temperature=0.9,
                       top_p=0.95, seed=1234)
        eng.run()
        assert eng.info()["sampled_tokens"] == 10
        return g.result(), s.result()

    g1, s1 = serve()
    g2, s2 = serve()
    np.testing.assert_array_equal(g1, want_greedy)
    np.testing.assert_array_equal(g2, want_greedy)
    np.testing.assert_array_equal(s1, s2)
    assert s1.size == 7 + 10


@pytest.mark.parametrize("kw", [
    {"temperature": -1.0}, {"temperature": float("nan")}, {"top_p": 0.0},
    {"top_p": 1.5}, {"top_p": 0.5}])
def test_unservable_sampling_rejected_typed(kw):
    eng = ServingEngine(_port(), max_batch=2, max_seq_len=64)
    with pytest.raises(SamplingUnsupported):
        eng.submit(_prompt(4), max_new_tokens=2, **kw)
    assert eng.info()["rejected"] == 1


def test_kv_pool_alloc_release_freelist():
    pool = KVPagePool(total_pages=4, page_size=16)
    assert pool.pages_for(1) == 1 and pool.pages_for(16) == 1 \
        and pool.pages_for(17) == 2
    a = pool.alloc(3)
    assert pool.free_pages == 1
    assert pool.info()["peak_active"] == 3
    with pytest.raises(PoolExhausted):
        pool.alloc(2)
    assert pool.free_pages == 1
    pool.release(a)
    assert pool.free_pages == 4
    with pytest.raises(ValueError):
        pool.release(a)


def test_never_fitting_reservation_is_permanent_pool_exhaustion():
    eng = ServingEngine(_port(), max_batch=1, max_seq_len=64, page_size=8)
    eng.pool = KVPagePool(total_pages=2, page_size=8)
    eng.scheduler.pool = eng.pool
    with pytest.raises(PoolExhausted) as ei:
        eng.submit(_prompt(10), max_new_tokens=10)
    assert ei.value.permanent


def test_engine_runs_on_the_model_device():
    eng = ServingEngine(_port(), max_batch=2, max_seq_len=64)
    assert eng.device.type == "cpu"
    assert all(k.device.type == "cpu" for k, _ in eng._caches)
    assert eng.buckets == [8, 16, 32, 64]


def test_trace_ring_records_the_serving_path_when_enabled():
    from paddle_tpu_torch.observability import trace
    eng = ServingEngine(_port(), max_batch=2, max_seq_len=64)
    trace.trace_clear()
    trace.enable(True)
    try:
        req = eng.submit(_prompt(5, seed=1), max_new_tokens=3)
        eng.run()
    finally:
        trace.enable(False)
    recs = trace.trace_records()
    trace.trace_clear()
    names = [r["name"] for r in recs]
    for site in ("engine.submit", "scheduler.join", "engine.prefill",
                 "engine.decode_step", "scheduler.evict"):
        assert site in names, site
    assert sum(n == "engine.decode_step" for n in names) == 2
    assert all(r["args"]["rid"] == req.rid for r in recs
               if r["name"] == "engine.prefill")
    assert all(r["dur"] is not None and r["dur"] >= 0 for r in recs
               if r["name"] == "engine.decode_step")


@pytest.mark.parametrize("mode,exc", [("error", "FaultInjected"),
                                      ("drop", "FaultDrop")])
def test_engine_pressure_faultpoint_fires_when_armed(monkeypatch, mode, exc):
    from paddle_tpu_torch.distributed import chaos
    eng = ServingEngine(_port(), max_batch=2, max_seq_len=64)
    eng.submit(_prompt(5, seed=1), max_new_tokens=2)
    monkeypatch.setenv("PT_FAULTPOINT", "engine.pressure")
    monkeypatch.setenv("PT_FAULTPOINT_MODE", mode)
    chaos.reset_hits()
    with pytest.raises(getattr(chaos, exc)) as ei:
        eng.step()
    assert ei.value.site == "engine.pressure"
    eng.run()   # fired once (PT_FAULTPOINT_HITS=1), then serving resumes
    assert eng.info()["finished"] == 1
    chaos.reset_hits()
