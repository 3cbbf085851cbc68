"""The port's step-capture tier (``paddle_tpu_torch.jit.capture``) on the
CPU: signatures, the LRU, the counters, launch-count bookkeeping and the
bailout path, driven through ``torch_replay.ReplayBackend`` (a backend
that re-runs the step where a CUDA graph would replay it). The graph
itself is tested on the card (tests/test_torch_cuda.py).

Values are compared exactly: the replayed step is the same function on
the same inputs.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import capture
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels.decode_attention import (
    ragged_decode_attention)
from torch_replay import ReplayBackend

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, inter=64, seq=64)


@pytest.fixture
def backend():
    b = ReplayBackend()
    capture.set_capture_backend(b)
    capture.capture_clear()
    yield b
    capture.set_capture_backend(None)
    capture.set_step_capture_enabled(True)


def _step(x, cache, scale):
    """Writes its cache where it lies, as a KV-cache step does: the same
    input writes the same values."""
    cache[:x.shape[0]].copy_(2 * x)
    return x * scale + cache.sum()


def test_cpu_without_a_backend_runs_eagerly_and_counts_eager_calls():
    step = capture.capture_step(_step, inplace=(1,))
    cache = torch.zeros(3)
    out = step(torch.ones(3), cache, 2.0)
    assert torch.equal(out, torch.full((3,), 8.0))
    assert step.cache_info() == {"signatures": 0, "lowerings": 0, "hits": 0,
                                 "bailouts": 0, "fallback_calls": 0,
                                 "eager_calls": 1}


def test_one_lowering_per_signature_then_replays(backend):
    step = capture.capture_step(_step, inplace=(1,))
    cache = torch.zeros(3)
    want_cache = torch.zeros(3)
    for i in range(4):
        x = torch.full((3,), float(i + 1))
        got = step(x, cache, 2.0)
        want = _step(x, want_cache, 2.0)
        assert torch.equal(got, want)
    assert torch.equal(cache, want_cache)
    info = step.cache_info()
    assert info["signatures"] == 1 and info["lowerings"] == 1
    assert info["hits"] == 3 and info["bailouts"] == 0
    assert backend.captures == 1 and backend.replays == 3


def test_replay_outputs_are_the_static_buffers(backend):
    step = capture.capture_step(lambda x, c: x + c, inplace=(1,))
    c = torch.zeros(2)
    step(torch.ones(2), c)                 # warm-up: a fresh tensor
    a = step(torch.full((2,), 2.0), c)
    b = step(torch.full((2,), 3.0), c)
    assert a is b and torch.equal(b, torch.full((2,), 3.0))


@pytest.mark.parametrize("change", ["shape", "dtype", "python_value",
                                    "moved_cache"])
def test_what_makes_a_new_signature(backend, change):
    step = capture.capture_step(_step, inplace=(1,))
    cache = torch.zeros(3)
    step(torch.ones(3), cache, 2.0)
    step(torch.ones(3), cache, 2.0)
    if change == "shape":
        step(torch.ones(1), cache, 2.0)
    elif change == "dtype":
        step(torch.ones(3, dtype=torch.float64), cache, 2.0)
    elif change == "python_value":
        step(torch.ones(3), cache, 3.0)
    else:
        # same shape, another address: the graph would hold a stale one
        step(torch.ones(3), torch.zeros(3), 2.0)
    assert step.cache_info()["lowerings"] == 2
    assert step.cache_info()["signatures"] == 2


def test_copied_inputs_do_not_join_the_signature(backend):
    step = capture.capture_step(_step, inplace=(1,))
    cache = torch.zeros(3)
    for _ in range(3):
        step(torch.ones(3), cache, 2.0)    # a new x tensor every call
    assert step.cache_info()["lowerings"] == 1


def test_lru_bound_evicts_the_oldest_signature(backend):
    step = capture.capture_step(_step, inplace=(1,), maxsize=2)
    cache = torch.zeros(4)
    for n in (1, 2, 4):
        step(torch.ones(n), cache, 1.0)
    assert step.cache_info()["signatures"] == 2
    step(torch.ones(1), cache, 1.0)        # evicted: captured again
    assert step.cache_info()["lowerings"] == 4
    assert step.graphs() == 2


@pytest.mark.parametrize("sync", ["item", "cpu", "tolist", "nonzero", "bool",
                                  "int"])
def test_host_sync_bails_out_and_runs_eagerly(backend, sync):
    def step(x, c):
        s = x.sum()
        if sync == "item":
            s.item()
        elif sync == "cpu":
            s.cpu()
        elif sync == "tolist":
            x.tolist()
        elif sync == "nonzero":
            torch.nonzero(x)
        elif sync == "bool":
            bool(s > 0)
        else:
            int(s)
        c.add_(1.0)
        return x * 2

    wrapped = capture.capture_step(step, inplace=(1,))
    c = torch.zeros(2)
    for _ in range(3):
        out = wrapped(torch.ones(2), c)
        assert torch.equal(out, torch.full((2,), 2.0))
    info = wrapped.cache_info()
    assert info["bailouts"] == 1 and info["lowerings"] == 0
    assert info["fallback_calls"] == 3 and info["hits"] == 0
    assert "HostSync" in wrapped.bailout_reason()
    assert backend.captures == 0
    # the guarded warm-up stopped at the sync; every call then ran whole
    assert torch.equal(c, torch.full((2,), 3.0))
    assert capture.capture_info()["bailouts"] == 1
    assert "HostSync" in capture.capture_info()["last_bailout"]


def test_failed_capture_keeps_the_warm_up_result_and_poisons(backend):
    def broken(*a, **k):
        raise RuntimeError("capture refused")

    backend.capture = broken
    step = capture.capture_step(lambda x, c: x + 1, inplace=(1,))
    c = torch.zeros(1)
    assert torch.equal(step(torch.ones(1), c), torch.full((1,), 2.0))
    assert torch.equal(step(torch.ones(1), c), torch.full((1,), 2.0))
    info = step.cache_info()
    assert info["bailouts"] == 1 and info["fallback_calls"] == 1
    assert "capture refused" in step.bailout_reason()


def test_kernel_launch_counts_taken_back_at_capture_and_added_per_replay(
        backend):
    def step(x, c):
        ragged_decode_attention.launches += 3   # as three kernel launches
        return x + c

    wrapped = capture.capture_step(step, inplace=(1,))
    c = torch.zeros(1)
    base = ragged_decode_attention.launches
    wrapped(torch.ones(1), c)                  # warm-up: 3 real launches
    assert ragged_decode_attention.launches == base + 3
    for i in range(4):
        wrapped(torch.ones(1), c)
    # the capture's 3 were taken back; each replay adds the graph's 3
    assert ragged_decode_attention.launches == base + 3 + 4 * 3
    ragged_decode_attention.launches = base


def test_disabled_tier_runs_eagerly(backend):
    capture.set_step_capture_enabled(False)
    assert not capture.step_capture_enabled()
    step = capture.capture_step(_step, inplace=(1,))
    step(torch.ones(3), torch.zeros(3), 1.0)
    assert step.cache_info()["eager_calls"] == 1
    assert backend.warmups == 0


def test_capture_series_in_the_metrics_text(backend):
    from paddle_tpu_torch.observability import metrics
    step = capture.capture_step(_step, inplace=(1,))
    c = torch.zeros(3)
    for _ in range(3):
        step(torch.ones(3), c, 1.0)
    info = capture.capture_info()
    assert info["lowerings"] == 1 and info["hits"] == 2
    assert info["graphs"] >= 1 and info["pool_mib"] == 0.0
    text = metrics.render_prometheus()
    assert "pt_step_capture_lowerings 1" in text
    assert "pt_step_capture_hits 2" in text
    assert "# TYPE pt_step_capture_graphs gauge" in text


def _model(seed=3):
    return LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu",
                            seed=seed)


def test_model_steps_through_the_replay_backend_equal_eager(backend):
    m = _model()
    rng = np.random.default_rng(0)
    b, s_max = 3, 32

    def run(n_calls):
        caches = m.init_kv_caches(b, s_max)
        outs = []
        for i in range(n_calls):
            tok = torch.from_numpy(rng.integers(0, 64, (b, 1)))
            off = torch.tensor([i, i + 2, i + 5], dtype=torch.int32)
            nxt, last = m.slot_step(tok, caches, off,
                                    torch.zeros(b, dtype=torch.int32),
                                    return_logits=True)
            win = torch.from_numpy(rng.integers(0, 64, (b, 3)))
            v = m.verify_step(win, caches, off + 1)
            outs.append((nxt.clone(), last.clone(), v.clone()))
        return outs, caches

    rng = np.random.default_rng(0)
    got, got_caches = run(4)
    capture.set_capture_backend(None)
    rng = np.random.default_rng(0)
    want, want_caches = run(4)
    for g, w in zip(got, want):
        for a, e in zip(g, w):
            assert torch.equal(a, e)
    for (gk, gv), (wk, wv) in zip(got_caches, want_caches):
        assert torch.equal(gk, wk) and torch.equal(gv, wv)


def test_generate_takes_one_prefill_and_one_decode_graph(backend):
    """The offset rides a device tensor, so every decode position shares
    one signature (a Python int would make one per position)."""
    m = _model(seed=5)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 5)))
    got = m.generate(ids, max_new_tokens=7)
    info = m.captured_step("_decode_step").cache_info()
    assert info["lowerings"] == 2 and info["hits"] == 5
    capture.set_capture_backend(None)
    want = m.generate(ids, max_new_tokens=7)
    assert torch.equal(got, want)
    assert torch.equal(got, m.generate(ids, max_new_tokens=7,
                                       use_cache=False))


def test_replacing_parameters_rebuilds_the_model_wrapper(backend):
    m = _model(seed=7)
    ids = torch.zeros((1, 4), dtype=torch.int64)
    m.generate(ids, max_new_tokens=3)
    first = m.captured_step("_decode_step")
    with torch.no_grad():
        m.lm_head.weight.data = m.lm_head.weight.data.clone()
    m.generate(ids, max_new_tokens=3)
    assert m.captured_step("_decode_step") is not first
