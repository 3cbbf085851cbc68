"""The port's speculative decoding, held against the JAX engine's.

Both engines serve the same weights (fp32, CPU; the JAX model's
parameters carried across), the draft model's too. Greedy tokens must be
bitwise the JAX engine's (and the non-speculative engine's), with the
n-gram and the model drafters, on EOS, on a late join and after an
eviction with drafts in flight; the counters and the tokens-per-verify
histogram must be equal. Inside the JAX engine's traced steps the decode
attention resolves to ``_ragged_ref`` and the verify window to the masked
``_sdpa_ref``, which the port's plain versions mirror.
"""
import time

import numpy as np
import pytest

from paddle_tpu.inference.serving import NGramDrafter as JaxNGram
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.inference.serving import (
    NGramDrafter, RequestState, SamplingUnsupported, ServingEngine)
from paddle_tpu_torch.jit import capture
from paddle_tpu_torch.utils.deadline import RequestTimeout
from torch_pairs import DRAFT, assert_same_outputs, pair, prompt
from torch_replay import ReplayBackend

_SPEC_KEYS = ("verify_steps", "draft_steps", "draft_tokens_proposed",
              "draft_tokens_accepted", "tokens_per_verify_hist")
_ENGINE_KEYS = ("prefills", "decode_steps", "tokens_generated", "finished")


def _spec_view(info):
    return ({k: info["spec"][k] for k in _SPEC_KEYS},
            {k: info[k] for k in _ENGINE_KEYS},
            info["spec"]["drafter"]["kind"])


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_engine_bitwise_jax_with_equal_counters(drafter):
    jm, pm = pair(seed=53)
    jd, pd = pair(seed=99, **DRAFT)
    prompts = [prompt(5, seed=80), prompt(8, seed=81), prompt(11, seed=82)]
    base = ServingEngine(pm, max_batch=4, max_seq_len=64, page_size=8)
    base_outs = base.generate(prompts, max_new_tokens=9)

    jkw = {"draft_model": jd} if drafter == "model" else {}
    pkw = {"draft_model": pd} if drafter == "model" else {}
    jeng = JaxEngine(jm, max_batch=4, max_seq_len=64, page_size=8,
                     spec_k=3, drafter=drafter, **jkw)
    want = jeng.generate(prompts, max_new_tokens=9)
    eng = ServingEngine(pm, max_batch=4, max_seq_len=64, page_size=8,
                        spec_k=3, drafter=drafter, **pkw)
    got = eng.generate(prompts, max_new_tokens=9)
    assert_same_outputs(want, got)
    assert_same_outputs(base_outs, got)
    assert _spec_view(eng.info()) == _spec_view(jeng.info())
    info = eng.info()
    assert info["spec"]["verify_steps"] > 0
    assert info["spec"]["tokens_per_verify"] >= 1.0
    assert info["pool"]["active_pages"] == 0


def test_spec_eos_matches_jax_and_oracle():
    jm, pm = pair(seed=11)
    p = prompt(6, seed=4)
    base = ServingEngine(pm, max_batch=2, max_seq_len=64).generate(
        [p], max_new_tokens=8)[0]
    eos = int(base[6 + 2])   # the 3rd generated token, forced to be "EOS"
    outs = []
    for eng in (JaxEngine(jm, max_batch=2, max_seq_len=64, eos_token_id=eos,
                          spec_k=4),
                ServingEngine(pm, max_batch=2, max_seq_len=64,
                              eos_token_id=eos, spec_k=4)):
        req = eng.submit(p, max_new_tokens=8)
        eng.run()
        assert req.finish_reason == "eos"
        outs.append(req.result())
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[1].size == 6 + 3 and outs[1][-1] == eos
    np.testing.assert_array_equal(outs[1], base[:9])


def _late_join(eng, pa, pb):
    ra = eng.submit(pa, max_new_tokens=12)
    eng.step()
    eng.step()
    mid = len(ra.output_tokens)
    rb = eng.submit(pb, max_new_tokens=6)
    eng.run()
    return mid, list(ra.output_tokens), rb


def test_spec_late_join_bitwise_jax_and_changes_nothing_inflight():
    jm, pm = pair(seed=59)
    pa, pb = prompt(5, seed=85), prompt(7, seed=86)
    solo = ServingEngine(pm, max_batch=4, max_seq_len=64, spec_k=2)
    ra_solo = solo.submit(pa, max_new_tokens=12)
    solo.run()
    jmid, jtoks, jrb = _late_join(
        JaxEngine(jm, max_batch=4, max_seq_len=64, spec_k=2), pa, pb)
    backend = ReplayBackend()
    capture.set_capture_backend(backend)
    try:
        eng = ServingEngine(pm, max_batch=4, max_seq_len=64, spec_k=2)
        mid, toks, rb = _late_join(eng, pa, pb)
    finally:
        capture.set_capture_backend(None)
    assert 1 < mid < 12 and mid == jmid
    assert toks == jtoks == list(ra_solo.output_tokens)
    assert list(rb.output_tokens) == list(jrb.output_tokens)
    assert rb.state is RequestState.FINISHED and len(rb.output_tokens) == 6
    # one verify graph for the engine's [max_batch, k+1] signature
    assert eng.info()["spec"]["verify"]["lowerings"] == 1
    assert eng.info()["spec"]["verify"]["hits"] > 0


def test_spec_eviction_with_drafts_in_flight_returns_pages():
    """A queued request expiring and a mid-decode TTL eviction while the
    slot holds draft state return every page and drop the drafter's
    state; the slot then serves the next request bitwise the JAX
    engine's."""
    jm, pm = pair(seed=61)
    eng = ServingEngine(pm, max_batch=1, max_seq_len=64, page_size=16,
                        spec_k=3)
    ra = eng.submit(prompt(4, seed=90), max_new_tokens=30)
    eng.step()
    assert ra.state is RequestState.DECODING
    assert eng.drafter._idx, "drafter holds in-flight state for A"
    pages_a = eng.pool.info()["active_pages"]

    rb = eng.submit(prompt(4, seed=91), max_new_tokens=8, ttl=0.02)
    assert eng.pool.info()["active_pages"] > pages_a
    time.sleep(0.05)
    eng.step()
    assert rb.state is RequestState.TIMED_OUT
    with pytest.raises(RequestTimeout):
        rb.result()
    assert eng.pool.info()["active_pages"] == pages_a

    ra.deadline = type(ra.deadline)(0.0, what="expired now")
    time.sleep(0.01)
    eng.step()
    assert ra.state is RequestState.TIMED_OUT
    assert len(ra.output_tokens) > 0
    assert eng.pool.info()["active_pages"] == 0
    assert not eng.drafter._idx, "evicted request's drafter state leaked"

    rc = eng.submit(prompt(5, seed=92), max_new_tokens=4)
    eng.run()
    want = JaxEngine(jm, max_batch=1, max_seq_len=64, page_size=16,
                     spec_k=3).generate([prompt(5, seed=92)],
                                        max_new_tokens=4)
    np.testing.assert_array_equal(rc.result(), want[0])


def test_spec_capacity_guard_includes_verify_scratch():
    _, pm = pair(seed=67)
    eng = ServingEngine(pm, max_batch=2, max_seq_len=32, spec_k=4)
    with pytest.raises(ValueError, match="verify scratch"):
        eng.submit(prompt(20), max_new_tokens=10)   # 20+10+4 > 32
    assert eng.info()["rejected"] == 1
    eng2 = ServingEngine(pm, max_batch=2, max_seq_len=32)
    r = eng2.submit(prompt(20), max_new_tokens=10)
    eng2.run()
    assert r.result().size == 30


@pytest.mark.parametrize("kw", [{"temperature": 0.7}, {"top_p": 0.9,
                                                       "temperature": 1.0}])
def test_spec_engine_refuses_sampling_typed(kw):
    _, pm = pair(seed=67)
    eng = ServingEngine(pm, max_batch=2, max_seq_len=32, spec_k=2)
    with pytest.raises(SamplingUnsupported, match="SPECULATIVELY"):
        eng.submit(prompt(4), max_new_tokens=2, **kw)
    assert eng.info()["rejected"] == 1


def test_ngram_drafter_unit_equals_jax_drafter():
    """Longest-suffix match replays its continuation, the self-match falls
    back to the previous occurrence, no match repeats the last token;
    proposals are exactly k, as the JAX drafter's."""
    class R:
        rid, prompt, output_tokens = 7, np.asarray([1, 2, 3, 1, 2]), []

    outs = []
    for d in (JaxNGram(max_n=3), NGramDrafter(max_n=3)):
        R.output_tokens = []
        d.on_join(R)
        a = d.propose({0: R}, 3)
        R.output_tokens = [9]
        d.observe(R, 1)
        b = d.propose({0: R}, 2)
        d.on_evict(R)
        assert not d._idx
        outs.append((a, b, d.info()))
    assert outs[1] == outs[0]
    assert outs[1][0] == {0: [3, 1, 2]} and outs[1][1] == {0: [9, 9]}


def test_spec_info_fields_live():
    _, pm = pair(seed=71)
    eng = ServingEngine(pm, max_batch=2, max_seq_len=32, spec_k=2)
    eng.generate([prompt(4, seed=95), prompt(6, seed=96)], max_new_tokens=6)
    info = eng.info()["spec"]
    assert info["k"] == 2 and info["drafter"]["kind"] == "ngram"
    assert info["draft_tokens_proposed"] > 0 and info["draft_steps"] > 0
    assert 0.0 <= info["acceptance_rate"] <= 1.0
    hist = info["tokens_per_verify_hist"]
    assert len(hist) == 4 and sum(hist) > 0
