"""The port's prefix sharing, chunked prefill and degradation ladder, held
against the JAX engine's.

Both engines serve the same weights (fp32, CPU). Tokens must be bitwise
the JAX engine's, and the counters (shared joins, pages saved, chunks)
equal; the page pool and the radix tree must give the JAX answers for the
same operations; the ladder must enter and leave levels 1-3 at the JAX
thresholds on the same queue script.
"""
import time

import numpy as np
import pytest

from paddle_tpu.inference.serving import KVPagePool as JaxPool
from paddle_tpu.inference.serving import PrefixCache as JaxPrefix
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.utils.deadline import EngineOverloaded as JaxOverloaded
from paddle_tpu_torch.inference.serving import (
    KVPagePool, PageUncommitted, PrefixCache, RequestState, ServingEngine)
from paddle_tpu_torch.jit import capture
from paddle_tpu_torch.utils.deadline import EngineOverloaded, RequestTimeout
from torch_pairs import assert_same_outputs, pair, prompt
from torch_replay import ReplayBackend

_KEYS = ("prefills", "decode_steps", "tokens_generated", "prefill_chunks",
         "chunked_prefills", "shared_prefix_joins", "prefill_pages_saved",
         "finished", "timed_out")


def _counters(info):
    return {k: info[k] for k in _KEYS}


@pytest.fixture(scope="module")
def models():
    return pair(seed=7)


# ---------------------------------------------------------------------------
# the pool and the tree
# ---------------------------------------------------------------------------

def test_kv_pool_refcounts_retain_share_commit():
    pool = KVPagePool(total_pages=4, page_size=8)
    a = pool.alloc(2)
    pool.retain(a)
    assert all(p.refs == 2 for p in a)
    pool.release(a)
    assert pool.free_pages == 2        # still held once
    with pytest.raises(PageUncommitted) as ei:
        pool.share(a)
    assert ei.value.page is a[0]
    assert all(p.refs == 1 for p in a), "a failed share must take no refs"
    pool.commit(a)
    pool.share(a)
    assert all(p.refs == 2 for p in a) and pool.info()["shared"] == 2
    pool.release(a)
    pool.release(a)
    assert pool.free_pages == 4
    with pytest.raises(ValueError):
        pool.retain(a)
    with pytest.raises(ValueError):
        pool.commit(a)
    # released pages lose the committed mark: a recycled page is never
    # shareable before its new prefill commits it
    fresh = pool.alloc(4)
    with pytest.raises(PageUncommitted):
        pool.share(fresh)


def _tree_script(pool_cls, tree_cls):
    """One script of share / insert / evict on a 16-page pool of 4-token
    pages; returns every answer the tree and the pool give."""
    pool = pool_cls(total_pages=16, page_size=4)
    tree = tree_cls(pool)
    p1 = np.arange(14)                            # 3 full pages + 2 tokens
    p2 = np.concatenate([np.arange(8), [50, 51, 52, 53, 54]])
    out = [tree.share(p1)[2]]                     # empty tree: a miss
    own1 = pool.alloc(4)
    pool.commit(own1[:3])
    out.append(tree.insert(p1, 0, own1[:3], lambda i: ("kv", i)))
    pages, kvs, slen = tree.share(p2)             # 2 pages of p1 shared
    out += [slen, kvs, [p.refs for p in pages]]
    own2 = pool.alloc(2)
    pool.commit(own2[:1])
    out.append(tree.insert(p2, slen, own2[:1], lambda i: ("kv2", i)))
    out.append(tree.share(np.arange(9))[2])       # capped at plen - 1
    out.append(tree.evict(99))                    # all pinned by requests
    pool.release(own1)
    pool.release(own2)
    pool.release(pages)
    pool.release(tree.share(np.arange(9))[0])
    out.append(tree.evict(2))                     # oldest leaves first
    out.append(tree.info())
    out.append(tree.clear())
    out += [tree.info(), pool.info()]
    return out


def test_prefix_cache_answers_equal_the_jax_tree():
    assert _tree_script(KVPagePool, PrefixCache) == \
        _tree_script(JaxPool, JaxPrefix)


# ---------------------------------------------------------------------------
# prefix sharing through the engine
# ---------------------------------------------------------------------------

def _serve_one_at_a_time(eng, prompts, new):
    outs = []
    for p in prompts:
        r = eng.submit(p, max_new_tokens=new)
        eng.run()
        outs.append(r.result())
    return outs


def test_prefix_sharing_engine_bitwise_jax_with_equal_counters(models):
    jm, pm = models
    rng = np.random.RandomState(5)
    common = rng.randint(0, 64, (32,))            # 2 full pages of 16
    prompts = [np.concatenate([common, rng.randint(0, 64, (3 + i,))])
               for i in range(8)]
    kw = dict(max_batch=4, max_seq_len=64, page_size=16, prefix_sharing=True)
    jeng = JaxEngine(jm, **kw)
    want = _serve_one_at_a_time(jeng, prompts, 6)
    eng = ServingEngine(pm, **kw)
    got = _serve_one_at_a_time(eng, prompts, 6)
    assert_same_outputs(want, got)
    info = eng.info()
    assert _counters(info) == _counters(jeng.info())
    assert info["shared_prefix_joins"] == 7
    assert info["prefill_pages_saved"] == 14
    assert info["prefix"] == jeng.info()["prefix"]
    # refcount law: only the tree's own pages stay active at idle
    assert info["pool"]["active_pages"] == info["prefix"]["pages_held"]
    plain = ServingEngine(pm, max_batch=4, max_seq_len=64, page_size=16)
    assert_same_outputs(plain.generate(prompts, max_new_tokens=6), got)


def test_prefix_join_time_rewalk_bitwise_jax(models):
    """Submitted together, the borrowers miss the tree at submit and hit
    it at join, after the donor's prefill committed."""
    jm, pm = models
    common = prompt(40, seed=11)
    prompts = [np.concatenate([common, prompt(2 + i, seed=20 + i)])
               for i in range(3)]
    kw = dict(max_batch=4, max_seq_len=64, page_size=8, prefix_sharing=True)
    jeng = JaxEngine(jm, **kw)
    want = jeng.generate(prompts, max_new_tokens=5)
    eng = ServingEngine(pm, **kw)
    got = eng.generate(prompts, max_new_tokens=5)
    assert_same_outputs(want, got)
    assert _counters(eng.info()) == _counters(jeng.info())
    assert eng.info()["shared_prefix_joins"] == 2


def test_prefix_tree_eviction_respects_refcounts(models):
    _, pm = models
    eng = ServingEngine(pm, max_batch=2, max_seq_len=64, page_size=16,
                        prefix_sharing=True)
    donor = prompt(33, seed=21)
    ra = eng.submit(donor, max_new_tokens=20)
    eng.step()
    assert eng.prefix_cache.info()["pages_held"] == 2
    rb = eng.submit(donor, max_new_tokens=4)
    eng.step()
    assert rb.shared_len == 32
    assert eng.prefix_cache.evict(99) == 0, \
        "evicted a page a live request shares"
    eng.run()
    assert ra.state is rb.state is RequestState.FINISHED
    big1 = eng.submit(prompt(40, seed=22), max_new_tokens=24)
    big2 = eng.submit(prompt(40, seed=23), max_new_tokens=24)
    eng.run()
    assert big1.state is big2.state is RequestState.FINISHED
    assert eng.prefix_cache.info()["pages_evicted"] >= 1


def test_fork_during_chunked_prefill_misses_tree_bitwise_jax(models):
    jm, pm = models
    p = prompt(40, seed=31)
    kw = dict(max_batch=2, max_seq_len=64, page_size=16,
              prefix_sharing=True, prefill_chunk=16)
    runs = []
    for eng in (JaxEngine(jm, **kw), ServingEngine(pm, **kw)):
        ra = eng.submit(p, max_new_tokens=5)
        eng.step()
        assert ra.state.name == "PREFILL"
        rb = eng.submit(p, max_new_tokens=5)
        eng.step()
        assert rb.shared_len == 0, "B shared pages of an in-flight prefill"
        eng.run()
        rc = eng.submit(p, max_new_tokens=5)
        eng.run()
        assert rc.shared_len == 32
        runs.append(([ra.result(), rb.result(), rc.result()],
                     _counters(eng.info())))
    assert_same_outputs(runs[0][0], runs[1][0])
    assert runs[1][1] == runs[0][1]


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def test_chunked_prefill_bitwise_jax_with_equal_counters(models):
    jm, pm = models
    prompts = [prompt(45, seed=41), prompt(37, seed=42), prompt(6, seed=43)]
    kw = dict(max_batch=4, max_seq_len=64, prefill_chunk=16)
    jeng = JaxEngine(jm, **kw)
    want = jeng.generate(prompts, max_new_tokens=6)
    backend = ReplayBackend()
    capture.set_capture_backend(backend)
    try:
        eng = ServingEngine(pm, **kw)
        got = eng.generate(prompts, max_new_tokens=6)
    finally:
        capture.set_capture_backend(None)
    assert_same_outputs(want, got)
    info = eng.info()
    assert _counters(info) == _counters(jeng.info())
    assert info["chunked_prefills"] == 2 and info["prefill_chunks"] == 6
    # one window graph per scratch buffer the engine used (two prompts
    # prefilled side by side); the JAX engine lowers the window once
    assert info["window"]["lowerings"] == len(eng._free_scratch) == 2
    assert info["pool"]["active_pages"] == 0


def test_chunked_prefill_interleaves_decode_steps_like_jax(models):
    """While a long prompt prefills window by window, the decoding request
    emits one token every engine step, in both engines, and both streams
    are bitwise the JAX engine's."""
    jm, pm = models
    runs = []
    for eng in (JaxEngine(jm, max_batch=4, max_seq_len=64, prefill_chunk=8),
                ServingEngine(pm, max_batch=4, max_seq_len=64,
                              prefill_chunk=8)):
        ra = eng.submit(prompt(5, seed=51), max_new_tokens=20)
        eng.step()
        eng.step()
        rb = eng.submit(prompt(45, seed=52), max_new_tokens=4)
        steps = 0
        while rb.state.name != "DECODING" and not rb.done:
            before = len(ra.output_tokens)
            eng.step()
            steps += 1
            assert len(ra.output_tokens) == before + 1, \
                "a decode step stalled behind the long prompt's prefill"
        eng.run()
        runs.append((list(ra.output_tokens), rb.result(), steps,
                     _counters(eng.info())))
    assert runs[1][0] == runs[0][0]
    np.testing.assert_array_equal(runs[1][1], runs[0][1])
    assert runs[1][2] == runs[0][2] == 6      # ceil(45 / 8) windows
    assert runs[1][3] == runs[0][3]


def test_chunked_prefill_ttl_eviction_returns_everything(models):
    _, pm = models
    eng = ServingEngine(pm, max_batch=2, max_seq_len=64, prefill_chunk=8)
    ra = eng.submit(prompt(45, seed=61), max_new_tokens=8, ttl=0.01)
    eng.step()
    assert ra.state is RequestState.PREFILL and ra.scratch is not None
    time.sleep(0.03)
    eng.step()
    assert ra.state is RequestState.TIMED_OUT
    assert ra.scratch is None and len(eng._free_scratch) == 1
    assert eng.pool.info()["active_pages"] == 0
    with pytest.raises(RequestTimeout):
        ra.result()
    rb = eng.submit(prompt(5, seed=62), max_new_tokens=4)
    eng.run()
    assert rb.state is RequestState.FINISHED


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------

def _ladder_script(eng, n_queued, new=2):
    levels = []
    for i in range(n_queued):
        eng.submit(prompt(4, seed=20 + i), max_new_tokens=new)
    while not eng.scheduler.idle:
        eng.step()
        levels.append(eng.pressure_level)
    return levels, eng.info()["pressure"]


@pytest.mark.parametrize("n_queued", [4, 6, 7, 8])
def test_ladder_levels_follow_the_jax_thresholds(models, n_queued):
    jm, pm = models
    kw = dict(max_batch=1, max_seq_len=64, max_queue=8)
    want = _ladder_script(JaxEngine(jm, **kw), n_queued)
    got = _ladder_script(ServingEngine(pm, **kw), n_queued)
    assert got == want
    assert max(got[0]) == {4: 1, 6: 2, 7: 2, 8: 3}[n_queued]
    assert got[0][-1] == 0


def test_ladder_level1_trims_prefix_tree_like_jax(models):
    jm, pm = models
    kw = dict(max_batch=1, max_seq_len=64, max_queue=4, page_size=16,
              prefix_sharing=True)
    runs = []
    for eng in (JaxEngine(jm, **kw), ServingEngine(pm, **kw)):
        eng.generate([prompt(32, seed=30)], max_new_tokens=2)
        held = eng.info()["prefix"]["pages_held"]
        eng.submit(prompt(4, seed=31), max_new_tokens=2)
        eng.submit(prompt(4, seed=32), max_new_tokens=2)
        eng.step()
        mid = (eng.pressure_level, eng.info()["prefix"]["pages_held"],
               dict(eng.info()["pressure"]))
        eng.run()
        out = eng.generate([prompt(32, seed=30)], max_new_tokens=2)
        runs.append((held, mid, eng.info()["prefix"]["pages_held"],
                     eng.info()["pressure"]["prefix_paused"], out))
    assert runs[1][:4] == runs[0][:4]
    assert_same_outputs(runs[0][4], runs[1][4])
    held, (level, trimmed, pressure), regrown, paused, _ = runs[1]
    assert held > 0 and level >= 1 and trimmed == 0
    assert pressure["prefix_paused"] == 1 and pressure["pressure_trims"] == 1
    assert regrown > 0 and paused == 0


def test_ladder_level2_pauses_spec_and_returns_scratch_like_jax(models):
    jm, pm = models
    kw = dict(max_batch=1, max_seq_len=64, max_queue=4, spec_k=2,
              page_size=4)
    runs = []
    for eng in (JaxEngine(jm, **kw), ServingEngine(pm, **kw)):
        assert eng.scheduler.reserve_extra == 2
        for i in range(3):
            eng.submit(prompt(4, seed=40 + i), max_new_tokens=3)
        req = eng.submit(prompt(4, seed=43), max_new_tokens=3)
        with pytest.raises((EngineOverloaded, JaxOverloaded)):
            eng.submit(prompt(4, seed=44), max_new_tokens=3)
        eng.step()
        mid = (eng.pressure_level, dict(eng.info()["pressure"]),
               eng.scheduler.reserve_extra)
        eng.run()
        runs.append((mid, eng.pressure_level, eng.scheduler.reserve_extra,
                     req.result()))
    assert runs[1][:3] == runs[0][:3]
    np.testing.assert_array_equal(runs[1][3], runs[0][3])
    (level, pressure, extra), level_end, extra_end, _ = runs[1]
    assert level >= 2 and extra == 0
    assert pressure["spec_paused"] == 1 and pressure["spec_pauses"] == 1
    assert pressure["scratch_pages_returned"] > 0
    assert level_end == 0 and extra_end == 2


def test_ladder_level3_one_window_per_step_like_jax(models):
    """At level 3 only one scratch prefill advances a step."""
    jm, pm = models
    kw = dict(max_batch=2, max_seq_len=64, max_queue=5, prefill_chunk=8)
    runs = []
    for eng in (JaxEngine(jm, **kw), ServingEngine(pm, **kw)):
        long_a = eng.submit(prompt(30, seed=70), max_new_tokens=2)
        long_b = eng.submit(prompt(30, seed=71), max_new_tokens=2)
        for i in range(3):
            eng.submit(prompt(4, seed=72 + i), max_new_tokens=2)
        chunks = []
        while not eng.scheduler.idle:
            eng.step()
            chunks.append((eng.pressure_level,
                           eng.info()["prefill_chunks"]))
        runs.append((chunks, long_a.result(), long_b.result()))
    assert runs[1][0] == runs[0][0]
    assert_same_outputs(runs[0][1:], runs[1][1:])
    assert runs[1][0][0] == (3, 1)    # level 3 at once: one window only
