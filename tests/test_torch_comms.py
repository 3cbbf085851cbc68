"""The port's comms layer against the JAX package's
(``paddle_tpu/distributed/comms``), after tests/test_comms.py.

- The wire format: int8 and fp8 payloads and scales bitwise the JAX
  package's at deterministic rounding, the round trip too; the four
  docstring contracts as known-answer tests (all-zero block, inf/nan
  guard, odd tail block, stochastic rounding unbiased and repeatable from
  a seed, fp8 with stochastic rounding refused); the byte counts.
- The local leg of ``quantized_all_reduce`` and its CommOp record, the
  context's guards and cache key, the schedule and the per-site
  aggregate.
- On 2 and 4 gloo ranks (``tests/torch_dist.py``): the quantized two-shot
  all-reduce (sum and avg), the quantized all-gather and all-to-all of
  different per-rank inputs against the JAX ones run per rank inside
  ``shard_map``, and ``grad_sync`` of replicated grads against the JAX
  ``grad_sync``; the CommOp byte records against the JAX records.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from paddle_tpu.distributed import comms as J
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu_torch.distributed import comms as T

import torch_dist

BLOCK = 64


def _q_both(x, dtype, block):
    jq, js = J.quantize_blockwise(jnp.asarray(x), dtype, block)
    tq, ts = T.quantize_blockwise(torch.from_numpy(x), dtype, block)
    return jq, js, tq, ts


def _bytes(q):
    a = np.asarray(q)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("size,block", [(1000, 256), (512, 64), (37, 16)])
def test_payload_and_scales_bitwise_jax(dtype, size, block):
    x = (np.random.RandomState(size).randn(size) *
         np.random.RandomState(1).choice([1e-3, 1.0, 50.0], size)
         ).astype(np.float32)
    jq, js, tq, ts = _q_both(x, dtype, block)
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back_j = J.dequantize_blockwise(jq, js, x.shape, jnp.float32, block)
    back_t = T.dequantize_blockwise(tq, ts, x.shape, torch.float32, block)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))


def test_all_zero_block_scale_one_and_exact_zeros():
    x = np.zeros(2 * BLOCK, np.float32)
    x[BLOCK:] = np.linspace(-1, 1, BLOCK)
    for dtype in ("int8", "fp8"):
        q, s = T.quantize_blockwise(torch.from_numpy(x), dtype, BLOCK)
        assert float(s[0]) == 1.0
        back = T.dequantize_blockwise(q, s, x.shape, torch.float32, BLOCK)
        assert torch.all(back[:BLOCK] == 0)


def test_inf_nan_guard_matches_jax():
    x = np.linspace(-2, 2, BLOCK).astype(np.float32)
    x[3], x[7], x[9] = np.nan, np.inf, -np.inf
    for dtype in ("int8", "fp8"):
        jq, js, tq, ts = _q_both(x, dtype, BLOCK)
        finite_max = np.abs(x[np.isfinite(x)]).max()
        qmax = 127.0 if dtype == "int8" else 448.0
        assert float(ts[0]) == np.float32(finite_max) / np.float32(qmax)
        back = T.dequantize_blockwise(tq, ts, x.shape, torch.float32,
                                      BLOCK).numpy()
        assert back[3] == 0.0 and np.isfinite(back).all()
        np.testing.assert_allclose(back[7], finite_max, rtol=1e-6)
        np.testing.assert_allclose(back[9], -finite_max, rtol=1e-6)
        np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                      _bytes(jq))


def test_odd_tail_block_round_trips_the_shape():
    x = np.random.RandomState(2).randn(3, 7, 5).astype(np.float32)
    q, s = T.quantize_blockwise(torch.from_numpy(x), "int8", BLOCK)
    assert q.shape == (2 * BLOCK,) and s.shape == (2,)
    back = T.dequantize_blockwise(q, s, x.shape, torch.float32, BLOCK)
    assert back.shape == x.shape
    np.testing.assert_allclose(back.numpy(), x,
                               atol=float(np.abs(x).max()) / 127)


def test_stochastic_rounding_unbiased_and_repeatable():
    x = torch.full((BLOCK,), 0.3)
    x[0] = 1.0                                    # scale = 1 / 127
    draws = []
    for seed in range(200):
        g = torch.Generator().manual_seed(seed)
        q, s = T.quantize_blockwise(x, "int8", BLOCK, stochastic=True,
                                    generator=g)
        draws.append(T.dequantize_blockwise(q, s, x.shape,
                                            torch.float32, BLOCK)[1:])
    mean = torch.stack(draws).mean()
    assert abs(float(mean) - 0.3) < 2e-4          # rounding alone: 1.1e-3
    a = T.quantize_blockwise(x, "int8", BLOCK, True,
                             torch.Generator().manual_seed(5))
    b = T.quantize_blockwise(x, "int8", BLOCK, True,
                             torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="int8"):
        T.quantize_blockwise(x, "fp8", BLOCK, stochastic=True,
                             generator=torch.Generator())
    with pytest.raises(ValueError):
        T.quantize_blockwise(x, "int8", BLOCK, stochastic=True)
    with pytest.raises(ValueError):
        with T.quantized("fp8", stochastic=True,
                         generator=torch.Generator()):
            pass
    with pytest.raises(ValueError):
        with T.quantized("int4"):
            pass


@pytest.mark.parametrize("size", [1, 255, 256, 1000, 4096])
def test_byte_counts_match_jax(size):
    for dtype in ("int8", "fp8"):
        assert T.wire_bytes(size, dtype, 256) == J.wire_bytes(size, dtype,
                                                              256)
    assert T.logical_bytes(size, 2) == J.logical_bytes(size, 2)


def test_local_quantized_all_reduce_and_record_match_jax():
    """No mesh: the quantize -> dequantize round trip, bitwise the JAX
    local leg, recorded with nothing on the wire."""
    x = np.random.RandomState(3).randn(300).astype(np.float32)
    J.comm_clear()
    T.comm_clear()
    with J.quantized("int8", block=BLOCK), J.step_schedule() as js:
        jo = J.quantized_all_reduce(jnp.asarray(x), owner="t")
    with T.quantized("int8", block=BLOCK), T.step_schedule() as ts:
        to = T.quantized_all_reduce(torch.from_numpy(x), owner="t")
        assert T.comms_cache_key() == ("int8", BLOCK, False)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    (jop,), (top,) = js.ops, ts.ops
    for f in ("kind", "bytes_logical", "bytes_wire", "quantized", "site",
              "shape"):
        assert getattr(top, f) == getattr(jop, f), f
    assert top.staged_bytes == 0 and T.comms_cache_key() is False
    info = T.comm_info()
    assert info["sites"]["t/all_reduce/local"]["count"] == 1
    assert info["total_staged"] == 0
    with pytest.raises(ValueError, match="quantized"):
        T.quantized_all_reduce(torch.from_numpy(x))
    grads = [torch.ones(3)]
    assert T.grad_sync(grads)[0] is grads[0]


def test_comm_op_and_schedule_accounting():
    op = T.CommOp(owner="o", site="o/all_reduce/dp", kind="all_reduce",
                  axis="dp", shape=(4,), dtype="float32", bytes_logical=400,
                  bytes_wire=100, staged_bytes=32)
    assert op.compression == 4.0
    with T.step_schedule("s") as s:
        T.record(op)
        T.record(T.CommOp(owner="o", site="o/all_reduce/dp",
                          kind="all_reduce", axis="dp", shape=(4,),
                          dtype="float32", bytes_logical=16, bytes_wire=16))
    assert [o.seq for o in s.ops] == [0, 1]
    assert (s.bytes_logical(), s.bytes_wire(), s.bytes_staged()) == \
        (416, 116, 32)


# ---------------------------------------------------------------------------
# on ranks
# ---------------------------------------------------------------------------

WORLDS = {2: ({"dp": 2}, "dp"), 4: ({"dp": 4}, "dp")}


def _inputs(world):
    r = np.random.RandomState(10 + world)
    x = (r.randn(world, 200) * 3).astype(np.float32)
    blocks = r.randn(world, world, 70).astype(np.float32)
    grads = [r.randn(40, 16).astype(np.float32),
             r.randn(7).astype(np.float32),
             r.randn(300).astype(np.float32)]
    return x, blocks, grads


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comms")
    jobs = []
    for world, (mesh, axis) in WORLDS.items():
        x, blocks, grads = _inputs(world)
        payload = {"mesh": mesh, "axis": axis, "x": x, "blocks": blocks,
                   "grads": [grads] * world, "block": BLOCK}

        def job(world=world, payload=payload):
            return {world: torch_dist.spawn("comms", world, tmp, payload)}
        jobs.append(([world], job))
    runs = torch_dist.Background(jobs)      # spawns beside the JAX side
    yield runs
    runs.join()


_JAX = {}


def _jax(world, dtype):
    """The JAX side for one (world, wire dtype), traced once: the per-rank
    two-shot sum and avg, all-gather and all-to-all inside one
    ``shard_map``, and ``grad_sync`` of the replicated grads under one
    ``jit``; each with its CommOp records."""
    if (world, dtype) in _JAX:
        return _JAX[(world, dtype)]
    x, blocks, grads = _inputs(world)
    mesh_shape, axis = WORLDS[world]
    mesh = jmesh.init_mesh(mesh_shape)

    def body(v, b):
        v, b = v[0], b[0]
        return tuple(o[None] for o in (
            J.wire_all_reduce(v, axis, "sum", owner="t"),
            J.wire_all_reduce(v, axis, "avg", owner="t"),
            J.wire_all_gather(v, axis, owner="t"),
            J.wire_all_to_all(b, axis, owner="t")))
    try:
        with J.quantized(dtype, block=BLOCK):
            with J.step_schedule() as ops:
                f = jax.shard_map(body, mesh=mesh, in_specs=(PS(axis),) * 2,
                                  out_specs=(PS(axis),) * 4, check_vma=False)
                per_rank = [np.asarray(o) for o in
                            f(jnp.asarray(x), jnp.asarray(blocks))]
            with J.step_schedule() as gops:
                synced = jax.jit(lambda gs: J.grad_sync(gs, mesh=mesh,
                                                        axis=axis))(
                    [jnp.asarray(g) for g in grads])
    finally:
        jmesh.set_mesh(None)
    _JAX[(world, dtype)] = (per_rank, ops.ops,
                            [np.asarray(g) for g in synced], gops.ops)
    return _JAX[(world, dtype)]


def _rec(op):
    return (op.kind, op.bytes_logical, op.bytes_wire, op.quantized)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_two_shot_all_reduce_matches_jax(port, world, dtype):
    x, _, _ = _inputs(world)
    (want_sum, want_avg, _, _), jops, _, _ = _jax(world, dtype)
    for key, want, jop in ((f"ar_{dtype}", want_sum, jops[0]),
                           (f"ar_avg_{dtype}", want_avg, jops[1])):
        got = np.stack([res[key] for res in port[world]])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        # every rank holds the same reduction
        assert all(np.array_equal(got[0], g) for g in got)
    trec = port[world][0][f"ar_ops_{dtype}"]
    assert [t[:4] for t in trec] == [_rec(o) for o in jops[:2]]
    assert all(t[4] == 0 for t in trec)                # no host staging
    exact = x.sum(axis=0)
    for res in port[world]:
        np.testing.assert_allclose(res[f"ar_{dtype}"], exact,
                                   atol=0.05 * np.abs(x).max() * world)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_all_gather_and_all_to_all_match_jax(port, world, dtype):
    (_, _, want_ag, want_a2a), _, _, _ = _jax(world, dtype)
    np.testing.assert_array_equal(
        np.stack([res[f"ag_{dtype}"] for res in port[world]]), want_ag)
    np.testing.assert_array_equal(
        np.stack([res[f"a2a_{dtype}"] for res in port[world]]), want_a2a)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_grad_sync_and_records_match_jax(port, world, dtype):
    """Replicated grads: the port's sync (the mean over dp) equals the JAX
    ``grad_sync`` (a quantized mean of the GSPMD-reduced values); the
    leaf below one block per rank stays exact in both."""
    _, _, want, gops = _jax(world, dtype)
    for res in port[world]:
        for a, b in zip(res[f"gs_{dtype}"], want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    trec = [o for o in port[world][0][f"gs_ops_{dtype}"] if o[3]]
    assert trec == [_rec(o) for o in gops]


@pytest.mark.parametrize("world", list(WORLDS))
def test_exact_path_and_staging(port, world):
    x, _, grads = _inputs(world)
    for res in port[world]:
        np.testing.assert_allclose(res["ar_exact"], x.sum(axis=0),
                                   rtol=1e-6, atol=1e-6)
        for a, g in zip(res["gs_exact"], grads):
            np.testing.assert_allclose(a, g, rtol=1e-6)
        for kind, logical, wire, quant, staged in res["exact_ops"]:
            assert kind == "all_reduce" and quant is None
            assert logical == wire and staged == 0
        assert res["info"]["total_staged"] == 0
        assert res["info"]["total_wire"] < res["info"]["total_logical"]
