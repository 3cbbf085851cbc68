"""The port's sharded embedding tables against the JAX package's
(``paddle_tpu/distributed/embedding/sharded.py``), on the CPU in fp32.

- ``hash_bucket`` is bit-equal to the JAX function over ids beyond 2**32
  and negative ids, hashed and not; the static-size unique is
  ``jnp.unique(size=L, fill_value=0, return_inverse=True)``'s.
- dp1 (no mesh): ``ShardedEmbedding`` is bitwise the port's dense
  ``Embedding`` from the same seed, its lookup bitwise the JAX dense
  gather on the same table; a table the axis does not divide stays whole
  and dense.
- dp2 (two gloo ranks, ``tests/torch_dist.py``, spawned once): each rank
  holds its block of rows; the exchange's output is bitwise the dense
  gather and its grad equals the dense gather's within 1e-6 (rtol; each
  rank sums its own duplicates before the owner adds the ranks'), inside
  ``comms.quantized("int8")`` the output within the blockwise bound
  ``absmax / 254`` and the grad within 10% of the exact one; a unique
  beyond its owner's capacity reads the zero embedding; the comms sites
  are the JAX test's.
- ``table_param_spec`` plans through the port's ``reshard`` planner as
  through the JAX one: the same bytes moved and local, the same lost
  bricks, and ``redistribute`` moves the rows bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.distributed import reshard as jrs
from paddle_tpu.distributed.embedding import hash_bucket as jax_hash
from paddle_tpu.distributed.embedding import \
    table_param_spec as jax_table_spec

from paddle_tpu_torch.distributed import reshard as prs
from paddle_tpu_torch.distributed.embedding import (ShardedEmbedding,
                                                    hash_bucket,
                                                    sharded_lookup,
                                                    table_param_spec,
                                                    unique_static)
from paddle_tpu_torch.nn.layer import Embedding

from torch_dist import spawn


@pytest.mark.parametrize("hashed", [True, False])
@pytest.mark.parametrize("buckets", [64, 1000, 1 << 24])
def test_hash_bucket_bit_equal_to_jax(hashed, buckets):
    ids = np.random.RandomState(0).randint(-2 ** 40, 2 ** 41, 4096)
    ids = np.concatenate([ids, [0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5,
                                -1, -(2 ** 31)]]).astype(np.int64)
    got = hash_bucket(torch.from_numpy(ids), buckets, hashed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_hash(ids, buckets, hashed)))


def test_unique_static_is_jnp_unique_with_size():
    for seed, hi in ((0, 30), (1, 5), (2, 1000)):
        flat = np.random.RandomState(seed).randint(0, hi, 64)
        u, inv = unique_static(torch.from_numpy(flat))
        ju, jinv = jnp.unique(jnp.asarray(flat), size=64, fill_value=0,
                              return_inverse=True)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(inv.numpy(),
                                      np.asarray(jinv).reshape(-1))


def test_dp1_bitwise_the_dense_embedding_and_the_jax_gather():
    gen = torch.Generator().manual_seed(11)
    sharded = ShardedEmbedding(32, 8, device="cpu", generator=gen,
                               mesh=None)
    dense = Embedding(32, 8, device="cpu",
                      generator=torch.Generator().manual_seed(11))
    assert sharded.shards == 1 and sharded.weight.row_sharded is None
    assert torch.equal(sharded.weight, dense.weight)
    ids = np.random.RandomState(0).randint(0, 32, (6, 4))
    out = sharded(torch.from_numpy(ids))
    assert torch.equal(out, dense(torch.from_numpy(ids)))
    w = sharded.weight.detach().numpy()
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(jnp.take(jnp.asarray(w),
                                                  jnp.asarray(ids), axis=0)))
    # hashed ids: the JAX module's hash then the same gather
    raw = np.random.RandomState(1).randint(0, 2 ** 40, (5, 3))
    got = sharded_lookup(torch.from_numpy(raw), sharded.weight,
                         hash_ids=True)
    rows = np.asarray(jax_hash(raw, 32, True))
    np.testing.assert_array_equal(got.detach().numpy(), w[rows])


def test_indivisible_table_stays_whole_and_dense():
    from paddle_tpu_torch.parallel.mesh import DeviceMesh
    mesh = DeviceMesh({"dp": 2}, rank=1)   # coordinates only, no groups
    layer = ShardedEmbedding(33, 4, device="cpu", mesh=mesh)
    assert layer.shards == 1 and tuple(layer.weight.shape) == (33, 4)
    assert layer.weight.row_sharded is None
    split = ShardedEmbedding(32, 4, device="cpu", mesh=mesh,
                             generator=torch.Generator().manual_seed(3))
    whole = Embedding(32, 4, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    assert split.shards == 2 and split.weight.row_sharded == "dp"
    assert torch.equal(split.weight, whole.weight[16:])
    assert split.weight.dist_layout.shape == (32, 4)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    rng = np.random.RandomState(7)
    payload = {"mesh": {"dp": 2},
               "w": rng.randn(32, 8).astype(np.float32),
               "ids": rng.randint(0, 32, (8, 4)),
               "scale": np.arange(8, dtype=np.float32),
               "hash": False,
               "w_small": rng.randn(4, 2).astype(np.float32),
               "ids_small": np.array([[0, 1], [0, 1]])}
    out = spawn("embedding", 2, tmp_path_factory.mktemp("emb"), payload)
    return payload, out


def _dense(payload):
    w = torch.from_numpy(payload["w"]).requires_grad_()
    ids = torch.from_numpy(payload["ids"])
    out = w[ids]
    (torch.tanh(out) * torch.from_numpy(payload["scale"])[:, None, None]
     ).sum().backward()
    return out.detach().numpy(), w.grad.numpy()


def test_dp2_lookup_bitwise_and_grad_equal_the_dense_gather(dp2):
    payload, outs = dp2
    ref, gref = _dense(payload)
    got = np.concatenate([o["exact"]["out"] for o in outs])
    np.testing.assert_array_equal(got, ref)
    grad = np.concatenate([o["exact"]["grad"] for o in outs])
    np.testing.assert_allclose(grad, gref, rtol=1e-6, atol=1e-7)
    sites = outs[0]["exact"]["sites"]
    for s in ("embedding.ids/all_to_all/dp", "embedding.rows/all_to_all/dp",
              "embedding.rows.grad/all_to_all/dp"):
        assert s in sites, sorted(sites)
    rows = sites["embedding.rows/all_to_all/dp"]
    assert rows["bytes_wire"] == rows["bytes_logical"] > 0
    assert sites["embedding.ids/all_to_all/dp"]["quantized"] is None


def test_dp2_int8_within_the_wire_bound(dp2):
    payload, outs = dp2
    ref, gref = _dense(payload)
    got = np.concatenate([o["int8"]["out"] for o in outs])
    bound = np.abs(payload["w"]).max() / 254 + 1e-6
    assert np.max(np.abs(got - ref)) <= bound
    grad = np.concatenate([o["int8"]["grad"] for o in outs])
    assert np.all(np.isfinite(grad))
    assert np.max(np.abs(grad - gref)) <= 0.1 * (np.abs(gref).max() + 1.0)
    sites = outs[0]["int8"]["sites"]
    rows = sites["embedding.rows/all_to_all/dp"]
    assert rows["quantized"] == "int8"
    assert rows["bytes_wire"] < rows["bytes_logical"]
    assert sites["embedding.ids/all_to_all/dp"]["quantized"] is None
    assert "embedding.rows.grad/all_to_all/dp" in sites


def test_dp2_capacity_overflow_reads_the_zero_embedding(dp2):
    payload, outs = dp2
    w = payload["w_small"]
    for o in outs:
        np.testing.assert_array_equal(o["overflow"][0, 0], w[0])
        np.testing.assert_array_equal(o["overflow"][0, 1], np.zeros(2))


def _plans(rs, spec_fn, src, dst, avail=None):
    table = {"table": spec_fn(16, 4, src_axis=src[1], dst_axis=dst[1])}
    s = rs.MeshSpec.from_members(src[0], shape={"mp": len(src[0])})
    d = rs.MeshSpec.from_members(dst[0], shape={"mp": len(dst[0])})
    return rs.plan_reshard(s, d, table, available=avail)


@pytest.mark.parametrize("case", ["grow", "shrink_lost", "replicated"])
def test_table_param_spec_plans_as_the_jax_planner(case):
    src, dst, avail = {
        "grow": ((["a", "b"], "mp"), (["a", "b", "c", "d"], "mp"), None),
        "shrink_lost": ((["a", "b", "c", "d"], "mp"), (["a", "b"], "mp"),
                        {"a", "b", "c"}),
        "replicated": ((["a"], None), (["a", "b"], "mp"), None)}[case]
    mine = _plans(prs, table_param_spec, src, dst, avail)
    ref = _plans(jrs, jax_table_spec, src, dst, avail)
    assert (mine.bytes_moved, mine.bytes_local) == \
        (ref.bytes_moved, ref.bytes_local)
    assert mine.recoverable_from_peers == ref.recoverable_from_peers
    assert sorted(p.index for p in mine.lost) == \
        sorted(p.index for p in ref.lost)
    assert mine.digest() == ref.digest()
    if case == "shrink_lost":
        assert {p.index[0] for p in mine.lost} == {(12, 16)}
        return
    full = np.arange(64, dtype=np.float32).reshape(16, 4)
    n_src = len(src[0])
    states = {o: {"table": full[i * 16 // n_src:(i + 1) * 16 // n_src]
                  if src[1] else full.copy()}
              for i, o in enumerate(src[0])}
    s = prs.MeshSpec.from_members(src[0], shape={"mp": n_src})
    d = prs.MeshSpec.from_members(dst[0], shape={"mp": len(dst[0])})
    out, _ = prs.redistribute(s, d, {"table": table_param_spec(
        16, 4, src_axis=src[1], dst_axis=dst[1])}, states)
    n = len(dst[0])
    for i, o in enumerate(dst[0]):
        np.testing.assert_array_equal(out[o]["table"],
                                      full[i * 16 // n:(i + 1) * 16 // n])
