"""The port's ``DeviceMesh`` against the JAX package's mesh.

Ranks are laid out row-major over the axes, as the JAX package reshapes
its device list (``paddle_tpu/parallel/mesh.py:38-44``): for every rank
and axis, the port's slice of ranks equals the device ids along that axis
of the JAX mesh, and on four gloo ranks (``tests/torch_dist.py``) the
process group of each slice holds exactly those ranks (an all-reduce of
the rank ids sums them). ``shard_batch`` keeps the block the JAX
function's sharding puts on the rank's device; ``elastic_mesh_shape``
gives the JAX function's answers.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.distributed.parallel import shard_batch as jax_shard_batch
from paddle_tpu.parallel import mesh as jmesh
import paddle_tpu as P
from paddle_tpu_torch.distributed import shard_batch
from paddle_tpu_torch.parallel import mesh as pmesh

import torch_dist

SHAPES = [{"dp": 2, "mp": 2}, {"dp": 2, "pp": 2, "mp": 2}, {"sep": 4},
          {"dp": 1, "sep": 2, "mp": 4}, {"dp": 4, "mp": 2}]


@pytest.fixture(autouse=True)
def _clean():
    jmesh.set_mesh(None)
    pmesh.set_mesh(None)
    yield
    jmesh.set_mesh(None)
    pmesh.set_mesh(None)


def _jax_ids(shape):
    m = jmesh.init_mesh(shape)
    return np.vectorize(lambda d: d.id)(m.devices)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_row_major_layout_matches_the_jax_mesh(shape):
    ids = _jax_ids(shape)
    names = list(shape)
    for r in range(ids.size):
        m = pmesh.DeviceMesh(shape, rank=r)
        where = tuple(int(c[0]) for c in np.nonzero(ids == r))
        assert tuple(m.coords[a] for a in names) == where
        for i, a in enumerate(names):
            idx = list(where)
            idx[i] = slice(None)
            assert m.axis_ranks(a) == ids[tuple(idx)].tolist(), (r, a)
            assert m.axis_index(a) == where[i]
        assert m.axis_ranks(None) == list(range(ids.size))


@pytest.mark.parametrize("template,n", [({"dp": 2, "mp": 2}, 8),
                                        ({"dp": 4, "pp": 2}, 4),
                                        ({"dp": 1, "sep": 2, "mp": 2}, 12)])
def test_elastic_mesh_shape_matches_jax(template, n):
    assert pmesh.elastic_mesh_shape(template, n) == \
        jmesh.elastic_mesh_shape(template, n)
    for bad in (n + 1, 0):
        with pytest.raises(ValueError):
            jmesh.elastic_mesh_shape(template, bad)
        with pytest.raises(ValueError):
            pmesh.elastic_mesh_shape(template, bad)


def test_mesh_helpers_without_a_world():
    """No mesh: extent 1 and coordinate 0, as the JAX helpers; a one-rank
    mesh needs no process group; a bigger one needs init_parallel_env."""
    assert pmesh.mesh_axis_size("dp") == jmesh.mesh_axis_size("dp") == 1
    assert pmesh.axis_index("dp") == 0 and not pmesh.has_mesh()
    m = pmesh.init_mesh({"dp": 1, "mp": 1}, device="cpu")
    assert pmesh.get_mesh() is m and m.group("dp") is None
    assert pmesh.mesh_axis_size("mp") == 1
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        pmesh.init_mesh({"dp": 2}, device="cpu")
    with pytest.raises(ValueError):
        pmesh.init_mesh([2, 2], ["dp"])


@pytest.mark.parametrize("shape", [{"dp": 2, "mp": 2}, {"sep": 4}])
def test_shard_batch_keeps_the_jax_block(shape):
    """Each rank's block of a global batch is the shard the JAX function
    places on that rank's device."""
    x = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    axis = next(iter(shape))
    jm = jmesh.init_mesh(shape)
    placed = jax_shard_batch(P.to_tensor(x), axis=axis)._value
    by_dev = {s.device.id: np.asarray(s.data)
              for s in placed.addressable_shards}
    import torch
    for r in range(jm.devices.size):
        pmesh.set_mesh(pmesh.DeviceMesh(shape, rank=r))
        np.testing.assert_array_equal(
            shard_batch(torch.from_numpy(x), axis=axis).numpy(), by_dev[r])
        np.testing.assert_array_equal(shard_batch(x, axis=axis), by_dev[r])
    jnp.zeros(()).block_until_ready()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    batch = np.arange(4 * 4, dtype=np.float32).reshape(4, 4)
    return torch_dist.spawn("mesh", 4, tmp_path_factory.mktemp("mesh"),
                            {"mesh": {"dp": 2, "mp": 2}, "batch": batch})


def test_process_groups_hold_the_jax_slices(four_ranks):
    ids = _jax_ids({"dp": 2, "mp": 2})
    for r, res in enumerate(four_ranks):
        i, j = (int(c[0]) for c in np.nonzero(ids == r))
        assert res["coords"] == {"dp": i, "mp": j}
        assert res["ranks"]["dp"] == ids[:, j].tolist()
        assert res["ranks"]["mp"] == ids[i, :].tolist()
        assert res["sums"]["dp"] == float(ids[:, j].sum())
        assert res["sums"]["mp"] == float(ids[i, :].sum())
        assert res["sums"]["world"] == res["sums"]["('dp', 'mp')"] == 6.0


def test_parallel_env_and_shard_batch_on_ranks(four_ranks):
    batch = np.arange(4 * 4, dtype=np.float32).reshape(4, 4)
    for r, res in enumerate(four_ranks):
        assert res["env"][:4] == (r, 4, 4, r)
        assert res["env"][4:] == ("gloo", "cpu")
        dp, mp = res["coords"]["dp"], res["coords"]["mp"]
        np.testing.assert_array_equal(res["dp_rows"],
                                      batch[2 * dp:2 * dp + 2])
        np.testing.assert_array_equal(res["sep_cols"],
                                      batch[:, 2 * mp:2 * mp + 2])


def test_every_axis_pair_is_a_group(four_ranks):
    """The slices of every axis partition the ranks."""
    for a in ("dp", "mp"):
        groups = {tuple(res["ranks"][a]) for res in four_ranks}
        assert sorted(itertools.chain(*groups)) == [0, 1, 2, 3]
    assert jax.device_count() >= 4
