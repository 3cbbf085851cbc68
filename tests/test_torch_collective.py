"""Paddle's collective API in the port, on 2 and 4 gloo ranks, against the
JAX package's collectives run per rank inside ``shard_map`` on the CPU
mesh.

The JAX functions outside ``shard_map`` act on global arrays; the port's
act on each rank's local tensor, as Paddle's do. So each op runs here in
JAX inside ``shard_map`` over the stacked per-rank inputs (rank r's input
is row r, the mesh laid out as the port's), and the port's per-rank
results, assembled, are held against it: bitwise, since the inputs are
small integers stored as floats. Four ranks run a dp2 x mp2 mesh with the
group on ``mp`` (and the world group for one all-reduce).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as PS

import paddle_tpu as P
import paddle_tpu.distributed as jdist
from paddle_tpu.parallel import mesh as jmesh

import torch_dist

CASES = {2: ({"dp": 2}, "dp"), 4: ({"dp": 2, "mp": 2}, "mp")}


def _inputs(world):
    r = np.random.RandomState(world)
    x = r.randint(-5, 6, (world, 3, 4)).astype(np.float32)
    n = CASES[world][0][CASES[world][1]]
    pieces = r.randint(-5, 6, (world, n, 3)).astype(np.float32)
    return x, pieces


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collective")
    out = {}
    for world, (mesh, axis) in CASES.items():
        x, pieces = _inputs(world)
        out[world] = torch_dist.spawn("collective", world, tmp, {
            "mesh": mesh, "axis": axis, "x": x, "pieces": pieces})
    return out


@pytest.fixture(autouse=True)
def _clean():
    yield
    jmesh.set_mesh(None)


def _jax(world, fn, *stacked):
    """``fn(group, *local tensors) -> jax array`` per rank, stacked."""
    mesh_shape, axis = CASES[world]
    mesh = jmesh.init_mesh(mesh_shape)
    g = jdist.new_group(axis=axis)
    spec = PS(tuple(mesh_shape))

    def body(*vs):
        return jnp.asarray(fn(g, *[P.Tensor(v[0]) for v in vs]))[None]

    f = jax.shard_map(body, mesh=mesh, in_specs=(spec,) * len(stacked),
                      out_specs=spec, check_vma=False)
    return np.asarray(f(*[jnp.asarray(a) for a in stacked]))


def _port(port, world, key):
    return np.stack([np.asarray(res[key]) for res in port[world]])


def _ar(op):
    def fn(g, t):
        jdist.all_reduce(t, op=op, group=g)
        return t._value
    return fn


WORLDS = list(CASES)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", ["sum", "max", "min", "avg"])
def test_all_reduce(port, world, op):
    x, _ = _inputs(world)
    np.testing.assert_array_equal(_port(port, world, f"all_reduce_{op}"),
                                  _jax(world, _ar(op), x))


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_prod_and_reduce(port, world):
    """PROD against numpy (the JAX all_reduce routes an unknown op to a
    sum); ``reduce`` all-reduces on every rank, as the JAX function."""
    x, _ = _inputs(world)
    mesh_shape, axis = CASES[world]
    m = jmesh.init_mesh(mesh_shape)
    ids = np.vectorize(lambda d: d.id)(m.devices)
    names = list(mesh_shape)
    want_prod, want_sum = np.empty_like(x), np.empty_like(x)
    for r in range(world):
        where = [int(c[0]) for c in np.nonzero(ids == r)]
        where[names.index(axis)] = slice(None)
        group = ids[tuple(where)].ravel()
        want_prod[r] = np.prod(x[group], axis=0)
        want_sum[r] = np.sum(x[group], axis=0)
    np.testing.assert_array_equal(_port(port, world, "all_reduce_prod"),
                                  want_prod)
    np.testing.assert_array_equal(_port(port, world, "reduce"), want_sum)
    np.testing.assert_array_equal(_port(port, world, "reduce"),
                                  _jax(world, _ar("sum"), x))


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_and_gather(port, world):
    x, _ = _inputs(world)
    want = _jax(world, lambda g, t: jdist.all_gather(None, t,
                                                     group=g)._value, x)
    np.testing.assert_array_equal(_port(port, world, "all_gather"), want)
    for key in ("all_gather_list", "gather"):
        got = np.stack([np.stack(res[key]) for res in port[world]])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_all_to_all(port, world):
    _, pieces = _inputs(world)

    def fn(g, t):
        outs = []
        jdist.all_to_all(outs, [P.Tensor(t._value[i])
                                for i in range(t.shape[0])], group=g)
        return jnp.stack([o._value for o in outs])
    np.testing.assert_array_equal(_port(port, world, "all_to_all"),
                                  _jax(world, fn, pieces))


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_scatter(port, world):
    _, pieces = _inputs(world)

    def fn(g, t):
        out = P.Tensor(jnp.zeros(t.shape[1:], t._value.dtype))
        jdist.reduce_scatter(out, [P.Tensor(t._value[i])
                                   for i in range(t.shape[0])], group=g)
        return out._value
    np.testing.assert_array_equal(_port(port, world, "reduce_scatter"),
                                  _jax(world, fn, pieces))


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_and_scatter_from_src(port, world):
    x, pieces = _inputs(world)

    def bcast(g, t):
        jdist.broadcast(t, src=1, group=g)
        return t._value

    def scat(g, t):
        out = P.Tensor(jnp.zeros(t.shape[1:], t._value.dtype))
        jdist.scatter(out, [P.Tensor(t._value[i])
                            for i in range(t.shape[0])], src=1, group=g)
        return out._value
    np.testing.assert_array_equal(_port(port, world, "broadcast"),
                                  _jax(world, bcast, x))
    np.testing.assert_array_equal(_port(port, world, "scatter"),
                                  _jax(world, scat, pieces))


@pytest.mark.parametrize("world", WORLDS)
def test_ring_send_recv(port, world):
    """``batch_isend_irecv`` of a ring (send to r+1, receive from r-1)
    equals the JAX ``recv`` with the permutation ``src = r - 1``."""
    x, _ = _inputs(world)
    n = CASES[world][0][CASES[world][1]]

    def fn(g, t):
        jdist.recv(t, src=lambda r: (r - 1) % n, group=g)
        return t._value
    np.testing.assert_array_equal(_port(port, world, "ring"),
                                  _jax(world, fn, x))


@pytest.mark.parametrize("world", WORLDS)
def test_point_to_point_pair(port, world):
    """Group rank 0 sends, group rank 1 receives (Paddle's per-rank
    send/recv; the JAX form is a permutation inside shard_map)."""
    x, _ = _inputs(world)
    for r, res in enumerate(port[world]):
        n, me, ranks = res["group"]
        want = x[ranks[0]] if me == 1 else np.zeros_like(x[r])
        np.testing.assert_array_equal(res["pair"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_groups_objects_and_world(port, world):
    x, _ = _inputs(world)
    mesh_shape, axis = CASES[world]
    jmesh.init_mesh(mesh_shape)
    for r, res in enumerate(port[world]):
        n, me, ranks = res["group"]
        assert n == mesh_shape[axis] and r in ranks and ranks[me] == r
        assert res["objects"] == [{"rank": i, "tag": "r%d" % i}
                                  for i in range(n)]
        assert res["backend"] == "gloo"
        assert res["from_ranks_axis"] == axis == \
            jdist.collective._axis_from_ranks(ranks)
        np.testing.assert_array_equal(res["world_sum"], x.sum(axis=0))
        assert res["default_group_n"] == world
        assert res["world_size"] == (world, world)
        assert res["after_destroy"] == 0            # back to the default
        kinds = {site.split("/")[1] for site in res["recorded"]}
        assert {"all_reduce", "all_gather", "all_to_all", "reduce_scatter",
                "broadcast", "sendrecv", "all_gather_object",
                "barrier"} <= kinds
