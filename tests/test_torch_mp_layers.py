"""The port's tensor- and sequence-parallel layers, and the vocab-parallel
fused loss, on two gloo ranks of an mp axis, against the JAX package.

The JAX layers declare sharding specs and GSPMD inserts the collectives,
so their values are the dense math: each layer runs here in JAX on the
full weights (eager, with the tape) and the port's per-rank results,
assembled (weight grads concatenated along the split dim, column outputs
along the last dim, sequence shards along dim 1), are held against it at
rtol 1e-5. The sequence-parallel ops have no value of their own in JAX
(each is a sharding constraint), so their JAX side is the function the
ranks compute together: a scatter or gather is the identity on the whole
tensor, an all-gather's grads are the ranks' summed, a reduce-scatter's
value is the ranks' inputs summed.

``fused_linear_cross_entropy_tp`` runs on mp2 against the JAX function
under ``shard_map`` on two CPU devices (its Pallas kernels in interpret
mode): the per-row loss, dh and each rank's dW shard, with about 10% of
the labels ignored (-100: outside every shard, so the row's loss is its
logsumexp; the caller's mask zeroes its grad).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as PS

import paddle_tpu as P
from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as JL
from paddle_tpu.ops.pallas.fused_ce import fused_linear_cross_entropy_tp \
    as jax_tp
from paddle_tpu.parallel import mesh as jmesh

import torch_dist

RTOL, ATOL = 1e-5, 1e-6
N = 2                       # mp ranks
V, H, O, B, S = 16, 8, 12, 2, 4


def _payload():
    r = np.random.RandomState(0)
    f = lambda *s: r.randn(*s).astype(np.float32)   # noqa: E731
    labels = r.randint(0, O, (B, S))
    labels[0, 1] = -100
    return dict(
        mesh={"mp": N}, V=V, H=H, O=O,
        ids=r.randint(0, V, (B, S)), emb=f(V, H), g_emb=f(B, S, H),
        x=f(B, S, H), col_w=f(H, O), col_b=f(O), g_col=f(B, S, O),
        xr=f(B, S, O), row_w=f(O, H), row_b=f(H), g_row=f(B, S, H),
        logits=f(B, S, O), labels=labels, g_ce=f(B, S),
        seq=f(B, S, H), g_scatter=[f(B, S // N, H) for _ in range(N)],
        g_gather=[f(B, S, H)] * N, g_allgather=[f(B, S, H)
                                                for _ in range(N)],
        g_reducescatter=[f(B, S // N, H) for _ in range(N)],
        g_sp=f(B, S, H))


PAY = _payload()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return torch_dist.spawn("mp_layers", N, tmp_path_factory.mktemp("mp"),
                            PAY)


def _jt(a, grad=False):
    t = P.to_tensor(np.asarray(a))
    t.stop_gradient = not grad
    return t


def _set(layer, **vals):
    for k, v in vals.items():
        getattr(layer, k)._value = jnp.asarray(v)
    return layer


def _grads(layer):
    return {k: np.asarray(p.grad._value) for k, p in layer.named_parameters()}


def _cat(parts, axis):
    return np.concatenate(parts, axis=axis)


def test_vocab_parallel_embedding(port):
    layer = _set(JL.VocabParallelEmbedding(V, H), weight=PAY["emb"])
    y = layer(_jt(PAY["ids"]))
    (y * _jt(PAY["g_emb"])).sum().backward()
    for res in port:
        np.testing.assert_allclose(res["emb"][0], y.numpy(), rtol=RTOL,
                                   atol=ATOL)
    got = _cat([res["emb"][1]["weight"] for res in port], 0)
    np.testing.assert_allclose(got, _grads(layer)["weight"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("gather", [True, False])
def test_column_parallel_linear(port, gather):
    layer = _set(JL.ColumnParallelLinear(H, O, gather_output=gather),
                 weight=PAY["col_w"], bias=PAY["col_b"])
    x = _jt(PAY["x"], grad=True)
    y = layer(x)
    (y * _jt(PAY["g_col"])).sum().backward()
    outs = [res[f"col_{gather}"] for res in port]
    got_y = outs[0][0] if gather else _cat([o[0] for o in outs], -1)
    np.testing.assert_allclose(got_y, y.numpy(), rtol=RTOL, atol=ATOL)
    jg = _grads(layer)
    np.testing.assert_allclose(_cat([o[1]["weight"] for o in outs], 1),
                               jg["weight"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_cat([o[1]["bias"] for o in outs], 0),
                               jg["bias"], rtol=RTOL, atol=ATOL)
    for o in outs:              # the input grad is all-reduced over mp
        np.testing.assert_allclose(o[2], x.grad.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("parallel", [True, False])
def test_row_parallel_linear(port, parallel):
    layer = _set(JL.RowParallelLinear(O, H, input_is_parallel=parallel),
                 weight=PAY["row_w"], bias=PAY["row_b"])
    x = _jt(PAY["xr"], grad=True)
    y = layer(x)
    (y * _jt(PAY["g_row"])).sum().backward()
    outs = [res[f"row_{parallel}"] for res in port]
    for o in outs:
        np.testing.assert_allclose(o[0], y.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(o[1]["bias"],
                                   _grads(layer)["bias"], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(_cat([o[1]["weight"] for o in outs], 0),
                               _grads(layer)["weight"], rtol=RTOL, atol=ATOL)
    xg = _cat([o[2] for o in outs], -1) if parallel else outs[0][2]
    np.testing.assert_allclose(xg, x.grad.numpy(), rtol=RTOL, atol=ATOL)


def test_parallel_cross_entropy(port):
    logits = _jt(PAY["logits"], grad=True)
    ce = JL.ParallelCrossEntropy()(logits, _jt(PAY["labels"]))
    (ce * _jt(PAY["g_ce"])).sum().backward()
    for res in port:
        np.testing.assert_allclose(res["pce"][0], ce.numpy(), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(_cat([res["pce"][1] for res in port], -1),
                               logits.grad.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["scatter", "gather", "allgather",
                                  "reducescatter"])
def test_sequence_parallel_ops(port, name):
    op = {"scatter": JL.ScatterOp, "gather": JL.GatherOp,
          "allgather": JL.AllGatherOp,
          "reducescatter": JL.ReduceScatterOp}[name]
    seq = PAY["seq"]
    gs = PAY[f"g_{name}"]
    x = _jt(seq, grad=True)
    if name == "reducescatter":           # the ranks' inputs, summed
        y = op.apply(x * float(N), 1)
    else:
        y = op.apply(x, 1)
    if name in ("scatter", "reducescatter"):
        g = _cat(gs, 1)                   # each rank's grad of its shard
    elif name == "gather":
        g = gs[0]                         # the same grad on every rank
    else:
        g = np.sum(gs, axis=0)            # each rank's partial grad
    (y * _jt(g)).sum().backward()
    outs = [res[name] for res in port]
    got_y = _cat([o[0] for o in outs], 1) if name in (
        "scatter", "reducescatter") else outs[0][0]
    np.testing.assert_allclose(got_y, y.numpy(), rtol=RTOL, atol=ATOL)
    if name in ("scatter", "reducescatter"):
        want = x.grad.numpy() / (N if name == "reducescatter" else 1)
        for o in outs:
            np.testing.assert_allclose(o[1], want if name == "scatter"
                                       else _cat(gs, 1), rtol=RTOL,
                                       atol=ATOL)
    else:
        np.testing.assert_allclose(_cat([o[1] for o in outs], 1),
                                   x.grad.numpy(), rtol=RTOL, atol=ATOL)


def test_sequence_parallel_linears_and_norm_hook(port):
    """``RowSequenceParallelLinear(ColumnSequenceParallelLinear(x * w))``
    on sequence shards equals the dense layers; the marked weight's grad,
    all-reduced by the hook, is the whole sequence's (a sum whose terms
    cancel, so it is held at rtol 1e-5 of its largest element)."""
    col = _set(JL.ColumnSequenceParallelLinear(H, O, has_bias=False),
               weight=PAY["col_w"])
    row = _set(JL.RowSequenceParallelLinear(O, H, has_bias=False),
               weight=PAY["row_w"])
    scale = _jt(np.ones(H, np.float32), grad=True)
    x = _jt(PAY["seq"], grad=True)
    y = row(col(x * scale))
    (y * _jt(PAY["g_sp"])).sum().backward()
    outs = [res["sp"] for res in port]
    np.testing.assert_allclose(_cat([o[0] for o in outs], 1), y.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_cat([o[1] for o in outs], 1),
                               np.asarray(col.weight.grad._value),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_cat([o[2] for o in outs], 0),
                               np.asarray(row.weight.grad._value),
                               rtol=RTOL, atol=ATOL)
    want = scale.grad.numpy()     # a sum over positions that cancels:
    for o in outs:                # held against its largest element
        np.testing.assert_allclose(o[3], want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(_cat([o[4] for o in outs], 1),
                               x.grad.numpy(), rtol=RTOL, atol=ATOL)


def test_ranks_see_their_mp_coordinate(port):
    assert [res["mp"] for res in port] == [(N, r, r) for r in range(N)]


# ---------------------------------------------------------------------------
# the vocab-parallel fused loss
# ---------------------------------------------------------------------------

def _tp_inputs():
    r = np.random.RandomState(7)
    n, hd, v = 16, 32, 512
    h = (r.randn(n, hd) * 0.3).astype(np.float32)
    w = (r.randn(hd, v) * 0.1).astype(np.float32)
    lab = r.randint(0, v, (n,))
    lab[r.rand(n) < 0.1] = -100
    lab[3] = -100
    g = r.randn(n).astype(np.float32) * (lab != -100)
    return h, w, lab, g


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    h, w, lab, g = _tp_inputs()
    return torch_dist.spawn("tp_ce", N, tmp_path_factory.mktemp("tp"), {
        "mesh": {"mp": N}, "h": h, "w": w, "labels": lab, "g": g})


def test_fused_linear_cross_entropy_tp_matches_jax(tp):
    h, w, lab, g = _tp_inputs()
    mesh = jmesh.init_mesh({"mp": N})
    try:
        def loss(hh, ww):
            return jax.shard_map(
                lambda a, b, c: jax_tp(a, b, c, axis="mp"), mesh=mesh,
                in_specs=(PS(), PS(None, "mp"), PS()), out_specs=PS(),
                axis_names={"mp"}, check_vma=False)(hh, ww, jnp.asarray(lab))
        want = np.asarray(loss(jnp.asarray(h), jnp.asarray(w)))
        dh, dw = jax.grad(lambda a, b: jnp.sum(loss(a, b) * g),
                          argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    finally:
        jmesh.set_mesh(None)
    for res in tp:
        np.testing.assert_allclose(res["loss"], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res["dh"], np.asarray(dh), rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(_cat([res["dw"] for res in tp], 1),
                               np.asarray(dw), rtol=1e-4, atol=1e-6)
    ignored = lab == -100
    assert ignored.any()
    lse = np.log(np.exp((h @ w)[ignored]).sum(axis=1))
    np.testing.assert_allclose(tp[0]["loss"][ignored], lse, rtol=1e-5)
