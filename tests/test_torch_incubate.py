"""The port's ``incubate`` against the JAX package's, on the CPU in fp32.

The same numpy inputs (and, for the layers, the JAX layer's weights
carried across by ``set_state_dict``) go through both packages. Each
fused functional is compared at rtol 1e-5 / atol 1e-5 (the same fp32
math, summed in another order by each backend), including every mode of
``fused_multi_transformer``: no cache, cache prefill, ``time_step``
decode, per-example ``seq_lens`` decode, rotary, ``attn_mask`` on the
cache path; ``masked_multihead_attention`` with per-example lengths;
fused RoPE (neox and interleaved, with a table, ``position_ids`` past S)
and the five fused transformer layers, at the same tolerance. The
segment, graph and softmax-mask ops and ``identity_loss`` at rtol 1e-6;
``LookAhead`` and ``ModelAverage`` over 3 SGD steps at rtol 1e-6; the ASP
masks exactly. Random paths (dropout, neighbour sampling) are held on
shapes, rates and moments: the port's generator is not the JAX key
stream.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.incubate as JI
import paddle_tpu.incubate.nn.functional as JF
import paddle_tpu_torch as P
import paddle_tpu_torch.incubate as PI
import paddle_tpu_torch.incubate.nn.functional as PF
from paddle_tpu_torch.core import device as pdev

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)) \
        .astype(np.float32)


def both(*arrays):
    """(JAX tensors, port tensors) of copies of the same arrays."""
    return ([J.to_tensor(np.array(a)) for a in arrays],
            [P.to_tensor(np.array(a)) for a in arrays])


def close(p, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(p.numpy()), np.asarray(j.numpy()),
                               rtol=rtol, atol=atol)


def call(fn_name, arrays, **kw):
    (ja, pa) = both(*arrays)
    return getattr(JF, fn_name)(*ja, **kw), getattr(PF, fn_name)(*pa, **kw)


# ---- the simple fused functionals ----

E, H, Dh, F, B, S = 16, 2, 8, 32, 2, 5


def _simple_cases():
    x, r, w, b = rnd(B, S, E), rnd(B, S, E, seed=1), rnd(E, seed=2), \
        rnd(E, seed=3)
    m1, m2, bb = rnd(B, S, E), rnd(E, F, seed=4), rnd(F, seed=5)
    return {
        "layer_norm": ("fused_layer_norm", [x, w, b, r, b],
                       dict(epsilon=1e-5)),
        "rms_norm": ("fused_rms_norm", [x, w, 1e-6, r, b], {}),
        "matmul_bias": ("fused_matmul_bias", [m1, m2, bb], {}),
        "matmul_bias_tt": ("fused_matmul_bias",
                           [rnd(B, E, S), rnd(F, E, seed=6), bb],
                           dict(transpose_x=True, transpose_y=True)),
        "linear_t": ("fused_linear", [m1, rnd(F, E, seed=7), bb],
                     dict(transpose_weight=True)),
        "linear_gelu": ("fused_linear_activation", [m1, m2, bb],
                        dict(activation="gelu")),
        "linear_relu": ("fused_linear_activation", [m1, m2, bb],
                        dict(activation="relu")),
        "linear_none": ("fused_linear_activation", [m1, m2, bb],
                        dict(activation=None)),
        "dropout_add_eval": ("fused_dropout_add", [x, r],
                             dict(p=0.3, training=False)),
        "dropout_add_downscale": ("fused_dropout_add", [x, r],
                                  dict(p=0.3, training=False,
                                       mode="downscale_in_infer")),
        "bias_dropout_residual_ln": (
            "fused_bias_dropout_residual_layer_norm", [x, r, b, w, b],
            dict(dropout_rate=0.5, training=False)),
    }


@pytest.mark.parametrize("case", sorted(_simple_cases()))
def test_simple_functionals(case):
    name, arrays, kw = _simple_cases()[case]
    if name == "fused_rms_norm":        # epsilon is positional there
        x, w, eps, r, b = arrays
        (jx, jw, jr, jb), (px, pw, pr, pb) = both(x, w, r, b)
        close(PF.fused_rms_norm(px, pw, eps, pr, pb),
              JF.fused_rms_norm(jx, jw, eps, jr, jb))
        return
    if name == "fused_layer_norm":
        x, w, b, r, bb = arrays
        (jx, jw, jb, jr, jbb), (px, pw, pb, pr, pbb) = both(x, w, b, r, bb)
        close(PF.fused_layer_norm(px, pw, pb, residual=pr, bias=pbb, **kw),
              JF.fused_layer_norm(jx, jw, jb, residual=jr, bias=jbb, **kw))
        return
    j, p = call(name, arrays, **kw)
    close(p, j)


@pytest.mark.parametrize("pre_ln", [True, False])
def test_fused_feedforward(pre_ln):
    arrays = [rnd(B, S, E), rnd(E, F, seed=1, scale=0.3),
              rnd(F, E, seed=2, scale=0.3), rnd(F, seed=3), rnd(E, seed=4),
              rnd(E, seed=5), rnd(E, seed=6), rnd(E, seed=7), rnd(E, seed=8)]
    j, p = call("fused_feedforward", arrays, dropout1_rate=0.2,
                dropout2_rate=0.2, activation="gelu", pre_layer_norm=pre_ln,
                training=False, mode="downscale_in_infer")
    close(p, j)


def test_dropout_draws_hold_their_rate_and_mean():
    """training dropout: about p of the values dropped, the kept ones
    scaled by 1/(1-p) (upscale_in_train): the mean stays ~1; the two
    dropouts of fused_feedforward draw differently."""
    x = P.to_tensor(np.ones((64, 256), np.float32))
    z = P.to_tensor(np.zeros((64, 256), np.float32))
    P.seed(11, "cpu")
    out = PF.fused_dropout_add(x, z, p=0.3).numpy()
    dropped = float((out == 0).mean())
    assert abs(dropped - 0.3) < 0.02, dropped
    assert abs(float(out.mean()) - 1.0) < 0.03
    assert np.allclose(out[out != 0], 1.0 / 0.7, rtol=1e-6)
    P.seed(11, "cpu")
    again = PF.fused_dropout_add(x, z, p=0.3).numpy()
    np.testing.assert_array_equal(out, again)       # seeded: reproducible
    down = PF.fused_dropout_add(x, z, p=0.3,
                                mode="downscale_in_infer").numpy()
    assert set(np.unique(down).tolist()) <= {0.0, 1.0}


# ---- attention ----

def _mha_weights(seed=0):
    return [rnd(3, H, Dh, E, seed=seed, scale=0.3),
            rnd(E, E, seed=seed + 1, scale=0.3), rnd(3, H, Dh, seed=seed + 2),
            rnd(E, seed=seed + 3), rnd(E, seed=seed + 4),
            rnd(E, seed=seed + 5)]


@pytest.mark.parametrize("mode", ["pre_ln", "post_ln", "mask", "cache",
                                  "flat_qkv"])
def test_fused_multi_head_attention(mode):
    qkv_w, lin_w, qkv_b, lin_b, ln_w, ln_b = _mha_weights()
    x = rnd(B, S, E, seed=9)
    arrays = [x, qkv_w, lin_w]
    kw = dict(pre_layer_norm=mode == "pre_ln", dropout_rate=0.1,
              attn_dropout_rate=0.1, training=False)
    opt = dict(pre_ln_scale=ln_w, pre_ln_bias=ln_b, ln_scale=ln_w,
               ln_bias=ln_b, qkv_bias=qkv_b, linear_bias=lin_b)
    if mode == "mask":
        opt["attn_mask"] = rnd(B, 1, S, S, seed=10)
    if mode == "cache":
        opt["cache_kv"] = np.zeros((2, B, H, 8, Dh), np.float32)
    if mode == "flat_qkv":
        arrays[1] = qkv_w.transpose(3, 0, 1, 2).reshape(E, 3 * E).copy()
        opt["qkv_bias"] = qkv_b.reshape(-1).copy()
        kw.update(transpose_qkv_wb=True, num_heads=H)
    names = list(opt)
    (ja, pa) = both(*arrays, *[opt[n] for n in names])
    jkw = dict(kw, **dict(zip(names, ja[3:])))
    pkw = dict(kw, **dict(zip(names, pa[3:])))
    if mode == "flat_qkv":
        # the JAX function's flat path reshapes the weight but hands the
        # core the flat one (a reference caveat, ROADMAP.md): hold the
        # port's flat form against the JAX [3, H, D, E] form of the same
        # weights
        ja[1] = J.to_tensor(qkv_w.copy())
        jkw.update(qkv_bias=J.to_tensor(qkv_b.copy()),
                   transpose_qkv_wb=False)
    j = JF.fused_multi_head_attention(*ja[:3], **jkw)
    p = PF.fused_multi_head_attention(*pa[:3], **pkw)
    if mode == "cache":
        close(p[0], j[0])
        close(p[1], j[1])
    else:
        close(p, j)
    with pytest.raises(ValueError, match="num_heads"):
        PF.fused_multi_head_attention(pa[0], pa[1], pa[2],
                                      transpose_qkv_wb=True)


L, SMAX = 2, 12


def _fmt_weights(seed=20):
    """The 12 per-layer lists of fused_multi_transformer, L layers."""
    rs = np.random.RandomState(seed)

    def lst(*shape, scale=0.3, ones=False):
        return [(1.0 + 0.1 * rs.standard_normal(shape) if ones else
                 scale * rs.standard_normal(shape)).astype(np.float32)
                for _ in range(L)]
    return [lst(E, ones=True), lst(E), lst(3, H, Dh, E), lst(3, H, Dh),
            lst(E, E), lst(E), lst(E, ones=True), lst(E), lst(E, F),
            lst(F), lst(F, E), lst(E)]


def _sincos(d=Dh, n=SMAX):
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = np.arange(n, dtype=np.float32)[:, None] * inv[None, :]
    return np.stack([np.sin(ang), np.cos(ang)]).astype(np.float32)


def _fmt_run(pkg_f, to, lists, x, **kw):
    wl = [[to(a) for a in lst] for lst in lists]
    return pkg_f.fused_multi_transformer(to(x), *wl, **kw)


def _both_fmt(x, lists, jkw, pkw):
    j = _fmt_run(JF, lambda a: J.to_tensor(np.array(a)), lists, x, **jkw)
    p = _fmt_run(PF, lambda a: P.to_tensor(np.array(a)), lists, x, **pkw)
    return j, p


def _caches(pkg_to, n=L, b=B):
    return [pkg_to(np.zeros((2, b, H, SMAX, Dh), np.float32))
            for _ in range(n)]


def _jt(a):
    return J.to_tensor(np.array(a))


def _pt(a):
    return P.to_tensor(np.array(a))


@pytest.fixture(scope="module")
def prefilled():
    """The cache prefill (``time_step=None``) of S tokens into zero caches,
    run once by both packages: its outputs and caches are compared in
    ``test_fused_multi_transformer_modes[prefill]`` and the decode modes
    continue from the caches."""
    lists = _fmt_weights()
    pre = rnd(B, S, E, seed=31)
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    jout = _fmt_run(JF, _jt, lists, pre, cache_kvs=_caches(_jt))
    pout = _fmt_run(PF, _pt, lists, pre, cache_kvs=_caches(_pt))
    pdev._state.device = prev
    return lists, jout, pout


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "time_step",
                                  "seq_lens", "rotary", "rotary_cache",
                                  "mask_cache"])
def test_fused_multi_transformer_modes(mode, prefilled):
    lists, (jo, jc), (po, pc) = prefilled
    if mode == "prefill":
        close(po, jo)
        for a, b_ in zip(pc, jc):
            close(a, b_)
        return
    s = 1 if mode in ("time_step", "seq_lens") else S - 2
    x = rnd(B, s, E, seed=30)
    jkw, pkw = {}, {}
    if mode not in ("no_cache", "rotary"):
        jkw["cache_kvs"], pkw["cache_kvs"] = jc, pc
    if mode in ("time_step", "mask_cache", "rotary_cache"):
        jkw["time_step"] = pkw["time_step"] = S
    if mode == "seq_lens":
        lens = np.array([S, 2], np.int32)
        jkw["seq_lens"], pkw["seq_lens"] = _jt(lens), _pt(lens)
    if mode in ("rotary", "rotary_cache"):
        sc = _sincos()
        jkw.update(rotary_embs=_jt(sc), rotary_emb_dims=1)
        pkw.update(rotary_embs=_pt(sc), rotary_emb_dims=1)
    if mode == "mask_cache":
        m = rnd(B, 1, s, S, seed=32)     # zero-padded up to S_max
        jkw["attn_mask"], pkw["attn_mask"] = _jt(m), _pt(m)
    j, p = _both_fmt(x, lists, jkw, pkw)
    if "cache_kvs" in jkw:
        close(p[0], j[0])
        for a, b_ in zip(p[1], j[1]):
            close(a, b_)
    else:
        close(p, j)


def test_fused_multi_transformer_refusals():
    lists = _fmt_weights()
    pt = lambda a: P.to_tensor(np.array(a))     # noqa: E731
    x = rnd(B, S, E)
    with pytest.raises(NotImplementedError, match="q_len == 1"):
        _fmt_run(PF, pt, lists, x, cache_kvs=_caches(pt),
                 seq_lens=pt(np.array([1, 2], np.int32)))
    with pytest.raises(ValueError, match="trans_qkvw"):
        _fmt_run(PF, pt, lists, x, trans_qkvw=False)
    with pytest.raises(NotImplementedError, match="pre_caches"):
        _fmt_run(PF, pt, lists, x, pre_caches=[pt(np.zeros(1))])


@pytest.mark.parametrize("neox", [False, True])
def test_masked_multihead_attention(neox):
    cache = rnd(2, B, H, SMAX, Dh, seed=40)
    x = rnd(B, 3 * H * Dh, seed=41)
    bias = rnd(3 * H * Dh, seed=42)
    mask = rnd(B, 1, 1, SMAX + 3, seed=43)
    lens = np.array([5, 0], np.int32)
    (jx, jc, jb, jm, jl, jr), (px, pc, pb, pm, pl, pr) = both(
        x, cache, bias, mask, lens, _sincos())
    j = JF.masked_multihead_attention(jx, jc, bias=jb, src_mask=jm,
                                      sequence_lengths=jl, rotary_tensor=jr,
                                      rotary_emb_dims=1,
                                      use_neox_rotary_style=neox)
    p = PF.masked_multihead_attention(px, pc, bias=pb, src_mask=pm,
                                      sequence_lengths=pl, rotary_tensor=pr,
                                      rotary_emb_dims=1,
                                      use_neox_rotary_style=neox)
    close(p[0], j[0])
    close(p[1], j[1])
    np.testing.assert_array_equal(pc.numpy(), cache)    # input not written


@pytest.mark.parametrize("case", ["neox", "interleaved", "table_d",
                                  "table_half", "pos_table", "pos_past_s"])
def test_fused_rotary_position_embedding(case):
    q, k, v = rnd(B, S, H, Dh), rnd(B, S, H, Dh, seed=1), \
        rnd(B, S, H, Dh, seed=2)
    args = [q, k, v]
    kw = dict(use_neox_rotary_style=case == "neox")
    # a table without position_ids has S rows (Paddle's [1, S, 1, D])
    sc = _sincos(n=16 if case == "pos_table" else S)
    if case == "table_d":          # width D: Paddle's duplicated halves
        args += [np.concatenate([sc[0], sc[0]], -1)[None, :, None],
                 np.concatenate([sc[1], sc[1]], -1)[None, :, None]]
    if case in ("table_half", "pos_table"):
        args += [sc[0], sc[1]]
    names = ["q", "k", "v", "sin", "cos"][:len(args)]
    if case == "pos_table":
        args.append(np.array([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], np.int64))
        names.append("position_ids")
    if case == "pos_past_s":
        args.append(np.array([[30, 31, 32, 33, 34]] * B, np.int64))
        names.append("position_ids")
    (ja, pa) = both(*args)
    j = JF.fused_rotary_position_embedding(**dict(zip(names, ja)), **kw)
    p = PF.fused_rotary_position_embedding(**dict(zip(names, pa)), **kw)
    for a, b_ in zip(p, j):
        close(a, b_)
    only_q = PF.fused_rotary_position_embedding(pa[0], **kw)
    assert only_q[1] is None and only_q[2] is None


# ---- layers, the JAX weights carried across ----

def _carry(jl, pl):
    pl.set_state_dict({k: np.asarray(v.numpy()).copy()
                       for k, v in jl.state_dict().items()})
    jl.eval()
    pl.eval()
    assert list(pl.state_dict()) == list(jl.state_dict())


def _layer_pair(name):
    J.seed(5)
    jn, pn = JI.nn, PI.nn
    if name == "bias_dropout_residual_ln":
        return jn.FusedBiasDropoutResidualLayerNorm(E), \
            pn.FusedBiasDropoutResidualLayerNorm(E, device="cpu")
    if name == "mha":
        return jn.FusedMultiHeadAttention(E, H, normalize_before=True), \
            pn.FusedMultiHeadAttention(E, H, normalize_before=True,
                                       device="cpu")
    if name == "ffn":
        return jn.FusedFeedForward(E, F, activation="gelu"), \
            pn.FusedFeedForward(E, F, activation="gelu", device="cpu")
    if name == "encoder":
        return jn.FusedTransformerEncoderLayer(E, H, F), \
            pn.FusedTransformerEncoderLayer(E, H, F, device="cpu")
    if name == "multi":
        return jn.FusedMultiTransformer(E, H, F, num_layers=L), \
            pn.FusedMultiTransformer(E, H, F, num_layers=L, device="cpu")
    if name == "linear":
        return jn.layer.fused_misc.FusedLinear(E, F), \
            pn.FusedLinear(E, F, device="cpu")
    if name == "ec_moe":
        return jn.layer.fused_misc.FusedEcMoe(E, F, 3, "gelu"), \
            pn.FusedEcMoe(E, F, 3, "gelu", device="cpu")
    raise KeyError(name)


@pytest.mark.parametrize("name", ["bias_dropout_residual_ln", "mha", "ffn",
                                  "encoder", "multi", "linear", "ec_moe"])
def test_fused_layers_with_the_jax_weights(name):
    jl, pl = _layer_pair(name)
    _carry(jl, pl)
    x = rnd(B, S, E, seed=50)
    if name == "bias_dropout_residual_ln":
        extra = [rnd(B, S, E, seed=51)]
    elif name == "ec_moe":
        extra = [rnd(B, S, 3, seed=52)]
    else:
        extra = []
    (ja, pa) = both(x, *extra)
    with J.no_grad():          # no vjp to record for the JAX parameters
        want = jl(*ja)
    close(pl(*pa), want)


def test_fused_multi_transformer_layer_decodes_with_init_caches():
    jl, pl = _layer_pair("multi")
    _carry(jl, pl)
    assert sorted(pl.state_dict())[:2] == ["p0_0", "p0_1"]
    jc, pc = jl.init_caches(B, SMAX), pl.init_caches(B, SMAX, device="cpu")
    assert [tuple(c.shape) for c in pc] == [(2, B, H, SMAX, Dh)] * L
    (jx, jn), (px, pn) = both(rnd(B, S, E, seed=53), rnd(B, 1, E, seed=54))
    with J.no_grad():
        jo, jc = jl(jx, caches=jc)
    po, pc = pl(px, caches=pc)
    close(po, jo)
    lens = np.array([S, S], np.int32)
    with J.no_grad():
        jo, jc = jl(jn, caches=jc, seq_lens=J.to_tensor(lens))
    po, pc = pl(pn, caches=pc, seq_lens=P.to_tensor(lens))
    close(po, jo)
    for a, b_ in zip(pc, jc):
        close(a, b_)


def test_fused_dropout_add_layer():
    x, y = rnd(B, S, E), rnd(B, S, E, seed=1)
    (jx, jy), (px, py) = both(x, y)
    jl, pl = JI.nn.FusedDropoutAdd(0.4), PI.nn.FusedDropoutAdd(0.4)
    jl.eval()
    pl.eval()
    close(pl(px, py), jl(jx, jy))
    pl.train()
    out = pl(px, py).numpy() - y
    kept = out != 0
    assert 0.2 < 1 - kept.mean() < 0.6      # 160 draws at p = 0.4
    np.testing.assert_allclose(out[kept], (x / 0.6)[kept], rtol=1e-5)


# ---- segment, graph and softmax-mask ops ----

SEG_IDS = np.array([0, 0, 1, 3, 3, 3], np.int64)      # segment 2 is empty


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_max", "segment_min"])
def test_segment_ops(op):
    (jd, ji), (pd, pi) = both(rnd(6, 3), SEG_IDS)
    p, j = getattr(PI, op)(pd, pi), getattr(JI, op)(jd, ji)
    assert tuple(p.shape) == (4, 3)
    close(p, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pool", ["sum", "mean", "max", "min"])
def test_graph_send_recv(pool):
    src = np.array([0, 1, 2, 3, 4, 0], np.int64)
    dst = np.array([1, 2, 1, 0, 4, 4], np.int64)
    (jx, js, jd), (px, ps, pd) = both(rnd(5, 3), src, dst)
    close(PI.graph_send_recv(px, ps, pd, pool),
          JI.graph_send_recv(jx, js, jd, pool), rtol=1e-6, atol=1e-6)
    close(PI.graph_send_recv(px, ps, pd, pool, out_size=7),
          JI.graph_send_recv(jx, js, jd, pool, out_size=7), rtol=1e-6,
          atol=1e-6)


def test_softmax_mask_fuse_and_identity_loss():
    (jx, jm), (px, pm) = both(rnd(2, 2, 4, 4), rnd(2, 1, 4, 4, seed=1))
    close(PI.softmax_mask_fuse(px, pm), JI.softmax_mask_fuse(jx, jm),
          rtol=1e-6, atol=1e-6)
    close(PI.softmax_mask_fuse_upper_triangle(px),
          JI.softmax_mask_fuse_upper_triangle(jx), rtol=1e-6, atol=1e-6)
    for red in ("none", "mean", "sum", 0, 1, 2):
        close(PI.identity_loss(px, red), JI.identity_loss(jx, red),
              rtol=1e-6, atol=1e-6)


# CSC graph: node n's neighbours are row[colptr[n]:colptr[n + 1]]
ROW = np.array([1, 2, 3, 0, 2, 0, 1, 3, 4, 0, 2, 2], np.int64)
COLPTR = np.array([0, 3, 5, 9, 11, 12], np.int64)


def test_graph_sample_neighbors_draws_true_neighbours():
    nodes = np.array([0, 2, 4], np.int64)
    eids = np.arange(ROW.size, dtype=np.int64) + 100
    weight = np.ones(ROW.size, np.float32)
    weight[5] = 0.0                           # edge 2 -> 0 is never drawn
    P.seed(3, "cpu")
    nb, cnt, e = PI.graph_sample_neighbors(
        P.to_tensor(ROW), P.to_tensor(COLPTR), P.to_tensor(nodes),
        sample_size=2, eids=P.to_tensor(eids), return_eids=True,
        edge_weight=P.to_tensor(weight))
    nb, cnt, e = nb.numpy(), cnt.numpy(), e.numpy()
    np.testing.assert_array_equal(cnt, [2, 2, 1])
    off = np.concatenate([[0], np.cumsum(cnt)])
    for i, n in enumerate(nodes):
        got = nb[off[i]:off[i + 1]]
        true = ROW[COLPTR[n]:COLPTR[n + 1]]
        assert set(got) <= set(true) and len(set(got)) == len(got)
        np.testing.assert_array_equal(ROW[e[off[i]:off[i + 1]] - 100], got)
    assert 105 not in e
    full, fcnt = PI.graph_sample_neighbors(
        P.to_tensor(ROW), P.to_tensor(COLPTR), P.to_tensor(nodes))
    jfull, jcnt = JI.graph_sample_neighbors(
        J.to_tensor(ROW), J.to_tensor(COLPTR), J.to_tensor(nodes))
    np.testing.assert_array_equal(full.numpy(), jfull.numpy())
    np.testing.assert_array_equal(fcnt.numpy(), jcnt.numpy())


def test_graph_reindex_and_khop():
    x = np.array([0, 2], np.int64)
    nb = np.array([1, 3, 0, 4, 3], np.int64)
    cnt = np.array([2, 3], np.int64)
    p = PI.graph_reindex(*[P.to_tensor(a) for a in (x, nb, cnt)])
    j = JI.graph_reindex(*[J.to_tensor(a) for a in (x, nb, cnt)])
    for a, b_ in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), b_.numpy())
    src, dst, nodes, counts = PI.graph_khop_sampler(
        P.to_tensor(ROW), P.to_tensor(COLPTR),
        P.to_tensor(np.array([0], np.int64)), [2, -1])
    nodes = nodes.numpy()
    assert nodes[0] == 0 and len(set(nodes)) == nodes.size
    edges = {(int(d), int(s)) for s, d in zip(ROW, np.repeat(
        np.arange(5), np.diff(COLPTR)))}
    for s, d in zip(src.numpy(), dst.numpy()):      # every edge a true one
        assert (int(nodes[d]), int(nodes[s])) in edges
    assert int(counts.numpy().sum()) == src.shape[0]


# ---- optimizers ----

def _linear_pair(seed=0):
    w0 = rnd(4, 3, seed=seed)
    jw = J.create_parameter([4, 3], "float32")
    jw.set_value(J.to_tensor(w0.copy()))
    pw = P.create_parameter([4, 3], "float32", place="cpu")
    with torch.no_grad():
        pw.copy_(torch.from_numpy(w0.copy()))
    return jw, pw


def _step_loss(pkg, w, xs):
    return (pkg.matmul(pkg.to_tensor(xs), w) ** 2).mean()


def test_lookahead_three_steps():
    jw, pw = _linear_pair()
    jo = JI.LookAhead(J.optimizer.SGD(0.1, parameters=[jw]), alpha=0.5, k=2)
    po = PI.LookAhead(P.optimizer.SGD(0.1, parameters=[pw]), alpha=0.5, k=2)
    for i in range(3):
        xs = rnd(5, 4, seed=60 + i)
        _step_loss(J, jw, xs).backward()
        jo.step()
        jo.clear_grad()
        _step_loss(P, pw, xs).backward()
        po.step()
        po.clear_grad()
        close(pw, jw, rtol=1e-6, atol=1e-7)
    assert po.state_dict()["lookahead_steps"] == 3


def test_model_average_three_steps():
    jw, pw = _linear_pair(1)
    jsgd = J.optimizer.SGD(0.1, parameters=[jw])
    psgd = P.optimizer.SGD(0.1, parameters=[pw])
    jma = JI.ModelAverage(0.15, parameters=[jw])
    pma = PI.ModelAverage(0.15, parameters=[pw])
    for i in range(3):
        xs = rnd(5, 4, seed=70 + i)
        for pkg, w, opt, ma in ((J, jw, jsgd, jma), (P, pw, psgd, pma)):
            _step_loss(pkg, w, xs).backward()
            opt.step()
            opt.clear_grad()
            ma.step()
    trained = pw.numpy().copy()
    with jma.apply(), pma.apply():
        close(pw, jw, rtol=1e-6, atol=1e-7)
        assert not np.allclose(pw.numpy(), trained)
    np.testing.assert_array_equal(pw.numpy(), trained)   # restored


# ---- ASP ----

def test_asp_masks_prune_and_decorate():
    w = rnd(8, 6, seed=80)
    jm = JI.asp.create_mask(J.to_tensor(w.copy()))
    pm = PI.asp.create_mask(P.to_tensor(w.copy()))
    np.testing.assert_array_equal(pm.numpy(), jm.numpy())
    assert PI.asp.check_sparsity(pm * P.to_tensor(w)) and \
        not PI.asp.check_sparsity(P.to_tensor(w))
    assert PI.asp.calculate_density(pm) == JI.asp.calculate_density(jm) \
        == 0.5
    P.seed(0, "cpu")
    net = P.nn.Sequential(P.nn.Linear(8, 8, device="cpu"),
                          P.nn.Linear(8, 4, device="cpu"))
    masks = PI.asp.prune_model(net)
    assert sorted(masks) == ["0.weight", "1.weight"]
    opt = PI.asp.decorate(P.optimizer.SGD(0.5, parameters=net.parameters()))
    (net(P.to_tensor(rnd(3, 8))) ** 2).mean().backward()
    opt.step()
    for name, p in net.named_parameters():
        if name.endswith("weight"):
            assert PI.asp.check_sparsity(p)
            assert PI.asp.calculate_density(p) <= 0.5
    PI.asp.reset_excluded_layers()


def test_incubate_autograd():
    def f(x):
        return (x ** 3).sum()
    xs = rnd(3, seed=90)
    jt, pt = PI.autograd.forward_grad(f, P.to_tensor(xs.copy())), \
        JI.autograd.forward_grad(f, J.to_tensor(xs.copy()))
    close(jt, pt)
    PI.autograd.enable_prim()
    assert PI.autograd.prim_enabled()
    PI.autograd.disable_prim()
    assert not PI.autograd.prim_enabled()
