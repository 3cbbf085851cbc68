"""The port's static-graph world against the JAX package's.

Every case of ``tests/test_static.py`` on the port, each held against the
same program in the JAX package on the same seeded numpy inputs and the
same weights (copied from the JAX layers); plus ``append_backward`` /
``gradients`` as ``@GRAD`` fetches, the ``static.nn`` layers' shapes,
``set_program_state`` / ``load_program_state``, the typed error of
``static.save``, the metric ops, EMA, a static Program of the tiny LLaMA
trained 3 AdamW steps (losses and final weights against the JAX static
program), a direct torch call on a Variable (recorded, or raising), and
the ``_static_shape`` helpers.

Tolerances: fp32 on both sides; one op or a short program at rtol 1e-5 /
atol 1e-6, the 50-step SGD fit and the 3-step LLaMA at rtol 1e-4 / atol
1e-5 (the two libraries' matmuls sum in different orders, and the steps
compound it).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu import static as js
import paddle_tpu_torch as P
from paddle_tpu_torch import static
from paddle_tpu_torch.core import device as pdev

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev
    static.disable_static()
    js.disable_static()


@pytest.fixture
def static_mode():
    static.enable_static()
    js.enable_static()
    yield
    static.disable_static()
    js.disable_static()


def _weights(jl):
    """A copy of a JAX layer's weights, in parameter order."""
    return [np.asarray(q._value).copy() for _, q in jl.named_parameters()]


def _copy_linear(pl, jl):
    """A JAX Linear's weights (the layer, or ``_weights`` of it) into the
    port's (the same [in, out] layout)."""
    ws = jl if isinstance(jl, list) else _weights(jl)
    with torch.no_grad():
        for (_, p), w in zip(pl.named_parameters(), ws):
            p.copy_(torch.from_numpy(w))


def _both(build, feed, steps=1):
    """Build a program on each side with ``build(pkg, static_mod)``
    (returning the fetch Variables and the layers to copy), run it
    ``steps`` times, return both sides' fetches per step."""
    out = []
    for pkg, st in ((J, js), (P, static)):
        main, startup = st.Program(), st.Program()
        with st.program_guard(main, startup):
            fetches = build(pkg, st)
        exe = st.Executor()
        scope = st.Scope()
        with st.scope_guard(scope):
            exe.run(startup)
            out.append([exe.run(main, feed=feed, fetch_list=fetches)
                        for _ in range(steps)])
    return out


def test_program_capture_and_run(static_mode):
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [4, 3], "float32")
        y = x * 2.0 + 1.0
        z = y.sum()
    assert len(main.ops) >= 2
    exe = static.Executor()
    exe.run(startup)
    xv = np.arange(12, dtype=np.float32).reshape(4, 3)
    (out,) = exe.run(main, feed={"x": xv}, fetch_list=[z])
    jmain = js.Program()
    with js.program_guard(jmain):
        jx = js.data("x", [4, 3], "float32")
        jz = (jx * 2.0 + 1.0).sum()
    (want,) = js.Executor().run(jmain, feed={"x": xv}, fetch_list=[jz])
    np.testing.assert_allclose(out, want, rtol=RTOL)
    np.testing.assert_allclose(out, (xv * 2 + 1).sum(), rtol=RTOL)


def test_layer_in_static_mode(static_mode):
    J.seed(1)
    jmain = js.Program()
    with js.program_guard(jmain):
        jnet = J.nn.Linear(8, 4)
        jx = js.data("x", [2, 8], "float32")
        jout = jnet(jx)
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        net = P.nn.Linear(8, 4)
        _copy_linear(net, jnet)
        x = static.data("x", [2, 8], "float32")
        out = net(x)
    assert out.shape == [2, 4]
    exe = static.Executor()
    exe.run(startup)
    xv = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    (ov,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    (want,) = js.Executor().run(jmain, feed={"x": xv}, fetch_list=[jout])
    static.disable_static()
    ref = net(P.to_tensor(xv)).numpy()
    np.testing.assert_allclose(ov, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ov, want, rtol=RTOL, atol=ATOL)


def test_minimize_trains(static_mode):
    rng = np.random.RandomState(0)
    xv = rng.randn(16, 4).astype(np.float32)
    w = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    feed = {"x": xv, "yt": xv @ w}
    J.seed(2)
    made = {}

    def build(pkg, st):
        net = pkg.nn.Linear(4, 1)
        if pkg is P:
            _copy_linear(net, made["jax"])
        else:
            made["jax"] = _weights(net)
        x = st.data("x", [16, 4], "float32")
        yt = st.data("yt", [16, 1], "float32")
        loss = ((net(x) - yt) ** 2).mean()
        pkg.optimizer.SGD(learning_rate=0.1,
                          parameters=net.parameters()).minimize(loss)
        return [loss]
    jl, pl = _both(build, feed, steps=50)
    jl = [float(v[0]) for v in jl]
    pl = [float(v[0]) for v in pl]
    assert pl[-1] < pl[0] * 0.1, (pl[0], pl[-1])
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-5)


def test_clone_for_test_drops_backward(static_mode):
    main = static.Program()
    with static.program_guard(main):
        net = P.nn.Linear(4, 2)
        x = static.data("x", [3, 4], "float32")
        loss = net(x).sum()
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
        opt.minimize(loss)
    test_prog = main.clone(for_test=True)
    assert any(isinstance(o, static.BackwardRecord) for o in main.ops)
    assert not any(isinstance(o, static.BackwardRecord)
                   for o in test_prog.ops)
    assert len(test_prog.ops) == len(main.ops) - 1


def test_save_load_inference_model(tmp_path, static_mode):
    J.seed(3)
    jmain = js.Program()
    with js.program_guard(jmain):
        jnet = J.nn.Linear(6, 3)
        jx = js.data("x", [2, 6], "float32")
        jout = J.nn.functional.softmax(jnet(jx))
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        net = P.nn.Linear(6, 3)
        _copy_linear(net, jnet)
        x = static.data("x", [2, 6], "float32")
        out = P.nn.functional.softmax(net(x))
    exe = static.Executor()
    exe.run(startup)
    prefix = str(tmp_path / "model" / "m")
    static.save_inference_model(prefix, [x], [out], exe, program=main)

    xv = np.random.RandomState(1).randn(2, 6).astype(np.float32)
    (ref,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    prog, feed_names, fetch_names = static.load_inference_model(prefix, exe)
    assert feed_names == ["x"] and fetch_names == [out.name]
    (got,) = exe.run(prog, feed={"x": xv})
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    jexe = js.Executor()
    js.save_inference_model(str(tmp_path / "j" / "m"), [jx], [jout], jexe,
                            program=jmain)
    jprog, _, _ = js.load_inference_model(str(tmp_path / "j" / "m"), jexe)
    (want,) = jexe.run(jprog, feed={"x": xv})
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_dynamic_batch_dim(static_mode):
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [None, 2, 3], "float32")
        assert x.shape == [-1, 2, 3]
        y = x.reshape([x.shape[0], 6])
        z = y.sum(axis=1)
        assert z.shape == [-1]
    exe = static.Executor()
    for bs in (2, 5):
        xv = np.ones((bs, 2, 3), np.float32)
        (out,) = exe.run(main, feed={"x": xv}, fetch_list=[z])
        assert out.shape == (bs,)
        np.testing.assert_allclose(out, 6.0)
    assert exe.cache_info()["entries"] == 2      # one entry per feed shape


def test_save_load_dynamic_batch(tmp_path, static_mode):
    J.seed(4)
    jmain = js.Program()
    with js.program_guard(jmain):
        jnet = J.nn.Linear(6, 3)
        jx = js.data("x", [None, 6], "float32")
        jout = jnet(jx)
    main = static.Program()
    with static.program_guard(main):
        net = P.nn.Linear(6, 3)
        _copy_linear(net, jnet)
        x = static.data("x", [None, 6], "float32")
        out = net(x)
    exe = static.Executor()
    prefix = str(tmp_path / "m")
    static.save_inference_model(prefix, [x], [out], exe, program=main)
    prog, _, _ = static.load_inference_model(prefix, exe)
    jexe = js.Executor()
    js.save_inference_model(str(tmp_path / "j"), [jx], [jout], jexe,
                            program=jmain)
    jprog, _, _ = js.load_inference_model(str(tmp_path / "j"), jexe)
    rng = np.random.RandomState(5)
    for bs in (1, 4, 7):
        xv = rng.randn(bs, 6).astype(np.float32)
        (got,) = exe.run(prog, feed={"x": xv})
        assert got.shape == (bs, 3)
        (want,) = jexe.run(jprog, feed={"x": xv})
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_compiled_program_shim(static_mode):
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [2, 2], "float32")
        y = x * 3.0
    exe = static.Executor()
    cp = static.CompiledProgram(main)
    (out,) = exe.run(cp, feed={"x": np.ones((2, 2), np.float32)},
                     fetch_list=[y])
    np.testing.assert_allclose(out, 3.0)
    assert P.CompiledProgram is static.CompiledProgram


def test_dynamic_mode_restored():
    assert static.in_dynamic_mode() and P.in_dynamic_mode()
    P.enable_static()
    assert static.in_static_mode() and not P.in_dynamic_mode()
    P.disable_static()
    t = P.to_tensor([1.0, 2.0])
    assert float((t * 2).sum().numpy()) == 6.0


# ---- beyond test_static.py ----

def test_append_backward_and_gradients_match_jax(static_mode):
    """Parameter grads (``append_backward``) and a feed's grad
    (``gradients``) as ``@GRAD`` fetches, against the JAX program's."""
    rng = np.random.RandomState(6)
    feed = {"x": rng.randn(5, 4).astype(np.float32)}
    J.seed(5)
    made = {}

    def build(pkg, st):
        net = pkg.nn.Linear(4, 3)
        if pkg is P:
            _copy_linear(net, made["jax"])
        else:
            made["jax"] = _weights(net)
        x = st.data("x", [5, 4], "float32")
        loss = pkg.tanh(net(x)).sum()
        pairs = st.append_backward(loss, parameter_list=[net.weight,
                                                         net.bias])
        return [loss] + [g for _, g in pairs]
    (jout,), (pout,) = _both(build, feed)
    for j, p in zip(jout, pout):
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)

    def build_x(pkg, st):
        net = pkg.nn.Linear(4, 3)
        if pkg is P:
            _copy_linear(net, made["jax"])
        else:
            made["jax"] = _weights(net)
        x = st.data("x", [5, 4], "float32")
        loss = (net(x) ** 2).sum()
        if pkg is J:
            # the JAX gradients() fails building its result Variables
            # (Variable(name, shape=...) against Variable(shape, dtype,
            # name)): hold the port's against its append_backward
            gname = st.append_backward(loss, parameter_list=[x])[0][1]
            with st.program_guard(st.Program()):
                xx = st.data("xx", [2], "float32")
                with pytest.raises(TypeError):
                    st.gradients([xx.sum()], [xx])
            return [gname]
        (gx,) = st.gradients([loss], [x])
        assert gx.name == "x@GRAD"
        return [gx]
    (jout,), (pout,) = _both(build_x, feed)
    np.testing.assert_allclose(pout[0], jout[0], rtol=RTOL, atol=ATOL)


def test_static_nn_layer_shapes(static_mode):
    shapes = []
    for pkg, st in ((J, js), (P, static)):
        main = st.Program()
        with st.program_guard(main):
            x = st.data("x", [4, 10], "float32")
            img = st.data("img", [2, 3, 8, 8], "float32")
            ids = st.data("ids", [4, 7], "int64")
            outs = [st.nn.fc(x, 6, activation="relu"),
                    st.nn.embedding(ids, (50, 5)),
                    st.nn.conv2d(img, 4, 3, padding=1, activation="relu"),
                    st.nn.batch_norm(img, is_test=True)]
        shapes.append([list(o.shape) for o in outs])
        exe = st.Executor()
        feed = {"x": np.ones((4, 10), np.float32),
                "img": np.ones((2, 3, 8, 8), np.float32),
                "ids": np.zeros((4, 7), np.int64)}
        got = exe.run(main, feed=feed, fetch_list=outs)
        assert [list(g.shape) for g in got] == shapes[-1]
    assert shapes[0] == shapes[1] == [[4, 6], [4, 7, 5], [2, 4, 8, 8],
                                      [2, 3, 8, 8]]


def test_program_state_round_trip_and_typed_save_error(tmp_path,
                                                       static_mode):
    """``static.save`` writes ``.pdparams`` (the JAX numbers, by capture
    order), then the program where pickle can carry it (the JAX save
    fails there: its Operators hold local lambdas) and otherwise raises a
    typed error naming save_inference_model; ``load_program_state`` /
    ``set_program_state`` carry the JAX state into the port's program."""
    import pickle
    J.seed(7)
    jmain = js.Program()
    with js.program_guard(jmain):
        jnet = J.nn.Linear(3, 2)
        jx = js.data("x", [1, 3], "float32")
        jout = jnet(jx)
    with pytest.raises(AttributeError):        # JAX: pickle of a lambda
        js.save(jmain, str(tmp_path / "j"))
    jstate = js.load_program_state(str(tmp_path / "j"))

    main = static.Program()
    with static.program_guard(main):
        net = P.nn.Linear(3, 2)
        x = static.data("x", [1, 3], "float32")
        out = net(x)
    static.save(main, str(tmp_path / "p"))
    mine = static.load_program_state(str(tmp_path / "p"))
    assert list(mine) == list(main.captured)
    static.set_program_state(main, dict(zip(mine, jstate.values())))
    xv = np.array([[1.0, -2.0, 0.5]], np.float32)
    exe = static.Executor()
    (got,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    (want,) = js.Executor().run(jmain, feed={"x": xv}, fetch_list=[jout])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    static.save(main, str(tmp_path / "p2"))
    for got_a, want_a in zip(static.load_program_state(
            str(tmp_path / "p2")).values(), jstate.values()):
        np.testing.assert_array_equal(got_a, want_a)
    with open(str(tmp_path / "p2.pdmodel"), "rb") as f:
        back = pickle.load(f)
    (again,) = exe.run(back, feed={"x": xv}, fetch_list=[out.name])
    np.testing.assert_allclose(again, want, rtol=RTOL, atol=ATOL)
    first = list(mine)[0]
    assert list(static.load_program_state(str(tmp_path / "p"),
                                          var_list=[first])) == [first]
    blob = static.serialize_persistables([x], [out], program=main)
    state = static.deserialize_persistables(main, blob)
    np.testing.assert_array_equal(state[first], list(jstate.values())[0])

    lam = static.Program()                      # a closure: not picklable
    with static.program_guard(lam):
        y = static.data("y", [3], "float32")
        z = static.py_func(lambda a: a + 1.0, y,
                           static.data("z_spec", [3], "float32"))
    with pytest.raises(static.ProgramNotSerializable,
                       match="save_inference_model"):
        static.save(lam, str(tmp_path / "lam"))
    with pytest.raises(static.ProgramNotSerializable):
        static.serialize_program([y], [z], program=lam)


def test_metric_ops_match_jax(static_mode):
    rng = np.random.RandomState(8)
    pred = rng.rand(32, 2).astype(np.float32)
    pred /= pred.sum(1, keepdims=True)
    label = rng.randint(0, 2, (32, 1)).astype(np.int64)
    feed = {"p": pred, "l": label}

    def build(pkg, st):
        p = st.data("p", [32, 2], "float32")
        l = st.data("l", [32, 1], "int64")
        acc = st.accuracy(p, l, k=1)
        a, _, _ = st.auc(p, l, num_thresholds=255)
        bundle = st.ctr_metric_bundle(p[:, 1:], l)
        return [acc, a, *bundle]
    (jout,), (pout,) = _both(build, feed)
    for j, p in zip(jout, pout):
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)


def test_py_func_print_and_ema(static_mode, capsys):
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [3], "float32")
        y = static.py_func(lambda a: a * 10.0 + 1.0, x,
                           static.data("y_spec", [3], "float32"))
        z = static.Print(y, message="zed")
    (out,) = static.Executor().run(main, feed={"x": np.arange(
        3, dtype=np.float32)}, fetch_list=[z])
    np.testing.assert_allclose(out, [1.0, 11.0, 21.0])
    assert "zed" in capsys.readouterr().out

    p = P.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    ema = static.ExponentialMovingAverage(decay=0.5)
    ema.track([p])
    ema.update()
    with torch.no_grad():
        p.fill_(3.0)
    ema.update()
    with ema.apply():
        ema_val = p.numpy().copy()
    np.testing.assert_allclose(p.numpy(), 3.0)
    # decay min(0.5, (1+t)/(10+t)): 2/11 then 3/12 = 0.25
    d1, d2 = 2 / 11, 0.25
    want = d2 * (d1 * 1.0 + (1 - d1) * 1.0) + (1 - d2) * 3.0
    np.testing.assert_allclose(ema_val, want, rtol=1e-6)


def test_tiny_llama_program_trains_like_jax(static_mode):
    """A static Program of ``LlamaConfig.tiny()``: ``static.data`` for ids
    and labels, ``compute_loss``, ``AdamW.minimize``, 3 runs; the losses
    and the final weights against the JAX static program."""
    from paddle_tpu.models import LlamaConfig as JC
    from paddle_tpu.models import LlamaForCausalLM as JL
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.models.llama import paddle_tpu_state
    tiny = dict(vocab=64, hidden=32, layers=2, heads=4, inter=64)
    tok = np.random.RandomState(4).randint(0, 64, (2, 13))
    feed = {"ids": tok[:, :-1], "labels": tok[:, 1:].copy()}
    J.seed(11)
    made = {}

    def build(pkg, st):
        if pkg is J:
            m = JL(JC.tiny(**tiny))
            made["state"] = {n: np.asarray(p._value).copy()
                             for n, p in m.named_parameters()}
        else:
            m = LlamaForCausalLM(LlamaConfig.tiny(**tiny), device="cpu")
            load_paddle_tpu_state(m, made["state"])
        made[pkg.__name__] = m
        ids = st.data("ids", [2, 12], "int64")
        labels = st.data("labels", [2, 12], "int64")
        loss = m.compute_loss(ids, labels)
        pkg.optimizer.AdamW(learning_rate=1e-2,
                            parameters=m.parameters()).minimize(loss)
        return [loss]
    jl, pl = _both(build, feed, steps=3)
    jl = [float(v[0]) for v in jl]
    pl = [float(v[0]) for v in pl]
    assert pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-5)
    want = {n: np.asarray(p._value)
            for n, p in made["paddle_tpu"].named_parameters()}
    got = paddle_tpu_state(made["paddle_tpu_torch"])
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_direct_torch_call_on_a_variable_is_recorded_or_raises(
        static_mode):
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [2, 3], "float32")
        y = torch.exp(x)                         # torch directly: recorded
        z = torch.nn.functional.relu(y - 2.0).sum(dim=1)
        w = x.clone()
        w[0] = 5.0                               # in place: recorded
        assert isinstance(y, static.Variable) and y.op.type == "exp"
        assert x.dtype == torch.float32 and x.dim() == 2   # metadata
        with pytest.raises(TypeError, match="no value"):
            float(x.sum())
        with pytest.raises(TypeError, match="no value"):
            x.sum().item()
        with pytest.raises(TypeError, match="no static form"):
            x.sum().backward()
    types = [o.type for o in main.ops]
    assert "exp" in types and "__setitem__" in types
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    zo, wo = static.Executor().run(main, feed={"x": xv}, fetch_list=[z, w])
    np.testing.assert_allclose(zo, np.maximum(np.exp(xv) - 2.0, 0).sum(1),
                               rtol=RTOL)
    want = xv.copy()
    want[0] = 5.0
    np.testing.assert_allclose(wo, want)
    static.disable_static()
    with pytest.raises(RuntimeError, match="outside static mode"):
        torch.exp(x)


def test_static_shape_helpers():
    from paddle_tpu.ops import _static_shape as jss
    from paddle_tpu_torch.ops import _static_shape as pss
    for f, v in ((pss.static_int, P.to_tensor(3)),
                 (pss.static_scalar, P.to_tensor(2.5)),
                 (pss.static_int_list, P.to_tensor([2, 3])),
                 (pss.static_int_list, [P.to_tensor(4), 5])):
        jv = v if isinstance(v, list) else J.to_tensor(v.numpy())
        if isinstance(v, list):
            jv = [J.to_tensor(4), 5]
        assert f(v) == getattr(jss, f.__name__)(jv)
    meta = torch.empty(2, device="meta")
    with pytest.raises(TypeError, match="repeat count"):
        pss.static_int(meta, "repeat count")
    static.enable_static()
    main = static.Program()
    with static.program_guard(main):
        s = static.data("s", [2], "int64")
        with pytest.raises(TypeError, match="shape must be a trace-time"):
            P.zeros(s)
        with pytest.raises(TypeError, match="arange end"):
            P.arange(0, s[0])


def test_graft_program_views_a_captured_step_as_a_program():
    """A captured step's record (``jit.program``) as a static Program:
    the op counts and the Program's op types equal the JAX
    ``GraftProgram``'s for the same op record."""
    from paddle_tpu.static.graft_program import GraftProgram as JGraft
    from paddle_tpu_torch.jit.passes import PassReport
    from paddle_tpu_torch.jit.program import CapturedProgram, StepRecord
    from paddle_tpu_torch.static.graft_program import GraftProgram
    rec = StepRecord()
    rec.ops = ["aten.mm", "aten.add", "aten.mm", "paddle_tpu_torch."
               "flash_attention_fwd"]
    rec.kernels = {"flash_attention_fwd": 1}
    cap = CapturedProgram("step", rec, PassReport(), donate=(0,))
    g = GraftProgram(cap)
    j = JGraft(None, rec.ops, None)
    assert g.num_eqns == 4 and g.op_counts() == j.op_counts()
    assert [o.type for o in g.as_program().ops] == \
        [o.type for o in j.as_program().ops]
    assert isinstance(g.as_program(), static.Program)
    text = g.describe()
    assert "aten.mm: 2" in text and "kernel flash_attention_fwd: 1" in text
