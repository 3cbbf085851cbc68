"""``amp.auto_cast`` and ``amp.decorate`` against the JAX package's: the
lists are equal, each op's output dtype under O1 (default and custom
lists) is the JAX op's, and ``decorate(level="O2")`` leaves the same
parameters (the norms') in float32. Also the dispatch's nan/inf check
(``FLAGS_check_nan_inf``), ``check_numerics`` and the operator stats."""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
import paddle_tpu_torch as P
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import dispatch

pac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

A = np.random.RandomState(0).uniform(0.5, 2, (3, 4)).astype(np.float32)
B = np.random.RandomState(1).uniform(0.5, 2, (4, 2)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _name(t):
    return str(t.dtype).replace("torch.", "") if isinstance(
        t, torch.Tensor) else np.dtype(t.dtype).name


def test_lists_are_the_jax_packages():
    assert P.amp.white_list() == J.amp.white_list()
    assert P.amp.black_list() == J.amp.black_list()


OPS = {
    "matmul": lambda pkg, a, b: pkg.matmul(a, b),
    "exp": lambda pkg, a, b: pkg.exp(a),
    "add": lambda pkg, a, b: pkg.add(a, a),
    "sum": lambda pkg, a, b: pkg.sum(a),
    "mean": lambda pkg, a, b: pkg.mean(a),
    "softmax": lambda pkg, a, b: pkg.nn.functional.softmax(a),
    "linear": lambda pkg, a, b: pkg.nn.functional.linear(a, b),
    "einsum": lambda pkg, a, b: pkg.einsum("ij,jk->ik", a, b),
    "tanh": lambda pkg, a, b: pkg.tanh(a),
}


@pytest.mark.parametrize("lists", ["default", "custom"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_o1_output_dtype_equals_jax(op, dtype, lists):
    kw = {} if lists == "default" else dict(
        custom_white_list={"tanh", "exp"}, custom_black_list={"matmul"})

    def run(pkg, a):
        with pkg.amp.auto_cast(level="O1", dtype=dtype, **kw):
            return OPS[op](pkg, pkg.to_tensor(a), pkg.to_tensor(B))
    got = run(P, A)
    want = run(J, A)
    assert _name(got) == _name(want)
    tol = 1e-2 if _name(got) in ("bfloat16", "float16") else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype("float32").numpy()),
                               rtol=tol, atol=tol)


def test_amp_state_and_cache_key():
    assert pac.amp_cache_key() is False
    with P.amp.auto_cast(dtype="bfloat16", custom_white_list={"b", "a"}):
        assert pac.amp_state().enabled
        assert pac.amp_cache_key() == (True, "bfloat16", ("a", "b"), ())
        assert pac.amp_dtype_for("Linear") == torch.bfloat16
        assert pac.amp_dtype_for("rms_norm") == torch.float32
        assert pac.amp_dtype_for("silu") is None
    assert not pac.amp_state().enabled
    assert P.amp.is_bfloat16_supported() and P.amp.is_float16_supported()


def test_decorate_o2_keeps_the_norms_fp32_as_jax():
    tiny = dict(vocab=32, hidden=16, layers=1, heads=2, inter=32)
    jm = J.amp.decorate(JaxLlama(JaxConfig.tiny(**tiny)), level="O2",
                        dtype="bfloat16")
    pm, opt = P.amp.decorate(
        LlamaForCausalLM(LlamaConfig.tiny(**tiny), device="cpu"),
        optimizers="opt", level="O2", dtype="bfloat16")
    assert opt == "opt"
    want = {n: np.dtype(p._value.dtype).name
            for n, p in jm.named_parameters()}
    got = {n: _name(p) for n, p in pm.named_parameters()}
    assert got == want
    assert got["llama.norm.weight"] == "float32"
    assert P.amp.decorate(pm, level="O1") is pm
    with pytest.raises(ValueError):
        P.amp.decorate(pm, level="O3")


def test_nan_check_names_the_op_and_is_off_by_default():
    x = P.to_tensor([1.0, 0.0])
    assert not dispatch._nan_check
    P.log(x)                                   # -inf passes unchecked
    debugging.enable_tensor_checker()
    try:
        assert P.get_flags("FLAGS_check_nan_inf") == {
            "FLAGS_check_nan_inf": True}
        with pytest.raises(FloatingPointError, match="'log'"):
            P.log(x)
    finally:
        debugging.disable_tensor_checker()
    assert not dispatch._nan_check and dispatch._quiet
    with pytest.raises(KeyError):
        P.set_flags({"FLAGS_nope": 1})


def test_check_numerics_and_operator_stats():
    n, i, z = debugging.check_numerics(
        P.to_tensor([1.0, np.inf, np.nan, 0.0]),
        debug_mode=debugging.DebugMode.CHECK_NAN_INF)
    jn, ji, jz = J.amp.debugging.check_numerics(
        J.to_tensor([1.0, np.inf, np.nan, 0.0]),
        debug_mode=J.amp.debugging.DebugMode.CHECK_NAN_INF)
    assert (int(n), int(i), int(z)) == (int(jn.numpy()), int(ji.numpy()),
                                        int(jz.numpy()))
    with pytest.raises(FloatingPointError):
        debugging.check_numerics(P.to_tensor([np.nan]))
    with P.amp.auto_cast(), debugging.collect_operator_stats() as st:
        P.matmul(P.to_tensor(A), P.to_tensor(B))
        P.exp(P.to_tensor(A))
    assert st.stats == {"matmul": 1, "exp": 1}
    assert st.dtypes == {"matmul": {"bfloat16": 1}, "exp": {"float32": 1}}
    assert dispatch._quiet


def test_op_error_names_the_op_and_its_inputs():
    with pytest.raises(RuntimeError, match=r"operator 'matmul' failed on "
                                           r"inputs \(float32\[3, 4\], "
                                           r"float32\[3, 4\]"):
        P.matmul(P.to_tensor(A), P.to_tensor(A))


def test_capture_signature_keys_on_the_amp_regime():
    """A step captured outside ``auto_cast`` is another signature inside
    it (the JAX tiers key their lowerings on ``amp_cache_key``)."""
    from paddle_tpu_torch.jit import capture
    step = capture.CapturedStep(lambda x: x)
    x = [P.to_tensor([1.0])]
    plain = step._signature(x, (1,))
    with P.amp.auto_cast(dtype="bfloat16"):
        cast = step._signature(x, (1,))
    assert plain != cast and plain[1] is False
    assert cast[1] == (True, "bfloat16", (), ())
