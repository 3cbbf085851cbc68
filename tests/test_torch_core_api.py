"""The rest of the port's core API against the JAX package's, on the CPU.

``core.generator``'s ``next_key`` / ``key_override`` (the same structure
of equal and distinct draws as the JAX keys, seeded determinism, the
restore on exit also when blocks nest), ``utils`` (``LockedLRU`` and
``Lazy``, ``get_logger``, ``enforce``, DLPack, ``deprecated`` /
``require_version`` / ``try_import``, ``run_check``) and
``framework_compat``'s ``LazyGuard``, ``flops`` (equal to XLA's count on
bias-free linear stacks, where both count ``2 m n k`` a product),
``batch``, ``bool``, ``set_printoptions``, ``check_shape`` and
``disable_signal_handler``. Exact comparisons throughout: nothing here
rounds.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.core import generator as jgen
from paddle_tpu.utils import memo as jmemo
import paddle_tpu_torch as P
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.core import generator as pgen
from paddle_tpu_torch.utils import memo as pmemo


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _draw(g):
    return torch.rand(4, generator=g).numpy()


def _jkey(k):
    return tuple(np.asarray(jax.random.key_data(k)).ravel().tolist())


def _pattern(keys):
    """Which draws of a sequence equal which (first index of each)."""
    first = {}
    return [first.setdefault(k, i) for i, k in enumerate(keys)]


def _override_sequence(gen_mod, next_key, as_key, base):
    """Draws: 2 plain, 2 in a block, 1 in a nested block of the same base,
    1 more in the outer block, 1 in a second block, 1 plain."""
    out = [as_key(next_key()), as_key(next_key())]
    with gen_mod.key_override(base):
        out += [as_key(next_key()), as_key(next_key())]
        with gen_mod.key_override(base):
            out.append(as_key(next_key()))
        out.append(as_key(next_key()))
    with gen_mod.key_override(base):
        out.append(as_key(next_key()))
    out.append(as_key(next_key()))
    return out


def test_key_override_matches_the_jax_structure():
    J.seed(7)
    jkeys = _override_sequence(jgen, jgen.next_key, _jkey,
                               jax.random.key(1234))
    P.seed(7, "cpu")
    pkeys = _override_sequence(
        pgen, lambda: pgen.next_key(device="cpu"),
        lambda g: tuple(_draw(g).tolist()), 1234)
    assert _pattern(pkeys) == _pattern(jkeys)
    # counting from 0 in every block: the blocks' first draws agree; the
    # outer block resumes its own count after the nested one (a third draw)
    assert pkeys[2] == pkeys[4] == pkeys[6] and \
        pkeys[5] not in (pkeys[2], pkeys[3])


def test_next_key_is_seeded_and_leaves_the_stream_to_override():
    P.seed(3, "cpu")
    a = [_draw(pgen.next_key(device="cpu")) for _ in range(3)]
    P.seed(3, "cpu")
    b = [_draw(pgen.next_key(device="cpu")) for _ in range(3)]
    np.testing.assert_array_equal(np.stack(a), np.stack(b))
    assert not np.array_equal(a[0], a[1])
    P.seed(3, "cpu")
    with pgen.key_override(pgen.next_key(device="cpu")):
        pgen.next_key(device="cpu")               # drawn off the base
    np.testing.assert_array_equal(_draw(pgen.next_key(device="cpu")), a[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            pdev._state.device = None
            pgen.next_key()


def test_locked_lru_and_lazy_match_the_jax_containers():
    out = []
    for mod in (jmemo, pmemo):
        c = mod.LockedLRU(maxsize=3)
        for k in "abcd":
            c.put(k, ord(k))
        c.get("b")
        c.put("e", 5)
        made = c.get_or_create("f", lambda: 6)
        c.set_maxsize(2)
        out.append((c.items(), c.evictions, made, len(c), "f" in c,
                    c.pop("f"), c.get("zz", -1)))
        calls = []
        lz = mod.Lazy(lambda: calls.append(1) or 42)
        out.append((lz(), lz(), len(calls)))
    assert out[0] == out[2] and out[1] == out[3]


def test_logger_enforce_and_compat(monkeypatch):
    from paddle_tpu_torch.utils import (EnforceNotMet, deprecated, enforce,
                                        get_logger, require_version,
                                        try_import)
    from paddle_tpu.utils import EnforceNotMet as JEnforceNotMet
    from paddle_tpu.utils import enforce as jenforce
    monkeypatch.setenv("PADDLE_TPU_LOG_LEVEL", "warning")
    lg = get_logger("pt_core_api_test")
    assert lg is get_logger("pt_core_api_test") and lg.level == 30
    assert enforce(True) is True
    for fn, exc in ((enforce, EnforceNotMet), (jenforce, JEnforceNotMet)):
        with pytest.raises(exc, match=r"want 3, got 2\n\n\[operator stack\]"):
            fn(False, "want %d, got %d", 3, 2)

    @deprecated(update_to="new_fn", since="0.1")
    def old_fn():
        return 1
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert old_fn() == 1
    assert "new_fn" in str(w[0].message) and "deprecated" in old_fn.__doc__
    with pytest.raises(RuntimeError, match="deprecated"):
        deprecated(level=2)(lambda: 1)()
    require_version("0.0.1")
    with pytest.raises(Exception, match="required minimum"):
        require_version("99.0")
    with pytest.raises(Exception, match="allowed maximum"):
        require_version("0.0.1", "0.0.2")
    assert try_import("json").dumps([1]) == "[1]"
    with pytest.raises(ImportError, match="no_such_module_x"):
        try_import("no_such_module_x")


def test_dlpack_round_trips_and_takes_a_jax_array():
    from paddle_tpu_torch.utils import dlpack
    t = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    back = dlpack.from_dlpack(dlpack.to_dlpack(t))
    assert isinstance(back, P.Tensor) and back.data_ptr() == t.data_ptr()
    ja = J.to_tensor(np.arange(4, dtype=np.float32))
    got = dlpack.from_dlpack(J.utils.dlpack.to_dlpack(ja))
    np.testing.assert_array_equal(got.numpy(), ja.numpy())


def test_run_check(capsys):
    assert P.utils.run_check(device="cpu") is True
    assert "128.0 == 128.0" in capsys.readouterr().out
    if not torch.cuda.is_available():
        pdev._state.device = None
        with pytest.raises(RuntimeError, match="CUDA"):
            P.utils.run_check()


def test_lazy_guard_defers_then_materialises():
    with J.LazyGuard():
        jlin = J.nn.Linear(16, 16)
    with P.LazyGuard():
        lin = nn.Linear(16, 16)
        enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(8, 2, 16), 2)
    assert float(np.abs(jlin.weight.numpy()).sum()) == 0.0
    assert lin.weight.device.type == "meta" and \
        {p.device.type for p in enc.parameters()} == {"meta"}
    jlin.lazy_init()
    lin.lazy_init()
    assert float(np.abs(jlin.weight.numpy()).sum()) > 0.0
    assert lin.weight.device.type == "cpu" and \
        float(lin.weight.detach().abs().sum()) > 0.0
    out = enc(P.to_tensor(np.ones((1, 3, 8), np.float32)))   # first forward
    assert tuple(out.shape) == (1, 3, 8)
    assert {p.device.type for p in enc.parameters()} == {"cpu"}
    # the stacked copies start from the same weights, as built eagerly
    torch.testing.assert_close(enc.layers[0].linear1.weight,
                               enc.layers[1].linear1.weight)
    assert not enc._forward_pre_hooks
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    with P.LazyGuard():
        fmt = FusedMultiTransformer(8, 2, 16, num_layers=2)
    fmt.lazy_init()
    assert all(w.device.type == "cpu" for w in fmt.qkv_weights)
    assert fmt.qkv_weights[1] is fmt._parameters["p2_1"]


@pytest.mark.parametrize("widths", [(32, 64), (32, 64, 16)])
def test_flops_counts_what_xla_counts(widths):
    jnet = J.nn.Sequential(*[J.nn.Linear(a, b, bias_attr=False)
                             for a, b in zip(widths, widths[1:])])
    pnet = nn.Sequential(*[nn.Linear(a, b, bias_attr=False, device="cpu")
                           for a, b in zip(widths, widths[1:])])
    want = sum(2 * 8 * a * b for a, b in zip(widths, widths[1:]))
    assert P.flops(pnet, (8, widths[0])) == J.flops(jnet, (8, widths[0])) \
        == want


def test_batch_bool_printoptions_check_shape():
    for pkg in (J, P):
        r = pkg.batch(lambda: iter(range(10)), 4)
        assert [len(b) for b in r()] == [4, 4, 2]
        assert [len(b) for b in pkg.batch(lambda: iter(range(10)), 4,
                                          drop_last=True)()] == [4, 4]
    assert P.bool is torch.bool and P.to_tensor([1, 0]).astype(
        P.bool).dtype == torch.bool
    with P.set_grad_enabled(False):       # its module's `bool` is torch's
        assert not torch.is_grad_enabled()
    try:
        P.set_printoptions(precision=2, sci_mode=False)
        assert "3.14" in repr(torch.tensor([3.14159])) and \
            "3.141" not in repr(torch.tensor([3.14159]))
    finally:
        torch.set_printoptions(profile="default")
    assert P.disable_signal_handler() is None
    cases = [[2, -1, 3], (4,), 5, np.int64(3), [P.to_tensor(2), 3],
             P.to_tensor([2, 3]), "bad", [2.5], P.to_tensor([[2]])]
    for c in cases:
        jc = J.to_tensor(c.numpy()) if isinstance(c, P.Tensor) else (
            [J.to_tensor(e.numpy()) if isinstance(e, P.Tensor) else e
             for e in c] if isinstance(c, list) else c)
        results = []
        for fn, arg in ((J.check_shape, jc), (P.check_shape, c)):
            try:
                fn(arg)
                results.append(None)
            except (TypeError, ValueError) as e:
                results.append(type(e))
        assert results[0] == results[1], (c, results)
