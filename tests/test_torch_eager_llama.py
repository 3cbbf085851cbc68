"""The slice: Paddle's dygraph loop on the port's eager core, against the
JAX package's eager loop (``LlamaForCausalLM.compute_loss`` under
``amp.auto_cast``, ``loss.backward()``, ``AdamW.step()``,
``clear_grad()``), 3 steps of a 2-layer narrow LLaMA over the same
weights (``load_paddle_tpu_state``) and the same numpy batch.

- amp off: every loss and every grad of every step at rtol 1e-5 /
  atol 1e-6 (fp32 on both sides).
- O1 bf16: the dtypes the named compute ops output (``embedding``,
  ``rms_norm``, ``linear``, ``sdpa``, ``silu``, ``cross_entropy``) are
  exactly the JAX package's, and the losses agree within 2e-2 relative:
  both round the white-listed ops to bf16 (8 bits of mantissa, 2**-8 =
  4e-3 a rounding), but the two libraries' bf16 matmuls accumulate in
  different orders, so the roundings land differently.
"""
import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
import paddle_tpu_torch as P
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.llama import paddle_tpu_state

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, inter=64)
NAMED = ("embedding", "rms_norm", "linear", "sdpa", "silu", "cross_entropy")
STEPS = 3


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _pair():
    J.seed(11)
    jm = JaxLlama(JaxConfig.tiny(**TINY))
    pm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    load_paddle_tpu_state(pm, {n: np.asarray(p._value)
                               for n, p in jm.named_parameters()})
    return jm, pm


def _batch():
    ids = np.random.RandomState(4).randint(0, TINY["vocab"], (2, 13))
    return ids[:, :-1], ids[:, 1:].copy()


def _jax_op_dtypes(fn):
    """(op name -> set of output dtype names) of the JAX ops ``fn`` runs,
    read through the dispatch's nan/inf scan (which sees every op's
    outputs)."""
    from paddle_tpu.ops import dispatch as jd
    seen = {}
    orig = jd._scan_nan_inf

    def rec(out, multi, name):
        o = out[0] if multi else out
        seen.setdefault(name, set()).add(np.dtype(o._value.dtype).name)
    jd._scan_nan_inf, prev = rec, jd._nan_check
    jd.set_nan_check(True)
    try:
        out = fn()
    finally:
        jd._scan_nan_inf = orig
        jd.set_nan_check(prev)
    return out, seen


def _run(amp):
    jm, pm = _pair()
    ids, labels = _batch()
    jopt = J.optimizer.AdamW(learning_rate=1e-2,
                             parameters=jm.parameters())
    popt = P.optimizer.AdamW(learning_rate=1e-2,
                             parameters=pm.parameters())
    out = []
    for _ in range(STEPS):
        if amp:
            jm.set_state_dict(paddle_tpu_state(pm))
        with J.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
            jl, jdt = _jax_op_dtypes(lambda: jm.compute_loss(
                J.to_tensor(ids), J.to_tensor(labels)))
        jgrads = {}
        if not amp:
            jl.backward()
            jgrads = {n: np.asarray(p.grad._value, np.float32)
                      for n, p in jm.named_parameters()}
            jopt.step()
            jopt.clear_grad()
        with P.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"), \
                debugging.collect_operator_stats() as st:
            pl = pm.compute_loss(P.to_tensor(ids), P.to_tensor(labels))
        pl.backward()
        pgrads = {n: p.grad.numpy() for n, p in pm.named_parameters()}
        popt.step()
        popt.clear_grad()
        out.append((float(jl.numpy()), float(pl.numpy()), jgrads, pgrads,
                    jdt, {k: set(v) for k, v in st.dtypes.items()}))
    return out


def test_eager_steps_fp32_match_jax_losses_and_every_grad():
    for jl, pl, jg, pg, _, _ in _run(amp=False):
        np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-6)
        assert set(jg) == set(pg)
        for n in jg:
            np.testing.assert_allclose(pg[n], jg[n], rtol=1e-5, atol=1e-6,
                                       err_msg=n)


def test_eager_steps_o1_bf16_op_dtypes_equal_jax_and_losses_close():
    steps = _run(amp=True)
    for jl, pl, _, _, jdt, pdt in steps:
        for name in NAMED:
            assert name in pdt, name
            assert pdt[name] == jdt[name], (name, pdt[name], jdt[name])
        assert pdt["linear"] == {"bfloat16"} and pdt["sdpa"] == {"bfloat16"}
        assert pdt["rms_norm"] == {"float32"}
        assert pdt["cross_entropy"] == {"float32"}
        np.testing.assert_allclose(pl, jl, rtol=2e-2)
    assert steps[-1][1] < steps[0][1]
