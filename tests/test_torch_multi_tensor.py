"""The multi-tensor kernels' plain versions (U1, U2) on the CPU.

- Plain U2 (``multi_tensor_adam_ref``, the CPU path of the wrapper) over a
  list of parameters equals, bit for bit, five steps of the per-tensor rule
  (``Adam._update_rule`` / ``AdamW``'s, the base ``Optimizer._multi_update``),
  with and without weight decay, in fp32 and bf16, with an inverse loss
  scale and a clip scale folded in; and agrees with the JAX rule at rtol
  1e-6 / atol 1e-7 (its bias corrections come from XLA's pow).
- A ``finite`` flag of 0 leaves every bit of p, m and v.
- The grad is multiplied by ``inv_scale`` first and ``clip_scale`` second,
  each rounded to the grad's dtype, as the reference train step does.
- Plain U1: each tensor's fp32 sum of squares against a float64 sum at
  rtol 1e-6, the total added in list order, the finite flag over the
  unscaled grads (nan, +inf, -inf each found), and the inverse scale
  applied in the grad's dtype.
- The wrappers take the plain versions for CPU tensors and launch nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu_torch.ops.kernels import multi_tensor as mt
from paddle_tpu_torch.optimizer import Adam, AdamW, Optimizer

SHAPES = [(1,), (0,), (7, 5), (1031,), (3, 4, 5)]


def _tensors(seed, dtype=torch.float32, scale=1.0, shapes=SHAPES):
    r = np.random.RandomState(seed)
    return [torch.from_numpy((scale * r.randn(*s)).astype(np.float32))
            .to(dtype) for s in shapes]


def _params_and_state(dtype, seed=0):
    ps = _tensors(seed, dtype)
    ms = _tensors(seed + 1, dtype, 0.1)
    vs = [t.abs() for t in _tensors(seed + 2, dtype, 0.1)]
    return ps, ms, vs


def _scalar(x, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cls,wd", [(Adam, None), (Adam, 0.05),
                                    (AdamW, 0.0), (AdamW, 0.05)])
@pytest.mark.parametrize("scaled", [False, True])
def test_plain_u2_equals_five_steps_of_the_per_tensor_rule(cls, wd, dtype,
                                                           scaled):
    kw = dict(learning_rate=0.01, beta1=0.8, beta2=0.95, weight_decay=wd)
    opt = cls(parameters=[torch.zeros(1)], **kw)
    ps, ms, vs = _params_and_state(dtype)
    rule = [(p.clone(), {"moment1": m.clone(), "moment2": v.clone()})
            for p, m, v in zip(ps, ms, vs)]
    inv = _scalar(2.0 ** -7) if scaled else None
    clip = _scalar(0.37) if scaled else None
    for step in range(1, 6):
        grads = _tensors(10 + step, dtype, 128.0 if scaled else 1.0)
        mt.multi_tensor_adam(
            ps, grads, ms, vs, lr=0.01, beta1=0.8, beta2=0.95, epsilon=1e-8,
            weight_decay=opt._wd(), decoupled=cls is AdamW, step=step,
            inv_scale=inv, clip_scale=clip)
        Optimizer._multi_update(opt, [p for p, _ in rule], grads,
                                [s for _, s in rule], 0.01, step,
                                grad_scale=inv, clip_scale=clip)
    for (p, s), p2, m2, v2 in zip(rule, ps, ms, vs):
        assert p.dtype == p2.dtype == dtype
        for a, b in ((p, p2), (s["moment1"], m2), (s["moment2"], v2)):
            assert torch.equal(a, b)
    assert mt.multi_tensor_adam.launches == 0


@pytest.mark.parametrize("decoupled", [False, True])
def test_plain_u2_follows_the_jax_rule(decoupled):
    """The JAX rule on the grads pre-multiplied by inv then clip (in fp32,
    as TrainStep multiplies them): five steps, every tensor within rtol
    1e-6 / atol 1e-7."""
    cls = jopt.AdamW if decoupled else jopt.Adam
    jo = cls(learning_rate=0.01, beta1=0.8, beta2=0.95, weight_decay=0.05,
             parameters=[])
    ps, ms, vs = _params_and_state(torch.float32, seed=3)
    # copies: on the CPU jnp.asarray may share the numpy buffer, which is
    # the torch tensor's and is updated in place below
    jv = [(jnp.array(p.numpy().copy()),
           {"moment1": jnp.array(m.numpy().copy()),
            "moment2": jnp.array(v.numpy().copy())})
          for p, m, v in zip(ps, ms, vs)]
    inv, clip = np.float32(2.0 ** -5), np.float32(0.61)
    for step in range(1, 6):
        grads = _tensors(20 + step, scale=32.0)
        mt.multi_tensor_adam_ref(
            ps, grads, ms, vs, lr=0.01, beta1=0.8, beta2=0.95, epsilon=1e-8,
            weight_decay=0.05, decoupled=decoupled, step=step,
            inv_scale=_scalar(inv), clip_scale=_scalar(clip))
        new = []
        for (v, s), g in zip(jv, grads):
            gj = jnp.asarray(g.numpy()) * inv * clip
            s = dict(s, __step__=jnp.asarray(step, jnp.int32))
            nv, ns = jo._update_rule(v, gj, s, jnp.asarray(0.01, jnp.float32),
                                     0.05)
            ns.pop("__step__", None)
            new.append((nv, ns))
        jv = new
    for (v, s), p, m, vv in zip(jv, ps, ms, vs):
        for got, want in ((p, v), (m, s["moment1"]), (vv, s["moment2"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_finite_zero_leaves_every_bit(dtype):
    ps, ms, vs = _params_and_state(dtype, seed=5)
    before = [t.clone() for t in ps + ms + vs]
    grads = _tensors(6, dtype)
    grads[2][1, 1] = float("nan")
    mt.multi_tensor_adam(ps, grads, ms, vs, lr=0.1, beta1=0.9, beta2=0.999,
                         epsilon=1e-8, weight_decay=0.01, decoupled=True,
                         step=1, inv_scale=_scalar(0.5),
                         clip_scale=_scalar(float("nan")),
                         finite=_scalar(0, torch.int32))
    for a, b in zip(before, ps + ms + vs):
        assert torch.equal(a.view(torch.int16 if a.element_size() == 2
                                  else torch.int32),
                           b.view(torch.int16 if b.element_size() == 2
                                  else torch.int32))
    mt.multi_tensor_adam(ps, _tensors(6, dtype), ms, vs, lr=0.1, beta1=0.9,
                         beta2=0.999, epsilon=1e-8, weight_decay=0.01,
                         decoupled=True, step=1,
                         finite=_scalar(1, torch.int32))
    assert not torch.equal(before[2], ps[2])


def test_grad_is_multiplied_by_inv_then_clip_in_its_dtype():
    """In bf16 ``(g * inv) * clip`` and ``(g * clip) * inv`` round apart;
    U2's first moment after one step from zero (b1 = 0: m = g') shows which
    was taken, and that each scale was rounded to bf16 first."""
    g = torch.tensor([1.3, -2.7, 0.011, 5.9], dtype=torch.bfloat16)
    inv, clip = _scalar(0.3), _scalar(0.77)
    p, m, v = (torch.zeros(4, dtype=torch.bfloat16) for _ in range(3))
    mt.multi_tensor_adam([p], [g], [m], [v], lr=0.0, beta1=0.0, beta2=0.0,
                         epsilon=1e-8, weight_decay=0.0, decoupled=True,
                         step=1, inv_scale=inv, clip_scale=clip)
    want = (g * inv.to(torch.bfloat16)) * clip.to(torch.bfloat16)
    other = (g * clip.to(torch.bfloat16)) * inv.to(torch.bfloat16)
    assert torch.equal(m, want)
    assert not torch.equal(want, other)      # the order is visible here


def test_plain_u1_sums_in_fp32_in_list_order_and_finds_nonfinite():
    grads = _tensors(7, scale=3.0) + [torch.randn(4, 4, dtype=torch.bfloat16)]
    sumsq, total, finite = mt.multi_tensor_sumsq_finite(grads)
    want = [float(np.sum(np.square(g.double().numpy()))) for g in grads]
    np.testing.assert_allclose(sumsq.numpy(), want, rtol=1e-6)
    acc = torch.zeros((), dtype=torch.float32)
    for s in sumsq:
        acc = acc + s
    assert sumsq.dtype == total.dtype == torch.float32
    assert torch.equal(total, acc) and int(finite) == 1
    assert finite.dtype == torch.int32 and sumsq.shape == (len(grads),)
    for bad in (float("nan"), float("inf"), float("-inf")):
        poisoned = [g.clone() for g in grads]
        poisoned[3][17] = bad
        assert int(mt.multi_tensor_sumsq_finite(poisoned)[2]) == 0
    # the flag is judged after the inverse scale, in the grad's dtype
    big = [torch.tensor([3.0e38, 1.0]), torch.tensor([60000.0],
                                                     dtype=torch.float16)]
    assert int(mt.multi_tensor_sumsq_finite(big, _scalar(4.0))[2]) == 0
    s, _, fin = mt.multi_tensor_sumsq_finite(big, _scalar(0.5))
    assert int(fin) == 1                     # every element is finite ...
    assert s[0] == float("inf") and s[1] == 9.0e8   # ... a square is not
    assert mt.multi_tensor_sumsq_finite.launches == 0


def test_wrappers_refuse_other_devices_and_empty_lists():
    with pytest.raises(ValueError):
        mt.multi_tensor_sumsq_finite([])
    with pytest.raises(ValueError):
        mt.multi_tensor_sumsq_finite([torch.zeros(3, device="meta")])
    p = torch.zeros(3, device="meta")
    with pytest.raises(ValueError):
        mt.multi_tensor_adam([p], [p], [p], [p], lr=0.1, beta1=0.9,
                             beta2=0.9, epsilon=1e-8, weight_decay=0.0,
                             decoupled=True, step=1)
    mt.multi_tensor_adam([], [], [], [], lr=0.1, beta1=0.9, beta2=0.9,
                         epsilon=1e-8, weight_decay=0.0, decoupled=True,
                         step=1)


def test_adam_scalars_round_as_the_rule():
    """``1 - beta1`` taken in double then rounded (0.1f, not 1.0f - 0.9f),
    the bias corrections as float32 powers, every constant in the dtype."""
    sc = mt.adam_scalars(torch.float32, 1e-3, 0.9, 0.999, 1e-8, 0.01, 3,
                         True)
    assert sc.omb1 == float(np.float32(0.1))
    assert sc.omb1 != float(np.float32(1.0) - np.float32(0.9))
    assert sc.bc1 == float(1 - np.float32(0.9) ** np.float32(3))
    bf = mt.adam_scalars(torch.bfloat16, 1e-3, 0.9, 0.999, 1e-8, 0.01, 3,
                         True)
    assert bf.b2 == float(torch.tensor(0.999).to(torch.bfloat16))
    assert bf.decoupled is True
