"""The PyTorch port's training path, held against the JAX package's on the
CPU.

Both sides carry the same weights at ``LlamaConfig.tiny(vocab=64,
hidden=32, layers=2, heads=4, inter=64)``, once with 4 kv heads (MHA) and
once with 2 (GQA): the JAX model's parameters go across with
``load_paddle_tpu_state`` and come back with ``paddle_tpu_state``. Inputs
are made with numpy from a seed. Everything is compared in fp32 (the JAX
package turns x64 on) at rtol 1e-4 / atol 1e-5, as
tests/test_torch_llama.py, unless a test states otherwise: the two
libraries sum their matmuls in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import build_hybrid_train_step as jax_build
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.nn.functional import cross_entropy as jax_ce
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     build_hybrid_train_step,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.llama import paddle_tpu_state
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import Adam, AdamW

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(vocab=64, hidden=32, layers=2, heads=4, inter=64)


def _pair(kv_heads, seed=3):
    """(jax model, port model on the CPU) over the same weights."""
    P.seed(seed)
    jcfg = JaxConfig.tiny(**TINY)
    jcfg.num_key_value_heads = kv_heads
    jm = JaxLlama(jcfg)
    cfg = LlamaConfig.tiny(**TINY)
    cfg.num_key_value_heads = kv_heads
    pm = LlamaForCausalLM(cfg, device="cpu")
    load_paddle_tpu_state(pm, {n: np.asarray(p._value)
                               for n, p in jm.named_parameters()})
    return jm, pm


def _batch(B=4, S=12, seed=5, ignore=0):
    ids = np.random.RandomState(seed).randint(0, TINY["vocab"], (B, S + 1))
    labels = ids[:, 1:].copy()
    if ignore:
        labels[np.random.RandomState(seed + 1).rand(B, S) < ignore] = -100
    return ids[:, :-1], labels


def _jax_state(jm):
    return {n: np.asarray(p._value) for n, p in jm.named_parameters()}


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_compute_loss_and_every_grad_match_jax(kv_heads):
    jm, pm = _pair(kv_heads)
    ids, labels = _batch(ignore=0.2)
    jl = jm.compute_loss(P.to_tensor(ids), P.to_tensor(labels))
    jl.backward()
    pl = pm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl.numpy()),
                               rtol=RTOL)
    jgrads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    pgrads = dict(pm.named_parameters())
    assert set(jgrads) == set(pgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(pgrads[n].grad.numpy(), g, rtol=RTOL,
                                   atol=ATOL, err_msg=n)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_recompute_loss_and_every_grad_match_jax(kv_heads):
    """``recompute=True`` checkpoints each decoder layer (the JAX model's
    ``recompute``): the loss and every grad equal the JAX model's with
    ``recompute=True``, and the port's own without it."""
    jm, pm = _pair(kv_heads)
    jm.config.recompute = pm.config.recompute = True
    ids, labels = _batch(ignore=0.2, seed=7)
    jl = jm.compute_loss(P.to_tensor(ids), P.to_tensor(labels))
    jl.backward()
    pl = pm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl.numpy()),
                               rtol=RTOL)
    grads = {n: p.grad.clone() for n, p in pm.named_parameters()}
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(grads[n].numpy(),
                                   np.asarray(p.grad._value), rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    pm.config.recompute = False
    pm.zero_grad()
    plain = pm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
    plain.backward()
    assert float(plain.detach()) == float(pl.detach())
    for n, p in pm.named_parameters():
        torch.testing.assert_close(p.grad, grads[n], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_with_ignored_labels_matches_jax(reduction):
    r = np.random.RandomState(0)
    logits = r.randn(3, 5, 7).astype(np.float32)
    labels = r.randint(0, 7, (3, 5))
    labels[0, 1] = labels[2, 4] = -100
    want = np.asarray(jax_ce(P.to_tensor(logits), P.to_tensor(labels),
                             reduction=reduction).numpy())
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        reduction=reduction).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    all_ignored = torch.full((3, 5), -100)
    assert float(cross_entropy(torch.from_numpy(logits), all_ignored)) == 0.0
    # label smoothing, once raising here, now follows the reference too
    # (tests/test_torch_cross_entropy.py holds every option)
    smooth = jax_ce(P.to_tensor(logits), P.to_tensor(labels),
                    reduction=reduction, label_smoothing=0.1)
    np.testing.assert_allclose(
        cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                      reduction=reduction, label_smoothing=0.1).numpy(),
        np.asarray(smooth.numpy()), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cls", ["Adam", "AdamW"])
def test_adam_update_rule_matches_jax(cls):
    import paddle_tpu.optimizer as jopt
    r = np.random.RandomState(1)
    val, grad, m1 = (r.randn(6, 5).astype(np.float32) for _ in range(3))
    m2 = np.abs(r.randn(6, 5)).astype(np.float32)
    kw = dict(learning_rate=0.01, weight_decay=0.1, beta1=0.8, beta2=0.95)
    jo = getattr(jopt, cls)(parameters=[], **kw)
    po = {"Adam": Adam, "AdamW": AdamW}[cls](parameters=[], **kw)
    jv, js = jo._update_rule(jnp.asarray(val), jnp.asarray(grad),
                             {"moment1": jnp.asarray(m1),
                              "moment2": jnp.asarray(m2),
                              "__step__": jnp.asarray(3, jnp.int32)},
                             jnp.asarray(0.01, jnp.float32), 0.1)
    pv, ps = po._update_rule(torch.from_numpy(val), torch.from_numpy(grad),
                             {"moment1": torch.from_numpy(m1),
                              "moment2": torch.from_numpy(m2),
                              "__step__": 3}, 0.01, 0.1)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-7)
    for k in ("moment1", "moment2"):
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6, atol=1e-7)


def test_eager_optimizer_step_with_global_norm_clip_matches_jax():
    """``loss.backward(); opt.step(); opt.clear_grad()`` twice with a
    global-norm clip against the JAX optimizer's own eager loop."""
    jm, pm = _pair(2)
    ids, labels = _batch(seed=9)
    jo = P.optimizer.AdamW(learning_rate=0.01, parameters=jm.parameters(),
                           grad_clip=JaxClip(0.5))
    po = AdamW(learning_rate=0.01, parameters=pm.parameters(),
               grad_clip=ClipGradByGlobalNorm(0.5))
    for _ in range(2):
        jm.compute_loss(P.to_tensor(ids), P.to_tensor(labels)).backward()
        jo.step()
        jo.clear_grad()
        pm.compute_loss(torch.from_numpy(ids),
                        torch.from_numpy(labels)).backward()
        po.step()
        po.clear_grad()
    want = _jax_state(jm)
    for n, got in paddle_tpu_state(pm).items():
        np.testing.assert_allclose(got, want[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    sd = po.state_dict()
    assert sd["global_step"] == 2 and "0_moment1" in sd
    fresh = AdamW(learning_rate=0.01, parameters=pm.parameters())
    fresh.set_state_dict(sd)
    assert fresh.state_dict().keys() == sd.keys()
    for key, val in fresh.state_dict().items():
        if key != "global_step":
            torch.testing.assert_close(val, sd[key], rtol=0, atol=0)


def test_global_norm_clip_matches_jax():
    r = np.random.RandomState(2)
    grads = [r.randn(4, 3).astype(np.float32), r.randn(7).astype(np.float32)]
    want = JaxClip(1.5)([(None, P.to_tensor(g)) for g in grads])
    got = ClipGradByGlobalNorm(1.5)([(None, torch.from_numpy(g))
                                     for g in grads])
    for (_, w), (_, g) in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   rtol=1e-6)
    small = ClipGradByGlobalNorm(1e6)([(None, torch.from_numpy(grads[0]))])
    np.testing.assert_array_equal(small[0][1].numpy(), grads[0])


def _train_both(kv_heads, steps=5, **kw):
    jm, pm = _pair(kv_heads)
    clip = kw.pop("clip", None)
    jo = P.optimizer.AdamW(learning_rate=1e-2, parameters=jm.parameters(),
                           grad_clip=clip and JaxClip(clip))
    po = AdamW(learning_rate=1e-2, parameters=pm.parameters(),
               grad_clip=clip and ClipGradByGlobalNorm(clip))
    jstep = jax_build(jm, jo, **kw)
    pstep = build_hybrid_train_step(pm, po, **kw)
    jl, pl = [], []
    ids, labels = _batch(seed=20, ignore=0.1)   # one batch, as bench.py
    for _ in range(steps):
        jl.append(float(jstep({"input_ids": P.to_tensor(ids),
                               "labels": P.to_tensor(labels)}).numpy()))
        pl.append(float(pstep({"input_ids": ids, "labels": labels})))
    jstep.write_back()
    pstep.write_back()
    assert pstep.state["step"] == steps
    return np.asarray(jl), np.asarray(pl), _jax_state(jm), paddle_tpu_state(pm)


@pytest.mark.parametrize("kv_heads,remat", [(4, True), (4, False),
                                            (2, True), (2, False)])
def test_five_train_steps_match_jax(kv_heads, remat):
    """Losses at every step within rtol 1e-4; the final parameters within
    rtol 1e-4 / atol 1e-5 (AdamW at lr 1e-2 moves each weight about 5e-2
    in five steps, so this is about 2e-4 of the distance travelled)."""
    jl, pl, jp, pp = _train_both(kv_heads, remat=remat, amp=False)
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    assert pl[-1] < pl[0]
    for n, w in jp.items():
        np.testing.assert_allclose(pp[n], w, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_accumulate_steps_and_global_norm_clip_match_jax():
    jl, pl, jp, pp = _train_both(2, steps=3, remat=True, amp=False,
                                 accumulate_steps=2, clip=0.5)
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    for n, w in jp.items():
        np.testing.assert_allclose(pp[n], w, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_amp_losses_match_jax_within_bf16():
    """bf16 compute, fp32 masters, CE in fp32: the five losses agree within
    rtol 2e-2, about three bf16 rounding steps (2^-8 = 3.9e-3 each): the
    two libraries round their bf16 matmuls' fp32 sums at different
    places."""
    jl, pl, _, pp = _train_both(2, remat=True, amp=True)
    np.testing.assert_allclose(pl, jl, rtol=2e-2)
    assert all(v.dtype == np.float32 for v in pp.values())


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_five_fused_loss_train_steps_match_jax(kv_heads):
    """``fused_loss=True`` (the fused lm head + cross-entropy, K5-K7; their
    plain versions on the CPU) against the JAX step's fused leg, whose
    Pallas kernels run in interpret mode: losses and final parameters
    within rtol 1e-4 / atol 1e-5, with about 10% of the labels ignored."""
    jl, pl, jp, pp = _train_both(kv_heads, remat=True, amp=False,
                                 fused_loss=True)
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    assert pl[-1] < pl[0]
    for n, w in jp.items():
        np.testing.assert_allclose(pp[n], w, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_amp_fused_loss_losses_match_jax_within_bf16():
    """bf16 compute with the fused loss: both keep the logits as unrounded
    fp32 sums of bf16 products; the rest rounds as in
    test_amp_losses_match_jax_within_bf16, so the same rtol 2e-2."""
    jl, pl, _, pp = _train_both(2, remat=True, amp=True, fused_loss=True)
    np.testing.assert_allclose(pl, jl, rtol=2e-2)
    assert pl[-1] < pl[0]
    assert all(v.dtype == np.float32 for v in pp.values())


def test_fused_loss_equals_the_unfused_loss_in_fp32():
    """The port's two heads on the same weights and batch (ignored labels
    included): one step's loss within rtol 1e-5, and every parameter
    after it within rtol 1e-4 / atol 1e-5."""
    ids, labels = _batch(seed=20, ignore=0.1)
    losses, states = [], []
    for fused in (True, False):
        _, pm = _pair(2)
        opt = AdamW(learning_rate=1e-2, parameters=pm.parameters())
        step = build_hybrid_train_step(pm, opt, amp=False, fused_loss=fused)
        losses.append(float(step({"input_ids": ids, "labels": labels})))
        states.append(paddle_tpu_state(pm))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for n, w in states[1].items():
        np.testing.assert_allclose(states[0][n], w, rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_fused_loss_and_a_mesh_raise_not_in_this_slice():
    """Every mesh leg is ported (tests/test_torch_hybrid.py and
    test_torch_hybrid_pp.py drive them), so nothing raises
    ``NotInThisSlice`` any more: a mesh with an axis above 1 must be a real
    DeviceMesh (a dict raises ``TypeError``), with or without the fused
    loss; the schedule's checks raise ``ValueError``; ``fused_loss=True``
    alone builds."""
    _, pm = _pair(2)
    opt = AdamW(parameters=pm.parameters())
    build_hybrid_train_step(pm, opt, fused_loss=True)
    with pytest.raises(TypeError):
        build_hybrid_train_step(pm, opt, fused_loss=True,
                                mesh={"dp": 1, "pp": 2})
    with pytest.raises(TypeError):
        build_hybrid_train_step(pm, opt, mesh={"dp": 2, "sharding": 2})
    with pytest.raises(TypeError):
        build_hybrid_train_step(pm, opt, mesh={"dp": 2, "mp": 1})
    with pytest.raises(ValueError):
        build_hybrid_train_step(pm, opt, schedule="zigzag")
    build_hybrid_train_step(pm, opt, mesh={"dp": 1})      # trivial mesh
