"""The port's ``compile_train_step``, ``GradScaler`` and the hybrid step's
LR scheduler, held against the JAX package on the CPU.

- ``compile_train_step`` on a tiny LLaMA (2 layers, hidden 64) against the
  JAX one on the same weights and batches: five steps' losses and the
  final parameters at rtol 1e-4 / atol 1e-5 (tests/test_torch_train.py's
  tolerances: the two libraries sum their matmuls in different orders),
  plain and with a GradScaler, a global-norm clip and two micro-batches.
- Each case of tests/test_amp_self_healing.py on the port, on a linear
  model with an MSE loss, beside the JAX step where the reference's
  numbers can be read: a nan step is skipped with every parameter and
  moment bit-identical; the steps after a skip equal an uninterrupted run
  bit for bit; the scale backs off and grows as the JAX step's; growth is
  capped at 2**31; a scaled run tracks an unscaled one; a global-norm clip
  leaves the scale alone; a nan in one micro-batch skips the whole step.
- The eager ``GradScaler`` (scale, backward, step, update) against JAX's,
  with an overflowing step, and ``build_hybrid_train_step`` with an
  ``LRScheduler`` against the JAX step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.optimizer as jopt
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu.amp import GradScaler as JaxScaler
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import build_hybrid_train_step as jax_build
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.parallel import mesh as mesh_mod
from paddle_tpu.parallel.trainer import compile_train_step as jax_compile
import paddle_tpu_torch.optimizer as popt
import paddle_tpu_torch.optimizer.lr as plr
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.core.errors import NotInThisSlice
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     build_hybrid_train_step,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.llama import paddle_tpu_state
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.parallel import (MAX_LOSS_SCALE, TrainStep,
                                       compile_train_step)

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(vocab=64, hidden=64, layers=2, heads=4, inter=128)


@pytest.fixture(autouse=True)
def _clean_mesh():
    mesh_mod.set_mesh(None)
    yield
    mesh_mod.set_mesh(None)


# ---- the tiny LLaMA against the JAX TrainStep ----

def _llamas(seed=3):
    P.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(**TINY))
    pm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    load_paddle_tpu_state(pm, {n: np.asarray(p._value)
                               for n, p in jm.named_parameters()})
    return jm, pm


def _ids(step, B=4, S=12):
    ids = np.random.RandomState(50 + step).randint(0, TINY["vocab"],
                                                   (B, S + 1))
    return ids[:, :-1], ids[:, 1:].copy()


def _llama_loss(m, b):
    return m.compute_loss(b["input_ids"], b["labels"])


@pytest.mark.parametrize("variant", ["plain", "scaled_clip_acc2"])
def test_compile_train_step_five_steps_match_jax(variant):
    """With the scaler, the clip and two micro-batches AdamW runs at epsilon
    1e-3: at its default 1e-8 an element whose grad is near 0 (a sum that
    cancels, whose last bits differ between the libraries) moves by lr x
    its grad's sign, and the ratio m / sqrt(v) carries the sum's relative
    noise into the parameter (one element of 8192 lands 3e-5 apart); with
    epsilon 1e-3 the update is a smooth function of the grads."""
    jm, pm = _llamas()
    kw, jkw = {}, {}
    clip = jclip = None
    eps = 1e-8
    if variant != "plain":
        eps = 1e-3
        kw = dict(accumulate_steps=2, scaler=GradScaler(
            init_loss_scaling=2.0 ** 10, incr_every_n_steps=2))
        jkw = dict(accumulate_steps=2, scaler=JaxScaler(
            init_loss_scaling=2.0 ** 10, incr_every_n_steps=2))
        clip, jclip = ClipGradByGlobalNorm(0.5), JaxClip(0.5)
    jo = jopt.AdamW(learning_rate=1e-2, parameters=jm.parameters(),
                    grad_clip=jclip, epsilon=eps)
    po = popt.AdamW(learning_rate=1e-2, parameters=pm.parameters(),
                    grad_clip=clip, epsilon=eps)
    jstep = jax_compile(jm, _llama_loss, jo, **jkw)
    pstep = compile_train_step(pm, _llama_loss, po, **kw)
    jl, pl = [], []
    for s in range(5):
        ids, labels = _ids(s)
        jl.append(float(jstep({"input_ids": P.to_tensor(ids),
                               "labels": P.to_tensor(labels)}).numpy()))
        pl.append(float(pstep({"input_ids": ids, "labels": labels})))
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    assert pstep.skipped_steps == jstep.skipped_steps == 0
    assert pstep.loss_scale == jstep.loss_scale
    got = paddle_tpu_state(pm)
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(got[n], np.asarray(p._value), rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    assert all(st["moment1"].abs().sum() > 0 for st in pstep._opt_state)


def test_train_step_legs_of_later_slices_raise():
    """The mesh legs are ported (tests/test_torch_zero.py); what still
    waits for later slices raises ``NotInThisSlice``: ``lower_text`` and
    ``memory_stats`` (whole-step capture). ``reshard`` is ported (its
    dp2 -> dp1 case is in tests/test_torch_elastic_trainer.py): it refuses
    no mesh, as the JAX one, and onto the same one-rank mesh it keeps
    every value."""
    _, pm = _llamas()
    opt = popt.SGD(parameters=pm.parameters())
    with pytest.raises(TypeError):          # every mesh leg: a DeviceMesh
        compile_train_step(pm, _llama_loss, opt, mesh={"dp": 2, "pp": 2})
    with pytest.raises(TypeError):
        compile_train_step(pm, _llama_loss, opt, mesh={"dp": 2})
    step = compile_train_step(pm, _llama_loss, opt, mesh={"dp": 1})
    assert isinstance(step, TrainStep) and step.captured_program is None
    for fn in (step.lower_text, step.memory_stats):
        with pytest.raises(NotInThisSlice):
            fn(None)
    with pytest.raises(ValueError):
        step.reshard(None)
    before = [p.detach().clone() for p in pm.parameters()]
    step.reshard({"dp": 1})
    assert all(torch.equal(a, p) for a, p in zip(before, pm.parameters()))


# ---- the self-healing cases (tests/test_amp_self_healing.py) ----

class _Linear(torch.nn.Module):
    """``x @ W + b`` with W ``[in, out]``: P.nn.Linear's layout."""

    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.bias = torch.nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, x):
        return x @ self.weight + self.bias


def _mse(m, b):
    return torch.mean(torch.square(m(b["x"]) - b["y"]))


def _jax_mse(m, b):
    return P.nn.functional.mse_loss(m(b["x"]), b["y"])


def _linears(seed):
    P.seed(seed)
    jm = P.nn.Linear(8, 4)
    return jm, _Linear(np.asarray(jm.weight._value),
                       np.asarray(jm.bias._value))


def _steps(scaler=None, jscaler=None, acc=None, seed=3, opt="SGD",
           clip=None):
    jm, pm = _linears(seed)
    kw = dict(learning_rate=0.1)
    jo = getattr(jopt, opt)(parameters=jm.parameters(),
                            grad_clip=clip and JaxClip(clip), **kw)
    po = getattr(popt, opt)(parameters=pm.parameters(),
                            grad_clip=clip and ClipGradByGlobalNorm(clip),
                            **kw)
    return (jm, jax_compile(jm, _jax_mse, jo, accumulate_steps=acc,
                            scaler=jscaler),
            pm, compile_train_step(pm, _mse, po, accumulate_steps=acc,
                                   scaler=scaler))


def _data(seed, nan=False, batch=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 8).astype(np.float32)
    if nan:
        x[0, 0] = np.nan
    return {"x": x, "y": rng.randn(batch, 4).astype(np.float32)}


def _both(jstep, pstep, b):
    jl = float(jstep({k: P.to_tensor(v) for k, v in b.items()}).numpy())
    return jl, float(pstep(b))


def _bits(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def _state_bits(step):
    return [{k: v.clone() for k, v in st.items()} for st in step._opt_state]


def _same_bits(a, b):
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               for k in a)


@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
def test_nan_grad_skips_step_params_bit_identical(opt):
    jm, jstep, pm, pstep = _steps(opt=opt)
    _both(jstep, pstep, _data(0))
    before, sbefore = _bits(pm), _state_bits(pstep)
    jl, pl = _both(jstep, pstep, _data(1, nan=True))
    assert not np.isfinite(pl) and not np.isfinite(jl)
    assert pstep.skipped_steps == jstep.skipped_steps == 1
    assert _same_bits(before, _bits(pm))
    for a, b in zip(sbefore, _state_bits(pstep)):
        assert _same_bits(a, b)
    _both(jstep, pstep, _data(2))
    assert pstep.skipped_steps == 1
    assert not _same_bits(before, _bits(pm))
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(pm.state_dict()[n].numpy(),
                                   np.asarray(p._value), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
def test_post_skip_steps_match_uninterrupted_run(opt):
    _, _, pa, sa = _steps(seed=5, opt=opt)
    for b in (_data(0), _data(1, nan=True), _data(2), _data(3)):
        sa(b)
    _, _, pb, sb = _steps(seed=5, opt=opt)
    for b in (_data(0), _data(2), _data(3)):
        sb(b)
    if opt == "SGD":
        assert _same_bits(_bits(pa), _bits(pb))
    else:
        # Adam's bias correction counts the skipped step (the reference's
        # step counter advances on it too), so only the skip count and
        # finiteness are comparable with the uninterrupted run
        assert all(torch.isfinite(p).all() for p in pa.parameters())
    assert sa.skipped_steps == 1 and sb.skipped_steps == 0
    assert sa._step_count == 4 and sb._step_count == 3


def test_gradscaler_backoff_and_growth_inside_the_step():
    kw = dict(init_loss_scaling=1024.0, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    scaler = GradScaler(**kw)
    _, jstep, _, step = _steps(scaler=scaler, jscaler=JaxScaler(**kw))
    want = [1024.0, 2048.0, 1024.0, 1024.0, 2048.0]
    for i, b in enumerate([_data(0), _data(1), _data(2, nan=True), _data(3),
                           _data(4)]):
        _both(jstep, step, b)
        assert step.loss_scale == jstep.loss_scale == want[i]
    assert step.skipped_steps == 1
    assert step.sync_scaler() is scaler and scaler._scale == 2048.0


def test_loss_scale_growth_is_capped():
    scaler = GradScaler(init_loss_scaling=MAX_LOSS_SCALE / 4,
                        incr_every_n_steps=1)
    _, _, _, step = _steps(scaler=scaler)
    for i in range(5):
        step(_data(i))
    assert step.loss_scale == MAX_LOSS_SCALE == 2.0 ** 31
    assert step.skipped_steps == 0


@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
def test_scaled_run_matches_unscaled_run(opt):
    scaler = GradScaler(init_loss_scaling=256.0, incr_every_n_steps=2)
    _, _, ms, ss = _steps(scaler=scaler, seed=9, opt=opt)
    _, _, mu, su = _steps(seed=9, opt=opt)
    for i in range(5):
        np.testing.assert_allclose(float(ss(_data(i))), float(su(_data(i))),
                                   rtol=1e-5)
    assert ss.loss_scale > 256.0
    for (n, a), (_, b) in zip(ms.named_parameters(), mu.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_loss_scale_unaffected_by_global_norm_clip():
    scaler = GradScaler(init_loss_scaling=4096.0, incr_every_n_steps=100)
    _, _, _, step = _steps(scaler=scaler, seed=13, clip=0.01)
    for i in range(3):
        step(_data(i))
    assert step.loss_scale == 4096.0
    step(_data(9, nan=True))
    assert step.loss_scale == 2048.0 and step.skipped_steps == 1


def test_nan_in_one_microbatch_skips_whole_accumulated_step():
    jm, jstep, pm, step = _steps(acc=2)
    _both(jstep, step, _data(0, batch=8))
    before = _bits(pm)
    _both(jstep, step, _data(1, nan=True, batch=8))
    assert step.skipped_steps == jstep.skipped_steps == 1
    assert _same_bits(before, _bits(pm))
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(pm.state_dict()[n].numpy(),
                                   np.asarray(p._value), rtol=1e-6,
                                   atol=1e-7)


# ---- the eager GradScaler and the hybrid step's scheduler ----

def test_eager_gradscaler_matches_jax():
    jm, pm = _linears(21)
    jo = jopt.Adam(learning_rate=0.05, parameters=jm.parameters())
    po = popt.Adam(learning_rate=0.05, parameters=pm.parameters())
    kw = dict(init_loss_scaling=2.0 ** 12, incr_every_n_steps=2)
    js, ps = JaxScaler(**kw), GradScaler(**kw)
    for i, nan in enumerate([False, False, True, False, False]):
        b = _data(30 + i, nan=nan)
        js.scale(_jax_mse(jm, {k: P.to_tensor(v) for k, v in b.items()})
                 ).backward()
        js.step(jo)
        js.update()
        jo.clear_grad()
        ps.scale(_mse(pm, {k: torch.from_numpy(v) for k, v in b.items()})
                 ).backward()
        ps.step(po)
        ps.update()
        po.clear_grad()
        assert float(ps.get_loss_scaling()) == float(
            js.get_loss_scaling().numpy())
    assert po._global_step == jo._global_step == 4
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(pm.state_dict()[n].numpy(),
                                   np.asarray(p._value), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    assert ps.state_dict() == js.state_dict()
    off = GradScaler(enable=False)
    assert off.scale(3.0) == 3.0 and not off.is_enable()


def test_hybrid_step_with_an_lr_scheduler_matches_jax():
    jm, pm = _llamas(seed=4)
    js = jlr.LinearWarmup(jlr.CosineAnnealingDecay(2e-2, T_max=6),
                          warmup_steps=2, start_lr=1e-3, end_lr=2e-2)
    ps = plr.LinearWarmup(plr.CosineAnnealingDecay(2e-2, T_max=6),
                          warmup_steps=2, start_lr=1e-3, end_lr=2e-2)
    jo = jopt.AdamW(learning_rate=js, parameters=jm.parameters(),
                    grad_clip=JaxClip(0.5))
    po = popt.AdamW(learning_rate=ps, parameters=pm.parameters(),
                    grad_clip=ClipGradByGlobalNorm(0.5))
    jstep = jax_build(jm, jo, amp=False)
    pstep = build_hybrid_train_step(pm, po, amp=False)
    jl, pl, lrs = [], [], []
    for s in range(5):
        ids, labels = _ids(s)
        lrs.append(po.get_lr())
        jl.append(float(jstep({"input_ids": P.to_tensor(ids),
                               "labels": P.to_tensor(labels)}).numpy()))
        pl.append(float(pstep({"input_ids": ids, "labels": labels})))
        js.step()
        ps.step()
    assert len(set(lrs)) == 5
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    jstep.write_back()
    got = paddle_tpu_state(pm)
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(got[n], np.asarray(p._value), rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    state_ids = [id(t) for st in pstep.state["opt"].values()
                 for t in st.values()]
    pstep({"input_ids": ids, "labels": labels})
    assert state_ids == [id(t) for st in pstep.state["opt"].values()
                         for t in st.values()]        # moments in place
