"""The port's rule optimizers, clips and LBFGS against the JAX package's.

Each of the ten rule optimizers (SGD, Momentum, Adam, AdamW, Adamax,
Adagrad, Adadelta, RMSProp, Lamb, Lars; Nesterov momentum and centred
RMSProp besides), with weight decay on and off, takes five eager
``step()``s over the same three parameters and the same seeded grads in
both packages: every parameter and every state tensor agree at rtol 1e-6
/ atol 1e-7 (fp32; both round each op of the rule in fp32, and sums such
as Lamb's and Lars's norms are taken in different orders). Then parameter
groups, an ``LRScheduler`` as the learning rate, the state_dict keys, each
clip against the reference clip, and LBFGS's closure steps with and
without the strong-Wolfe line search.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.clip as jclip
import paddle_tpu.optimizer as jopt
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu.core.tensor import Parameter as JaxParameter
import paddle_tpu_torch.nn.clip as pclip
import paddle_tpu_torch.optimizer as popt
import paddle_tpu_torch.optimizer.lr as plr

RTOL, ATOL = 1e-6, 1e-7
SHAPES = [(6, 4), (4,), (3, 5)]
# (class, its own arguments, the name of its weight-decay argument)
RULES = {
    "SGD": ("SGD", {}, "weight_decay"),
    "Momentum": ("Momentum", {"momentum": 0.8}, "weight_decay"),
    "Momentum_nesterov": ("Momentum", {"momentum": 0.8,
                                       "use_nesterov": True},
                          "weight_decay"),
    "Adam": ("Adam", {"beta1": 0.8, "beta2": 0.95}, "weight_decay"),
    "AdamW": ("AdamW", {"beta1": 0.8, "beta2": 0.95}, "weight_decay"),
    "Adamax": ("Adamax", {"beta1": 0.8, "beta2": 0.95}, "weight_decay"),
    "Adagrad": ("Adagrad", {"initial_accumulator_value": 0.1},
                "weight_decay"),
    "Adadelta": ("Adadelta", {"rho": 0.9}, "weight_decay"),
    "RMSProp": ("RMSProp", {"rho": 0.9, "momentum": 0.5}, "weight_decay"),
    "RMSProp_centered": ("RMSProp", {"rho": 0.9, "momentum": 0.5,
                                     "centered": True}, "weight_decay"),
    "Lamb": ("Lamb", {"beta1": 0.8}, "lamb_weight_decay"),
    "Lars": ("Lars", {"momentum": 0.8, "lars_coeff": 0.01,
                      "epsilon": 1e-6}, "lars_weight_decay"),
}


def _values(seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32) for s in SHAPES]


def _grads(step, seed=100):
    r = np.random.RandomState(seed + step)
    return [r.randn(*s).astype(np.float32) for s in SHAPES]


def _pair(values):
    jp = [JaxParameter(jnp.asarray(v)) for v in values]
    pp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    return jp, pp


def _make(name, wd, jp, pp, **extra):
    cls, kw, wd_arg = RULES[name]
    kw = dict(kw, learning_rate=0.05, **extra)
    kw[wd_arg] = 0.05 if wd else (None if wd_arg == "weight_decay" else 0.0)
    return (getattr(jopt, cls)(parameters=jp, **kw),
            getattr(popt, cls)(parameters=pp, **kw))


def _step_both(jo, po, jp, pp, step, skip=()):
    for i, (a, b, g) in enumerate(zip(jp, pp, _grads(step))):
        if i in skip:
            continue
        a.grad = P.to_tensor(g)
        b.grad = torch.from_numpy(g)
    jo.step()
    jo.clear_grad()
    po.step()
    po.clear_grad()


def _assert_same(jo, po, jp, pp):
    for i, (a, b) in enumerate(zip(jp, pp)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a._value),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"param {i}")
        js, ps = jo._states[id(a)], po._states[id(b)]
        assert set(js) == set(ps), (set(js), set(ps))
        for k in js:
            np.testing.assert_allclose(
                np.asarray(ps[k]), np.asarray(js[k]), rtol=RTOL, atol=ATOL,
                err_msg=f"param {i} state {k}")


@pytest.mark.parametrize("wd", [True, False])
@pytest.mark.parametrize("name", sorted(RULES))
def test_five_eager_steps_match_jax(name, wd):
    jp, pp = _pair(_values())
    jo, po = _make(name, wd, jp, pp)
    for step in range(5):
        _step_both(jo, po, jp, pp, step, skip=(2,) if step == 1 else ())
    _assert_same(jo, po, jp, pp)
    assert po.state_dict().keys() == jo.state_dict().keys()
    assert po.state_dict()["global_step"] == 5


def test_parameter_groups_flatten_as_the_reference():
    jp, pp = _pair(_values(1))
    groups = lambda ps: [{"params": ps[:2]}, {"params": ps[2:]}]  # noqa: E731
    jo = jopt.Adam(learning_rate=0.05, parameters=groups(jp))
    po = popt.Adam(learning_rate=0.05, parameters=groups(pp))
    assert po._param_groups is not None and len(po._params) == 3
    for step in range(3):
        _step_both(jo, po, jp, pp, step)
    _assert_same(jo, po, jp, pp)


@pytest.mark.parametrize("name", ["SGD", "AdamW", "Lamb"])
def test_lr_scheduler_as_learning_rate_matches_jax(name):
    jp, pp = _pair(_values(2))
    js = jlr.CosineAnnealingDecay(0.1, T_max=4)
    ps = plr.CosineAnnealingDecay(0.1, T_max=4)
    jo, po = _make(name, True, jp, pp)
    jo._lr, po._lr = js, ps
    for step in range(5):
        assert po.get_lr() == jo.get_lr()
        _step_both(jo, po, jp, pp, step)
        js.step()
        ps.step()
    _assert_same(jo, po, jp, pp)
    sd, jsd = po.state_dict(), jo.state_dict()
    assert sd.keys() == jsd.keys() and "LR_Scheduler" in sd
    assert sd["LR_Scheduler"] == jsd["LR_Scheduler"]


def test_lamb_exclude_fn_and_state_dict_round_trip():
    jp, pp = _pair(_values(3))
    jo = jopt.Lamb(learning_rate=0.05, parameters=jp,
                   exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1)
    po = popt.Lamb(learning_rate=0.05, parameters=pp,
                   exclude_from_weight_decay_fn=lambda p: p.dim() == 1)
    for step in range(3):
        _step_both(jo, po, jp, pp, step)
    _assert_same(jo, po, jp, pp)
    assert float(po._states[id(pp[1])]["wd_scale"]) == 0.0
    sd = po.state_dict()
    fresh = popt.Lamb(learning_rate=0.05, parameters=pp)
    fresh.set_state_dict(sd)
    assert fresh.state_dict().keys() == sd.keys()
    for k, v in fresh.state_dict().items():
        if k != "global_step":
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


CLIPS = {
    "value": (lambda m: m.ClipGradByValue(0.3)),
    "value_min": (lambda m: m.ClipGradByValue(0.5, min=-0.1)),
    "norm": (lambda m: m.ClipGradByNorm(0.7)),
    "norm_small": (lambda m: m.ClipGradByNorm(100.0)),
    "global_norm": (lambda m: m.ClipGradByGlobalNorm(1.2)),
    "global_norm_small": (lambda m: m.ClipGradByGlobalNorm(1e6)),
}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clip_matches_the_reference_clip(name):
    grads = _grads(7) + [None]
    want = CLIPS[name](jclip)([(None, None if g is None else P.to_tensor(g))
                               for g in grads])
    got = CLIPS[name](pclip)([(None, None if g is None else
                               torch.from_numpy(g)) for g in grads])
    assert isinstance(CLIPS[name](pclip), pclip.ClipGradBase)
    for (_, w), (_, g) in zip(want, got):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["value", "norm", "global_norm"])
def test_clip_inside_the_optimizer_matches_jax(name):
    jp, pp = _pair(_values(4))
    jo = jopt.Momentum(learning_rate=0.05, parameters=jp,
                       grad_clip=CLIPS[name](jclip))
    po = popt.Momentum(learning_rate=0.05, parameters=pp,
                       grad_clip=CLIPS[name](pclip))
    for step in range(3):
        _step_both(jo, po, jp, pp, step)
    _assert_same(jo, po, jp, pp)


def _lbfgs_problem(seed=5):
    r = np.random.RandomState(seed)
    x = r.randn(16, 5).astype(np.float32)
    y = r.randn(16, 3).astype(np.float32)
    w0 = (0.1 * r.randn(5, 3)).astype(np.float32)
    b0 = np.zeros(3, np.float32)
    return x, y, w0, b0


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_five_closure_steps_match_jax(line_search):
    """LBFGS(max_iter=2) on a small least-squares problem with a quartic
    term: five ``step(closure)`` calls, the loss falling from 1.37 to
    0.67, losses and parameters after each within rtol 1e-4 / atol 1e-5
    (the flat dot products and the closures' sums are taken in different
    orders). Near the minimum the line search's choices rest on loss
    differences at fp32 noise, where the two packages may branch apart, so
    the run stops while the loss still falls by percents a step."""
    x, y, w0, b0 = _lbfgs_problem()
    jp, pp = _pair([w0, b0])
    kw = dict(learning_rate=1.0, max_iter=2, history_size=5,
              line_search_fn=line_search)
    jo = jopt.LBFGS(parameters=jp, **kw)
    po = popt.LBFGS(parameters=pp, **kw)
    jx, jy, tx, ty = P.to_tensor(x), P.to_tensor(y), torch.from_numpy(x), \
        torch.from_numpy(y)

    def jclosure():
        jo.clear_grad()
        r = P.matmul(jx, jp[0]) + jp[1] - jy
        loss = P.mean(r * r) + 0.1 * P.sum(jp[0] * jp[0] * jp[0] * jp[0])
        loss.backward()
        return loss

    def pclosure():
        po.clear_grad()
        r = tx @ pp[0] + pp[1] - ty
        loss = torch.mean(r * r) + 0.1 * torch.sum(pp[0] ** 4)
        loss.backward()
        return loss

    for _ in range(5):
        jl = float(jo.step(jclosure).numpy())
        pl = float(po.step(pclosure))
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
        for a, b in zip(jp, pp):
            np.testing.assert_allclose(b.detach().numpy(),
                                       np.asarray(a._value), rtol=1e-4,
                                       atol=1e-5)
    assert po._hist["func_evals"] == jo._hist["func_evals"]
    assert float(pclosure()) < 0.9 * float(
        torch.mean((tx @ torch.from_numpy(w0) - ty) ** 2))
    sd = po.state_dict()
    fresh = popt.LBFGS(parameters=pp, **kw)
    fresh.set_state_dict(sd)
    assert fresh._hist["n_iter"] == po._hist["n_iter"]
    assert len(fresh._hist["old_stps"]) == len(po._hist["old_stps"])


@pytest.mark.parametrize("name", ["Momentum", "AdamW", "Lamb"])
def test_functional_update_matches_jax(name):
    """``functional_update()``'s pure ``(init_fn, update_fn)`` over a nested
    tree, two steps, against the JAX optimizer's: new params and states at
    rtol 1e-6 / atol 1e-7; the port's inputs stay as they were."""
    vals = _values(6)
    jtree = {"a": jnp.asarray(vals[0]), "b": [jnp.asarray(vals[1]),
                                              jnp.asarray(vals[2])]}
    ptree = {"a": torch.from_numpy(vals[0].copy()),
             "b": [torch.from_numpy(vals[1].copy()),
                   torch.from_numpy(vals[2].copy())]}
    jo, po = _make(name, True, [], [])
    jinit, jupd = jo.functional_update()
    pinit, pupd = po.functional_update()
    js, ps = jinit(jtree), pinit(ptree)
    for step in (1, 2):
        g = _grads(20 + step)
        jg = {"a": jnp.asarray(g[0]), "b": [jnp.asarray(g[1]),
                                            jnp.asarray(g[2])]}
        pg = {"a": torch.from_numpy(g[0]), "b": [torch.from_numpy(g[1]),
                                                 torch.from_numpy(g[2])]}
        jtree, js = jupd(jtree, jg, js, jnp.asarray(0.05, jnp.float32),
                         jnp.asarray(step, jnp.int32))
        before = ptree["a"].clone()
        new_tree, ps = pupd(ptree, pg, ps, 0.05, step)
        assert torch.equal(ptree["a"], before)
        ptree = new_tree
    for jv, pv, jst, pst in ((jtree["a"], ptree["a"], js["a"], ps["a"]),
                             (jtree["b"][1], ptree["b"][1], js["b"][1],
                              ps["b"][1])):
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=RTOL,
                                   atol=ATOL)
        assert set(jst) == set(pst)
        for k in jst:
            np.testing.assert_allclose(np.asarray(pst[k]), np.asarray(jst[k]),
                                       rtol=RTOL, atol=ATOL)


def test_minimize_is_backward_step_clear_grad():
    jp, pp = _pair(_values(8))
    jo, po = _make("Adam", False, jp, pp)
    x = _grads(30)[0][:4]                    # [4, 4] inputs
    jl = P.sum(P.matmul(P.to_tensor(x), jp[0][:4]) ** 2)
    jo.minimize(jl)
    pl = torch.sum((torch.from_numpy(x) @ pp[0][:4]) ** 2)
    po.minimize(pl)
    assert all(p.grad is None for p in pp) and po._global_step == 1
    np.testing.assert_allclose(pp[0].detach().numpy(),
                               np.asarray(jp[0]._value), rtol=RTOL,
                               atol=ATOL)
