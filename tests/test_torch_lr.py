"""The port's LR schedulers against the JAX package's.

Every scheduler of ``paddle_tpu.optimizer.lr`` (16, plus LinearWarmup
around another scheduler) is built with the same arguments in both
packages; 30 values of ``scheduler()``, each followed by ``step()``
(ReduceOnPlateau: ``step(metric)`` over one seeded metric sequence), are
equal to the last bit (both are host arithmetic in Python floats). The
``state_dict`` of a scheduler part-way through loads into a fresh one,
which then goes on exactly as the first.
"""
import math

import numpy as np
import pytest

import paddle_tpu.optimizer.lr as jlr
import paddle_tpu_torch.optimizer.lr as plr
from paddle_tpu_torch.optimizer import SGD, AdamW


def _cases():
    lam = (lambda e: 0.95 ** e)
    return {
        "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                           learning_rate=2.0),
        "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 9, 20],
                                                     [0.1, 0.05, 0.01, 1e-3]),
        "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
        "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
        "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=12,
                                                       end_lr=1e-3,
                                                       power=2.0),
        "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
            0.1, decay_steps=7, power=1.5, cycle=True),
        "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=6,
                                                 start_lr=0.0, end_lr=0.1),
        "LinearWarmup_sched": lambda m: m.LinearWarmup(
            m.CosineAnnealingDecay(0.2, T_max=10), warmup_steps=4,
            start_lr=0.01, end_lr=0.2),
        "ExponentialDecay": lambda m: m.ExponentialDecay(0.3, gamma=0.9),
        "MultiStepDecay": lambda m: m.MultiStepDecay(0.3, [4, 11, 17],
                                                     gamma=0.3),
        "StepDecay": lambda m: m.StepDecay(0.3, step_size=4, gamma=0.5),
        "LambdaDecay": lambda m: m.LambdaDecay(0.2, lam),
        "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
            0.1, factor=0.5, patience=2, cooldown=1, min_lr=1e-3),
        "ReduceOnPlateau_max_abs": lambda m: m.ReduceOnPlateau(
            0.1, mode="max", threshold_mode="abs", threshold=0.05,
            patience=1),
        "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
            0.1, T_max=9, eta_min=1e-3),
        "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.2, lam),
        "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=25),
        "OneCycleLR_linear": lambda m: m.OneCycleLR(
            0.1, total_steps=20, anneal_strategy="linear", phase_pct=0.4),
        "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4),
        "CyclicLR_tri2": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3,
                                              step_size_down=5,
                                              mode="triangular2"),
        "CyclicLR_exp": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3,
                                             mode="exp_range",
                                             exp_gamma=0.97),
        "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
            0.1, T_0=5, T_mult=2, eta_min=1e-3),
    }


CASES = _cases()
METRICS = list(np.random.RandomState(0).rand(30) + np.linspace(1, 0, 30))


def _run(sched, n, start=0):
    out = []
    for i in range(start, start + n):
        out.append(sched())
        if isinstance(sched, (plr.ReduceOnPlateau, jlr.ReduceOnPlateau)):
            sched.step(METRICS[i])
        else:
            sched.step()
    return out


def test_every_scheduler_is_covered():
    names = {n for n in dir(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)
             and n != "LRScheduler"}
    assert len(names) == 16
    assert names == {n.split("_")[0] for n in CASES}
    assert all(issubclass(getattr(plr, n), plr.LRScheduler) for n in names)


@pytest.mark.parametrize("name", sorted(CASES))
def test_thirty_values_equal_jax(name):
    want = _run(CASES[name](jlr), 30)
    got = _run(CASES[name](plr), 30)
    assert got == want
    assert all(math.isfinite(v) for v in got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_round_trips(name):
    a, ja = CASES[name](plr), CASES[name](jlr)
    _run(a, 13)
    _run(ja, 13)
    assert a.state_dict() == ja.state_dict()
    b = CASES[name](plr)
    b.set_state_dict(a.state_dict())
    assert _run(b, 10, start=13) == _run(a, 10, start=13)


def test_scheduler_drives_the_optimizer_lr_and_its_state_dict():
    """An optimizer reads ``scheduler()`` at every step; ``set_lr`` raises
    under a scheduler; the optimizer's state_dict carries the scheduler's
    (``LR_Scheduler``) and loads it back."""
    import torch
    p = torch.nn.Parameter(torch.ones(3))
    sched = plr.StepDecay(0.5, step_size=2, gamma=0.1)
    opt = SGD(learning_rate=sched, parameters=[p])
    seen = []
    for _ in range(5):
        seen.append(opt.get_lr())
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    assert seen == [0.5, 0.5, 0.05, 0.05, 0.005000000000000001]
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)
    sd = opt.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 5
    fresh_sched = plr.StepDecay(0.5, step_size=2, gamma=0.1)
    fresh = AdamW(learning_rate=fresh_sched, parameters=[p])
    fresh.set_state_dict(sd)
    assert fresh_sched.last_epoch == 5 and fresh.get_lr() == sched()
    plain = SGD(learning_rate=0.25, parameters=[p])
    plain.set_lr(0.125)
    assert plain.get_lr() == 0.125 and "LR_Scheduler" not in \
        plain.state_dict()
