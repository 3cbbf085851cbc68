"""Training-step parity of a port model against the JAX model, with the
JAX side traced.

``JaxStep(model, loss_fn)`` runs the JAX model's forward and backward on
its eager tape inside one ``jax.jit`` (one XLA compile for the whole
step, where the eager tape compiles op by op): the traced function takes
the parameters' and buffers' values as arguments, puts them into the
model for the trace, and puts the model's own values back after, so no
tracer stays behind. It returns the loss, every parameter's grad and
the buffers after the step (BatchNorm's running statistics).

``train_both(jmodel, pmodel, loss_fn, inputs, make_opt, steps, ...)``
takes ``steps`` optimizer steps on the port model; before each, the JAX
step runs at the port model's parameters and buffers, and the losses,
grads and updated buffers are compared. The update itself is the port
optimizer's (the optimizers are held against the JAX ones in
``tests/test_torch_optimizers.py``). Imports JAX: for CPU tests only.
"""
import jax
import numpy as np

import paddle_tpu as J


class JaxStep:
    def __init__(self, model, loss_fn):
        self.model = model
        self.params = [p for _, p in model.named_parameters()]
        self.buffers = [b for _, b in model.named_buffers()]

        def step(pvals, bvals, inputs):
            saved = ([p._value for p in self.params],
                     [b._value for b in self.buffers])
            try:
                for p, v in zip(self.params, pvals):
                    p._set_value(v)
                    p.grad = None
                for b, v in zip(self.buffers, bvals):
                    b._set_value(v)
                loss = loss_fn(J, model, [J.to_tensor(v) for v in inputs])
                loss.backward()
                return (loss._value, [p.grad._value for p in self.params],
                        [b._value for b in self.buffers])
            finally:
                for p, v in zip(self.params, saved[0]):
                    p._set_value(v)
                    p.grad = None
                for b, v in zip(self.buffers, saved[1]):
                    b._set_value(v)
        self._step = jax.jit(step)

    def __call__(self, pvals, bvals, inputs):
        out = self._step(pvals, bvals, inputs)
        return jax.tree_util.tree_map(np.asarray, out)


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def train_both(jmodel, pmodel, loss_fn, inputs, make_opt, steps,
               tol=(1e-5, 1e-6), later_tol=None):
    """The port model's losses over ``steps`` optimizer steps, each step's
    loss, grads and buffers held against the traced JAX step at the same
    parameters (``later_tol`` for the steps after the first, where a
    reason calls for it)."""
    import paddle_tpu_torch as P
    names = [n for n, _ in pmodel.named_parameters()]
    assert names == [n for n, _ in jmodel.named_parameters()]
    bnames = [n for n, _ in pmodel.named_buffers()]
    assert bnames == [n for n, _ in jmodel.named_buffers()]
    jstep = JaxStep(jmodel, loss_fn)
    opt = make_opt(P, pmodel)
    losses = []
    for step in range(steps):
        rtol, atol = tol if step == 0 or later_tol is None else later_tol
        pvals = [_np(p) for p in pmodel.parameters()]
        bvals = [_np(b) for b in pmodel.buffers()]
        jl, jg, jb = jstep(pvals, bvals, inputs)
        loss = loss_fn(P, pmodel, [P.to_tensor(a.copy()) for a in inputs])
        loss.backward()
        losses.append(float(loss.detach()))
        np.testing.assert_allclose(losses[-1], float(jl), rtol=rtol,
                                   err_msg=f"loss, step {step}")
        for n, p, g in zip(names, pmodel.parameters(), jg):
            np.testing.assert_allclose(_np(p.grad), g, rtol, atol,
                                       err_msg=f"grad {n}, step {step}")
        for n, b, want in zip(bnames, pmodel.buffers(), jb):
            np.testing.assert_allclose(_np(b), want, rtol, atol,
                                       err_msg=f"buffer {n}, step {step}")
        opt.step()
        opt.clear_grad()
    return losses
