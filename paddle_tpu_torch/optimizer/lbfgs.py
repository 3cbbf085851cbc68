"""L-BFGS with an optional strong-Wolfe line search.

Counterpart of ``paddle_tpu/optimizer/lbfgs.py`` (:23-343), in plain
PyTorch: the two-loop recursion, the history and the parameter update run
over one flattened fp32 vector of every trainable parameter; the line
search's bracketing runs on the host, since each trial point is a closure
call (forward and backward). ``step(closure)``: the closure clears and
refills the grads (``loss.backward()``) and returns the loss.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Minimiser of the cubic through two (x, f, f') samples (Nocedal and
    Wright, eq. 3.59), clamped to bounds; the midpoint when the cubic has
    no real minimiser."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 ** 2 - g1 * g2
    if d2_square >= 0:
        d2 = d2_square ** 0.5
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


def _strong_wolfe(obj_func, x, t, d, f, g, gtd, c1=1e-4, c2=0.9,
                  tolerance_change=1e-9, max_ls=25):
    """Line search for a step meeting the strong Wolfe conditions.
    ``obj_func(x, t, d) -> (f, g)`` evaluates the loss and the flat grad at
    ``x + t d``. Returns (f_new, g_new, t, n_evals)."""
    d_norm = float(d.abs().max())
    g = g.clone()
    f_new, g_new = obj_func(x, t, d)
    ls_func_evals = 1
    gtd_new = _dot(g_new, d)

    # bracket phase
    t_prev, f_prev, g_prev, gtd_prev = 0.0, f, g, gtd
    done = False
    ls_iter = 0
    bracket = None
    while ls_iter < max_ls:
        if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev, g_new]
            bracket_gtd = [gtd_prev, gtd_new]
            break
        if abs(gtd_new) <= -c2 * gtd:
            bracket = [t, t]
            bracket_f = [f_new, f_new]
            bracket_g = [g_new, g_new]
            bracket_gtd = [gtd_new, gtd_new]
            done = True
            break
        if gtd_new >= 0:
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev, g_new]
            bracket_gtd = [gtd_prev, gtd_new]
            break
        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new, gtd_new,
                               bounds=(min_step, max_step))
        t_prev, f_prev, g_prev, gtd_prev = tmp, f_new, g_new, gtd_new
        f_new, g_new = obj_func(x, t, d)
        ls_func_evals += 1
        gtd_new = _dot(g_new, d)
        ls_iter += 1
    if bracket is None:  # max_ls reached while extrapolating
        bracket = [0.0, t]
        bracket_f = [f, f_new]
        bracket_g = [g, g_new]
        bracket_gtd = [gtd, gtd_new]

    # zoom phase
    insuf_progress = False
    low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[1] else (1, 0)
    while not done and ls_iter < max_ls:
        if abs(bracket[1] - bracket[0]) * d_norm < tolerance_change:
            break
        t = _cubic_interpolate(bracket[0], bracket_f[0], bracket_gtd[0],
                               bracket[1], bracket_f[1], bracket_gtd[1])
        eps = 0.1 * (max(bracket) - min(bracket))
        if min(max(bracket) - t, t - min(bracket)) < eps:
            if insuf_progress or t >= max(bracket) or t <= min(bracket):
                if abs(t - max(bracket)) < abs(t - min(bracket)):
                    t = max(bracket) - eps
                else:
                    t = min(bracket) + eps
                insuf_progress = False
            else:
                insuf_progress = True
        else:
            insuf_progress = False

        f_new, g_new = obj_func(x, t, d)
        ls_func_evals += 1
        gtd_new = _dot(g_new, d)
        ls_iter += 1
        if f_new > (f + c1 * t * gtd) or f_new >= bracket_f[low_pos]:
            bracket[high_pos] = t
            bracket_f[high_pos] = f_new
            bracket_g[high_pos] = g_new
            bracket_gtd[high_pos] = gtd_new
            low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[1] \
                else (1, 0)
        else:
            if abs(gtd_new) <= -c2 * gtd:
                done = True
            elif gtd_new * (bracket[high_pos] - bracket[low_pos]) >= 0:
                bracket[high_pos] = bracket[low_pos]
                bracket_f[high_pos] = bracket_f[low_pos]
                bracket_g[high_pos] = bracket_g[low_pos]
                bracket_gtd[high_pos] = bracket_gtd[low_pos]
            bracket[low_pos] = t
            bracket_f[low_pos] = f_new
            bracket_g[low_pos] = g_new
            bracket_gtd[low_pos] = gtd_new

    return (bracket_f[low_pos], bracket_g[low_pos], bracket[low_pos],
            ls_func_evals)


def _two_loop_direction(flat_grad, old_stps, old_dirs, ro, h_diag):
    """The L-BFGS two-loop recursion over the history rows s_i, y_i and
    ro_i = 1 / (y_i . s_i)."""
    num = len(old_stps)
    q = -flat_grad
    al = []
    for i in range(num - 1, -1, -1):
        a = torch.dot(old_stps[i], q) * ro[i]
        q = q - a * old_dirs[i]
        al.append(a)
    al.reverse()
    d = q * h_diag
    for i in range(num):
        be = torch.dot(old_dirs[i], d) * ro[i]
        d = d + old_stps[i] * (al[i] - be)
    return d


class LBFGS(Optimizer):
    """Limited-memory BFGS (lbfgs.py:171): ``step(closure)``, where the
    closure re-evaluates the loss, fills ``p.grad`` and returns the loss."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn: Optional[str] = None,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        if max_eval is None:
            max_eval = max_iter * 5 // 4
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("only 'strong_wolfe' is supported for "
                             f"line_search_fn, got {line_search_fn!r}")
        self.max_iter = max_iter
        self.max_eval = max_eval
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._hist = {"old_stps": deque(maxlen=history_size),
                      "old_dirs": deque(maxlen=history_size),
                      "ro": deque(maxlen=history_size),
                      "h_diag": 1.0, "prev_flat_grad": None, "d": None,
                      "t": None, "n_iter": 0, "func_evals": 0}

    # ---- flat-vector plumbing ----
    def _trainable(self):
        return [p for p in self._params if p.requires_grad]

    def _flat_grad(self):
        parts = []
        for p in self._trainable():
            if p.grad is None:
                parts.append(torch.zeros(p.numel() or 1, dtype=torch.float32,
                                         device=p.device))
            else:
                parts.append(p.grad.reshape(-1).float())
        if self._weight_decay:
            wd = float(self._weight_decay)
            parts = [g + wd * p.detach().reshape(-1).float()
                     for g, p in zip(parts, self._trainable())]
        return torch.cat(parts)

    def _flat_params(self):
        return torch.cat([p.detach().reshape(-1).float()
                          for p in self._trainable()])

    def _set_flat_params(self, flat):
        off = 0
        with torch.no_grad():
            for p in self._trainable():
                n = p.numel() or 1
                p.copy_(flat[off:off + n].reshape(p.shape))
                off += n

    def _add_grad(self, step_size, direction):
        self._set_flat_params(self._flat_params() + step_size * direction)

    # ---- step ----
    def step(self, closure: Callable[[], torch.Tensor]):
        loss = closure()
        orig_loss = loss
        f = float(loss.detach())
        current_evals = 1
        h = self._hist
        h["func_evals"] += 1

        flat_grad = self._flat_grad()
        if float(flat_grad.abs().max()) <= self.tolerance_grad:
            return orig_loss

        lr = self.get_lr()
        n_local = 0
        while n_local < self.max_iter:
            n_local += 1
            h["n_iter"] += 1

            # direction
            if h["n_iter"] == 1:
                d = -flat_grad
                h["h_diag"] = 1.0
            else:
                y = flat_grad - h["prev_flat_grad"]
                s = h["d"] * h["t"]
                ys = _dot(y, s)
                if ys > 1e-10:
                    h["old_dirs"].append(y)
                    h["old_stps"].append(s)
                    h["ro"].append(1.0 / ys)
                    h["h_diag"] = ys / _dot(y, y)
                if h["old_stps"]:
                    d = _two_loop_direction(
                        flat_grad, list(h["old_stps"]), list(h["old_dirs"]),
                        torch.tensor(list(h["ro"]), dtype=torch.float32,
                                     device=flat_grad.device),
                        torch.tensor(h["h_diag"], dtype=torch.float32,
                                     device=flat_grad.device))
                else:
                    d = -flat_grad * h["h_diag"]
            h["prev_flat_grad"] = flat_grad

            # step length
            if h["n_iter"] == 1:
                t = min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr
            else:
                t = lr
            gtd = _dot(flat_grad, d)
            if gtd > -self.tolerance_change:
                break

            if self.line_search_fn == "strong_wolfe":
                x_init = self._flat_params()

                def obj_func(x, t_, d_):
                    self._set_flat_params(x + t_ * d_)
                    self.clear_grad()
                    return float(closure().detach()), self._flat_grad()

                f, flat_grad, t, ls_evals = _strong_wolfe(
                    obj_func, x_init, t, d, f, flat_grad, gtd,
                    tolerance_change=self.tolerance_change)
                self._set_flat_params(x_init + t * d)
                current_evals += ls_evals
                h["func_evals"] += ls_evals
            else:
                self._add_grad(t, d)
                if n_local != self.max_iter:
                    self.clear_grad()
                    f = float(closure().detach())
                    flat_grad = self._flat_grad()
                    current_evals += 1
                    h["func_evals"] += 1
            h["d"], h["t"] = d, t

            # convergence
            if current_evals >= self.max_eval:
                break
            if float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
            if float((d * t).abs().max()) <= self.tolerance_change:
                break
        return orig_loss

    def state_dict(self):
        h = self._hist
        sd = {"n_iter": h["n_iter"], "func_evals": h["func_evals"],
              "h_diag": h["h_diag"], "t": h["t"],
              "history_size": self.history_size}
        for k in ("old_stps", "old_dirs", "ro"):
            sd[k] = [v.clone() if isinstance(v, torch.Tensor) else v
                     for v in h[k]]
        for k in ("prev_flat_grad", "d"):
            sd[k] = None if h[k] is None else h[k].clone()
        return sd

    def set_state_dict(self, state_dict):
        h = self._hist
        for k in ("n_iter", "func_evals", "h_diag", "t"):
            if k in state_dict:
                h[k] = state_dict[k]
        for k in ("old_stps", "old_dirs"):
            if k in state_dict:
                h[k] = deque((torch.as_tensor(v) for v in state_dict[k]),
                             maxlen=self.history_size)
        if "ro" in state_dict:
            h["ro"] = deque((float(v) for v in state_dict["ro"]),
                            maxlen=self.history_size)
        for k in ("prev_flat_grad", "d"):
            if state_dict.get(k) is not None:
                h[k] = torch.as_tensor(state_dict[k])
