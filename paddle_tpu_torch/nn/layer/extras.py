"""The rest of the ``nn`` layers: counterpart of
``paddle_tpu/nn/layer/extras.py``.

Thin layers over ``nn/functional/extras.py`` (distances, ``Softmax2D``,
``Unflatten``, ``MaxUnPool*``, the losses; ``HSigmoidLoss`` owns its
``[num_classes - 1, feature_size]`` node table), the generic cell family
(``RNNCellBase.get_initial_states``, ``SimpleRNNCell``, and ``RNN`` /
``BiRNN``, which run any cell over a sequence in a Python time loop, as
the JAX layers do), and beam search: ``BeamSearchDecoder`` (top-``W``
over ``W x V`` candidates a step, ties to the lower index as
``lax.top_k``; finished beams extend only with ``end_token`` at no cost)
and ``dynamic_decode`` (steps until every beam finished or
``max_step_num``, backtraced by ``gather_tree``; lengths up to the first
``end_token`` of each backtraced beam). Layers with parameters take a
keyword-only ``device`` (default: the card).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.tensor import Tensor
from ...ops import creation
from ...ops.manip import concat, stack, unflatten
from .. import functional as F
from ..initializer import Uniform
from .layers import Layer

__all__ = ["PairwiseDistance", "Softmax2D", "Unflatten", "MaxUnPool1D",
           "MaxUnPool2D", "MaxUnPool3D", "PoissonNLLLoss", "SoftMarginLoss",
           "MultiLabelSoftMarginLoss", "MultiMarginLoss",
           "TripletMarginWithDistanceLoss", "GaussianNLLLoss",
           "HSigmoidLoss", "RNNTLoss", "RNNCellBase", "SimpleRNNCell", "RNN",
           "BiRNN", "BeamSearchDecoder", "dynamic_decode"]


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Softmax2D(Layer):
    """Softmax over the channels of a CHW or NCHW input."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(
                f"Softmax2D expects 3-D/4-D input, got {x.ndim}-D")
        return F.softmax(x, axis=-3)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        return unflatten(x, self.axis, self.shape)


class _MaxUnPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self._a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return getattr(F, self._fn)(x, indices, *self._a)


class MaxUnPool1D(_MaxUnPool):
    _fn = "max_unpool1d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool2D(_MaxUnPool):
    _fn = "max_unpool2d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool3D(_MaxUnPool):
    _fn = "max_unpool3d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


# ---------------- losses ----------------

class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._a = (log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self._a)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self._a = (p, margin, weight, reduction)

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, *self._a)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._a = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(input, positive, negative,
                                                   *self._a)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self._a = (full, epsilon, reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, *self._a)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid head: owns the internal nodes' weight and
    bias rows."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr, device=device)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes - 1], attr=bias_attr, is_bias=True, device=device)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self._a = (blank, fastemit_lambda, reduction)

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           *self._a)


# ---------------- the generic cell family ----------------

class RNNCellBase(Layer):
    """A cell's base: ``get_initial_states`` fills ``[batch, *shape]``
    (or a tuple of them) with ``init_value`` on ``batch_ref``'s device."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        state_shape = shape or getattr(self, "state_shape", None)
        dtype = dtype or "float32"

        def mk(s):
            return creation.full([batch] + [int(d) for d in s], init_value,
                                 dtype, place=batch_ref.device)
        if isinstance(state_shape, (list, tuple)) and state_shape \
                and isinstance(state_shape[0], (list, tuple)):
            return tuple(mk(s) for s in state_shape)
        return mk(state_shape or [self.hidden_size])


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.activation = activation
        std = 1.0 / math.sqrt(hidden_size)

        def param(shape, attr, is_bias=False):
            return self.create_parameter(
                shape, attr=attr, is_bias=is_bias,
                default_initializer=Uniform(-std, std), device=device)
        self.weight_ih = param([hidden_size, input_size], weight_ih_attr)
        self.weight_hh = param([hidden_size, hidden_size], weight_hh_attr)
        self.bias_ih = param([hidden_size], bias_ih_attr, True)
        self.bias_hh = param([hidden_size], bias_hh_attr, True)

    @property
    def state_shape(self):
        return [self.hidden_size]

    def forward(self, inputs, states=None):
        from ...ops import math as om
        if states is None:
            states = self.get_initial_states(inputs)
        h = states[0] if isinstance(states, (tuple, list)) else states
        z = inputs @ self.weight_ih.t() + self.bias_ih \
            + h @ self.weight_hh.t() + self.bias_hh
        out = om.tanh(z) if self.activation == "tanh" else F.relu(z)
        return out, out


class RNN(Layer):
    """Run ``cell`` over a sequence, step by step (the cell is any user
    layer, so the loop is Python, as in the JAX layer)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        axis = 0 if self.time_major else 1
        steps = inputs.shape[axis]
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        states = initial_states
        outs = []
        for i in order:
            x_t = inputs[i] if self.time_major else inputs[:, i]
            out, states = self.cell(x_t, states)
            outs.append(out)
        if self.is_reverse:
            outs.reverse()
        return stack(outs, axis=axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        o_fw, st_fw = self.rnn_fw(inputs, s_fw)
        o_bw, st_bw = self.rnn_bw(inputs, s_bw)
        return concat([o_fw, o_bw], axis=-1), (st_fw, st_bw)


# ---------------- beam search ----------------

def _plain(t):
    return t.detach().as_subclass(torch.Tensor)


class BeamSearchDecoder:
    """Beam search over an RNN cell: ``embedding_fn`` maps token ids to the
    cell's inputs, ``output_fn`` the cell's outputs to vocabulary
    logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn or (lambda ids: ids)
        self.output_fn = output_fn or (lambda x: x)

    def initialize(self, initial_cell_states):
        st = initial_cell_states
        ref = st[0] if isinstance(st, (tuple, list)) else st
        batch, dev = ref.shape[0], ref.device
        ids = creation.full([batch, self.beam_size], self.start_token,
                            "int64", place=dev)
        log_probs = Tensor(torch.from_numpy(np.tile(np.array(
            [[0.0] + [-1e9] * (self.beam_size - 1)], "f"), (batch, 1))),
            place=dev)
        finished = creation.zeros([batch, self.beam_size], "bool",
                                  place=dev)
        return ids, (st, log_probs, finished)

    def step(self, time, inputs, states):
        cell_states, log_probs, finished = states
        batch, W = inputs.shape[0], self.beam_size
        # the cell runs on the flattened (B * W) beams
        flat_in = self.embedding_fn(Tensor(_plain(inputs).reshape(-1)))
        out, new_flat_states = self.cell(flat_in, cell_states)
        lv = _plain(self.output_fn(out))
        V = lv.shape[-1]
        e = torch.exp(lv - lv.max(-1, keepdim=True).values)
        logp = torch.log(torch.clamp_min(e / e.sum(-1, keepdim=True),
                                         1e-30)).reshape(batch, W, V)
        # finished beams extend only with end_token, at zero cost
        mask = torch.full((V,), -1e9, device=lv.device)
        mask[self.end_token] = 0.0
        fin = _plain(finished)
        step_lp = torch.where(fin[..., None], mask[None, None, :], logp)
        total = (_plain(log_probs)[..., None] + step_lp).reshape(batch,
                                                                 W * V)
        # top-W, ties to the lower index (lax.top_k's order)
        order = torch.sort(total, dim=-1, descending=True, stable=True)
        top_lp, top_idx = order.values[:, :W], order.indices[:, :W]
        beam_idx = torch.div(top_idx, V, rounding_mode="floor")
        token_idx = top_idx % V
        new_finished = torch.gather(fin, 1, beam_idx) | (token_idx
                                                        == self.end_token)
        flat_parent = (torch.arange(batch, device=lv.device)[:, None] * W
                       + beam_idx).reshape(-1)

        def reorder(s):
            return Tensor(torch.index_select(_plain(s), 0, flat_parent))
        if isinstance(new_flat_states, (tuple, list)):
            new_states = type(new_flat_states)(
                reorder(s) for s in new_flat_states)
        else:
            new_states = reorder(new_flat_states)
        return (Tensor(token_idx), Tensor(beam_idx),
                (new_states, Tensor(top_lp), Tensor(new_finished)))


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Decode until every beam finished or ``max_step_num`` steps (64 when
    not given), then backtrace the beams with ``gather_tree``."""
    ids, states = decoder.initialize(inits)
    cell_states, log_probs, finished = states
    batch, W = ids.shape

    def tile(s):
        return Tensor(torch.repeat_interleave(_plain(s), W, dim=0))
    if isinstance(cell_states, (tuple, list)):
        cell_states = type(cell_states)(tile(s) for s in cell_states)
    else:
        cell_states = tile(cell_states)
    states = (cell_states, log_probs, finished)

    step_ids, step_parents = [], []
    inputs = ids
    for t in range(max_step_num or 64):
        tokens, parents, states = decoder.step(t, inputs, states)
        step_ids.append(_plain(tokens))
        step_parents.append(_plain(parents))
        inputs = tokens
        if bool(torch.all(_plain(states[2]))):
            break
    full = F.gather_tree(Tensor(torch.stack(step_ids)),
                         Tensor(torch.stack(step_parents)))
    # lengths of the backtraced beams: to the first end_token, inclusive
    full_tm = _plain(full)                            # (T, B, W)
    is_end = full_tm == decoder.end_token
    first_end = torch.argmax(is_end.to(torch.int64), 0)
    lengths = Tensor(torch.where(is_end.any(0), first_end + 1,
                                 full_tm.shape[0]).to(torch.int64))
    if not output_time_major:
        full = Tensor(full_tm.permute(1, 2, 0))       # (B, W, T)
    if return_length:
        return full, states[1], lengths
    return full, states[1]
