"""Recurrent layers: counterpart of ``paddle_tpu/nn/layer/rnn.py``.

``LSTM``, ``GRU`` and ``SimpleRNN`` hold ``weight_ih_l{k}[_reverse]``,
``weight_hh_...``, ``bias_ih_...``, ``bias_hh_...`` per layer and
direction (``[gates * hidden, in]`` weights, Uniform(-1/sqrt(hidden),
1/sqrt(hidden))), as the JAX layers do. The time loop is plain torch:
one input-projection GEMM over all steps, then a step's ``h @ w_hhᵀ``
and the gates, in the JAX cell's order of sums (LSTM gates i, f, g, o;
GRU r, z, n with ``b_hn`` inside ``r * (...)``). The reverse direction
runs over the flipped sequence and flips its outputs back; final states
stack as l0, l0_reverse, l1, ... into ``[layers * dirs, B, H]``.

As in the JAX forward (reference caveats, ROADMAP.md): ``initial_states``
is ignored (every sequence starts from zeros), and so is ``dropout``.
The whole stack is one op under the JAX op name (``lstm``, ``gru``,
``rnn_tanh``, ``rnn_relu``), so amp casts it as the JAX package does.
Every layer takes a keyword-only ``device`` (default: the card).
"""
from __future__ import annotations

import math

import torch

from ...core.tensor import Tensor, plain_views
from ...ops.dispatch import apply
from ..initializer import Uniform
from .layers import Layer

__all__ = ["LSTM", "GRU", "SimpleRNN", "LSTMCell", "GRUCell"]


def _lstm_gates(gates, c):
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c2), c2


def _gru_gates(gi, gh, h):
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def _run_direction(mode, seq, w_ih, w_hh, b_ih, b_hh, hidden):
    """One direction of one layer over ``seq`` ``[T, B, I]`` (plain
    tensors): the outputs ``[T, B, H]`` and the final (h, c)."""
    T, B = seq.shape[0], seq.shape[1]
    h = seq.new_zeros((B, hidden))
    c = torch.zeros_like(h) if mode == "LSTM" else None
    # the input projection of every step at once; the JAX cell adds
    # (x W_ih + h W_hh) + b_ih + b_hh for LSTM / RNN, x W_ih + b_ih for GRU
    gi_all = torch.matmul(seq, w_ih.t())
    if mode == "GRU":
        gi_all = gi_all + b_ih
    w_hh_t = w_hh.t()
    act = torch.tanh if mode == "RNN_TANH" else torch.relu
    ys = []
    for t in range(T):
        if mode == "LSTM":
            h, c = _lstm_gates(gi_all[t] + h @ w_hh_t + b_ih + b_hh, c)
        elif mode == "GRU":
            h = _gru_gates(gi_all[t], h @ w_hh_t + b_hh, h)
        else:
            h = act(gi_all[t] + h @ w_hh_t + b_ih + b_hh)
        ys.append(h)
    return torch.stack(ys, 0), h, c


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, device=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = 2 if direction in ("bidirect", "bidirectional") else 1
        gate_mult = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}[mode]
        self._weights = []
        std = 1.0 / math.sqrt(hidden_size)
        G = gate_mult * hidden_size
        for layer in range(num_layers):
            for d in range(self.bidirect):
                in_sz = input_size if layer == 0 \
                    else hidden_size * self.bidirect
                sfx = f"l{layer}" + ("_reverse" if d else "")
                names = (f"weight_ih_{sfx}", f"weight_hh_{sfx}",
                         f"bias_ih_{sfx}", f"bias_hh_{sfx}")
                for name, shape, attr, is_bias in (
                        (names[0], [G, in_sz], weight_ih_attr, False),
                        (names[1], [G, hidden_size], weight_hh_attr, False),
                        (names[2], [G], bias_ih_attr, True),
                        (names[3], [G], bias_hh_attr, True)):
                    self.add_parameter(name, self.create_parameter(
                        shape, attr=attr, is_bias=is_bias,
                        default_initializer=Uniform(-std, std),
                        device=device))
                self._weights.append(names)

    def forward(self, inputs, initial_states=None):
        n_state = 2 if self.mode == "LSTM" else 1
        weights = [getattr(self, n) for grp in self._weights for n in grp]

        def f(*ts):
            x, *ws = plain_views(ts)
            out = x if self.time_major else x.transpose(0, 1)  # [T, B, I]
            final_h, final_c = [], []
            wi = 0
            for _ in range(self.num_layers):
                dir_outs = []
                for d in range(self.bidirect):
                    seq = out if d == 0 else torch.flip(out, [0])
                    ys, h, c = _run_direction(self.mode, seq, *ws[wi:wi + 4],
                                              self.hidden_size)
                    wi += 4
                    dir_outs.append(ys if d == 0 else torch.flip(ys, [0]))
                    final_h.append(h)
                    if n_state == 2:
                        final_c.append(c)
                out = torch.cat(dir_outs, -1) if self.bidirect == 2 \
                    else dir_outs[0]
            ys_out = out if self.time_major else out.transpose(0, 1)
            res = [ys_out, torch.stack(final_h, 0)]
            if n_state == 2:
                res.append(torch.stack(final_c, 0))
            return tuple(r.as_subclass(Tensor) for r in res)

        out = apply(f, inputs, *weights, op_name=self.mode.lower())
        if n_state == 2:
            return out[0], (out[1], out[2])
        return out[0], out[1]


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, *, device=None, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, *, device=None, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, *, device=None, **kw):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device)


class _CellBase(Layer):
    """The four cell parameters, ``[gates * hidden, in]`` weights,
    Uniform(-1/sqrt(hidden), 1/sqrt(hidden))."""

    def __init__(self, input_size, hidden_size, gates, device):
        super().__init__()
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        G = gates * hidden_size

        def param(shape, is_bias=False):
            return self.create_parameter(
                shape, is_bias=is_bias,
                default_initializer=Uniform(-std, std), device=device)
        self.weight_ih = param([G, input_size])
        self.weight_hh = param([G, hidden_size])
        self.bias_ih = param([G], True)
        self.bias_hh = param([G], True)

    def _zeros(self, inputs):
        return torch.zeros((inputs.shape[0], self.hidden_size),
                           dtype=inputs.dtype, device=inputs.device)


class LSTMCell(_CellBase):
    def __init__(self, input_size, hidden_size, *, device=None, **kw):
        super().__init__(input_size, hidden_size, 4, device)

    def forward(self, inputs, states=None):
        def f(*ts):
            x, h, c, w_ih, w_hh, b_ih, b_hh = plain_views(ts)
            h2, c2 = _lstm_gates(x @ w_ih.t() + h @ w_hh.t() + b_ih + b_hh,
                                 c)
            return h2.as_subclass(Tensor), c2.as_subclass(Tensor)
        if states is None:
            states = (self._zeros(inputs), self._zeros(inputs))
        out = apply(f, inputs, states[0], states[1], self.weight_ih,
                    self.weight_hh, self.bias_ih, self.bias_hh,
                    op_name="lstm_cell")
        return out[0], (out[0], out[1])


class GRUCell(_CellBase):
    def __init__(self, input_size, hidden_size, *, device=None, **kw):
        super().__init__(input_size, hidden_size, 3, device)

    def forward(self, inputs, states=None):
        def f(*ts):
            x, h, w_ih, w_hh, b_ih, b_hh = plain_views(ts)
            return _gru_gates(x @ w_ih.t() + b_ih, h @ w_hh.t() + b_hh,
                              h).as_subclass(Tensor)
        if states is None:
            states = self._zeros(inputs)
        out = apply(f, inputs, states, self.weight_ih, self.weight_hh,
                    self.bias_ih, self.bias_hh, op_name="gru_cell")
        return out, out
