"""The rest of ``nn.functional``: counterpart of
``paddle_tpu/nn/functional/extras.py``.

Distances, the in-place activations (``elu_`` ... ``thresholded_relu_``,
written into the tensor as ``ops/breadth.py``'s in-place family writes),
``gumbel_softmax`` (its noise drawn from the input device's default
generator: the JAX key stream cannot be matched, the distribution and
the straight-through ``hard`` form are its), ``diag_embed``,
``sequence_mask``, ``one_hot`` (out-of-range ids give a zero row, as
``jax.nn.one_hot``), ``max_unpool{1,2,3}d`` over the masks of
``max_pool*d(return_mask=True)`` (an index outside the plane is dropped,
as JAX's scatter drops it), the losses (``hsigmoid_loss`` over the
default complete binary tree or a custom one, ``rnnt_loss`` by the exact
forward DP with FastEmit's gradient scale), ``affine_grid`` /
``grid_sample``, ``temporal_shift``, ``gather_tree`` and
``sparse_attention`` (CSR pattern, computed dense with a mask;
``key_padding_mask`` and ``attn_mask`` are accepted and ignored, as in
the JAX function). Each runs through ``dispatch.apply`` under the JAX op
name; the time loops of ``rnnt_loss`` and ``gather_tree`` are Python
loops of torch ops where the JAX functions scan.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core import dtype as dtypes
from ...core.generator import default_generator
from ...core.tensor import Tensor, plain_views
from ...ops.breadth import _make_inplace
from ...ops.dispatch import apply
from . import activation as act

__all__ = [
    "pairwise_distance", "elu_", "hardtanh_", "leaky_relu_", "softmax_",
    "tanh_", "thresholded_relu_", "gumbel_softmax", "diag_embed",
    "sequence_mask", "one_hot", "max_unpool1d", "max_unpool2d",
    "max_unpool3d", "dice_loss", "poisson_nll_loss", "npair_loss",
    "soft_margin_loss", "multi_label_soft_margin_loss", "multi_margin_loss",
    "triplet_margin_with_distance_loss", "gaussian_nll_loss",
    "hsigmoid_loss", "margin_cross_entropy", "rnnt_loss", "affine_grid",
    "grid_sample", "gather_tree", "temporal_shift", "sparse_attention",
]


def _reduce(v, reduction):
    if reduction == "mean":
        return torch.mean(v)
    if reduction == "sum":
        return torch.sum(v)
    return v


# ---------------- distance ----------------

def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    def f(a, b):
        d = torch.add(torch.sub(a, b), epsilon)
        return torch.pow(torch.sum(torch.pow(torch.abs(d), p), dim=-1,
                                   keepdim=keepdim), 1.0 / p)
    return apply(f, x, y, op_name="pairwise_distance")


# ---------------- in-place activations ----------------

_elu_ = _make_inplace(act.elu, "elu_")
_hardtanh_ = _make_inplace(act.hardtanh, "hardtanh_")
_leaky_relu_ = _make_inplace(act.leaky_relu, "leaky_relu_")
_softmax_ = _make_inplace(act.softmax, "softmax_")
_tanh_ = _make_inplace(act.tanh, "tanh_")
_thresholded_relu_ = _make_inplace(act.thresholded_relu,
                                   "thresholded_relu_")


def elu_(x, alpha=1.0, name=None):
    return _elu_(x, alpha)


def hardtanh_(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return _hardtanh_(x, min, max)


def leaky_relu_(x, negative_slope=0.01, name=None):
    return _leaky_relu_(x, negative_slope)


def softmax_(x, axis=-1, dtype=None, name=None):
    return _softmax_(x, axis)


def tanh_(x, name=None):
    return _tanh_(x)


def thresholded_relu_(x, threshold=1.0, name=None):
    return _thresholded_relu_(x, threshold)


# ---------------- sampling / shaping ----------------

def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g`` drawn
    from the device's default generator; ``hard`` returns the one-hot
    argmax forward with the soft gradient (straight-through)."""
    gen = default_generator(x.device).generator

    def f(logits):
        u = torch.rand(logits.shape, generator=gen, device=logits.device,
                       dtype=torch.float32).clamp_min(1e-20)
        g = torch.neg(torch.log(torch.neg(torch.log(u))))
        y = torch.softmax(torch.div(torch.add(logits, g.to(logits.dtype)),
                                    temperature), dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
            y = torch.add(torch.sub(y_hard, y).detach(), y)
        return y
    return apply(f, x, op_name="gumbel_softmax")


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    from ...ops import breadth
    return breadth.diag_embed(input, offset, dim1, dim2)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    dt = dtypes.convert_dtype(dtype)

    def f(lengths):
        m = int(torch.max(lengths)) if maxlen is None else int(maxlen)
        ar = torch.arange(m, dtype=lengths.dtype, device=lengths.device)
        return torch.lt(ar, lengths[..., None]).to(dt)
    return apply(f, x, op_name="sequence_mask")


def _one_hot(v, num_classes, dtype=torch.float32):
    classes = torch.arange(num_classes, device=v.device)
    return torch.eq(v[..., None].to(torch.int64), classes).to(dtype)


def one_hot(x, num_classes, name=None):
    return apply(lambda v: _one_hot(v, num_classes), x, op_name="one_hot")


# ---------------- max unpool ----------------

def _max_unpool(x, indices, kernel_size, stride, padding, output_size,
                spatial, data_format, op_name):
    """Scatter pooled values back to their pre-pool positions: ``indices``
    are the flat within-plane positions ``max_poolNd(return_mask=True)``
    records."""
    if isinstance(kernel_size, int):
        kernel_size = [kernel_size] * spatial
    if stride is None:
        stride = kernel_size
    if isinstance(stride, int):
        stride = [stride] * spatial
    if isinstance(padding, int):
        padding = [padding] * spatial

    def f(v, idx):
        v, idx = plain_views((v, idx))
        lead = v.shape[:-spatial]
        pooled_sp = v.shape[-spatial:]
        if output_size is not None:
            out_sp = tuple(int(s) for s in output_size[-spatial:])
        else:
            out_sp = tuple((pooled_sp[i] - 1) * stride[i] - 2 * padding[i]
                           + kernel_size[i] for i in range(spatial))
        plane = int(np.prod(out_sp))
        nplanes = int(np.prod(lead))
        vf = v.reshape(nplanes, -1)
        idxf = idx.reshape(nplanes, -1).to(torch.int64)
        # an index outside the plane lands in a spare last column, dropped
        idxf = torch.where((idxf >= 0) & (idxf < plane), idxf, plane)
        out = torch.zeros((nplanes, plane + 1), dtype=v.dtype,
                          device=v.device).scatter(1, idxf, vf)
        return out[:, :plane].reshape(*lead, *out_sp).as_subclass(Tensor)
    return apply(f, x, indices, op_name=op_name)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, output_size,
                       1, data_format, "max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, output_size,
                       2, data_format, "max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, output_size,
                       3, data_format, "max_unpool3d")


# ---------------- losses ----------------

def dice_loss(input, label, epsilon=1e-5, name=None):
    def f(pred, lab):
        lab_oh = _one_hot(torch.squeeze(lab, -1), pred.shape[-1], pred.dtype)
        red = tuple(range(1, pred.dim()))
        inter = torch.sum(torch.mul(pred, lab_oh), dim=red)
        union = torch.add(torch.sum(pred, dim=red), torch.sum(lab_oh,
                                                              dim=red))
        return torch.mean(torch.rsub(torch.div(
            torch.add(torch.mul(inter, 2.0), epsilon),
            torch.add(union, epsilon)), 1.0))
    return apply(f, input, label, op_name="dice_loss")


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    def f(pred, lab):
        if log_input:
            loss = torch.sub(torch.exp(pred), torch.mul(lab, pred))
        else:
            loss = torch.sub(pred, torch.mul(lab, torch.log(
                torch.add(pred, epsilon))))
        if full:
            stirling = torch.add(torch.sub(torch.mul(lab, torch.log(lab)),
                                           lab),
                                 torch.mul(torch.log(torch.mul(
                                     lab, 2 * math.pi)), 0.5))
            loss = torch.add(loss, torch.where(torch.gt(lab, 1), stirling,
                                               0.0))
        return _reduce(loss, reduction)
    return apply(f, input, label, op_name="poisson_nll_loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """N-pair loss: cross entropy over ``anchor @ positiveᵀ`` against the
    same-label rows, plus ``l2_reg`` on the embeddings."""
    def f(anc, pos, lab):
        reg = torch.add(torch.mean(torch.sum(torch.square(anc), -1)),
                        torch.mean(torch.sum(torch.square(pos), -1)))
        sim = torch.matmul(anc, pos.t())
        tgt = torch.eq(lab[:, None], lab[None, :]).to(sim.dtype)
        tgt = torch.div(tgt, torch.sum(tgt, -1, keepdim=True))
        ce = torch.mean(torch.sum(torch.mul(torch.neg(tgt), torch.log_softmax(
            sim, -1)), -1))
        return torch.add(ce, torch.mul(reg, l2_reg * 0.25))
    return apply(f, anchor, positive, labels, op_name="npair_loss")


def soft_margin_loss(input, label, reduction="mean", name=None):
    def f(pred, lab):
        return _reduce(torch.log1p(torch.exp(torch.mul(
            torch.neg(lab.to(pred.dtype)), pred))), reduction)
    return apply(f, input, label, op_name="soft_margin_loss")


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    args = (input, label) + ((weight,) if weight is not None else ())

    def f(pred, lab, *w):
        lab = lab.to(pred.dtype)
        loss = torch.neg(torch.add(
            torch.mul(lab, TF.logsigmoid(pred)),
            torch.mul(torch.rsub(lab, 1.0), TF.logsigmoid(torch.neg(pred)))))
        if w:
            loss = torch.mul(loss, w[0])
        return _reduce(torch.mean(loss, -1), reduction)
    return apply(f, *args, op_name="multi_label_soft_margin_loss")


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    args = (input, label) + ((weight,) if weight is not None else ())

    def f(pred, lab, *w):
        c = pred.shape[1]
        tgt = torch.gather(pred, 1, lab[:, None])
        m = torch.pow(torch.clamp_min(torch.add(torch.rsub(tgt, margin),
                                                pred), 0.0), p)
        if w:
            m = torch.mul(m, w[0][lab][:, None])
        mask = torch.rsub(_one_hot(lab, c, pred.dtype), 1.0)
        return _reduce(torch.div(torch.sum(torch.mul(m, mask), -1), c),
                       reduction)
    return apply(f, *args, op_name="multi_margin_loss")


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or (lambda a, b: pairwise_distance(a, b))
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        from ...ops import math as om
        d_neg = om.minimum(d_neg, dist(positive, negative))

    def f(dp, dn):
        return _reduce(torch.clamp_min(torch.add(torch.sub(dp, dn), margin),
                                       0.0), reduction)
    return apply(f, d_pos, d_neg, op_name="triplet_margin_with_distance_loss")


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def f(pred, lab, var):
        var = torch.clamp_min(var, epsilon)
        loss = torch.mul(torch.add(torch.log(var), torch.div(
            torch.square(torch.sub(pred, lab)), var)), 0.5)
        if full:
            loss = torch.add(loss, 0.5 * math.log(2 * math.pi))
        return _reduce(loss, reduction)
    return apply(f, input, label, variance, op_name="gaussian_nll_loss")


def _hsigmoid_paths(num_classes):
    """The default tree's paths: a complete binary tree whose leaves are
    the heap nodes ``[num_classes, 2 num_classes)``; internal node ``i``
    is row ``i - 1`` of the weight. Returns (path_table, path_code,
    lengths), padded to the deepest path."""
    depth = max(1, math.ceil(math.log2(max(num_classes, 2))) + 1)
    table = np.zeros((num_classes, depth), np.int64)
    code = np.zeros((num_classes, depth), np.int64)
    length = np.zeros((num_classes,), np.int64)
    for leaf in range(num_classes):
        n = leaf + num_classes
        path, bits = [], []
        while n > 1:
            bits.append(n & 1)
            n >>= 1
            path.append(n - 1)
        path.reverse()
        bits.reverse()
        length[leaf] = len(path)
        table[leaf, :len(path)] = path
        code[leaf, :len(bits)] = bits
    return table, code, length


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss: one sigmoid per edge of the label's path
    (the default complete binary tree, or ``path_table`` / ``path_code``
    with ``-1`` padding); ``[N]`` losses."""
    lengths = None
    if path_table is None or path_code is None:
        table_np, code_np, lengths = _hsigmoid_paths(num_classes)
        path_table = torch.from_numpy(table_np).to(input.device)
        path_code = torch.from_numpy(code_np).to(input.device)
        lengths = torch.from_numpy(lengths).to(input.device)
    args = (input, label, weight, path_table, path_code) + (
        (bias,) if bias is not None else ())

    def f(x, lab, w, table, codes, *b):
        lab = lab.to(torch.int64)
        t = table[lab]
        c = codes[lab]
        if lengths is not None:
            valid = torch.lt(torch.arange(t.shape[1], device=t.device)[None],
                             lengths[lab][:, None])
        else:
            valid = torch.ge(t, 0)
            t = torch.clamp_min(t, 0)
        z = torch.einsum("nf,nkf->nk", x, w[t])
        if b:
            z = torch.add(z, b[0][t])
        sign = torch.rsub(torch.mul(c.to(z.dtype), 2.0), 1.0)
        ll = TF.logsigmoid(torch.mul(sign, z))
        return torch.neg(torch.sum(torch.where(valid, ll, 0.0), dim=-1))
    return apply(f, *args, op_name="hsigmoid_loss")


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """Combined-margin softmax: ``cos(m1 θ + m2) - m3`` on the target
    logit, then the scaled cross entropy."""
    def f(lg, lab):
        cos = torch.clamp(lg, -1.0, 1.0)
        theta = torch.arccos(torch.gather(cos, 1, lab[:, None]))
        target = torch.sub(torch.cos(torch.add(torch.mul(theta, margin1),
                                               margin2)), margin3)
        out = torch.mul(cos.scatter(1, lab[:, None], target.to(cos.dtype)),
                        scale)
        logp = torch.log_softmax(out, -1)
        loss = _reduce(torch.neg(torch.gather(logp, 1, lab[:, None])[:, 0]),
                       reduction)
        return (loss, torch.exp(logp)) if return_softmax else loss
    return apply(f, logits, label, op_name="margin_cross_entropy")


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-transducer loss by the exact forward DP over ``(T, U + 1)``;
    FastEmit scales the emit arcs' gradient by ``1 + λ`` and leaves the
    loss as it is."""
    def f(acts, labels, t_lens, u_lens):
        acts, labels, t_lens, u_lens = plain_views(
            (acts, labels, t_lens, u_lens))
        if acts.dim() == 3:             # one sample
            acts, labels = acts[None], labels[None]
            t_lens, u_lens = t_lens[None], u_lens[None]
        logp = torch.log_softmax(acts, -1)            # (B, T, U1, V)
        B, T, U1, V = logp.shape
        neg_inf = torch.full((), -1e30, dtype=logp.dtype, device=logp.device)
        zero = torch.zeros((), dtype=logp.dtype, device=logp.device)
        blank_lp = logp[..., blank]                   # (B, T, U1)
        lab_idx = torch.clamp_max(labels.to(torch.int64), V - 1)
        emit_lp = torch.gather(
            logp[:, :, :-1, :], -1,
            lab_idx[:, None, :, None].expand(B, T, U1 - 1, 1))[..., 0]
        emit_lp = TF.pad(emit_lp, (0, 1))             # (B, T, U1)
        if fastemit_lambda:
            emit_lp = torch.add(emit_lp, torch.mul(torch.sub(
                emit_lp, emit_lp.detach()), fastemit_lambda))
        rows = []
        prev_row = neg_inf.expand(B, U1)
        for t in range(T):
            if t > 0:
                from_blank = torch.add(prev_row, blank_lp[:, t - 1, :])
            else:
                from_blank = torch.cat([zero.expand(B, 1),
                                        neg_inf.expand(B, U1 - 1)], 1)
            cols = []
            prev = neg_inf.expand(B)
            for u in range(U1):
                horiz = torch.add(prev, emit_lp[:, t, u - 1]) if u > 0 \
                    else neg_inf.expand(B)
                cur = zero.expand(B) if t == 0 and u == 0 else \
                    torch.logaddexp(from_blank[:, u], horiz)
                cols.append(cur)
                prev = cur
            prev_row = torch.stack(cols, 1)
            rows.append(prev_row)
        alphas = torch.stack(rows, 1)                 # (B, T, U1)
        bi = torch.arange(B, device=logp.device)
        tl = torch.clamp_min(t_lens.to(torch.int64) - 1, 0)
        ul = u_lens.to(torch.int64)
        ll = torch.add(alphas[bi, tl, ul], blank_lp[bi, tl, ul])
        return _reduce(torch.neg(ll), reduction).as_subclass(Tensor)
    return apply(f, input, label, input_lengths, label_lengths,
                 op_name="rnnt_loss")


# ---------------- vision ----------------

def affine_grid(theta, out_shape, align_corners=True, name=None):
    """2-D affine sampling grid ``[N, H, W, 2]`` for an NCHW
    ``out_shape``."""
    def f(th):
        _, _, h, w = [int(s) for s in out_shape]
        dev = th.device
        if align_corners:
            ys = torch.linspace(-1.0, 1.0, h, device=dev)
            xs = torch.linspace(-1.0, 1.0, w, device=dev)
        else:
            ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
            xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
        return torch.einsum("hwk,nck->nhwc", base.to(th.dtype), th)
    return apply(f, theta, op_name="affine_grid")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Bilinear or nearest sampling of NCHW ``x`` at the normalised
    ``grid`` ``[N, H, W, 2]`` locations; ``zeros`` padding zeroes the
    taps outside, else they clamp to the border."""
    def f(img, g):
        img, g = plain_views((img, g))
        n, _, h, w = img.shape
        gx, gy = g[..., 0], g[..., 1]
        if align_corners:
            fx = torch.div(torch.mul(torch.add(gx, 1), w - 1), 2)
            fy = torch.div(torch.mul(torch.add(gy, 1), h - 1), 2)
        else:
            fx = torch.div(torch.sub(torch.mul(torch.add(gx, 1), w), 1), 2)
            fy = torch.div(torch.sub(torch.mul(torch.add(gy, 1), h), 1), 2)
        batch = torch.arange(n, device=img.device)[:, None, None]

        def gather(iy, ix):
            vals = img[batch, :, torch.clamp(iy, 0, h - 1),
                       torch.clamp(ix, 0, w - 1)]        # N, Ho, Wo, C
            if padding_mode == "zeros":
                inside = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
                vals = torch.where(inside[..., None], vals, 0.0)
            return vals

        if mode == "nearest":
            out = gather(torch.round(fy).to(torch.int64),
                         torch.round(fx).to(torch.int64))
        else:
            x0 = torch.floor(fx).to(torch.int64)
            y0 = torch.floor(fy).to(torch.int64)
            wx = torch.sub(fx, x0)[..., None]
            wy = torch.sub(fy, y0)[..., None]
            ux, uy = torch.rsub(wx, 1), torch.rsub(wy, 1)
            out = torch.add(torch.add(
                torch.mul(torch.mul(gather(y0, x0), ux), uy),
                torch.mul(torch.mul(gather(y0, x0 + 1), wx), uy)),
                torch.add(torch.mul(torch.mul(gather(y0 + 1, x0), ux), wy),
                          torch.mul(torch.mul(gather(y0 + 1, x0 + 1), wx),
                                    wy)))
        return out.permute(0, 3, 1, 2).as_subclass(Tensor)
    return apply(f, x, grid, op_name="grid_sample")


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """Shift a slice of the channels one step along the segment (time)
    axis each way (the TSM op)."""
    def f(v):
        nt, c, h, w = v.shape
        v5 = v.reshape(nt // seg_num, seg_num, c, h, w)
        fold = int(c * shift_ratio)
        back = TF.pad(v5[:, 1:, :fold], (0, 0, 0, 0, 0, 0, 0, 1))
        fwd = TF.pad(v5[:, :-1, fold:2 * fold], (0, 0, 0, 0, 0, 0, 1, 0))
        return torch.cat([back, fwd, v5[:, :, 2 * fold:]], 2).reshape(
            nt, c, h, w)
    return apply(f, x, op_name="temporal_shift")


def gather_tree(ids, parents, name=None):
    """Beam-search backtrace over ``[T, B, W]`` ids: follow the parent
    pointers from the last step to recover whole beams."""
    def f(idv, par):
        t = idv.shape[0]
        b = torch.arange(idv.shape[1], device=idv.device)[:, None]
        beam_at = torch.arange(idv.shape[2], device=idv.device)[None, :] \
            .expand(idv.shape[1:])
        toks = []
        for step in range(t - 1, -1, -1):
            toks.append(idv[step, b, beam_at])
            beam_at = par[step, b, beam_at]
        return torch.stack(toks[::-1], 0)
    return apply(f, ids, parents, op_name="gather_tree")


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over a CSR pattern, computed dense with a mask: q/k/v
    ``[B, H, L, D]``, offsets ``[B, H, L + 1]``, columns ``[B, H, nnz]``."""
    def f(q, k, v, offs, cols):
        b, h, L, d = q.shape
        scores = torch.div(torch.einsum("bhld,bhmd->bhlm", q, k),
                           math.sqrt(d))
        nnz = cols.shape[-1]
        ar = torch.arange(nnz, device=q.device)
        row_of = torch.sum(torch.ge(ar[None, None, None, :],
                                    offs[..., 1:, None]).to(torch.int64), -2)
        mask = torch.zeros((b, h, L, L), dtype=torch.bool, device=q.device)
        bi = torch.arange(b, device=q.device)[:, None, None]
        hi = torch.arange(h, device=q.device)[None, :, None]
        mask = mask.index_put((bi.expand(b, h, nnz), hi.expand(b, h, nnz),
                               row_of, cols.to(torch.int64)),
                              torch.ones((), dtype=torch.bool,
                                         device=q.device))
        probs = torch.softmax(torch.where(mask, scores, -1e30), -1)
        probs = torch.where(mask, probs, 0.0)
        return torch.einsum("bhlm,bhmd->bhld", probs, v)
    return apply(f, query, key, value, sparse_csr_offset, sparse_csr_columns,
                 op_name="sparse_attention")
