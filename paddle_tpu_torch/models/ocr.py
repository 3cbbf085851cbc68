"""The PP-OCR pair: counterpart of ``paddle_tpu/models/ocr.py``.

``DBNet`` (a 4-stage conv + BatchNorm backbone at strides 4/8/16, 1x1
laterals summed at the finest level through nearest ``interpolate``, and
the probability and threshold heads, each a 3x3 conv + BatchNorm + ReLU
then a 4x4 stride-4 transposed conv and a sigmoid; the approximate
binary map ``1 / (1 + exp(-k (P - T)))`` is the ``db_binarize`` op) with
``db_loss`` (BCE on the probability and binary maps, L1 on the
threshold), and ``CRNN`` (two conv + BatchNorm + ReLU + 2x2 max pool
stages, the ``[B, C, 8, W/4]`` features read as ``[B, W/4, C * 8]``, a
bidirectional LSTM and a linear head) with ``ctc_rec_loss`` over the
port's ``ctc_loss``. The same layers, widths and state-dict keys as the
JAX models; every constructor takes a keyword-only ``device`` (default:
the card).
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ..nn import functional as F
from ..nn.layer.common import Linear
from ..nn.layer.container import LayerList, Sequential
from ..nn.layer.conv import Conv2D, Conv2DTranspose
from ..nn.layer.layers import Layer
from ..nn.layer.norm import BatchNorm2D
from ..nn.layer.pooling import MaxPool2D
from ..nn.layer.rnn import LSTM
from ..ops.dispatch import apply
from ..ops.manip import reshape, transpose

__all__ = ["DBNet", "CRNN", "db_loss", "ctc_rec_loss"]


def _conv_bn(cin, cout, stride=1, k=3, device=None):
    return Sequential(
        Conv2D(cin, cout, k, stride=stride, padding=k // 2, device=device),
        BatchNorm2D(cout, device=device),
    )


class _Backbone(Layer):
    """4-stage conv backbone, strides 4/8/16 (relative to the stem)."""

    def __init__(self, cin=3, base=16, *, device=None):
        super().__init__()
        self.stem = _conv_bn(cin, base, stride=2, device=device)
        self.stages = LayerList([
            _conv_bn(base, base * 2, stride=2, device=device),
            _conv_bn(base * 2, base * 4, stride=2, device=device),
            _conv_bn(base * 4, base * 8, stride=2, device=device),
        ])

    def forward(self, x):
        x = F.relu(self.stem(x))
        feats = []
        for s in self.stages:
            x = F.relu(s(x))
            feats.append(x)
        return feats


class DBNet(Layer):
    """Differentiable Binarization text detector (det_db)."""

    def __init__(self, in_channels=3, base=16, k=50.0, *, device=None):
        super().__init__()
        self.k = k
        self.backbone = _Backbone(in_channels, base, device=device)
        chans = [base * 2, base * 4, base * 8]
        neck_c = base * 4
        self.lateral = LayerList([Conv2D(c, neck_c, 1, device=device)
                                  for c in chans])
        self.prob_head = Sequential(
            Conv2D(neck_c, neck_c // 2, 3, padding=1, device=device),
            BatchNorm2D(neck_c // 2, device=device),
        )
        self.prob_out = Conv2DTranspose(neck_c // 2, 1, 4, stride=4,
                                        device=device)
        self.thresh_head = Sequential(
            Conv2D(neck_c, neck_c // 2, 3, padding=1, device=device),
            BatchNorm2D(neck_c // 2, device=device),
        )
        self.thresh_out = Conv2DTranspose(neck_c // 2, 1, 4, stride=4,
                                          device=device)

    def forward(self, x):
        feats = self.backbone(x)
        mapped = [lat(f) for lat, f in zip(self.lateral, feats)]
        target_hw = tuple(mapped[0].shape[2:])
        merged = mapped[0]
        for m in mapped[1:]:
            # nearest upsampling to the finest level
            merged = merged + F.interpolate(m, size=target_hw,
                                            mode="nearest")
        prob = F.sigmoid(self.prob_out(F.relu(self.prob_head(merged))))
        thresh = F.sigmoid(self.thresh_out(F.relu(self.thresh_head(
            merged))))
        k = self.k
        binary = apply(lambda p, t: torch.div(1.0, torch.add(torch.exp(
            torch.mul(torch.sub(p, t), -k)), 1.0)), prob, thresh,
            op_name="db_binarize")
        return {"maps": prob, "thresh": thresh, "binary": binary}


def db_loss(out, gt_prob, gt_thresh=None, alpha=5.0, beta=10.0):
    """BCE on the probability and binary maps, plus L1 on the threshold
    map (a simplified DBLoss)."""
    prob, binary = out["maps"], out["binary"]
    lp = F.binary_cross_entropy(prob, gt_prob)
    lb = F.binary_cross_entropy(binary, gt_prob)
    loss = lp * alpha + lb
    if gt_thresh is not None:
        loss = loss + beta * F.l1_loss(out["thresh"], gt_thresh)
    return loss


class CRNN(Layer):
    """conv -> BiLSTM -> CTC logits (rec_crnn)."""

    def __init__(self, in_channels=3, num_classes=63, hidden=96, base=16, *,
                 device=None):
        super().__init__()
        self.conv = Sequential(
            Conv2D(in_channels, base, 3, padding=1, device=device),
            BatchNorm2D(base, device=device),
        )
        self.pool1 = MaxPool2D(2, 2)
        self.conv2 = Sequential(
            Conv2D(base, base * 2, 3, padding=1, device=device),
            BatchNorm2D(base * 2, device=device),
        )
        self.pool2 = MaxPool2D(2, 2)
        self.rnn = LSTM(base * 2 * 8, hidden, direction="bidirect",
                        device=device)
        self.fc = Linear(hidden * 2, num_classes, device=device)

    def forward(self, x):
        """``[B, C, 32, W]`` -> logits ``[B, W // 4, num_classes]``."""
        h = self.pool1(F.relu(self.conv(x)))
        h = self.pool2(F.relu(self.conv2(h)))          # [B, C', 8, W/4]
        b, c, hh, w = h.shape
        h = transpose(h, [0, 3, 1, 2])                 # [B, W/4, C', 8]
        h = reshape(h, [b, w, c * hh])
        out, _ = self.rnn(h)
        return self.fc(out)


def ctc_rec_loss(logits, labels, label_lengths, blank: int = 0):
    """CTC over CRNN logits ``[B, T, C]``, every input of length T."""
    B, T = logits.shape[0], logits.shape[1]
    input_lengths = Tensor(torch.full((B,), T, dtype=torch.int32,
                                      device=logits.device))
    log_probs = apply(lambda lv: lv.permute(1, 0, 2), logits,
                      op_name="to_time_major")
    log_probs = apply(lambda lv: torch.log_softmax(lv, -1), log_probs,
                      op_name="log_softmax")
    return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                      blank=blank)
