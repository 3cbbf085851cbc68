"""ResNet and the OCR pair (CRNN, DBNet) in the port against the JAX
package's, on the CPU.

Each model is built in both packages with the same keys; the port takes
the JAX model's weights and BatchNorm statistics by
``load_paddle_tpu_state``. Over 2 optimizer steps on the port model,
each step's loss, every grad and the running statistics after it are
held against the JAX model's step at the same parameters
(``tests/torch_model_parity.py``, the JAX step traced under one
``jax.jit``): ``rtol=1e-5, atol=1e-6`` in float32 (a conv bias ahead of
a BatchNorm has a grad of rounding noise, which the ``atol`` covers).
ResNet (BasicBlock, one block a stage, 10 classes) at 32x32, batch 8,
Momentum with weight decay: grads at ``rtol=1e-4, atol=1e-5``, because
train-mode BatchNorm at the last stage normalises 8 values a channel
(1x1 spatial), which magnifies float32 rounding (XLA and torch reduce in
other orders) by ``1 / std``. CRNN (base 4, hidden 8, CTC over 11
classes) and DBNet (base 4, ``db_loss``) take Adam steps: after the first,
Adam turns the rounding noise of a BatchNorm-cancelled bias grad into a
full ``lr`` step, so later steps are held at ``rtol=1e-4, atol=1e-5``.
"""
import jax
import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu.models import ocr as jocr
from paddle_tpu.vision.models import resnet as jres
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.models import ocr as pocr
from paddle_tpu_torch.models.gpt import load_paddle_tpu_state
from paddle_tpu_torch.vision.models import resnet as pres

from torch_model_parity import train_both

LATER = (1e-4, 1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _pair(jm, pm):
    assert list(pm.state_dict()) == list(jm.state_dict())
    load_paddle_tpu_state(pm, {k: np.asarray(v.numpy()).copy()
                               for k, v in jm.state_dict().items()})
    return jm, pm


def test_resnet50_has_the_published_size_and_the_jax_keys():
    m = pres.resnet50(device="cpu")
    assert sum(p.numel() for p in m.parameters()) == 25557032
    jm = jres.ResNet(jres.BottleneckBlock, layers=[1, 1, 1, 1],
                     num_classes=10)
    pm = pres.ResNet(pres.BottleneckBlock, layers=[1, 1, 1, 1],
                     num_classes=10, device="cpu")
    assert list(pm.state_dict()) == list(jm.state_dict())
    assert "layer1.0.bn1._mean" in pm.state_dict()
    for name in pres.__all__:
        assert hasattr(P.vision, name) and hasattr(P.vision.models, name)


def test_resnet_trains_as_the_jax_model():
    J.seed(1)
    jm, pm = _pair(jres.ResNet(jres.BasicBlock, layers=[1, 1, 1, 1],
                               num_classes=10),
                   pres.ResNet(pres.BasicBlock, layers=[1, 1, 1, 1],
                               num_classes=10, device="cpu"))
    r = np.random.default_rng(0)
    inputs = [r.uniform(-1, 1, (8, 3, 32, 32)).astype(np.float32),
              r.integers(0, 10, 8)]

    def loss(pkg, m, ts):
        return pkg.nn.functional.cross_entropy(m(ts[0]), ts[1])

    losses = train_both(jm, pm, loss, inputs,
                        lambda pkg, m: pkg.optimizer.Momentum(
                            1e-3, 0.9, parameters=m.parameters(),
                            weight_decay=1e-4), 2, tol=LATER)
    assert losses[-1] < losses[0]
    # eval mode: the running statistics normalise, both packages agree
    # (the JAX forward traced, one compile instead of one an op)
    jm.set_state_dict({k: v.detach().numpy() for k, v in
                       pm.state_dict().items()})
    jm.eval()
    pm.eval()
    np.testing.assert_allclose(
        pm(P.to_tensor(inputs[0])).numpy(),
        np.asarray(jax.jit(lambda x: jm(J.to_tensor(x))._value)(inputs[0])),
        1e-5, 1e-5)


def test_crnn_trains_as_the_jax_model():
    J.seed(3)
    kw = dict(base=4, hidden=8, num_classes=11)
    jm, pm = _pair(jocr.CRNN(**kw), pocr.CRNN(**kw, device="cpu"))
    r = np.random.default_rng(1)
    inputs = [r.uniform(-1, 1, (2, 3, 32, 24)).astype(np.float32),
              np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int64),
              np.array([3, 2], np.int64)]
    assert tuple(pm(P.to_tensor(inputs[0])).shape) == (2, 6, 11)

    def loss(pkg, m, ts):
        mod = jocr if pkg is J else pocr
        return mod.ctc_rec_loss(m(ts[0]), ts[1], ts[2])

    losses = train_both(jm, pm, loss, inputs,
                        lambda pkg, m: pkg.optimizer.Adam(
                            1e-2, parameters=m.parameters()), 2,
                        later_tol=LATER)
    assert losses[-1] < losses[0]


def test_dbnet_trains_as_the_jax_model():
    J.seed(4)
    jm, pm = _pair(jocr.DBNet(base=4), pocr.DBNet(base=4, device="cpu"))
    r = np.random.default_rng(2)
    inputs = [r.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32),
              (r.uniform(0, 1, (2, 1, 32, 32)) > 0.5).astype(np.float32),
              r.uniform(0.3, 0.7, (2, 1, 32, 32)).astype(np.float32)]
    out = pm(P.to_tensor(inputs[0]))
    assert sorted(out) == ["binary", "maps", "thresh"]
    assert all(tuple(v.shape) == (2, 1, 32, 32) for v in out.values())

    def loss(pkg, m, ts):
        mod = jocr if pkg is J else pocr
        return mod.db_loss(m(ts[0]), ts[1], ts[2])

    losses = train_both(jm, pm, loss, inputs,
                        lambda pkg, m: pkg.optimizer.Adam(
                            1e-2, parameters=m.parameters()), 2,
                        later_tol=LATER)
    assert losses[-1] < losses[0]
