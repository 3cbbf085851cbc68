"""BERT in the port against the JAX package's, on the CPU.

``BertConfig.tiny`` with dropout 0, the JAX model's weights carried
across by ``load_paddle_tpu_state`` (the keys are the same; the tied MLM
head adds no key): ``BertForSequenceClassification`` takes 2 AdamW steps
with weight decay on a batch with pad ids and two token types, and
``BertForPretraining`` 2 steps of ``bert_pretraining_loss`` on 15%
masked labels. Each step's loss and every grad are held against the JAX
model's step at the same parameters (``tests/torch_model_parity.py``) at
``rtol=1e-5, atol=1e-6`` (the key projections' bias grads are rounding
noise, which ``atol`` covers); after the first step at ``rtol=1e-4,
atol=1e-5``, since AdamW turns that noise into a full ``lr`` step.
The pad mask is live in both: in eval mode, other ids at padded
positions leave the logits as they were.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models.gpt import load_paddle_tpu_state

from torch_model_parity import train_both

RTOL, ATOL = 1e-5, 1e-6
LATER = (1e-4, 1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _cfg(mod, **kw):
    return mod.BertConfig.tiny(hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0, **kw)


def _pair(jm, pm):
    assert list(pm.state_dict()) == list(jm.state_dict())
    load_paddle_tpu_state(pm, {k: np.asarray(v.numpy()).copy()
                               for k, v in jm.state_dict().items()})
    return jm, pm


def _batch(seed, B=3, S=12):
    r = np.random.default_rng(seed)
    ids = r.integers(1, 128, (B, S)).astype(np.int64)
    for b, n in enumerate(r.integers(4, S + 1, B)):
        ids[b, n:] = 0                          # pad id
    types = np.zeros_like(ids)
    types[:, S // 2:] = 1
    return ids, types


def _adamw(pkg, m):
    return pkg.optimizer.AdamW(1e-3, parameters=m.parameters(),
                               weight_decay=0.01)


def test_sequence_classification_trains_as_the_jax_model():
    J.seed(2)
    jm, pm = _pair(jbert.BertForSequenceClassification(_cfg(jbert), 2),
                   pbert.BertForSequenceClassification(_cfg(pbert), 2,
                                                       device="cpu"))
    ids, types = _batch(0)
    inputs = [ids, types, np.array([0, 1, 1])]

    def loss(pkg, m, ts):
        return pkg.nn.functional.cross_entropy(m(ts[0], ts[1]), ts[2])

    losses = train_both(jm, pm, loss, inputs, _adamw, 2, later_tol=LATER)
    assert losses[-1] < losses[0]


def test_pretraining_with_the_tied_head_trains_as_the_jax_model():
    J.seed(6)
    jm, pm = _pair(jbert.BertForPretraining(_cfg(jbert)),
                   pbert.BertForPretraining(_cfg(pbert), device="cpu"))
    assert "cls._tied" not in pm.state_dict()
    assert pm.cls._tied is pm.bert.embeddings.word_embeddings.weight
    ids, types = _batch(1, B=4, S=16)
    r = np.random.default_rng(3)
    masked = np.where(r.uniform(0, 1, ids.shape) < 0.15, ids, -100)
    masked[0, 1] = ids[0, 1]
    inputs = [ids, types, masked, np.array([0, 1, 1, 0])]

    def loss(pkg, m, ts):
        mod = jbert if pkg is J else pbert
        mlm, ns = m(ts[0], ts[1])
        return mod.bert_pretraining_loss(mlm, ns, ts[2], ts[3])

    losses = train_both(jm, pm, loss, inputs, _adamw, 2, later_tol=LATER)
    assert losses[-1] < losses[0]


def test_pad_mask_is_live_and_ernie_names_alias_bert():
    """In the port, the ids' own mask equals the explicit additive one;
    under it, other ids at the padded positions leave the logits equal,
    and without it (an all-zero mask) they move them (the training tests
    hold the port's outputs against the JAX model's)."""
    P.seed(8, "cpu")
    pm = pbert.BertForSequenceClassification(_cfg(pbert), 3, device="cpu")
    pm.eval()
    ids, _ = _batch(4)
    pad = ids == 0
    assert pad.any() and not pad.all(1).any()
    mask = np.where(pad, -1e9, 0.0).astype(np.float32)[:, None, None, :]
    other = np.where(pad, 7, ids)

    def run(x, msk=None):
        return pm(P.to_tensor(x), attention_mask=None
                  if msk is None else P.to_tensor(msk)).numpy()
    a, b, c = run(ids), run(ids, mask), run(other, mask)
    np.testing.assert_allclose(a, b, 1e-6, 1e-6)
    np.testing.assert_allclose(b, c, 1e-6, 1e-6)
    assert not np.allclose(run(ids, 0 * mask), run(other, 0 * mask))
    assert pbert.ErnieModel is pbert.BertModel
    assert pbert.ErnieForSequenceClassification is \
        pbert.BertForSequenceClassification
    assert pbert.ErnieConfig is pbert.BertConfig
