"""The port's DeepFM against the JAX package's (``paddle_tpu/models/
deepfm.py``), on the CPU in fp32, the JAX model's weights carried across
with ``load_paddle_tpu_state``.

- forward, ``predict``, the binary cross-entropy loss and every parameter's
  grad at rtol 1e-5, hashed ids and not; ``paddle_tpu_state`` gives the
  weights back;
- 3 steps of ``compile_train_step`` (Adam, no mesh) against the JAX
  ``TrainStep``: losses and parameters at rtol 1e-5;
- dp2 (two gloo ranks, spawned once; each holds its rows of both tables)
  trained through the graph-replay capture backend: the same losses as
  dp1 at rtol 1e-5 (the exchange sums a row's grads per rank first), the
  captured program's ``comm_tagged >= 4`` (two tables, two wire legs
  each), a clean lint, the tables left out of the dp grad sync (its bytes
  are the dense parameters'), the tables' state gathered equal to dp1's;
  a backend that holds graphs refuses the gloo step (one bailout, every
  call eager); inside ``comms.quantized("int8")`` the last loss within
  10% of the exact one (the JAX test's bound) with the rows on int8.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as jnn
from paddle_tpu.models import DeepFM as JaxDeepFM
from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu.parallel.trainer import compile_train_step as jax_compile

from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import DeepFM
from paddle_tpu_torch.models.deepfm import (load_paddle_tpu_state,
                                            paddle_tpu_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.parallel import compile_train_step

from torch_dist import spawn

RTOL = 1e-5
CFG = dict(sparse_feature_number=64, sparse_feature_dim=8,
           dense_feature_dim=4, sparse_field_num=6, layer_sizes=(16, 8))
LR = 1e-2


def _jax_model(seed=0, **kw):
    jax_mesh.set_mesh(None)
    P.seed(seed)
    return JaxDeepFM(**{**CFG, **kw})


def _state(jm):
    return {n: np.asarray(p._value).copy() for n, p in jm.named_parameters()}


def _pair(**kw):
    jm = _jax_model(**kw)
    pm = DeepFM(**{**CFG, **kw}, device="cpu", mesh=None)
    load_paddle_tpu_state(pm, _state(jm))
    return jm, pm


def _batch(seed, B=32, hi=64):
    r = np.random.RandomState(seed)
    return {"sparse": r.randint(0, hi, (B, 6)),
            "dense": r.randn(B, 4).astype(np.float32),
            "y": (r.rand(B, 1) > 0.5).astype(np.float32)}


def _port_loss(m, b):
    return F.binary_cross_entropy_with_logits(m(b["sparse"], b["dense"]),
                                              b["y"])


def _jax_loss(m, b):
    return jnn.functional.binary_cross_entropy_with_logits(
        m(b["sparse"], b["dense"]), b["y"])


@pytest.mark.parametrize("hash_ids", [False, True])
def test_forward_loss_and_grads_match_jax(hash_ids):
    jm, pm = _pair(hash_ids=hash_ids)
    b = _batch(1, hi=2 ** 40 if hash_ids else 64)
    jb = {k: P.to_tensor(v) for k, v in b.items()}
    pb = {k: torch.from_numpy(v) for k, v in b.items()}
    jl = _jax_loss(jm, jb)
    pl = _port_loss(pm, pb)
    np.testing.assert_allclose(float(pl.detach()), float(jl.numpy()),
                               rtol=RTOL)
    np.testing.assert_allclose(
        pm.predict(pb["sparse"], pb["dense"]).detach().numpy(),
        np.asarray(jm.predict(jb["sparse"], jb["dense"])._value), rtol=RTOL,
        atol=1e-6)
    jl.backward()
    pl.backward()
    grads = dict(pm.named_parameters())
    for n, p in jm.named_parameters():
        g = np.asarray(p.grad._value)
        np.testing.assert_allclose(grads[n].grad.numpy(), g, rtol=RTOL,
                                   atol=1e-6 * np.abs(g).max(), err_msg=n)


def test_state_round_trip_and_names():
    jm, pm = _pair()
    assert [n for n, _ in pm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    got = paddle_tpu_state(pm)
    for n, v in _state(jm).items():
        np.testing.assert_array_equal(got[n], v)
    with pytest.raises(KeyError):
        load_paddle_tpu_state(pm, {"emb_first.weight":
                                   got["emb_first.weight"]})


def _port_steps(pm, batches):
    opt = popt.Adam(learning_rate=LR, parameters=pm.parameters())
    step = compile_train_step(pm, _port_loss, opt)
    return [float(step({k: torch.from_numpy(v) for k, v in b.items()}))
            for b in batches]


def test_three_train_steps_match_the_jax_train_step():
    jm, pm = _pair()
    batches = [_batch(10)] * 3
    jopt = P.optimizer.Adam(learning_rate=LR, parameters=jm.parameters())
    jstep = jax_compile(jm, _jax_loss, jopt)
    jl = [float(jstep({k: P.to_tensor(v) for k, v in b.items()}).numpy())
          for b in batches]
    pl = _port_steps(pm, batches)
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    assert pl[-1] < pl[0]
    got = paddle_tpu_state(pm)
    for n, p in jm.named_parameters():
        want = np.asarray(p._value)
        np.testing.assert_allclose(got[n], want, rtol=RTOL,
                                   atol=1e-6 * np.abs(want).max(), err_msg=n)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    batches = [_batch(20 + i) for i in range(3)]
    jm = _jax_model(seed=4)
    pm = DeepFM(**CFG, device="cpu", mesh=None)
    load_paddle_tpu_state(pm, _state(jm))
    dp1 = _port_steps(pm, batches)
    payload = {"mesh": {"dp": 2}, "cfg": CFG, "state": _state(jm),
               "lr": LR, "batches": batches, "quantized": True,
               "gloo_bailout": True}
    outs = spawn("deepfm_dp", 2, tmp_path_factory.mktemp("deepfm"), payload,
                 timeout=90.0)
    return dp1, paddle_tpu_state(pm), outs


def test_dp2_matches_dp1_and_captures_the_exchange(dp2):
    dp1, state1, outs = dp2
    for o in outs:
        np.testing.assert_allclose(o["losses"], dp1, rtol=RTOL)
        assert o["rows"] == ["emb_first.weight", "emb_factor.weight"]
        for n, v in state1.items():
            np.testing.assert_allclose(o["state"][n], v, rtol=RTOL,
                                       atol=1e-6 * np.abs(v).max(),
                                       err_msg=n)
        rep = o["report"]
        assert rep is not None and rep["comm_tagged"] >= 4, rep
        assert o["lint"]["findings"] == [], o["lint"]
        info = o["info"]
        assert (info["lowerings"], info["hits"], info["bailouts"],
                info["fallback_calls"]) == (1, 2, 0, 0)
        sites = o["sites"]
        assert sites["embedding.ids/all_to_all/dp"]["count"] == 2 * 3
        assert sites["embedding.rows/all_to_all/dp"]["count"] == 2 * 3
        # the tables never ride the dp grad sync
        sync = sites["trainer.grad_sync/all_reduce/dp"]
        assert sync["bytes_logical"] == o["dense_bytes"] * 3


def test_dp2_gloo_step_is_refused_by_a_graph_backend(dp2):
    for o in dp2[2]:
        none, info, reason = o["refused"]
        assert none and "gloo" in reason
        assert info["bailouts"] == 1 and info["fallback_calls"] == 3
        assert info["lowerings"] == info["hits"] == 0


def test_dp2_int8_within_ten_percent(dp2):
    for o in dp2[2]:
        lq, l2 = o["quant_losses"], o["losses"]
        assert np.isfinite(lq[-1])
        assert abs(lq[-1] - l2[-1]) / max(abs(l2[-1]), 1e-9) < 0.1, (lq, l2)
        sites = o["quant_sites"]
        assert sites["embedding.rows/all_to_all/dp"]["quantized"] == "int8"
        assert sites["trainer.grad_sync/all_reduce/dp"]["quantized"] \
            == "int8"
