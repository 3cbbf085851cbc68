"""``TrainStep.reshard`` and the comms layer's lost-peer error, on gloo CPU
ranks (``tests/torch_dist.py``).

- Two ranks train a tiny LLaMA with ZeRO-1 over dp2 (``TrainStep``, the
  valid-token ``loss_sum``); rank 1 leaves; rank 0 re-forms a world of one
  through ``elastic_mesh`` and ``TrainStep.reshard``, with the moments it
  lacks from the gathered host state. After the swap every parameter and
  moment is bitwise its pre-swap gathered value, the rank holds all of the
  Adam state (half before), and the next step's loss equals the JAX
  ``TrainStep``'s after its ``reshard`` onto a dp1 mesh (fp32, rtol 1e-5;
  the two steps before at the same tolerance).
- A rank whose peer dies while it waits in an all-reduce gets the typed
  ``CommTimeout`` (the comms layer maps gloo's "Connection closed by
  peer"), well inside the group's budget, destroys the broken group
  without hanging and forms a world of one.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.fleet.meta_parallel import \
    sharding_optimizer as JSO
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel.trainer import compile_train_step as jax_compile

import torch_dist

RTOL = 1e-5
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)


def _batches(B=4, seq=8, steps=3):
    out = []
    for s in range(steps):
        r = np.random.RandomState(700 + 3 * s)
        ids = r.randint(0, TINY["vocab_size"], (B, seq + 1))
        labels = ids[:, 1:].copy()
        labels[r.rand(B, seq) < 0.2] = -100
        out.append((ids[:, :-1].astype(np.int64), labels.astype(np.int64)))
    return out


def _jax_model():
    P.seed(41)
    return JaxLlama(JaxConfig(**TINY))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_trainer")
    jm = _jax_model()
    cfg = dict(mesh={"dp": 2}, config=dict(TINY), kind="trainstep",
               state={n: np.asarray(p._value)
                      for n, p in jm.named_parameters()},
               batches=_batches(), lr=1e-2, eps=1e-3, clip=1.0, zero=1,
               loss_sum=True)
    reshard = torch_dist.spawn("elastic_reshard", 2, tmp,
                               {"mesh": {"dp": 2}, "config": cfg},
                               timeout=120)
    lost = torch_dist.spawn("lost_peer", 2, tmp, {"mesh": {"dp": 2}},
                            timeout=60)
    return reshard, lost


def _jax_losses():
    jm = _jax_model()
    mesh = jmesh.init_mesh({"dp": 2})
    try:
        opt = jopt.AdamW(learning_rate=1e-2, parameters=jm.parameters(),
                         epsilon=1e-3, grad_clip=JaxClip(1.0))
        model, opt, _ = JSO.group_sharded_parallel(jm, opt, "os")
        step = jax_compile(model, lambda m, b: m.compute_loss(
            b["input_ids"], b["labels"]), opt, mesh=mesh)
        batches = [{"input_ids": P.to_tensor(i), "labels": P.to_tensor(lab)}
                   for i, lab in _batches()]
        losses = [float(step(b).numpy()) for b in batches[:2]]
        step.reshard(jmesh.init_mesh({"dp": 1}))
        losses.append(float(step(batches[2]).numpy()))
    finally:
        jmesh.set_mesh(None)
    return losses


def test_reshard_dp2_to_dp1_keeps_every_value_bitwise(runs):
    (r0, r1), _ = runs
    assert r0["equal"] and all(r0["equal"].values()), \
        [n for n, ok in r0["equal"].items() if not ok]
    assert any(n.startswith("opt.") for n in r0["equal"])
    assert r0["share"] == r1["share"] == 0.5 and r0["after_share"] == 1.0
    assert r0["world"] == 1 and r0["mesh"] == {"dp": 1}
    assert r0["skipped"] == 0 and r0["step"] == 3
    assert r0["losses"][:2] == r1["losses"]


def test_reshard_next_step_equals_the_jax_step_after_reshard(runs):
    (r0, _), _ = runs
    np.testing.assert_allclose(r0["losses"], _jax_losses(), rtol=RTOL)


def test_lost_peer_mid_all_reduce_is_typed_comm_timeout(runs):
    _, (l0, l1) = runs
    assert l0["first"] == l1["first"] == 2.0
    assert l0["error"] is not None and "a peer is gone" in l0["error"]
    assert l0["waited"] < 10.0          # the group's timeout is 60 s
    assert l0["reform_s"] < 10.0 and l0["again"] == 1.0
