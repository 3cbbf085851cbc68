"""The slice as a whole on spawned gloo ranks: a dp2 x mp2 hybrid train
step with ZeRO-1 over dp saves its sharded state and a fresh step
resumes from it.

- ``build_hybrid_train_step`` (tiny LLaMA, fp32, AdamW with a global-norm
  clip, ZeRO-1 over dp) takes 2 steps; every rank stages the pieces of
  ``step.state`` it writes (``checkpoint.shard_bricks``: its mp slice of
  each parameter, its ZeRO slice of each moment, the replicated ones
  from the ranks at coordinate 0) and ``CheckpointManager.save_sharded``
  commits them, one owner a rank; the step then takes 2 more;
- a fresh step built from other weights restores the generation (each
  rank's pieces bitwise the saved ones) and takes the same 2 steps: its
  losses equal the uninterrupted run's bitwise;
- the generation restored onto one rank with no mesh gives a
  ``paddle_tpu_state`` equal to the mesh run's at the save;
- an untagged mp model's parameters (``split_axis``), saved by all four
  ranks with ``save_state_dict(async_save=True)``, load on one rank as
  the weights it was built from.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import CheckpointManager, load_state_dict
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    sharding_optimizer as SO
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     build_hybrid_train_step,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.llama import paddle_tpu_state
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

import torch_dist

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
SAVE = 2


def _state(seed):
    P.seed(seed)
    return {n: np.asarray(p._value)
            for n, p in JaxLlama(JaxConfig(**TINY)).named_parameters()}


def _batches(steps=4, B=4, seq=8):
    out = []
    for s in range(steps):
        r = np.random.RandomState(70 + s)
        ids = r.randint(0, TINY["vocab_size"], (B, seq + 1))
        labels = ids[:, 1:].copy()
        labels[r.rand(B, seq) < 0.25] = -100
        out.append((ids[:, :-1].astype(np.int64), labels.astype(np.int64)))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_hybrid")
    cfg = dict(name="ckpt", mesh={"dp": 2, "mp": 2}, config=dict(TINY),
               state=_state(31), batches=_batches(), lr=1e-2, eps=1e-3,
               kind="hybrid", clip=1.0, remat=True, zero=1)
    res = torch_dist.spawn("ckpt_hybrid", 4, root, {
        "mesh": {"dp": 2, "mp": 2}, "config": cfg, "save": SAVE,
        "other_state": _state(32), "root": str(root / "gens")},
        timeout=180)
    return res, root / "gens", str(root / "gens") + "_flat"


def test_resumed_losses_equal_the_uninterrupted_run_bitwise(run):
    res = run[0]
    for r, out in enumerate(res):
        assert out["step"] == SAVE and out["latest"] == SAVE
        assert out["step_count"] == len(out["losses"])
        assert out["resumed"] == out["losses"][SAVE:], r
        assert len(set(map(tuple, [o["losses"] for o in res]))) == 1


def test_restored_pieces_equal_the_saved_ones_bitwise(run):
    res = run[0]
    for out in res:
        assert out["restored"].keys() == out["saved"].keys()
        for k, v in out["saved"].items():
            assert out["restored"][k] == v, k
        assert out["bytes"] > 0
    # the moments are sliced over dp, the weights over mp: every rank
    # writes pieces, none writes the whole state
    keys = [set(o["saved"]) for o in res]
    assert all(keys) and len({frozenset(k) for k in keys}) == 4


def test_generation_restores_onto_one_rank_without_a_mesh(run):
    res, gens, _ = run
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    load_paddle_tpu_state(model, _state(33))
    opt = topt.AdamW(learning_rate=1e-2, parameters=model.parameters(),
                     epsilon=1e-3, grad_clip=ClipGradByGlobalNorm(1.0))
    _, opt, _ = SO.group_sharded_parallel(model, opt, "os")
    step = build_hybrid_train_step(model, opt, mesh=None, remat=True)
    assert CheckpointManager(str(gens)).restore(step.state) == SAVE
    assert step.state["step"] == SAVE
    want = res[0]["at_save"]
    got = paddle_tpu_state(model)
    assert set(got) == set(want)
    for n, v in want.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)
    m1 = step.state["opt"]["lm_head.weight"]["moment1"]
    assert m1.shape == model.lm_head.weight.shape and bool(m1.abs().sum())
    batch = _batches()[SAVE]
    loss = step({"input_ids": batch[0], "labels": batch[1]})
    assert torch.isfinite(loss)


def test_untagged_mp_parameters_save_by_their_split_axis(run):
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    load_state_dict(dict(model.named_parameters()), run[2])
    want = _state(31)
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
