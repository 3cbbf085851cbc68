"""Sharded checkpoints and durable generations in the port, held against
the JAX package's on-disk format.

- A checkpoint the JAX package writes (tiny llama parameters, an
  ``AdamW.state_dict()`` after one step, a bfloat16 leaf and an int)
  restores bitwise in the port, flat and through ``CheckpointManager``.
- A checkpoint the port writes restores bitwise in the JAX package,
  through ``load_state_dict`` and ``CheckpointManager.restore``. The JAX
  reader cannot read a bfloat16 leaf back, its own included
  (``np.asarray(V2 records, dtype=bfloat16)`` has no cast), so the port's
  bfloat16 bytes are checked in the file against ``ml_dtypes``' bytes.
- The port's ``metadata.json`` and ``manifest.json`` have the reference's
  keys.
- The crash matrix (after ``tests/test_ckpt_chaos.py``): a child that
  imports only ``paddle_tpu_torch`` is SIGKILLed at every registered
  ``ckpt.*`` crash site and at the sharded commit's fault sites, and
  ``latest()`` + ``restore()`` land on the last committed generation.
- Corruption is typed, GC keeps the last K, an async save's failure is
  re-raised once, and a bfloat16 checkpoint loads in a child that
  imports neither ``jax`` nor ``ml_dtypes``.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed.ckpt_manager import CheckpointManager as JMgr
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import chaos as tchaos
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager as TMgr
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import load_paddle_tpu_state

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=32, hidden_size=16, intermediate_size=32,
           num_hidden_layers=2, num_attention_heads=2,
           max_position_embeddings=16)
BF16 = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)


def _batch():
    r = np.random.RandomState(1)
    return (r.randint(0, 32, (2, 8)).astype(np.int64),
            r.randint(0, 32, (2, 8)).astype(np.int64))


def _jax_state(seed=3):
    """A JAX model, an AdamW after one eager step, a bf16 leaf, an int."""
    P.seed(seed)
    m = JaxLlama(JaxConfig(**CFG))
    opt = jopt.AdamW(learning_rate=0.01, parameters=m.parameters())
    ids, labels = _batch()
    m.compute_loss(P.to_tensor(ids), P.to_tensor(labels)).backward()
    opt.step()
    return m, opt, {"model": dict(m.named_parameters()),
                    "opt": opt.state_dict(),
                    "bf16": P.to_tensor(BF16).astype("bfloat16"),
                    "count": 7}


def _port_state(seed=0):
    """The port's twin tree: a model, an AdamW with states (one step on
    other data), a bf16 tensor and an int, all of other values."""
    torch.manual_seed(seed)
    m = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=seed)
    opt = topt.AdamW(learning_rate=0.01, parameters=m.parameters())
    ids, labels = _batch()
    m.compute_loss(torch.from_numpy(ids[::-1].copy()),
                   torch.from_numpy(labels)).backward()
    opt.step()
    return m, opt, {"model": dict(m.named_parameters()),
                    "opt": opt.state_dict(),
                    "bf16": torch.zeros(3, 4, dtype=torch.bfloat16),
                    "count": 0}


def _jnp(v):
    return np.asarray(v._value if hasattr(v, "_value") else v)


def _assert_port_equals_jax(tstate, jstate):
    for n, p in jstate["model"].items():
        np.testing.assert_array_equal(tstate["model"][n].detach().numpy(),
                                      _jnp(p), err_msg=n)
    for k, v in jstate["opt"].items():
        if k == "global_step":
            continue
        np.testing.assert_array_equal(tstate["opt"][k].numpy(), _jnp(v),
                                      err_msg=k)
    got = tstate["bf16"].view(torch.int16).numpy()
    want = _jnp(jstate["bf16"]).view(np.int16)
    np.testing.assert_array_equal(got, want)
    assert tstate["count"] == jstate["count"]


@pytest.mark.parametrize("via", ["flat", "manager"])
def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path, via):
    _, _, js = _jax_state()
    _, _, ts = _port_state()
    if via == "flat":
        jck.save_state_dict(js, str(tmp_path))
        tck.load_state_dict(ts, str(tmp_path))
    else:
        JMgr(str(tmp_path)).save(js, 5)
        assert TMgr(str(tmp_path)).restore(ts) == 5
    _assert_port_equals_jax(ts, js)


def _jax_target():
    """A JAX tree of other values to restore into (no bf16 leaf: the JAX
    reader cannot load one)."""
    m, opt, js = _jax_state(seed=8)
    js.pop("bf16")
    js["count"] = 0
    return js


def _check_bf16_bytes(d):
    meta = json.load(open(os.path.join(d, "metadata.json")))
    assert meta["params"]["bf16"]["dtype"] == "bfloat16"
    with np.load(os.path.join(d, "shard-0.npz")) as z:
        key = next(k for k in z.files if k.startswith("bf16|"))
        raw = z[key]
    assert raw.dtype.itemsize == 2 and raw.dtype.kind == "V"
    np.testing.assert_array_equal(raw.view(ml_dtypes.bfloat16),
                                  BF16.astype(ml_dtypes.bfloat16))


@pytest.mark.parametrize("via", ["flat", "manager"])
def test_port_checkpoint_restores_bitwise_in_jax(tmp_path, via):
    _, _, js_src = _jax_state()
    _, _, ts = _port_state()
    tck.load_state_dict(ts, _save_jax(tmp_path / "src", js_src))
    ts["bf16"] = torch.from_numpy(BF16).to(torch.bfloat16)
    out = tmp_path / "port"
    jt = _jax_target()
    if via == "flat":
        tck.save_state_dict(ts, str(out))
        jck.load_state_dict(jt, str(out))
        _check_bf16_bytes(str(out))
    else:
        TMgr(str(out)).save(ts, 9)
        assert JMgr(str(out)).restore(jt) == 9
        _check_bf16_bytes(str(out / "step-9"))
    for n, p in jt["model"].items():
        np.testing.assert_array_equal(_jnp(p), ts["model"][n].detach()
                                      .numpy(), err_msg=n)
    for k, v in jt["opt"].items():
        if k != "global_step":
            np.testing.assert_array_equal(_jnp(v), ts["opt"][k].numpy())
    assert jt["count"] == 7


def _save_jax(d, js):
    jck.save_state_dict(js, str(d))
    return str(d)


def test_metadata_and_manifest_keys_match_the_reference(tmp_path):
    _, _, js = _jax_state()
    _, _, ts = _port_state()
    JMgr(str(tmp_path / "j")).save(js, 1)
    TMgr(str(tmp_path / "t")).save(ts, 1)
    for f in ("metadata.json", "manifest.json"):
        a = json.load(open(tmp_path / "j" / "step-1" / f))
        b = json.load(open(tmp_path / "t" / "step-1" / f))
        assert set(a) == set(b), f
        assert a["format"] == b["format"]
    ja = json.load(open(tmp_path / "j" / "step-1" / "metadata.json"))
    tb = json.load(open(tmp_path / "t" / "step-1" / "metadata.json"))
    assert set(ja["params"]) == set(tb["params"])
    for n, rec in ja["params"].items():
        assert set(rec) == set(tb["params"][n]), n
        assert rec["shape"] == tb["params"][n]["shape"], n
        assert rec["dtype"] == tb["params"][n]["dtype"], n
    files = json.load(open(tmp_path / "t" / "step-1" / "manifest.json"))
    assert set(files["files"]) == {"metadata.json", "shard-0.npz"}


def test_llama_state_round_trips_through_the_port(tmp_path):
    """A port model's parameters written and read back by the port,
    also after ``reshard_checkpoint`` consolidates the files."""
    m, _, _ = _port_state(seed=4)
    other, _, _ = _port_state(seed=5)
    tck.save_state_dict(dict(m.named_parameters()), str(tmp_path / "a"))
    tck.reshard_checkpoint(str(tmp_path / "a"), str(tmp_path / "b"))
    for src in ("a", "b"):
        tck.load_state_dict(dict(other.named_parameters()),
                            str(tmp_path / src))
        for (n, p), (_, q) in zip(m.named_parameters(),
                                  other.named_parameters()):
            assert torch.equal(p, q), n


def test_corruption_is_typed(tmp_path):
    _, _, ts = _port_state()
    mgr = TMgr(str(tmp_path))
    mgr.save(ts, 1)
    shard = tmp_path / "step-1" / "shard-0.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(tck.CheckpointCorruptionError):
        mgr.restore(_port_state()[2], 1)
    mgr.save(ts, 2)
    (tmp_path / "step-2" / "shard-0.npz.crc32").write_text("zz not hex\n")
    with pytest.raises(tck.CheckpointCorruptionError):
        mgr.restore(_port_state()[2], 2)
    with pytest.raises(tck.CheckpointCorruptionError):
        mgr.read_param("count", 2)


def test_gc_keeps_the_last_k(tmp_path):
    mgr = TMgr(str(tmp_path), keep_last_k=2)
    for s in (1, 2, 3, 4):
        mgr.save({"x": torch.full((3,), float(s))}, s)
    assert mgr.all_steps() == [3, 4] and mgr.latest() == 4
    np.testing.assert_array_equal(mgr.read_param("x"), [4.0, 4.0, 4.0])
    with pytest.raises(ValueError):
        TMgr(str(tmp_path), keep_last_k=0)


def test_async_save_reraises_once(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk gone")
    state = {"x": torch.ones(4)}
    monkeypatch.setattr(tck, "_atomic_write", boom)
    tck.save_state_dict(state, str(tmp_path / "flat"), async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        tck.wait()
    tck.wait()
    mgr = TMgr(str(tmp_path / "gen"))
    mgr.save(state, 1, async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint generation"):
        mgr.wait()
    mgr.wait()
    monkeypatch.undo()
    mgr.save(state, 2, async_save=True)
    mgr.wait()
    assert mgr.latest() == 2


def test_sharded_owners_commit_and_restore(tmp_path):
    """Two owners stage disjoint bricks of one tensor; the committer
    commits; the read side assembles them (no process group needed)."""
    full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    meta = {"w": {"shape": [4, 6], "dtype": "float32", "spec": [None]}}
    mgr = TMgr(str(tmp_path))
    mgr.stage_shards(3, "b", {"w|2:4,0:6": full[2:].numpy()})
    mgr.save_sharded(3, "a", ["a", "b"], {"w|0:2,0:6": full[:2].numpy()},
                     meta)
    assert mgr.latest() == 3
    assert mgr.manifest(3)["layout"] == "owner-sharded"
    got = {"w": torch.zeros(4, 6)}
    mgr.restore(got)
    assert torch.equal(got["w"], full)
    with pytest.raises(tck.CheckpointCorruptionError):
        mgr.save_sharded(4, "a", ["a"], {"w|0:2,0:6": full[:2].numpy()},
                         meta)


CHILD = textwrap.dedent('''
    import os, sys
    sys.modules["jax"] = None
    sys.path.insert(0, sys.argv[1])
    import torch
    from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager
    root, kind = sys.argv[2], sys.argv[3]
    mgr = CheckpointManager(root, keep_last_k=3)
    x = {"w": torch.arange(6.0), "n": 1}
    if kind == "gather":
        for s in (1, 2):
            x["w"] = x["w"] + 1
            x["n"] = s
            mgr.save(x, s)
    else:
        meta = {"w": {"shape": [6], "dtype": "float32", "spec": []}}
        mgr.save_sharded(1, "a", ["a"], {"w|0:6": (x["w"] + 1).numpy()},
                         meta)
        owner, owners = ("a", ["a"]) if kind == "shard_staged" else \\
            ("b", ["a", "b"])
        mgr.save_sharded(2, owner, owners, {"w|0:6": (x["w"] + 2).numpy()},
                         meta, budget=30.0)
    print("SURVIVED")
''')
# crash sites after which generation 2 is committed
AFTER_COMMIT = {"ckpt.commit_written", "ckpt.gc_done"}


def _matrix():
    rows = [(s, "crash") for s in tchaos.registered_sites("ckpt.")]
    rows += [(s, "fault") for s in tchaos.fault_sites("ckpt.")]
    return rows


def test_the_matrix_covers_every_ckpt_site():
    names = {s for s, _ in _matrix()}
    assert len(names) == 11
    assert {"ckpt.shard_tmp_written", "ckpt.metadata_written",
            "ckpt.generation_staged", "ckpt.gc_done", "ckpt.shard_staged",
            "ckpt.receipts"} <= names


@pytest.mark.parametrize("site,mode", _matrix())
def test_crash_matrix_recovers_the_last_committed_generation(tmp_path, site,
                                                             mode):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    env = dict(os.environ)
    if mode == "crash":
        # the save of generation 1 passes each site once; kill in gen 2
        env.update(PT_CRASHPOINT=site, PT_CRASHPOINT_HITS="2")
        kind = "gather"
    else:
        env.update(PT_FAULTPOINT=site, PT_FAULTPOINT_MODE="crash",
                   PT_FAULTPOINT_SKIP="1" if site == "ckpt.shard_staged"
                   else "0")
        kind = site.split(".")[1]
    root = tmp_path / "ckpt"
    res = subprocess.run([sys.executable, str(script), str(ROOT), str(root),
                          kind], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == -signal.SIGKILL, (res.returncode, res.stderr)
    assert "SURVIVED" not in res.stdout
    mgr = TMgr(str(root))
    want = 2 if site in AFTER_COMMIT else 1
    assert mgr.latest() == want
    got = {"w": torch.zeros(6), "n": 0}
    assert mgr.restore(got) == want
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(6.0) + want)


def test_bf16_checkpoint_loads_without_jax_or_ml_dtypes(tmp_path):
    _, _, js = _jax_state()
    jck.save_state_dict({"bf16": js["bf16"]}, str(tmp_path))
    code = textwrap.dedent(f'''
        import sys
        sys.modules["jax"] = None
        sys.modules["ml_dtypes"] = None
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        from paddle_tpu_torch.distributed import checkpoint
        t = {{"bf16": torch.zeros(3, 4, dtype=torch.bfloat16)}}
        checkpoint.load_state_dict(t, {str(tmp_path)!r})
        print("VALUES", t["bf16"].float().flatten().tolist())
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and (m.split(".")[0] in ("jax", "ml_dtypes")
                          or m == "paddle_tpu"
                          or m.startswith("paddle_tpu.")))
        print("LOADED", bad)
    ''')
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout
    vals = eval(res.stdout.split("VALUES", 1)[1].split("\n")[0])
    np.testing.assert_array_equal(
        np.asarray(vals, np.float32),
        BF16.astype(ml_dtypes.bfloat16).astype(np.float32).ravel())
