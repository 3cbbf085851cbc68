"""The port's live resharding against the JAX package's.

Over a grid of (src mesh, dst mesh, spec) cases (dp4 -> dp2, dp2 -> dp4,
dp2 x mp2 -> dp2, a lost owner, dims that do not divide, a scalar):
- ``plan_reshard`` gives the same ``digest()``, the same transfers,
  local steps and lost pieces, and the same ``bytes_moved``,
  ``bytes_local`` and ``naive_bytes`` as the JAX planner;
- ``redistribute`` (every owner's ``execute`` over one ``LocalTransport``)
  gives the same bytes per owner, and both equal the full array cut to
  each owner's destination block;
- the ladder takes the same rung as the JAX one when a peer dies
  mid-transfer (full-restore from the committed generation), when a brick
  is lost (partial-restore), and the same ``rung_agreement``;
- the callable module raises ``NotInThisSlice`` for the auto-parallel API.

Exact throughout: the state is host bytes.
"""
import numpy as np
import pytest

from paddle_tpu.distributed import reshard as jrs
from paddle_tpu.distributed.ckpt_manager import CheckpointManager as JMgr
from paddle_tpu_torch.core.errors import NotInThisSlice
from paddle_tpu_torch.distributed import reshard as prs
from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager


def _full(seed=7):
    rng = np.random.RandomState(seed)
    return {
        "w": rng.randn(12, 8).astype(np.float32),
        "b": rng.randn(8).astype(np.float32),
        "m1": rng.randn(12, 8).astype(np.float32),
        "odd": rng.randn(7, 5).astype(np.float32),
        "scale": np.asarray(32768.0, np.float32),
        "steps": rng.randint(0, 1 << 30, (6,)).astype(np.int64),
    }


ROWS = {"w": ("dp", None), "m1": ("dp", None), "odd": ("dp", None),
        "steps": ("dp",)}
GRID2 = {"w": ("dp", "mp"), "m1": ("dp", "mp"), "odd": ("dp", "mp"),
         "b": ("mp",)}
M4, M2 = ["a", "b", "c", "d"], ["a", "b"]
# (label, src members, src shape, dst members, dst shape, src spec,
#  dst spec, available src owners or None)
CASES = [
    ("dp4_to_dp2", M4, None, M2, None, ROWS, ROWS, None),
    ("dp2_to_dp4", M2, None, M4, None, ROWS, ROWS, None),
    ("dp2xmp2_to_dp2", M4, {"dp": 2, "mp": 2}, M2, None, GRID2, ROWS, None),
    ("dp4_to_dp2_lost_owner", M4, None, M2, None, ROWS, ROWS,
     {"a", "b", "d"}),
    ("dp2_to_cols", M2, None, M2, None, ROWS,
     {"w": (None, "dp"), "m1": (None, "dp"), "odd": (None, "dp")}, None),
]


def _specs(mod, src_s, dst_s, full):
    return {n: mod.ParamSpec(a.shape, a.dtype, src_s.get(n, ()),
                             dst_s.get(n, ())) for n, a in full.items()}


def _meshes(mod, case):
    _, sm, ss, dm, ds, *_ = case
    return (mod.MeshSpec.from_members(sm, ss),
            mod.MeshSpec.from_members(dm, ds))


def _shards(mod, full, params, mesh, which="src"):
    return {o: {n: np.ascontiguousarray(a[tuple(
        slice(lo, hi) for lo, hi in mod.shard_index(
            a.shape, getattr(params[n], which), mesh, o))])
        for n, a in full.items()} for o in mesh.owners}


def _plans(case):
    full = _full()
    out = []
    for mod in (jrs, prs):
        src, dst = _meshes(mod, case)
        params = _specs(mod, case[5], case[6], full)
        out.append((mod, src, dst, params,
                    mod.plan_reshard(src, dst, params, available=case[7])))
    return full, out


def _plain(steps):
    return [tuple((f, getattr(s, f)) for f in s.__dataclass_fields__)
            for s in steps]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plan_equal_to_the_jax_planner(case):
    _, ((_, _, _, _, jp), (_, _, _, _, pp)) = _plans(case)
    assert pp.digest() == jp.digest()
    for field in ("steps", "local", "lost"):
        assert _plain(getattr(pp, field)) == _plain(getattr(jp, field)), \
            field
    for prop in ("bytes_moved", "bytes_local", "naive_bytes",
                 "participants", "recoverable_from_peers"):
        assert getattr(pp, prop) == getattr(jp, prop), prop
    assert (len(pp.lost) > 0) == (case[7] is not None)


@pytest.mark.parametrize("case", [c for c in CASES if c[7] is None],
                         ids=[c[0] for c in CASES if c[7] is None])
def test_execute_gives_the_jax_bytes_per_owner(case):
    full, plans = _plans(case)
    outs = []
    for mod, src, dst, params, _ in plans:
        states = _shards(mod, full, params, src)
        got, plan = mod.redistribute(src, dst, params, states, budget=20.0)
        want = _shards(mod, full, params, dst, "dst")
        for o in dst.owners:
            for n in full:
                assert got[o][n].tobytes() == want[o][n].tobytes(), (o, n)
        outs.append({o: {n: v.tobytes() for n, v in s.items()}
                     for o, s in got.items()})
    assert outs[0] == outs[1]


def _ladder(mod, mgr_cls, tmp_path, how):
    """(rung, new state) of owner a on dp2 -> dp1 when b dies before
    sending (``dead``) or b's brick is lost (``lost``)."""
    full = _full()
    rows = {"w": ("dp", None)}
    src = mod.MeshSpec.from_members(["a", "b"])
    dst = mod.MeshSpec.from_members(["a"])
    params = _specs(mod, rows, rows, full)
    states = _shards(mod, full, params, src)
    mgr = mgr_cls(str(tmp_path / mod.__name__.split(".")[0]))
    mgr.save(dict(full), 5)
    avail = {"a"} if how == "lost" else None
    plan = mod.plan_reshard(src, dst, params, available=avail)
    transport = mod.LocalTransport()
    out, rung = mod.reshard_or_restore(plan, "a", states["a"], transport,
                                       session=f"t_{how}", ckpt=mgr,
                                       budget=0.4)
    agreed = mod.rung_agreement(plan, transport, session=f"t_{how}",
                                budget=0.2)
    return rung, agreed, {n: v.tobytes() for n, v in out.items()}


@pytest.mark.parametrize("how", ["dead", "lost"])
def test_ladder_takes_the_jax_rung(tmp_path, how):
    want = _ladder(jrs, JMgr, tmp_path, how)
    got = _ladder(prs, CheckpointManager, tmp_path, how)
    assert got == want
    assert want[0] == ("full-restore" if how == "dead" else
                       "partial-restore")
    assert got[2]["w"] == _full()["w"].tobytes()


def test_session_ids_and_reports_match():
    dst_j = jrs.MeshSpec.from_members(["a", "b"])
    dst_p = prs.MeshSpec.from_members(["a", "b"])
    assert prs.session_for(3, dst_p) == jrs.session_for(3, dst_j)
    prs.reset_reports()
    full = _full()
    src, dst = prs.MeshSpec.from_members(M2), prs.MeshSpec.from_members(["a"])
    params = _specs(prs, ROWS, ROWS, full)
    prs.redistribute(src, dst, params, _shards(prs, full, params, src),
                     budget=10.0)
    reps = prs.reshard_reports()
    assert [r["owner"] for r in reps] and all(
        r["how"] == "reshard" for r in reps)
    from paddle_tpu_torch import profiler
    assert "reshard:" in profiler.reshard_summary()


def test_auto_parallel_reshard_call_is_not_in_this_slice():
    import paddle_tpu_torch.distributed as dist
    assert dist.reshard is prs
    with pytest.raises(NotInThisSlice, match="auto_parallel"):
        dist.reshard(np.zeros(2), None, None)
