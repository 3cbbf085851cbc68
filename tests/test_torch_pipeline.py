"""The port's pipeline schedules (``paddle_tpu_torch.parallel.pipeline``)
against ``paddle_tpu.parallel.pipeline`` on the same stage function and
inputs.

The stage is ``tanh(x W + b)`` per layer (as tests/test_pipeline_schedules.py
uses it), the head ``y Wo``. Each schedule runs on gloo CPU ranks of a pp
axis (``tests/torch_dist.py``), the JAX function on a pp mesh of the
8-device CPU platform; both take the same numpy weights and microbatches.
Cases: pp2 with M = S and M > S, pp4 with M = S and M = 2S, vpp with two
chunks a rank. The ``ce`` loss has ignored (-100) labels spread unevenly
over the microbatches: gpipe and vpp take the valid-label mean over the
whole batch, 1f1b the mean of the microbatches' means (pipeline.py:305),
and the two differ. Losses are held at rtol 1e-5, grads, dx and outputs
at rtol 1e-4 / atol 1e-5 (fp32; the JAX test's tolerances).
"""
import jax
import jax.numpy as jnp
import functools

import numpy as np
import pytest

from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import pipeline as JP
from paddle_tpu_torch.parallel import pipeline as TP

import torch_dist

H, MB, C = 8, 2, 5      # hidden, rows a microbatch, classes
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5


def _labels(r, M, kind):
    if kind == "mse":
        return r.randn(M, MB, C).astype(np.float32)
    lab = r.randint(0, C, (M, MB)).astype(np.int64)
    lab[0, :] = -100                 # microbatch 0 has no valid label
    lab[1 % M, 0] = -100             # microbatch 1 has one
    return lab


def _case(name, schedule, S, M, loss="ce", v=1, layers_per_stage=1,
          seed=0, remat=True):
    r = np.random.RandomState(seed)
    L = S * v * layers_per_stage
    return dict(name=name, schedule=schedule, S=S, M=M, v=v, loss=loss,
                remat=remat,
                params={"w": (r.randn(L, H, H) * 0.5).astype(np.float32),
                        "b": (r.randn(L, H) * 0.1).astype(np.float32)},
                wo=(r.randn(H, C) * 0.5).astype(np.float32),
                x=r.randn(M, MB, H).astype(np.float32),
                labels=_labels(r, M, loss))


CASES = [
    _case("gpipe_pp2_m2", "gpipe", 2, 2, seed=1),
    _case("gpipe_pp2_m6", "gpipe", 2, 6, seed=2, layers_per_stage=2),
    _case("gpipe_pp2_m4_noremat", "gpipe", 2, 4, seed=3, remat=False),
    _case("1f1b_pp2_m2", "1f1b", 2, 2, seed=4),
    _case("1f1b_pp2_m6", "1f1b", 2, 6, seed=5, layers_per_stage=2),
    _case("1f1b_compact_pp2_m2", "1f1b_compact", 2, 2, seed=6),
    _case("1f1b_compact_pp2_m6", "1f1b_compact", 2, 6, seed=7),
    _case("vpp_pp2_m2", "vpp", 2, 2, v=2, seed=8),
    _case("vpp_pp2_m6", "vpp", 2, 6, v=2, seed=9),
    _case("mse_1f1b_pp2_m4", "1f1b", 2, 4, loss="mse", seed=10),
    _case("gpipe_pp4_m4", "gpipe", 4, 4, seed=11),
    _case("1f1b_pp4_m4", "1f1b", 4, 4, seed=12),
    _case("1f1b_pp4_m8", "1f1b", 4, 8, seed=13),
    _case("1f1b_compact_pp4_m8", "1f1b_compact", 4, 8, seed=14),
    _case("vpp_pp4_m8", "vpp", 4, 8, v=2, seed=15),
]
BY_NAME = {c["name"]: c for c in CASES}
# the uneven-label pair: the same weights and inputs under both semantics
PAIR = dict(CASES[3], name="gpipe_as_1f1b_pp2_m2", schedule="gpipe")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    jobs = []
    for S in (2, 4):
        cases = [c for c in CASES + [PAIR] if c["S"] == S]

        def job(S=S, cases=cases):
            res = torch_dist.spawn("pipeline", S, tmp, {"mesh": {"pp": S},
                                                         "cases": cases},
                                   timeout=90)
            return {c["name"]: [r[c["name"]] for r in res] for c in cases}
        jobs.append(([c["name"] for c in cases], job))
    runs = torch_dist.Background(jobs)      # spawns beside the JAX side
    yield runs
    runs.join()


# ---- the JAX side ---------------------------------------------------------

def _j_stage(params, x):
    w, b = params["w"], params["b"]
    if w.ndim == 2:
        return jnp.tanh(x @ w + b)
    for j in range(w.shape[0]):
        x = jnp.tanh(x @ w[j] + b[j])
    return x


def _j_mb_loss(kind):
    def mse(head, y, labels):
        return jnp.mean((y @ head["wo"] - labels) ** 2)

    def ce(head, y, labels):
        logits = (y @ head["wo"]).reshape(-1, C)
        lab = labels.reshape(-1)
        valid = lab != -100
        lse = jax.nn.logsumexp(logits, axis=-1)
        at = jnp.take_along_axis(logits, jnp.where(valid, lab, 0)[:, None],
                                 axis=-1)[:, 0]
        rows = jnp.where(valid, lse - at, 0.0)
        return rows.sum() / jnp.maximum(valid.sum(), 1)
    return {"mse": mse, "ce": ce}[kind]


def _j_total_loss(kind, head, y, labels):
    M = y.shape[0]
    if kind == "mse":
        return _j_mb_loss("mse")(head, y.reshape(-1, H),
                                 labels.reshape(-1, C))
    return _j_mb_loss("ce")(head, y.reshape(M * MB, H), labels.reshape(-1))


@functools.lru_cache(maxsize=None)
def _jax(name):
    case = {**BY_NAME, PAIR["name"]: PAIR}[name]
    S, M, v = case["S"], case["M"], case["v"]
    mesh = jmesh.init_mesh({"pp": S})
    try:
        flat = {k: jnp.asarray(a) for k, a in case["params"].items()}
        head = {"wo": jnp.asarray(case["wo"])}
        x = jnp.asarray(case["x"])
        labels = jnp.asarray(case["labels"])
        sched = case["schedule"]
        if sched in ("gpipe", "vpp"):
            def loss_of(p, h, xx):
                if sched == "vpp":
                    p = {k: a.reshape(v, S, *a.shape[1:])
                         for k, a in p.items()}
                y = JP.spmd_pipeline(_j_stage, p, xx, n_microbatches=M,
                                     mesh=mesh, schedule=sched, n_virtual=v,
                                     remat=case["remat"])
                return _j_total_loss(case["loss"], h, y, labels), y
            (loss, y), (gp, gh, dx) = jax.value_and_grad(
                loss_of, argnums=(0, 1, 2), has_aux=True)(flat, head, x)
            if sched == "vpp":
                gp = {k: a.reshape(v, S, *a.shape[1:]) for k, a in gp.items()}
            return float(loss), gp, gh, dx, y
        loss, gp, gh, dx = JP.spmd_pipeline_1f1b(
            _j_stage, _j_mb_loss(case["loss"]), flat, head, x, labels,
            n_microbatches=M, mesh=mesh,
            variant="compact" if sched == "1f1b_compact" else "fused")
        return float(loss), gp, gh, dx, None
    finally:
        jmesh.set_mesh(None)


def _rank_slice(case, a, i):
    S, v = case["S"], case["v"]
    a = np.asarray(a)
    if case["schedule"] == "vpp":
        return a[:, i]
    n = a.shape[0] // S
    return a[i * n:(i + 1) * n]


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_schedule_matches_jax(port, name):
    """Loss, every rank's stage grads, the head grads, dx and (gpipe, vpp)
    the outputs equal the JAX schedule's on every pp rank."""
    case = BY_NAME[name]
    loss, gp, gh, dx, y = _jax(name)
    for i, res in enumerate(port[name]):
        np.testing.assert_allclose(res["loss"], loss, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {i}")
        for k in gp:
            np.testing.assert_allclose(res["g_stage"][k],
                                       _rank_slice(case, gp[k], i),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} rank {i} {k}")
        np.testing.assert_allclose(res["g_head"]["wo"], np.asarray(gh["wo"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res["dx"], np.asarray(dx), rtol=RTOL,
                                   atol=ATOL)
        if y is not None:
            np.testing.assert_allclose(res["y"], np.asarray(y), rtol=RTOL,
                                       atol=ATOL)


def test_uneven_labels_two_loss_semantics(port):
    """With microbatches of 0, 1 and 2 valid labels, 1f1b's mean of the
    microbatch means differs from gpipe's valid-label mean over the
    batch; each equals its JAX twin."""
    f1b, gp = port["1f1b_pp2_m2"][0]["loss"], \
        port["gpipe_as_1f1b_pp2_m2"][0]["loss"]
    assert abs(f1b - gp) > 1e-3 * abs(gp)
    np.testing.assert_allclose(gp, _jax(PAIR["name"])[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(f1b, _jax("1f1b_pp2_m2")[0],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if c["schedule"].startswith("1f1b")])
def test_1f1b_stash_stays_within_the_jax_bound(port, name):
    """Each rank's real stash peak is within the JAX bound (min(2S-1, M)
    fused, min(S, M) compact); a slot overwritten while needed would have
    raised in the rank. Ranks after the first stash something; the clock
    is M + 2(S-1) rounds (fused) or 2(M+S-1) ticks (compact)."""
    case = BY_NAME[name]
    S, M = case["S"], case["M"]
    bound = TP.activation_stash_microbatches(case["schedule"], S, M)
    assert bound == JP.activation_stash_microbatches(case["schedule"], S, M)
    for i, res in enumerate(port[name]):
        info = res["info"]
        assert info["stash_peak"] <= bound
        if i:
            assert info["stash_peak"] >= 1
        ticks = M + 2 * (S - 1) if case["schedule"] == "1f1b" \
            else 2 * (M + S - 1)
        assert info["ticks"] == ticks
        if case["schedule"] == "1f1b_compact":
            assert info["busy"] == 2 * M
        else:
            rounds = set(range(i, i + M)) | set(
                range(2 * (S - 1) - i, 2 * (S - 1) - i + M))
            assert info["busy"] == len(rounds)


def test_idle_ticks_follow_the_clock(port):
    """gpipe's forward and reversed clocks have M busy ticks of M + S - 1
    each; vpp's M v of M v + S - 1."""
    for name in ("gpipe_pp2_m6", "gpipe_pp4_m4", "vpp_pp4_m8"):
        case = BY_NAME[name]
        S, M, v = case["S"], case["M"], case["v"]
        for res in port[name]:
            assert res["info"]["ticks"] == 2 * (M * v + S - 1)
            assert res["info"]["busy"] == 2 * M * v


@pytest.mark.parametrize("sched", ["1f1b", "1f1b_fused", "1f1b_compact",
                                   "gpipe", "vpp"])
def test_activation_stash_microbatches_equals_jax(sched):
    for S in (1, 2, 4, 8):
        for M in (1, 3, 8, 16):
            for v in (1, 2):
                assert TP.activation_stash_microbatches(sched, S, M, v) == \
                    JP.activation_stash_microbatches(sched, S, M, v)
    with pytest.raises(ValueError):
        TP.activation_stash_microbatches("zigzag", 2, 2)


def test_stack_stage_params_equals_jax():
    r = np.random.RandomState(0)
    per = [{"w": r.randn(3, 4).astype(np.float32),
            "b": [r.randn(4).astype(np.float32)]} for _ in range(3)]
    import torch
    got = TP.stack_stage_params([{"w": torch.from_numpy(p["w"]),
                                  "b": [torch.from_numpy(p["b"][0])]}
                                 for p in per])
    want = JP.stack_stage_params([{"w": jnp.asarray(p["w"]),
                                   "b": [jnp.asarray(p["b"][0])]}
                                  for p in per])
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.asarray(want["b"][0]))


def test_unknown_schedules_raise():
    import torch
    x = torch.zeros(2, 1, H)
    with pytest.raises(ValueError, match="unknown schedule"):
        TP.spmd_pipeline(lambda p, v: v, {}, x, n_microbatches=2,
                         schedule="1f1b")
    with pytest.raises(ValueError, match="variant"):
        TP.spmd_pipeline_1f1b(lambda p, v: v, None, {}, {}, x, x,
                              n_microbatches=2, variant="zigzag")
