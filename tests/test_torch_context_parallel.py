"""``flash_attention_lse`` and context-parallel attention in the port,
against the JAX package on the CPU.

- ``flash_attention_lse``: O, the LSE and the grads of a loss on both
  outputs, against the Pallas ``flash_attention_lse`` in interpret mode
  with 128-wide blocks (as tests/test_context_parallel.py:141-179 runs
  it), MHA and GQA, causal and not; the port's CPU path is its plain
  versions through the same autograd Function the card uses. Tolerances
  as tests/test_torch_flash_attention.py: atol 2e-4 on O and LSE, 2e-3 on
  the grads.
- Ring and Ulysses attention on 2 and 4 gloo ranks of a sep axis
  (``tests/torch_dist.py``), forward and grads of q, k and v, causal and
  not, MHA and GQA, against the JAX ``sdpa_context_parallel`` on a sep
  mesh of the same size (its einsum leg on the CPU), at rtol 2e-5 / atol
  2e-5 on the output and 2e-4 on the grads.
- ``ring_attention`` and ``ulysses_attention`` called by name, in the JAX
  functions' per-rank layout ``[B, H, S_loc, D]`` with ``axis_name``
  second (every ``impl`` of the ring), against the JAX functions under
  ``shard_map`` over a sep mesh of the same size, causal and not, MHA and
  GQA, at the same tolerances.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import sdpa_context_parallel as jax_cp
from paddle_tpu.parallel import context_parallel as JCP
from paddle_tpu_torch.ops.kernels import flash_attention as fa_mod
from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention_lse

import torch_dist


@pytest.fixture
def small_blocks():
    prev = (JFA.BLOCK_Q, JFA.BLOCK_K)
    JFA.set_block_sizes(128, 128)
    yield
    JFA.set_block_sizes(*prev)


LSE_CASES = [(2, 64, 4, 32, 4, True), (1, 96, 4, 16, 2, True),
             (2, 64, 2, 32, 2, False), (1, 40, 4, 24, 1, False)]


@pytest.mark.parametrize("B,S,H,D,Hkv,causal", LSE_CASES)
def test_flash_attention_lse_matches_pallas(small_blocks, B, S, H, D, Hkv,
                                            causal):
    r = np.random.RandomState(S + H)
    q = r.randn(B, S, H, D).astype(np.float32)
    k = r.randn(B, S, Hkv, D).astype(np.float32)
    v = r.randn(B, S, Hkv, D).astype(np.float32)
    go = r.randn(B, S, H, D).astype(np.float32)
    gl = r.randn(B, H, S).astype(np.float32)

    def jloss(a, b, c):
        o, lse = JFA.flash_attention_lse(a, b, c, causal, None)
        return jnp.sum(o * go) + jnp.sum(lse * gl), (o, lse)
    (_, (jo, jlse)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = fa_mod.flash_attention_fwd.launches
    o, lse = flash_attention_lse(*ts, causal=causal)
    assert fa_mod.flash_attention_fwd.launches == before   # CPU: no kernel
    ((o * torch.from_numpy(go)).sum()
     + (lse * torch.from_numpy(gl)).sum()).backward()
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=2e-4)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               atol=2e-4)
    for t, want, name in zip(ts, jg, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=2e-3, err_msg=name)


def test_lse_cotangent_alone_reaches_the_inputs():
    """A loss on the LSE only (O unused) still has grads: the cotangent
    folds into delta (``delta - g_lse``)."""
    r = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(r.randn(1, 16, 2, 8).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    _, lse = flash_attention_lse(q, k, v, causal=True)
    lse.sum().backward()
    assert q.grad.abs().sum() > 0 and k.grad.abs().sum() > 0
    assert float(v.grad.abs().sum()) == 0.0     # d lse / d v = 0


# ---------------------------------------------------------------------------
# ring and Ulysses on ranks
# ---------------------------------------------------------------------------

def _cases(n):
    r = np.random.RandomState(20 + n)
    out = []
    for mode in ("ring", "ulysses"):
        for causal in (True, False):
            for hkv in (4, 2):
                B, S, H, D = 2, 8 * n, 4, 8
                q = r.randn(B, S, H, D).astype(np.float32)
                k = r.randn(B, S, hkv, D).astype(np.float32)
                v = r.randn(B, S, hkv, D).astype(np.float32)
                g = r.randn(B, S, H, D).astype(np.float32)
                out.append(dict(name=f"{mode}-{'causal' if causal else 'full'}"
                                f"-kv{hkv}", mode=mode, causal=causal, q=q,
                                k=k, v=v, g=g))
    return out


NAMES = [c["name"] for c in _cases(2)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cp")
    jobs = [([n], lambda n=n: {n: torch_dist.spawn(
        "cp", n, tmp, {"mesh": {"sep": n}, "cases": _cases(n)})})
        for n in (2, 4)]
    runs = torch_dist.Background(jobs)      # spawns beside the JAX side
    yield runs
    runs.join()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_context_parallel_matches_jax(port, n, name):
    case = next(c for c in _cases(n) if c["name"] == name)
    jmesh.init_mesh({"sep": n})
    try:
        ts = []
        for a in (case["q"], case["k"], case["v"]):
            t = P.to_tensor(a)
            t.stop_gradient = False
            ts.append(t)
        out = jax_cp(*ts, mode=case["mode"], is_causal=case["causal"])
        (out * P.to_tensor(case["g"])).sum().backward()
        want = [out.numpy()] + [t.grad.numpy() for t in ts]
    finally:
        jmesh.set_mesh(None)
    got = [np.concatenate([res[name][i] for res in port[n]], axis=1)
           for i in range(4)]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for a, b, nm in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=nm)


def _direct_cases():
    out = []
    r = np.random.RandomState(21)
    B, H, S, D = 1, 4, 16, 8
    for fn, impls in (("ring", ("auto", "flash", "einsum")),
                      ("ulysses", ("auto",))):
        for causal in (True, False):
            for hkv in (4, 2):
                for impl in impls:
                    out.append(dict(
                        name=f"{fn}-{impl}-{'causal' if causal else 'full'}"
                        f"-kv{hkv}", fn=fn, impl=impl, causal=causal,
                        q=r.randn(B, H, S, D).astype(np.float32),
                        k=r.randn(B, hkv, S, D).astype(np.float32),
                        v=r.randn(B, hkv, S, D).astype(np.float32),
                        g=r.randn(B, H, S, D).astype(np.float32)))
    return out


DIRECT = _direct_cases()


@pytest.fixture(scope="module")
def port_direct(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cp_direct")

    def job():
        res = torch_dist.spawn("cp_direct", 2, tmp, {"mesh": {"sep": 2},
                                                     "cases": DIRECT})
        return {c["name"]: [rk[c["name"]] for rk in res] for c in DIRECT}
    runs = torch_dist.Background([([c["name"] for c in DIRECT], job)])
    yield runs
    runs.join()


@pytest.mark.parametrize("name", [c["name"] for c in DIRECT])
def test_ring_and_ulysses_by_name_match_jax(port_direct, name):
    """The reference layout and arguments: a caller who passes
    ``[B, H, S_loc, D]`` and ``"sep"`` gets the JAX function's output
    and grads (before the repair this layout attended over the head axis,
    3.09 off)."""
    case = next(c for c in DIRECT if c["name"] == name)
    mesh = jmesh.init_mesh({"sep": 2})
    try:
        spec = jax.sharding.PartitionSpec(None, None, "sep", None)
        if case["fn"] == "ring":
            local = partial(JCP.ring_attention, axis_name="sep",
                            causal=case["causal"], impl="einsum")
        else:
            local = partial(JCP.ulysses_attention, axis_name="sep",
                            causal=case["causal"])
        f = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 3,
                                  out_specs=spec, check_vma=False))
        args = [jnp.asarray(case[k]) for k in "qkv"]
        o, vjp = jax.vjp(f, *args)
        want = [np.asarray(o)] + [np.asarray(t) for t in
                                  vjp(jnp.asarray(case["g"]))]
    finally:
        jmesh.set_mesh(None)
    got = [np.concatenate([rk[i] for rk in port_direct[name]], axis=2)
           for i in range(4)]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for a, b, nm in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=nm)


def test_ring_impl_is_checked():
    from paddle_tpu_torch.parallel.context_parallel import ring_attention
    x = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="impl"):
        ring_attention(x, x, x, "sep", impl="pallas")
