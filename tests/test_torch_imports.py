"""The PyTorch port stands apart from JAX and from the JAX package.

- With ``jax`` blocked, the port's packages import and load no
  ``paddle_tpu`` or ``ml_dtypes`` module (a subprocess: conftest has
  already imported ``paddle_tpu`` in this process).
- No file of the port, and not ``chip_smoke.py`` or the port processes'
  helpers (``tests/torch_dist.py``, ``tests/torch_supervisor_member.py``,
  ``tests/torch_no_hang_child.py``, ``tests/torch_op_cases.py``), imports ``jax``, ``ml_dtypes`` or a
  ``paddle_tpu`` module.
- The entry points run on the card by default and raise without CUDA
  rather than carry on quietly on the CPU; ``chip_smoke.py`` fails
  without a card and prints no result.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.core.device import get_device, resolve_device
from paddle_tpu_torch.core.generator import seed
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_port_imports_with_jax_blocked_and_loads_no_paddle_tpu():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import paddle_tpu_torch, paddle_tpu_torch.inference.serving\n"
        "import paddle_tpu_torch.models.llama\n"
        "import paddle_tpu_torch.ops.kernels.decode_attention\n"
        "import paddle_tpu_torch.ops.kernels.flash_attention\n"
        "import paddle_tpu_torch.ops.kernels.fused_ce\n"
        "import paddle_tpu_torch.incubate.nn.functional\n"
        "import paddle_tpu_torch.optimizer, paddle_tpu_torch.nn.clip\n"
        "import paddle_tpu_torch.optimizer.lr\n"
        "import paddle_tpu_torch.optimizer.lbfgs\n"
        "import paddle_tpu_torch.ops.kernels.multi_tensor\n"
        "import paddle_tpu_torch.amp, paddle_tpu_torch.parallel\n"
        "import paddle_tpu_torch.jit.capture\n"
        "import paddle_tpu_torch.observability.metrics\n"
        "import paddle_tpu_torch.inference.serving.prefix\n"
        "import paddle_tpu_torch.inference.serving.speculative\n"
        "import paddle_tpu_torch.inference.serving.gateway\n"
        "import paddle_tpu_torch.distributed\n"
        "import paddle_tpu_torch.distributed.comms\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel\n"
        "import paddle_tpu_torch.parallel.mesh\n"
        "import paddle_tpu_torch.parallel.context_parallel\n"
        "import paddle_tpu_torch.parallel.pipeline\n"
        "import paddle_tpu_torch.parallel.trainer\n"
        "import paddle_tpu_torch.distributed.fleet\n"
        "import paddle_tpu_torch.distributed.fleet.fleet\n"
        "import paddle_tpu_torch.distributed.fleet.topology\n"
        "import paddle_tpu_torch.distributed.fleet.role_maker\n"
        "import paddle_tpu_torch.distributed.fleet.hybrid_optimizer\n"
        "import paddle_tpu_torch.distributed.fleet.distributed_strategy\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel.pp_layers\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel"
        ".parallel_wrappers\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel"
        ".sharding_optimizer\n"
        "import paddle_tpu_torch.distributed.parallel\n"
        "import paddle_tpu_torch.core.generator\n"
        "import paddle_tpu_torch.distributed.fleet.recompute\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel"
        ".random_state\n"
        "import paddle_tpu_torch.distributed.fleet.moe\n"
        "import paddle_tpu_torch.distributed.fleet.util\n"
        "import paddle_tpu_torch.distributed.fleet.utils\n"
        "import paddle_tpu_torch.distributed.sharding\n"
        "import paddle_tpu_torch.distributed.checkpoint\n"
        "import paddle_tpu_torch.distributed.ckpt_manager\n"
        "import paddle_tpu_torch.nn.layer\n"
        "import paddle_tpu_torch.utils.native\n"
        "import paddle_tpu_torch.distributed.store\n"
        "import paddle_tpu_torch.distributed.rpc\n"
        "import paddle_tpu_torch.distributed.reshard\n"
        "import paddle_tpu_torch.distributed.supervisor\n"
        "import paddle_tpu_torch.distributed.launch\n"
        "import paddle_tpu_torch.distributed.launch.elastic\n"
        "import paddle_tpu_torch.io, paddle_tpu_torch.io.streaming\n"
        "import paddle_tpu_torch.profiler\n"
        "import paddle_tpu_torch.profiler.profiler\n"
        "import paddle_tpu_torch.profiler.timer\n"
        "import paddle_tpu_torch.device, paddle_tpu_torch.regularizer\n"
        "import paddle_tpu_torch.ops.breadth\n"
        "import paddle_tpu_torch.nn.functional.activation\n"
        "import paddle_tpu_torch.nn.functional.common\n"
        "import paddle_tpu_torch.nn.functional.norm\n"
        "import paddle_tpu_torch.nn.functional.loss\n"
        "import paddle_tpu_torch.nn.functional.attention\n"
        "import paddle_tpu_torch.nn.initializer\n"
        "import paddle_tpu_torch.nn.layer.norm\n"
        "import paddle_tpu_torch.nn.layer.loss\n"
        "import paddle_tpu_torch.nn.layer.transformer\n"
        "import paddle_tpu_torch.models.gpt\n"
        "import paddle_tpu_torch.autograd, paddle_tpu_torch.linalg\n"
        "import paddle_tpu_torch.amp.debugging, paddle_tpu_torch.ops.math\n"
        "import paddle_tpu_torch.framework_io\n"
        "import paddle_tpu_torch.framework_compat\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_dist, torch_op_cases, torch_nn_cases\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not\n"
        "             None and (m == 'paddle_tpu' or m.startswith(\n"
        "             'paddle_tpu.') or m.split('.')[0] in ('jax',\n"
        "             'ml_dtypes')))\n"
        "print('LOADED', bad)\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+ml_dtypes\b|"
    r"from\s+ml_dtypes\b|import\s+paddle_tpu(?!_torch)\b|"
    r"from\s+paddle_tpu(?!_torch)\b|from\s+\.\.+\s*import\s+paddle_tpu\b)",
    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "fce_variants.py", "tests/torch_dist.py",
       "tests/torch_supervisor_member.py", "tests/torch_no_hang_child.py",
       "tests/torch_op_cases.py", "tests/torch_nn_cases.py"]))
def test_source_imports_neither_jax_nor_paddle_tpu(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path


def test_no_device_means_cuda_and_raises_without_it():
    cfg = LlamaConfig.tiny(vocab=16, hidden=16, layers=1, heads=2, inter=32)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert LlamaForCausalLM(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg)
    from paddle_tpu_torch import device, nn
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    for build in (lambda: GPTForCausalLM(GPTConfig.tiny()),
                  lambda: nn.LayerNorm(4), lambda: nn.BatchNorm2D(3),
                  lambda: nn.Linear(2, 2), device.memory_allocated,
                  device.Stream):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    with pytest.raises(RuntimeError):
        get_device()
    with pytest.raises(RuntimeError):
        seed(0)
    with pytest.raises(RuntimeError):
        LlamaForCausalLM(cfg, device="cuda")
    assert LlamaForCausalLM(cfg, device="cpu").device.type == "cpu"
    assert seed(0, "cpu").device.type == "cpu"


def test_parallel_env_defaults_to_cuda_and_nccl_and_never_switches():
    """``init_parallel_env`` runs on the card by default (raising without
    one) and chooses nccl there, gloo only on the CPU; nccl on the CPU is
    refused rather than swapped for gloo."""
    from paddle_tpu_torch.distributed import env
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            env.init_parallel_env()
        with pytest.raises(RuntimeError):
            env.init_parallel_env(backend="gloo")
    with pytest.raises(ValueError, match="nccl"):
        env.init_parallel_env(backend="nccl", device="cpu")
    assert not env.is_initialized()


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
