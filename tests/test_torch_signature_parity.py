"""Signature parity: every public name that a port module shares with its
``paddle_tpu`` counterpart (``paddle_tpu_torch.X.Y`` against
``paddle_tpu.X.Y``) accepts every reference parameter, and takes the
reference's positional parameters first, in the reference's order. For a
class both its constructor and the methods the port class defines itself
are checked (methods a port class inherits from ``torch.nn.Module`` stand
for Paddle's ``Layer`` API and are not the port's). Port-only knobs are
free to follow, keyword-only.

``ALLOWED`` lists the differences the port makes on purpose, each with
its reason (ROADMAP.md "Deliberate differences"); an entry that no longer
differs fails the test, so the list stays true.
"""
import importlib
import inspect
import pkgutil

import pytest

import paddle_tpu_torch

ALLOWED = {
    "core.tensor.Tensor.astype":
        "the JAX method is installed as a lambda `(s, d)`; the port's is "
        "a method of the class, `(self, dtype)`",
    "core.tensor.Parameter.astype":
        "inherits Tensor.astype: `(self, dtype)` against the lambda's "
        "`(s, d)`",
    "ops.dispatch.apply":
        "runs a torch function (`fn`) where the JAX one runs a jax "
        "function (`jax_fn`)",
    "ops.dispatch.defprim":
        "lifts a torch function (`fn`), not a jax function (`jax_fn`)",
    "distributed.comms.quantize.quantize_blockwise":
        "takes a torch.Generator (`generator`) for stochastic rounding "
        "where the JAX function takes a PRNG key",
    "jit.capture.CapturedStep":
        "a CUDA graph keeps its inputs' addresses (`inplace`); XLA's "
        "`donate`, `allow_baked_rng` and its jaxpr `passes` have no "
        "counterpart",
    "jit.capture.capture_step":
        "as CapturedStep: `inplace` instead of `donate`; no baked-RNG "
        "check or jaxpr passes",
    "jit.capture.lower_step":
        "a CUDA graph holds the step's state by address (`inplace`) where "
        "XLA donates buffers (`donate_argnums`); there are no shardings to "
        "pin (each rank is a process) and no jaxpr `passes` "
        "(jit/passes/__init__.py)",
    "jit.passes.lint.analyze":
        "reads the warm-up's record of the step (`program`), where the JAX "
        "rule reads a closed jaxpr (`closed`)",
    "jit.passes.lint.record_lint":
        "as analyze: the step's record (`program`), not a closed jaxpr",
    "static.framework.Variable.astype":
        "inherits Tensor.astype: `(self, dtype)` against the lambda's "
        "`(s, d)`",
    "static.graft_program.GraftProgram":
        "views the port's captured step (`captured`: a jit.program."
        "CapturedProgram, one CUDA graph); there is no closed jaxpr, "
        "avals or donation to pass in",
}


def _pairs():
    """(qualified name, port object, reference object) of every shared
    public function, class constructor and own method."""
    out = []
    mods = ["paddle_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                              "paddle_tpu_torch.")]
    for name in mods:
        ref_name = "paddle_tpu" + name[len("paddle_tpu_torch"):]
        try:
            rm = importlib.import_module(ref_name)
        except ImportError:
            continue            # a port-only module (the CUDA kernels)
        pm = importlib.import_module(name)
        rel = name[len("paddle_tpu_torch."):] if "." in name else ""
        for attr in dir(pm):
            if attr.startswith("_") or not hasattr(rm, attr):
                continue
            po, ro = getattr(pm, attr), getattr(rm, attr)
            if inspect.ismodule(po) or not callable(po) or not callable(ro):
                continue
            if getattr(po, "__module__", None) != name:
                continue        # re-exported: checked where it is defined
            key = f"{rel}.{attr}" if rel else attr
            out.append((key, po, ro))
            if inspect.isclass(po) and inspect.isclass(ro):
                for meth in dir(ro):
                    if meth.startswith("_") or not hasattr(po, meth):
                        continue
                    own = any(meth in k.__dict__ for k in po.__mro__
                              if k.__module__.startswith("paddle_tpu_torch"))
                    pf, rf = getattr(po, meth), getattr(ro, meth)
                    if own and callable(pf) and callable(rf) \
                            and not inspect.isclass(pf):
                        out.append((f"{key}.{meth}", pf, rf))
    return out


def _params(obj):
    try:
        sig = inspect.signature(obj.__init__ if inspect.isclass(obj)
                                else obj)
    except (TypeError, ValueError):
        return None
    return [p for p in sig.parameters.values() if p.name != "self"]


def _mismatch(port, ref):
    """What the port's signature lacks against the reference's."""
    pp, rp = _params(port), _params(ref)
    if pp is None or rp is None:
        return []
    kinds = {p.kind for p in pp}
    names = {p.name for p in pp}
    pos_kinds = (inspect.Parameter.POSITIONAL_ONLY,
                 inspect.Parameter.POSITIONAL_OR_KEYWORD)
    out = []
    for p in rp:
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if p.name not in names and inspect.Parameter.VAR_KEYWORD not in kinds:
            out.append(f"missing {p.name!r}")
    rpos = [p.name for p in rp if p.kind in pos_kinds]
    ppos = [p.name for p in pp if p.kind in pos_kinds]
    var_pos_only = not ppos and inspect.Parameter.VAR_POSITIONAL in kinds
    if ppos[:len(rpos)] != rpos and not var_pos_only:
        out.append(f"positional order {ppos} against {rpos}")
    return out


PAIRS = _pairs()


def test_enough_shared_names_are_checked():
    """The walk finds the port's shared surface (guards against a vacuous
    pass): the mesh, comms, fleet, pipeline, trainer and model names."""
    keys = {k for k, _, _ in PAIRS}
    assert len(PAIRS) >= 600
    for must in ("parallel.mesh.init_mesh", "distributed.env.init_parallel_env",
                 "distributed.comms.api.grad_sync",
                 "parallel.context_parallel.ring_attention",
                 "parallel.context_parallel.ulysses_attention",
                 "parallel.pipeline.spmd_pipeline_1f1b",
                 "distributed.fleet.fleet.init",
                 "distributed.fleet.topology.HybridCommunicateGroup",
                 "distributed.fleet.meta_parallel.mp_layers."
                 "ColumnParallelLinear",
                 "distributed.fleet.meta_parallel.sharding_optimizer."
                 "group_sharded_parallel",
                 "inference.serving.request.Request.finish",
                 "nn.functional.common.linear",
                 "nn.functional.common.embedding",
                 "nn.functional.activation.relu",
                 "nn.functional.activation.sigmoid",
                 "nn.functional.loss.binary_cross_entropy_with_logits",
                 "nn.functional.common.interpolate",
                 "nn.functional.norm.batch_norm",
                 "nn.functional.loss.ctc_loss",
                 "nn.functional.attention.scaled_dot_product_attention",
                 "nn.layer.activation.LeakyReLU", "nn.layer.norm.LayerNorm",
                 "nn.layer.norm.BatchNorm2D", "nn.layer.loss.CTCLoss",
                 "nn.layer.container.LayerDict",
                 "nn.layer.transformer.MultiHeadAttention",
                 "nn.initializer.TruncatedNormal", "regularizer.L2Decay",
                 "models.gpt.GPTForCausalLM",
                 "models.gpt.GPTForCausalLM.generate",
                 "ops.breadth.pdist", "ops.breadth.where_",
                 "device.Stream", "device.memory_stats",
                 "profiler.profiler.Profiler",
                 "profiler.profiler.make_scheduler",
                 "profiler.statistic.summary", "profiler.timer.Benchmark",
                 "core.device.device_count",
                 "nn.layer.common.Embedding", "models.deepfm.DeepFM",
                 "models.deepfm.DeepFM.predict",
                 "distributed.embedding.sharded.ShardedEmbedding",
                 "distributed.embedding.sharded.sharded_lookup",
                 "distributed.embedding.sharded.hash_bucket",
                 "distributed.embedding.sharded.table_param_spec",
                 "jit.capture.lower_step", "jit.passes.PassReport",
                 "jit.passes.lint.analyze",
                 "profiler.statistic.step_capture_summary",
                 "profiler.statistic.lint_summary",
                 "core.tensor.Tensor", "core.tensor.Parameter",
                 "ops.math.add", "ops.math.sum", "ops.manip.transpose",
                 "ops.creation.to_tensor", "ops.linalg.svd",
                 "ops.random.randn", "autograd.backward.grad",
                 "autograd.py_layer.PyLayer.apply",
                 "autograd.functional.jacobian", "amp.auto_cast.decorate",
                 "amp.debugging.check_numerics",
                 "nn.layer.layers.Layer.state_dict",
                 "nn.layer.layers.Layer.to", "nn.layer.layers.Layer.train",
                 "nn.layer.layers.Layer.parameters",
                 "utils.flags.set_flags", "framework_io.save",
                 "framework_compat.ParamAttr",
                 "nn.functional.conv.conv2d",
                 "nn.functional.conv.conv3d_transpose",
                 "nn.functional.pooling.max_pool2d",
                 "nn.functional.pooling.adaptive_avg_pool2d",
                 "nn.functional.extras.rnnt_loss",
                 "nn.functional.extras.grid_sample",
                 "nn.layer.conv.Conv2DTranspose", "nn.layer.pooling.MaxPool2D",
                 "nn.layer.rnn.LSTM", "nn.layer.rnn.GRUCell",
                 "nn.layer.extras.BeamSearchDecoder.step",
                 "nn.layer.extras.dynamic_decode",
                 "nn.utils.spectral_norm", "nn.quant.weight_quantize",
                 "vision.models.resnet.ResNet", "vision.models.resnet.resnet50",
                 "models.bert.BertForPretraining",
                 "models.bert.bert_pretraining_loss", "models.ocr.DBNet",
                 "models.ocr.ctc_rec_loss"):
        assert must in keys, must


@pytest.mark.parametrize("key", sorted({k for k, _, _ in PAIRS}))
def test_signature_accepts_the_reference_parameters(key):
    port, ref = next((p, r) for k, p, r in PAIRS if k == key)
    bad = _mismatch(port, ref)
    if key in ALLOWED:
        assert bad, f"{key} no longer differs: drop it from ALLOWED"
        return
    assert not bad, f"{key}: {'; '.join(bad)}"


def test_every_allowed_difference_has_a_reason():
    keys = {k for k, _, _ in PAIRS}
    for key, why in ALLOWED.items():
        assert key in keys, f"{key} is not a shared name"
        assert len(why.split()) >= 5, key
