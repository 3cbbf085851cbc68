"""The port's deployment predictor against the JAX package's.

``inference.Config`` (the card by default, the CPU after
``disable_gpu()``), the handle API (``get_input_handle``,
``copy_from_cpu``, ``run``, ``copy_to_cpu``) and ``run(inputs)``, the
``_validate`` errors of the JAX types, ``clone`` and ``PredictorPool``
sharing the weight storage, the enums and helpers, and
``convert_to_mixed_precision`` on the port's own files (the JAX one
cannot read what its ``jit.save`` writes). The model is ResNet-18 (eval,
the JAX weights carried over), saved once with a dynamic batch and run at
batch 1 and 3 against the JAX predictor's outputs, fp32 at rtol 1e-4 /
atol 1e-5 (conv and BatchNorm sum in another order per layer, over 18
layers).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu import inference as jinf
from paddle_tpu.vision.models import resnet as jres
import paddle_tpu_torch as P
from paddle_tpu_torch import inference
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.models.gpt import load_paddle_tpu_state
from paddle_tpu_torch.vision.models import resnet as pres


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """ResNet-18 (JAX weights in the port model) saved by both packages
    with ``InputSpec([None, 3, 32, 32])``."""
    d = tmp_path_factory.mktemp("resnet")
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    J.seed(21)
    jm = jres.resnet18(num_classes=10)
    jm.eval()
    pm = pres.resnet18(num_classes=10, device="cpu")
    load_paddle_tpu_state(pm, {k: np.asarray(v.numpy()).copy()
                               for k, v in jm.state_dict().items()})
    pm.eval()
    J.jit.save(jm, str(d / "j"), input_spec=[
        J.jit.InputSpec([None, 3, 32, 32], "float32", name="image")])
    P.jit.save(pm, str(d / "p"), input_spec=[
        P.jit.InputSpec([None, 3, 32, 32], "float32", name="image")])
    pdev._state.device = prev
    return d, jm, pm


def _config(d, name="p"):
    c = inference.Config(str(d / name) + ".pdmodel")
    c.disable_gpu()
    return c


def test_config_defaults_to_the_card():
    c = inference.Config("model.pdmodel")
    assert c.model_prefix == "model" and c.use_gpu()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            c.device()
    c.disable_gpu()
    assert not c.use_gpu() and c.device() == torch.device("cpu")
    c.set_model("other.pdmodel")
    assert c.model_dir() == "other"
    c.enable_use_gpu(256, 0)
    assert c.use_gpu() and "other" in c.summary()
    c.switch_ir_optim(False)
    c.enable_memory_optim(False)
    jc = jinf.Config("model.pdmodel")
    assert jc.model_prefix == "model"


def test_resnet18_dynamic_batch_against_the_jax_predictor(saved):
    d, jm, pm = saved
    pred = inference.create_predictor(_config(d))
    jc = jinf.Config(str(d / "j") + ".pdmodel")
    jpred = jinf.create_predictor(jc)
    assert pred.get_input_names() == jpred.get_input_names() == ["image"]
    rng = np.random.RandomState(3)
    for bs in (1, 3):
        x = rng.randn(bs, 3, 32, 32).astype(np.float32)
        h = pred.get_input_handle("image")
        h.copy_from_cpu(x)
        assert pred.run() is True
        name = pred.get_output_names()[0]
        got = pred.get_output_handle(name).copy_to_cpu()
        jh = jpred.get_input_handle("image")
        jh.copy_from_cpu(x)
        jpred.run()
        want = jpred.get_output_handle(
            jpred.get_output_names()[0]).copy_to_cpu()
        assert got.shape == (bs, 10)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        (direct,) = pred.run([x])
        np.testing.assert_array_equal(direct.numpy(), got)
        eager = pm(P.to_tensor(x)).detach().numpy()
        np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-6)


def test_validate_errors_match_the_jax_types(saved):
    d, _, _ = saved
    pred = inference.create_predictor(_config(d))
    jpred = jinf.create_predictor(jinf.Config(str(d / "j")))
    good = np.zeros((2, 3, 32, 32), np.float32)
    cases = [([good, good], ValueError, "input"),
             ([good.astype(np.float64)], TypeError, "dtype float32"),
             ([np.zeros((2, 3, 16, 32), np.float32)], ValueError,
              "expects shape")]
    for vals, exc, msg in cases:
        with pytest.raises(exc, match=msg):
            pred.run(vals)
        with pytest.raises(exc, match=msg):
            jpred.run(vals)
    fresh = inference.create_predictor(_config(d))
    with pytest.raises(ValueError, match="never filled"):
        fresh.run()
    with pytest.raises(ValueError, match="no model path"):
        inference.Predictor(inference.Config())


def test_clone_and_pool_share_the_weight_storage(saved):
    d, _, _ = saved
    pred = inference.create_predictor(_config(d))
    twin = pred.clone()
    ptrs = [t.data_ptr() for t in pred._layer._param_vals]
    assert [t.data_ptr() for t in twin._layer._param_vals] == ptrs
    pool = inference.PredictorPool(_config(d), size=3)
    base = [t.data_ptr() for t in pool.retrieve(0)._layer._param_vals]
    for i in (1, 2):
        assert [t.data_ptr() for t in
                pool.retrieve(i)._layer._param_vals] == base
    x = np.ones((2, 3, 32, 32), np.float32)
    a = pool.retrieve(1).run([x])[0].numpy()
    b = pool.retrieve(2).run([x])[0].numpy()
    np.testing.assert_array_equal(a, b)
    pred.try_shrink_memory()


def test_enums_and_helpers_match_the_jax_module():
    for cls in ("DataType", "PlaceType", "PrecisionType"):
        jv = {k: v for k, v in vars(getattr(jinf, cls)).items()
              if not k.startswith("_")}
        pv = {k: v for k, v in vars(getattr(inference, cls)).items()
              if not k.startswith("_")}
        assert pv == jv, cls
    for dt in ("float32", "float16", "bfloat16", "int64", "int32", "int8",
               "uint8", "bool"):
        assert inference.get_num_bytes_of_data_type(dt) == \
            jinf.get_num_bytes_of_data_type(dt)
    assert inference.get_trt_compile_version() == (0, 0, 0)
    assert inference.get_trt_runtime_version() == (0, 0, 0)
    assert inference._get_phi_kernel_name("conv2d") == "conv2d"
    assert "torch" in inference.get_version()
    assert inference.XpuConfig(a=1).a == 1


def test_convert_to_mixed_precision_on_the_port_files(saved, tmp_path):
    """fp16 and bf16 weights written from the port's own files (the JAX
    converter fails on the files its own jit.save wrote); the converted
    model loads, its program casting the weights back, and stays near the
    fp32 outputs."""
    d, _, _ = saved
    with pytest.raises(FileNotFoundError):
        jinf.convert_to_mixed_precision(
            str(d / "j.pdmodel"), str(d / "j.pdiparams"),
            str(tmp_path / "jh.pdmodel"), str(tmp_path / "jh.pdiparams"),
            "float16")
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    ref = inference.create_predictor(_config(d)).run([x])[0].numpy()
    for prec, want_dtype in (("float16", np.float16),
                             (inference.PrecisionType.Bfloat16,
                              np.dtype("V2"))):
        out = tmp_path / f"m_{want_dtype}"
        inference.convert_to_mixed_precision(
            str(d / "p.pdmodel"), str(d / "p.pdiparams"),
            str(out) + ".pdmodel", str(out) + ".pdiparams", prec)
        with np.load(str(out) + ".pdiparams") as npz:
            assert npz["0"].dtype == want_dtype
        c = inference.Config(str(out) + ".pdmodel")
        c.disable_gpu()
        got = inference.create_predictor(c).run([x])[0].numpy()
        assert np.abs(got - ref).max() <= 0.1 * np.abs(ref).max()
