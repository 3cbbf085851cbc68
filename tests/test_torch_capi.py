"""The port's serving C ABI (``paddle_tpu_torch/csrc/predictor_capi.cc``)
on the CPU: ``utils.native.build_capi`` builds it,
``tests/torch_capi_smoke.c`` is compiled with ``gcc -ldl`` and serves two
``jit.save``d models (an MLP on float features, an embedding model on
int64 ids) in a process of its own with ``PDT_PLATFORM=cpu``, and its
outputs must be bitwise the in-process port Predictor's on the same
inputs (as ``tests/test_inference_capi.py`` holds the JAX ABI against the
JAX model). The int64 input path, the refusals and the library joining an
interpreter that is already running are checked in this process through
``ctypes``.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch import inference, nn
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.utils.native import build_capi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_C = os.path.join(REPO, "tests", "torch_capi_smoke.c")


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


@pytest.fixture(scope="module")
def capi(tmp_path_factory):
    so = build_capi()
    exe = str(tmp_path_factory.mktemp("capi") / "torch_capi_smoke")
    subprocess.run(["gcc", "-O1", SMOKE_C, "-o", exe, "-ldl"], check=True)
    return so, exe


def _env(so, platform="cpu"):
    env = dict(os.environ)
    env.update(PDT_PLATFORM=platform, PDT_PYTHON=sys.executable,
               LD_LIBRARY_PATH=os.path.dirname(so) + ":"
               + env.get("LD_LIBRARY_PATH", ""),
               PYTHONPATH=REPO + ":" + env.get("PYTHONPATH", ""))
    return env


def _predict(prefix, x):
    c = inference.Config(prefix)
    c.disable_gpu()
    pred = inference.create_predictor(c)
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(x)
    pred.run()
    return pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()


def _ids_model(tmp_path):
    P.seed(1, "cpu")
    net = nn.Sequential(nn.Embedding(50, 8, device="cpu"),
                        nn.Linear(8, 4, device="cpu"))
    prefix = str(tmp_path / "ids")
    P.jit.save(net, prefix, input_spec=[P.jit.InputSpec(
        [2, 5], "int64", name="input_ids")])
    return prefix, np.random.RandomState(2).randint(0, 50, (2, 5)).astype(
        np.int64)


def test_c_program_serves_saved_models(capi, tmp_path):
    """One C process serves an MLP (float features, a dynamic batch at 3
    and 5) and an embedding model (int64 ids): every output bitwise the
    in-process Predictor's."""
    so, exe = capi
    P.seed(0, "cpu")
    mlp = nn.Sequential(nn.Linear(16, 32, device="cpu"), nn.ReLU(),
                        nn.Linear(32, 8, device="cpu"))
    prefix = str(tmp_path / "served")
    P.jit.save(mlp, prefix, input_spec=[P.jit.InputSpec(
        [None, 16], "float32", name="feats")])
    ids_prefix, ids = _ids_model(tmp_path)
    rs = np.random.RandomState(0)
    xs = [rs.standard_normal((n, 16)).astype(np.float32) for n in (3, 5)]
    with open(tmp_path / "x.bin", "wb") as f:
        for a in (*xs, ids):
            a.tofile(f)
    r = subprocess.run([exe, "2", str(tmp_path / "x.bin"),
                        str(tmp_path / "y.bin"), prefix, "f32", "3x16",
                        "5x16", "--", ids_prefix, "i64", "2x5"],
                       capture_output=True, text=True, env=_env(so),
                       timeout=300)
    assert r.returncode == 0, f"stderr: {r.stderr}\nstdout: {r.stdout}"
    lines = [ln.split() for ln in r.stdout.splitlines()]
    assert ["IO", "feats", "->", "output_0"] in lines and \
        ["IO", "input_ids", "->", "output_0"] in lines
    assert ["SHAPE", "3x16", "3", "8"] in lines and \
        ["SHAPE", "5x16", "5", "8"] in lines and \
        ["SHAPE", "2x5", "2", "5", "4"] in lines
    runs = [ln for ln in lines if ln[0] == "RUN_MS"]
    assert [len(ln) for ln in runs] == [4, 4, 4]
    assert [ln[1] for ln in lines if ln[0] == "MODEL"] == [prefix,
                                                          ids_prefix]
    assert float(next(ln[1] for ln in lines if ln[0] == "STARTUP_S")) > 0
    got = np.fromfile(tmp_path / "y.bin", np.float32)
    want = np.concatenate([_predict(prefix, x).ravel() for x in xs]
                          + [_predict(ids_prefix, ids).ravel()])
    np.testing.assert_array_equal(got, want)
    with torch.no_grad():
        np.testing.assert_allclose(got[:24].reshape(3, 8),
                                   mlp(P.to_tensor(xs[0])).numpy(),
                                   rtol=1e-6, atol=1e-6)
    bad = subprocess.run([exe, "1", str(tmp_path / "x.bin"),
                          str(tmp_path / "y.bin"), prefix, "f32", "3x16"],
                         capture_output=True, text=True,
                         env=_env(so, "tpu"), timeout=60)
    assert bad.returncode == 1 and "init: unsupported platform" in bad.stderr


def _bind(so):
    lib = ctypes.CDLL(so)
    c = ctypes
    for name, res, args in (
            ("PDT_Init", c.c_int, [c.c_char_p]),
            ("PDT_GetLastError", c.c_char_p, []),
            ("PDT_ConfigCreate", c.c_void_p, []),
            ("PDT_ConfigSetModel", None, [c.c_void_p, c.c_char_p]),
            ("PDT_ConfigDestroy", None, [c.c_void_p]),
            ("PDT_PredictorCreate", c.c_void_p, [c.c_void_p]),
            ("PDT_PredictorDestroy", None, [c.c_void_p]),
            ("PDT_PredictorGetInputName", c.c_char_p, [c.c_void_p,
                                                       c.c_size_t]),
            ("PDT_PredictorGetOutputName", c.c_char_p, [c.c_void_p,
                                                        c.c_size_t]),
            ("PDT_PredictorGetInputHandle", c.c_void_p, [c.c_void_p,
                                                         c.c_char_p]),
            ("PDT_PredictorGetOutputHandle", c.c_void_p, [c.c_void_p,
                                                          c.c_char_p]),
            ("PDT_TensorReshape", c.c_int, [c.c_void_p,
                                            c.POINTER(c.c_int), c.c_int]),
            ("PDT_TensorCopyFromCpuInt64", c.c_int, [
                c.c_void_p, c.POINTER(c.c_int64), c.c_size_t]),
            ("PDT_PredictorRun", c.c_int, [c.c_void_p]),
            ("PDT_TensorCopyToCpuFloat", c.c_int, [
                c.c_void_p, c.POINTER(c.c_float), c.c_size_t]),
            ("PDT_TensorDestroy", None, [c.c_void_p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def test_abi_in_this_interpreter_int64_ids_and_refusals(capi, tmp_path):
    so, _ = capi
    prefix, ids = _ids_model(tmp_path)
    lib = _bind(so)
    assert lib.PDT_Init(b"tpu") == -1
    assert b"unsupported platform" in lib.PDT_GetLastError()
    assert lib.PDT_Init(b"cpu") == 0        # joins this interpreter
    cfg = lib.PDT_ConfigCreate()
    lib.PDT_ConfigSetModel(cfg, str(tmp_path / "missing").encode())
    assert not lib.PDT_PredictorCreate(cfg)
    assert b"missing" in lib.PDT_GetLastError()
    lib.PDT_ConfigSetModel(cfg, prefix.encode())
    pred = lib.PDT_PredictorCreate(cfg)
    assert pred, lib.PDT_GetLastError()
    assert lib.PDT_PredictorGetInputName(pred, 0) == b"input_ids"
    h = lib.PDT_PredictorGetInputHandle(pred, b"input_ids")
    dims = (ctypes.c_int * 2)(2, 5)
    assert lib.PDT_TensorReshape(h, dims, 2) == 0
    assert lib.PDT_TensorCopyFromCpuInt64(
        h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ids.size) == 0
    assert lib.PDT_PredictorRun(pred) == 0, lib.PDT_GetLastError()
    out = lib.PDT_PredictorGetOutputHandle(
        pred, lib.PDT_PredictorGetOutputName(pred, 0))
    got = np.zeros((2, 5, 4), np.float32)
    assert lib.PDT_TensorCopyToCpuFloat(
        out, got.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        got.size) == 0
    for t in (out, h):
        lib.PDT_TensorDestroy(t)
    lib.PDT_PredictorDestroy(pred)
    lib.PDT_ConfigDestroy(cfg)
    np.testing.assert_array_equal(got, _predict(prefix, ids))
