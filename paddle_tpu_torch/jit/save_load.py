"""jit.save / jit.load: a model exported for deployment.

Counterpart of ``paddle_tpu/jit/save_load.py``. The program is the
functional form ``pure(params, *inputs)`` of the layer in eval mode
(save_load.py:76-92), here a ``torch.export`` of it: the parameters and
buffers are inputs of the exported graph, so the weights live only in
``.pdiparams``. Files for ``path``:

- ``path.pdmodel``: the ``torch.export`` archive (the port's own format;
  the JAX package writes serialized StableHLO there, and neither package
  reads the other's program file);
- ``path.pdiparams``: the weights in the JAX layout, an ``.npz`` of
  ``{str(i): array}``, parameters then ``buffer:`` buffers (bfloat16 as
  2-byte void, as the JAX writer stores it without ``ml_dtypes``). The
  JAX ``np.savez`` appends ``.npz`` to the name; the port writes the
  name itself, which the JAX ``load`` also reads;
- ``path.pdmeta``: the JAX keys and values (save_load.py:104-117).

``None`` / -1 dims of an ``InputSpec`` become ``torch.export.Dim``s, so
the loaded program takes any extent there. The hand-written kernels are
``torch.library`` operators (``ops/kernels``): the exported graph names
them, and an artifact saved on the CPU and loaded on the card launches
them there (``load`` moves the program to its device).
"""
from __future__ import annotations

import json
import os
import threading
from typing import List

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..core.tensor import Tensor
from ..nn.layer.layers import Layer
from .api import InputSpec

__all__ = ["save", "load", "TranslatedLayer"]


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.detach().as_subclass(torch.Tensor)


def _state_lists(layer):
    """(JAX-layout names, module keys, tensors): parameters, then buffers
    as ``buffer:<name>``."""
    names, keys, tensors = [], [], []
    for n, p in layer.named_parameters():
        names.append(n)
        keys.append(n)
        tensors.append(p)
    for n, b in layer.named_buffers():
        names.append("buffer:" + n)
        keys.append(n)
        tensors.append(b)
    return names, keys, tensors


def _examples(input_spec, device):
    """Example inputs (a dynamic dim at extent 2) and their dynamic dims
    as ``torch.export.Dim``s, from InputSpecs or tensors."""
    examples, dyn, n_sym = [], [], 0
    for s in input_spec:
        if isinstance(s, InputSpec):
            dims, spec = [], {}
            for i, d in enumerate(s.shape):
                if d is None or (isinstance(d, int) and d < 0):
                    spec[i] = torch.export.Dim(f"b{n_sym}", min=1)
                    n_sym += 1
                    dims.append(2)
                else:
                    dims.append(int(d))
            examples.append(torch.zeros(dims, dtype=dtypes.convert_dtype(
                s.dtype), device=device))
            dyn.append(spec or None)
        else:
            examples.append(_plain(torch.as_tensor(s)).to(device))
            dyn.append(None)
    return examples, dyn


class _Pure(torch.nn.Module):
    """``fn(params, *inputs)`` as a module with no state of its own (what
    ``torch.export`` traces)."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, params, *inputs):
        return self._fn(params, *inputs)


def _out_leaves(out):
    leaves = pytree.tree_leaves(out)
    return tuple(x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
                 for x in leaves)


def export_pure(fn, params: List[torch.Tensor], examples, dyn):
    """``torch.export`` of ``fn(params, *inputs)`` under no_grad, with
    ``dyn`` (per input: ``{dim: Dim}`` or None) as its dynamic shapes."""
    shapes = ([None] * len(params), tuple(dyn))
    with torch.no_grad():
        return torch.export.export(
            _Pure(fn), (list(params), *examples),
            dynamic_shapes=shapes if any(d for d in dyn) else None)


def _is_static(d) -> bool:
    return isinstance(d, int) and not isinstance(d, torch.SymInt)


def out_avals(ep):
    """(shape with None for a dynamic dim, dtype name) of each output."""
    out = next(n for n in ep.graph.nodes if n.op == "output")
    vals = [a.meta.get("val") for a in pytree.tree_leaves(out.args[0])
            if hasattr(a, "meta")]
    return [([int(d) if _is_static(d) else None for d in v.shape],
             dtypes.dtype_name(v.dtype)) for v in vals]


def write_npz(path: str, arrays) -> None:
    """``np.savez`` to ``path`` itself; bfloat16 as 2-byte void."""
    with open(path, "wb") as f:
        np.savez(f, **{k: _np(v) for k, v in arrays.items()})


def _np(t) -> np.ndarray:
    t = _plain(torch.as_tensor(t)).cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def tensor_of(a: np.ndarray, device) -> torch.Tensor:
    """A tensor of an array written by ``write_npz`` (or the JAX writer)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def save(layer, path, input_spec=None, **configs):
    """Export ``layer`` (in eval mode) for the given ``input_spec`` and
    write ``path.pdmodel``, ``path.pdiparams`` and ``path.pdmeta``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not isinstance(layer, Layer):
        raise TypeError("jit.save expects a Layer")
    layer.eval()
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (shapes to trace with)")
    names, keys, tensors = _state_lists(layer)
    device = tensors[0].device if tensors else resolve_device(None)
    examples, dyn = _examples(input_spec, device)
    from torch.func import functional_call

    def pure(params, *inputs):
        out = functional_call(layer, dict(zip(keys, params)), inputs,
                              tie_weights=False)
        return _out_leaves(out)

    params = [_plain(t) for t in tensors]
    ep = export_pure(pure, params, examples, dyn)
    save_program(ep, path + ".pdmodel")
    write_npz(path + ".pdiparams", {str(i): t for i, t in enumerate(params)})
    in_names = []
    for i, s in enumerate(input_spec):
        nm = getattr(s, "name", None)
        in_names.append(nm if nm else f"input_{i}")
    outs = out_avals(ep)
    meta = {
        "param_names": names,
        "input_names": in_names,
        "input_shapes": [[None if i in (spec or {}) else int(d)
                          for i, d in enumerate(x.shape)]
                         for x, spec in zip(examples, dyn)],
        "input_dtypes": [dtypes.dtype_name(x.dtype) for x in examples],
        "output_names": [f"output_{i}" for i in range(len(outs))],
        "output_shapes": [s for s, _ in outs],
        "output_dtypes": [d for _, d in outs],
    }
    with open(path + ".pdmeta", "w") as f:
        json.dump(meta, f)


class TranslatedLayer(Layer):
    """Runs a loaded exported program (``jit::Layer`` /
    ``TranslatedLayer``) on its device; its weights are ``_param_vals``
    (shared by the ``inference.Predictor`` clones).

    On the card each input signature's run is one CUDA graph
    (``jit.capture.CapturedStep``, the weights held by address): the
    exported module's per-call host work (its input checks, the graph's
    ops one by one) would otherwise set the time of a device-light call.
    The outputs are copies, so they outlive the next call; calls of the
    layer (and of the Predictor clones that share it) take turns."""

    def __init__(self, exported, param_vals, meta, *, device=None):
        super().__init__()
        self._exported = exported
        self._program = exported.module()
        self._param_vals = list(param_vals)
        self._meta = meta
        self._device = torch.device(device) if device is not None else (
            self._param_vals[0].device if self._param_vals
            else torch.device("cpu"))
        from .capture import CapturedStep

        def run(params, *ins):
            return tuple(pytree.tree_leaves(self._program(params, *ins)))
        self._step = CapturedStep(run, inplace=(0,), inference=False,
                                  name="jit.load")
        self._lock = threading.Lock()    # clones share the graphs' buffers

    def forward(self, *inputs):
        ins = [(_plain(i) if isinstance(i, torch.Tensor)
                else torch.as_tensor(np.asarray(i))).to(self._device)
               for i in inputs]
        with self._lock, torch.no_grad():
            out = self._step(self._param_vals, *ins)
            outs = [Tensor(o.clone() if o.is_cuda else o) for o in out]
        return outs[0] if len(outs) == 1 else tuple(outs)


def load_program(path: str, device):
    """The exported program of ``path`` on ``device``."""
    from torch.export.passes import move_to_device_pass
    with open(path, "rb") as f:
        ep = torch.export.load(f)
    return move_to_device_pass(ep, str(device))


def save_program(ep, path: str) -> None:
    """Write an exported program to ``path`` (an open file: the archive
    writer wants a ``.pt2`` name otherwise), without its example inputs:
    they would carry a second copy of the weights."""
    ep.example_inputs = None
    with open(path, "wb") as f:
        torch.export.save(ep, f)


def load(path, **configs):
    """A TranslatedLayer of ``path``'s files, on ``configs["device"]``
    (default: the default device, ``cuda`` unless ``set_device`` chose
    another)."""
    device = resolve_device(configs.get("device"))
    ep = load_program(path + ".pdmodel", device)
    src = path + ".pdiparams"
    if not os.path.exists(src) and os.path.exists(src + ".npz"):
        src += ".npz"
    # the program's own parameter dtypes: weights stored in a lower
    # precision (inference.convert_to_mixed_precision) are cast back
    want = [n.meta["val"].dtype for n in ep.graph.nodes
            if n.op == "placeholder"]
    with np.load(src) as npz:
        param_vals = [tensor_of(npz[str(i)], device).to(want[i])
                      for i in range(len(npz.files))]
    meta = {}
    if os.path.exists(path + ".pdmeta"):
        with open(path + ".pdmeta") as f:
            meta = json.load(f)
    return TranslatedLayer(ep, param_vals, meta, device=device)
