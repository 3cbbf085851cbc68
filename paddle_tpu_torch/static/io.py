"""save/load_inference_model: a static Program exported for deployment.

Counterpart of ``paddle_tpu/static/io.py``. The program that is saved is
the replay of the Program's forward ops as ``fn(params, *feeds) ->
fetches``, exported with ``torch.export`` as ``jit.save`` exports a layer
(``jit/save_load.py``): a feed's dynamic (None / -1) dims become
``torch.export.Dim``s, so the loaded program takes any extent there.

Files for prefix P (the JAX package's names, the port's own program
format):

- ``P.shlo``: the ``torch.export`` archive (the JAX package writes
  serialized StableHLO under this name);
- ``P.npz``: the captured tensors by scope name;
- ``P.json``: feed names, shapes (-1 dynamic) and dtypes, fetch names.

``Executor.run`` of a loaded ``InferenceProgram`` dispatches to its
``_infer_run``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..jit import save_load as _sl
from .executor import Executor, _replay, global_scope
from .framework import BackwardRecord, Program

__all__ = ["save_inference_model", "load_inference_model", "normalize_program",
           "InferenceProgram"]

_FORMAT_VERSION = 1


def normalize_program(program: Program, feed_vars, fetch_vars) -> Program:
    """Prune to inference form (drop backward records)."""
    return program.clone(for_test=True)


def save_inference_model(path_prefix: str, feed_vars, fetch_vars,
                         executor: Executor = None, program: Program = None,
                         **kwargs) -> None:
    from .framework import default_main_program
    program = normalize_program(program or default_main_program(),
                                feed_vars, fetch_vars)
    feed_vars = feed_vars if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    feed_names = [v.name for v in feed_vars]
    fetch_names = [v.name for v in fetch_vars]

    scope = global_scope()
    names = list(program.captured)
    params = [_sl._plain(scope.vars.get(n, program.captured[n]))
              for n in names]
    device = params[0].device if params else resolve_device(None)
    ops = [o for o in program.ops if not isinstance(o, BackwardRecord)]

    def infer_fn(param_vals, *feed_vals):
        pvals = dict(zip(names, param_vals))
        env = _replay(ops, pvals, dict(zip(feed_names, feed_vals)))
        return tuple(env[n] if n in env else pvals[n] for n in fetch_names)

    examples, dyn, n_sym = [], [], 0
    for v in feed_vars:
        spec = {}
        for i in sorted(v.dynamic_dims):
            spec[i] = torch.export.Dim(f"_d{n_sym}", min=1)
            n_sym += 1
        examples.append(torch.zeros(tuple(v._pt_dims), dtype=v.dtype,
                                    device=device))
        dyn.append(spec or None)
    ep = _sl.export_pure(infer_fn, params, examples, dyn)

    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    _sl.save_program(ep, path_prefix + ".shlo")
    _sl.write_npz(path_prefix + ".npz", dict(zip(names, params)))
    with open(path_prefix + ".json", "w") as f:
        json.dump({
            "version": _FORMAT_VERSION,
            "feed_names": feed_names,
            "feed_shapes": [v.shape for v in feed_vars],
            "feed_dtypes": [dtypes.dtype_name(v.dtype) for v in feed_vars],
            "fetch_names": fetch_names,
        }, f)


class InferenceProgram:
    """A loaded artifact on ``device`` (default: the default device);
    ``Executor.run()`` dispatches to ``_infer_run``."""

    def __init__(self, path_prefix: str, device=None):
        self._device = resolve_device(device)
        with open(path_prefix + ".json") as f:
            self.meta = json.load(f)
        self._program = _sl.load_program(path_prefix + ".shlo",
                                         self._device).module()
        with np.load(path_prefix + ".npz") as npz:
            self.params = {k: _sl.tensor_of(npz[k], self._device)
                           for k in npz.files}
        self._order = list(self.params)
        self.feed_names: List[str] = self.meta["feed_names"]
        self.fetch_names: List[str] = self.meta["fetch_names"]

    def _infer_run(self, feed: Dict[str, np.ndarray]):
        vals = [_sl._plain(torch.as_tensor(np.asarray(feed[n]) if not
                                           isinstance(feed[n], torch.Tensor)
                                           else feed[n])).to(self._device)
                for n in self.feed_names]
        with torch.no_grad():
            return list(self._program([self.params[k] for k in self._order],
                                      *vals))


def load_inference_model(path_prefix: str, executor: Executor = None):
    """``[program, feed_names, fetch_names]`` as the reference returns;
    the program runs on the executor's device."""
    device = executor._device if executor is not None else None
    prog = InferenceProgram(path_prefix, device)
    return [prog, prog.feed_names, prog.fetch_names]
