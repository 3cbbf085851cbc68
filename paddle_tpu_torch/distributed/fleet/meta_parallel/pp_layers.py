"""``PipelineLayer``: a model described as a list of layers, cut into
pipeline stages.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``
(after Paddle's ``parallel_layers/pp_layers.py``: ``LayerDesc``,
``SharedLayerDesc``, ``SegmentLayers``, ``PipelineLayer``). As in the JAX
package every stage's layers are built on every rank and ``segment_parts``
records the stage boundaries; ``stage_layers(i)`` is what pp rank i runs.
The eager ``forward`` runs the stages one after another (the same numbers
as the pipeline, without its overlap); the pipelined execution is
``parallel.pipeline`` (``build_hybrid_train_step`` for LLaMA).
"""
from __future__ import annotations

import re
from typing import List

from torch import nn

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs
        if not issubclass(layer_cls, nn.Module):
            raise TypeError("LayerDesc expects an nn.Module subclass")

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared by several stages (e.g. tied embedding and head)."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    def __init__(self, layers_desc, num_parts, method="uniform",
                 num_virtual_pipeline_stage=None):
        self.layers_desc = layers_desc
        self.method = method
        self.num_parts = num_parts
        self.num_items = len(layers_desc)
        if self.num_items < self.num_parts:
            raise ValueError("layer count must be >= pipeline parallel "
                             "degree")

    def do_segment(self) -> List[int]:
        if self.method == "uniform":
            return self.uniform(self.num_items, self.num_parts)
        if self.method.startswith("layer:"):
            pat = self.method.split("layer:")[1]
            weights = [1 if re.search(pat, _desc_name(d)) else 0
                       for d in self.layers_desc]
            return self._segment_by_weight(weights)
        raise ValueError(f"unknown segment method {self.method}")

    @staticmethod
    def uniform(num_items, num_parts):
        result = [0]
        part = num_items // num_parts
        extra = num_items % num_parts
        for i in range(num_parts):
            result.append(result[-1] + part
                          + (1 if i >= num_parts - extra else 0))
        return result

    def _segment_by_weight(self, weights):
        total = sum(weights)
        per = total / self.num_parts
        result = [0]
        acc = 0
        target = per
        for i, w in enumerate(weights):
            acc += w
            if acc >= target and len(result) < self.num_parts:
                result.append(i + 1)
                target += per
        while len(result) < self.num_parts:
            result.append(self.num_items)
        result.append(self.num_items)
        return result[:self.num_parts + 1]


def _desc_name(d) -> str:
    cls = getattr(d, "layer_cls", None) or type(d)
    return cls.__name__


class PipelineLayer(nn.Module):
    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None, **kwargs):
        super().__init__()
        self._layers_desc = list(layers)
        from ..topology import get_hcg
        hcg = get_hcg()
        if num_stages is None and hcg is not None:
            num_stages = hcg.get_pipe_parallel_world_size()
        self._num_stages = num_stages or 1
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self._virtual_pp_degree = num_virtual_pipeline_stages or 1

        seg = SegmentLayers(self._layers_desc, self._num_stages, seg_method)
        self.segment_parts = seg.do_segment()

        self._shared_layers = nn.ModuleDict()
        built = []
        self._layer_stage = []
        for stage in range(self._num_stages):
            for i in range(self.segment_parts[stage],
                           self.segment_parts[stage + 1]):
                desc = self._layers_desc[i]
                if isinstance(desc, SharedLayerDesc):
                    if desc.layer_name not in self._shared_layers:
                        self._shared_layers[desc.layer_name] = \
                            desc.build_layer()
                    layer = _SharedLayerProxy(
                        self._shared_layers[desc.layer_name],
                        desc.forward_func)
                elif isinstance(desc, LayerDesc):
                    layer = desc.build_layer()
                elif isinstance(desc, nn.Module):
                    layer = desc
                elif callable(desc):
                    layer = _FuncLayer(desc)
                else:
                    raise TypeError(f"bad layer desc {desc!r}")
                built.append(layer)
                self._layer_stage.append(stage)
        self.run_function = nn.ModuleList(built)

    def stage_layers(self, stage):
        return [m for m, s in zip(self.run_function, self._layer_stage)
                if s == stage]

    def get_num_stages(self):
        return self._num_stages

    def forward(self, x):
        for layer in self.run_function:
            x = layer(x)
        return x


class _FuncLayer(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class _SharedLayerProxy(nn.Module):
    def __init__(self, shared, forward_func):
        super().__init__()
        self._forward_func = forward_func
        self._shared = [shared]      # not a submodule: the owner holds it

    def forward(self, *args):
        if self._forward_func is not None:
            return self._forward_func(self._shared[0], *args)
        return self._shared[0](*args)
