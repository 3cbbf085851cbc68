"""Layer: the base class of every port layer, an ``nn.Module``.

Counterpart of ``paddle_tpu/nn/layer/layers.py``. ``Layer`` adds the JAX
class's methods to ``nn.Module`` with Paddle's parameters first, in
Paddle's order, and takes torch's after them, since torch calls some of
them itself (``eval()`` calls ``train(False)``; ``state_dict`` recurses
with ``prefix=``/``keep_vars=``; ``parameters`` takes ``recurse``):
``train(mode)``, ``state_dict(destination, include_sublayers, use_hook)``,
``to(device, dtype, blocking)``, ``apply(fn)`` (this layer first, as the
JAX method), ``parameters(include_sublayers)``, ``named_sublayers``,
``set_state_dict``, the forward hooks with ``HookRemoveHelper``,
``create_parameter``, ``astype``, ``clear_gradients``. State-dict keys are
the JAX ``Layer``'s: every parameter, then every persistable buffer; the
values, as torch's, are detached unless ``keep_vars``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterator, Tuple

import torch
from torch import nn

from ...core import dtype as dtypes
from ...core.device import resolve_device

__all__ = ["Layer", "HookRemoveHelper"]


class HookRemoveHelper:
    def __init__(self, hooks, hid):
        self._hooks, self._hid = hooks, hid

    def remove(self):
        self._hooks.pop(self._hid, None)


def _device_of(device):
    if device is None or isinstance(device, torch.device):
        return device
    s = str(device)
    if s.startswith("gpu"):
        s = "cuda" + s[3:]
    return resolve_device(s)


def _lazy_pre_hook(layer, inputs):
    """The first forward of a layer built under ``LazyGuard`` builds it."""
    layer.lazy_init()


class Layer(nn.Module):
    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        from ...core import device as _dev
        if getattr(_dev._state, "lazy", 0):
            # built under LazyGuard (on meta): lazy_init builds it again
            # from the same arguments
            object.__setattr__(obj, "_lazy_ctor", (args, kwargs))
        return obj

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtypes.convert_dtype(dtype)
        self._name_scope = name_scope or self.__class__.__name__.lower()
        if "_lazy_ctor" in self.__dict__:
            nn.Module.register_forward_pre_hook(self, _lazy_pre_hook)

    # ---- registration ----
    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(tensor)
        super().register_buffer(name, tensor, persistable
                                if persistent is None else persistent)
        return tensor

    def create_parameter(self, shape, dtype=None, default_initializer=None,
                         attr=None, is_bias=False, *, device=None):
        """A port ``Parameter`` on ``device`` (default: the card): zeros
        for a bias, XavierNormal for a weight, unless an initializer is
        given (``attr.initializer``, else ``default_initializer``, else
        the one ``initializer.set_global_initializer`` set: a callable on
        the parameter). ``attr.name`` names it; ``attr.trainable=False``
        sets its ``stop_gradient``."""
        from ...ops.creation import create_parameter
        from ..initializer import _global_initializer
        dt = dtypes.convert_dtype(dtype) if dtype else self._dtype
        init = getattr(attr, "initializer", None) or default_initializer \
            or _global_initializer["bias" if is_bias else "weight"]
        p = create_parameter(shape, dt, is_bias=is_bias,
                             default_initializer=init, place=device)
        if attr is not None:
            if getattr(attr, "name", None):
                p.name = attr.name
            if getattr(attr, "trainable", True) is False:
                p.stop_gradient = True
        return p

    def lazy_init(self):
        """Materialise a layer built under ``LazyGuard``: its parameters
        and buffers (and its sublayers') are ``meta`` placeholders, so the
        layer is built once more from the arguments it was built with,
        outside the guard (its layer arguments materialised first), and
        every placeholder is replaced by the new build's tensor of the same
        name. The first forward calls it; otherwise it does nothing.
        Materialised parameters are new objects: read ``parameters()``
        again after it."""
        ctor = self.__dict__.get("_lazy_ctor")
        if ctor is not None:
            from ...core import device as _dev
            args, kwargs = ctor
            for a in (*args, *kwargs.values()):
                if isinstance(a, Layer) and a is not self:
                    a.lazy_init()
            depth = getattr(_dev._state, "lazy", 0)
            _dev._state.lazy = 0
            try:
                twin = type(self)(*args, **kwargs)
            finally:
                _dev._state.lazy = depth
            built = dict(twin.named_modules())
            for name, sub in self.named_modules():
                src = built[name]
                for k in list(sub._parameters):
                    sub._parameters[k] = src._parameters[k]
                for k in list(sub._buffers):
                    sub._buffers[k] = src._buffers[k]
        for sub in self.modules():
            sub.__dict__.pop("_lazy_ctor", None)
            for hid, fn in list(sub._forward_pre_hooks.items()):
                if fn is _lazy_pre_hook:
                    del sub._forward_pre_hooks[hid]
        return self

    # ---- iteration ----
    def named_sublayers(self, prefix="", include_self=False
                        ) -> Iterator[Tuple[str, nn.Module]]:
        for name, layer in self.named_modules(prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix="", include_sublayers=True, *,
                         recurse=None, remove_duplicate=True):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def parameters(self, include_sublayers=True, *, recurse=None):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers if recurse is None
            else recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, *,
                      recurse=None, remove_duplicate=True):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers if recurse is None
            else recurse)]

    # ---- mode ----
    def train(self, mode: bool = True):
        return super().train(mode)

    def apply(self, fn):
        """``fn(layer)`` on this layer, then on every sublayer in order."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # ---- hooks ----
    def register_forward_pre_hook(self, hook):
        """``hook(layer, inputs) -> inputs | None`` before ``forward``."""
        h = super().register_forward_pre_hook(hook)
        return HookRemoveHelper(self._forward_pre_hooks, h.id)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs) -> outputs | None`` after
        ``forward``."""
        h = super().register_forward_hook(hook)
        return HookRemoveHelper(self._forward_hooks, h.id)

    # ---- state dict ----
    def state_dict(self, destination=None, include_sublayers=True,
                   use_hook=True, *, prefix="", keep_vars=False):
        if prefix or not include_sublayers:
            if not include_sublayers:
                dest = destination if destination is not None \
                    else OrderedDict()
                for name, p in self.named_parameters(
                        prefix.rstrip("."), include_sublayers=False):
                    dest[name] = p if keep_vars else p.detach()
                for name, b in self.named_buffers(prefix.rstrip("."),
                                                  include_sublayers=False):
                    if name.rsplit(".", 1)[-1] not in \
                            self._non_persistent_buffers_set:
                        dest[name] = b if keep_vars else b.detach()
                return dest
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        dest = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters():
            dest[name] = p if keep_vars else p.detach()
        skip = {f"{mn}.{bn}" if mn else bn
                for mn, m in self.named_modules()
                for bn in m._non_persistent_buffers_set}
        for name, b in self.named_buffers():
            if name not in skip:
                dest[name] = b if keep_vars else b.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors or arrays) into this
        layer's, cast to their dtypes; returns ``(missing, unexpected)``
        names. A shape that differs raises ValueError."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected = [], []
        for name, t in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            val = src if isinstance(src, torch.Tensor) else torch.as_tensor(
                src)
            if tuple(val.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{tuple(val.shape)} vs {tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(val.to(device=t.device, dtype=t.dtype))
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        return missing, unexpected

    load_dict = set_state_dict

    # ---- dtype / device ----
    def to(self, device=None, dtype=None, blocking=None, *args, **kwargs):
        if isinstance(device, (torch.dtype, str)) and not isinstance(
                device, torch.device):
            try:
                dtype, device = dtypes.convert_dtype(device), dtype
            except TypeError:
                pass
        if args or kwargs or isinstance(device, torch.Tensor):
            return super().to(*[a for a in (device, dtype) if a is not None],
                              *args, **kwargs)
        dev = _device_of(device)
        dt = dtypes.convert_dtype(dtype) if dtype is not None else None
        if dt is not None:
            for m in self.modules():
                if isinstance(m, Layer):
                    m._dtype = dt
        kw = {"non_blocking": not blocking} if blocking is not None else {}
        if dev is None and dt is None:
            return self
        return super().to(*[a for a in (dev, dt) if a is not None], **kw)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        return self._name_scope
