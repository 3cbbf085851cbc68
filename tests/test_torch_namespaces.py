"""Every name a reference package exports, and the port defines, the port
package exports too.

For each package of ``paddle_tpu`` (a directory with ``__init__``) that
has a port counterpart, each public name it exports is looked up in the
port package; where it is absent, the port's modules under that package
are searched for a definition of that name (a class or function defined
there, or a submodule of that name). A name found so is a port name the
package fails to export: ``paddle_tpu_torch.nn.Linear`` raising while
``paddle_tpu_torch.nn.layer.common.Linear`` exists. Names the port has
not ported yet are not found anywhere and do not count.
``test_torch_signature_parity.py`` only sees names both sides have, so
it cannot make this check.
"""
import importlib
import inspect
import pkgutil

import pytest

import paddle_tpu
import paddle_tpu_torch

# names the JAX top level resolves in its module ``__getattr__``
LAZY = {"paddle_tpu": ("DataParallel", "distributed", "static", "inference",
                        "enable_static", "disable_static",
                        "in_dynamic_mode", "CompiledProgram")}


def _packages(root):
    out = [root.__name__]
    for m in pkgutil.walk_packages(root.__path__, root.__name__ + "."):
        if m.ispkg:
            out.append(m.name)
    return out


def _port_of(ref_name):
    return "paddle_tpu_torch" + ref_name[len("paddle_tpu"):]


def _definitions(pkg_name):
    """name -> where the port defines it, over the modules under
    ``pkg_name``: its direct submodules, and the classes and functions
    defined in any module below it."""
    pkg = importlib.import_module(pkg_name)
    mods = [pkg] + [importlib.import_module(m.name) for m in
                    pkgutil.walk_packages(pkg.__path__, pkg_name + ".")
                    if not m.name.endswith("__main__")]
    defs = {}
    for mod in mods:
        parent, _, short = mod.__name__.rpartition(".")
        if parent == pkg_name:                          # a submodule
            defs.setdefault(short, mod.__name__)
        for attr, obj in vars(mod).items():
            if attr.startswith("_"):
                continue
            if (inspect.isclass(obj) or inspect.isfunction(obj)) and \
                    getattr(obj, "__module__", None) == mod.__name__:
                defs.setdefault(attr, f"{mod.__name__}.{attr}")
    return defs


def _pairs():
    pairs = []
    for ref_name in _packages(paddle_tpu):
        try:
            importlib.import_module(_port_of(ref_name))
        except ImportError:
            continue
        pairs.append(ref_name)
    return pairs


PAIRS = _pairs()


def test_the_walk_sees_the_ported_packages():
    for must in ("paddle_tpu", "paddle_tpu.nn", "paddle_tpu.nn.functional",
                 "paddle_tpu.nn.layer", "paddle_tpu.jit", "paddle_tpu.models",
                 "paddle_tpu.utils", "paddle_tpu.distributed",
                 "paddle_tpu.core", "paddle_tpu.device",
                 "paddle_tpu.profiler", "paddle_tpu.ops",
                 "paddle_tpu.nn.utils", "paddle_tpu.nn.quant",
                 "paddle_tpu.vision", "paddle_tpu.vision.models",
                 "paddle_tpu.static", "paddle_tpu.inference",
                 "paddle_tpu.incubate", "paddle_tpu.incubate.nn",
                 "paddle_tpu.incubate.nn.functional",
                 "paddle_tpu.incubate.nn.layer",
                 "paddle_tpu.incubate.optimizer",
                 "paddle_tpu.incubate.autograd"):
        assert must in PAIRS, must


@pytest.mark.parametrize("ref_name", PAIRS)
def test_package_exports_what_the_port_defines(ref_name):
    ref = importlib.import_module(ref_name)
    port_name = _port_of(ref_name)
    port = importlib.import_module(port_name)
    names = [n for n in dir(ref) if not n.startswith("_")]
    names += list(LAZY.get(ref_name, ()))
    defs = None
    missing = []
    for n in names:
        if hasattr(port, n):
            continue
        if defs is None:
            defs = _definitions(port_name)
        if n in defs:
            missing.append(f"{n} (defined at {defs[n]})")
    assert not missing, f"{port_name} does not export: {missing}"
