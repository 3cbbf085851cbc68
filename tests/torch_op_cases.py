"""The op library's case table: one case per public name of the JAX
package's ``ops.{creation,math,manip,linalg,random,breadth}`` (and a few
extra forms, ``ALIASES``), with inputs made by numpy from a per-name seed.
An in-place ``*_`` case is its base op's case with no input to
differentiate (the op writes into its first argument).

JAX-free: ``tests/test_torch_ops.py`` holds each case against the JAX
package on the CPU; ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
run each on the card against the same port op on the CPU.
"""
import zlib

import numpy as np

MODULES = ("creation", "math", "manip", "linalg", "random", "breadth")


class A:
    """A tensor argument: ``grad`` marks it as one to differentiate."""

    def __init__(self, arr, grad=None):
        self.arr = np.asarray(arr)
        self.grad = (self.arr.dtype.kind == "f") if grad is None else grad


class C:
    def __init__(self, *args, kw=None, grad=True, rtol=1e-5, atol=1e-6,
                 check=None, shape_only=False, raises=False):
        self.args, self.kw = args, kw or {}
        self.grad, self.rtol, self.atol = grad, rtol, atol
        self.check, self.shape_only, self.raises = check, shape_only, raises


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def cases():
    """name -> C, inputs from a per-name seeded generator."""
    out = {}

    def add(name, fn):
        r = _rng(name)

        def f32(*shape, lo=-1.0, hi=1.0):
            return r.uniform(lo, hi, shape).astype(np.float32)

        def i64(*shape, lo=-5, hi=6):
            return r.integers(lo, hi, shape).astype(np.int64)
        out[name] = fn(f32, i64, r)

    # ---- creation ----
    add("to_tensor", lambda f, i, r: C([[1.5, 2.0], [3.0, 4.0]], grad=False))
    add("as_tensor", lambda f, i, r: C([1, 2, 3], grad=False))
    add("zeros", lambda f, i, r: C([2, 3], grad=False))
    add("ones", lambda f, i, r: C([2, 3], "int32", grad=False))
    add("full", lambda f, i, r: C([2, 2], 3, grad=False))
    add("empty", lambda f, i, r: C([2], grad=False))
    add("arange", lambda f, i, r: C(1, 9, 2, grad=False))
    add("linspace", lambda f, i, r: C(0, 1, 5, grad=False))
    add("logspace", lambda f, i, r: C(0, 2, 3, grad=False, rtol=1e-5))
    add("eye", lambda f, i, r: C(3, 4, grad=False))
    add("zeros_like", lambda f, i, r: C(A(f(2, 3)), grad=False))
    add("ones_like", lambda f, i, r: C(A(f(2, 3)), "int64", grad=False))
    add("full_like", lambda f, i, r: C(A(f(2, 3)), 2.5, grad=False))
    add("empty_like", lambda f, i, r: C(A(f(2)), grad=False))
    add("tril", lambda f, i, r: C(A(f(3, 4))))
    add("triu", lambda f, i, r: C(A(f(3, 4)), 1))
    add("diag", lambda f, i, r: C(A(f(3)), 1, 5.0))
    add("diagflat", lambda f, i, r: C(A(f(2, 2)), -1))
    # the JAX meshgrid records no grad (it is not on the tape); the port's
    # is a torch op and does: values only
    add("meshgrid", lambda f, i, r: C(A(f(3)), A(f(2)), grad=False))
    add("assign", lambda f, i, r: C(A(f(2, 3))))
    add("clone", lambda f, i, r: C(A(f(2, 3))))
    add("tril_indices", lambda f, i, r: C(4, 3, 1, grad=False))
    add("triu_indices", lambda f, i, r: C(4, None, 0, grad=False))
    add("complex", lambda f, i, r: C(A(f(3)), A(f(3)), grad=False))
    add("fill_constant", lambda f, i, r: C([2], "float32", 3.0, grad=False))
    add("create_tensor", lambda f, i, r: C("float32", grad=False))
    add("create_global_var",
        lambda f, i, r: C([2], 1.0, "float32", grad=False))
    add("create_parameter",
        lambda f, i, r: C([4, 3], "float32", shape_only=True, grad=False))
    add("gaussian", lambda f, i, r: C([3, 4], shape_only=True, grad=False))
    add("create_array", lambda f, i, r: C("float32", [A(f(2))], grad=False))
    add("array_length", lambda f, i, r: C([A(f(2)), A(f(2))], grad=False))
    add("array_read", lambda f, i, r: C([A(f(2)), A(f(3))], 1, grad=False))
    add("array_write",
        lambda f, i, r: C(A(f(2)), 2, [A(f(2))], grad=False))
    add("tensor_array_to_tensor",
        lambda f, i, r: C([A(f(2, 3)), A(f(1, 3))], 0))

    # ---- math: binary ----
    for n in ("add", "subtract", "multiply", "maximum", "minimum", "fmax",
              "fmin", "atan2", "hypot", "logaddexp", "copysign"):
        add(n, lambda f, i, r: C(A(f(3, 4)), A(f(4))))
    add("divide", lambda f, i, r: C(A(f(3, 4)), A(f(4, lo=0.5, hi=2))))
    add("divide_no_nan",
        lambda f, i, r: C(A(f(4)), A(np.array([1., 0., 2., 0.], "f4"))))
    for n in ("mod", "remainder", "floor_mod", "floor_divide"):
        add(n, lambda f, i, r: C(A(i(3, 4)), A(i(4, lo=1, hi=4) *
                                              np.array([1, -1, 1, -1]))))
    add("pow", lambda f, i, r: C(A(f(3, 4, lo=0.5, hi=2)), 2.5))
    add("nextafter", lambda f, i, r: C(A(f(4)), A(f(4)), grad=False))
    add("heaviside", lambda f, i, r: C(A(np.array([-1., 0., 2.], "f4")),
                                      A(np.array([.5, .5, .5], "f4")),
                                      grad=False))
    # integer heaviside promotes to float; float // 0.0 is nan
    add("heaviside_int", lambda f, i, r: C(A(i(6)), A(i(6, lo=0, hi=2)),
                                          grad=False))
    add("floor_divide_by_zero",
        lambda f, i, r: C(A(np.array([1., -1., 2.5, -2.5, 0.], "f4")),
                          A(np.array([0., 0., 2., -2., 0.], "f4")),
                          grad=False))
    add("gcd", lambda f, i, r: C(A(i(5, lo=1, hi=30)), A(i(5, lo=1, hi=30))))
    add("lcm", lambda f, i, r: C(A(i(5, lo=1, hi=12)), A(i(5, lo=1, hi=12))))
    add("inner", lambda f, i, r: C(A(f(2, 3)), A(f(4, 3))))
    add("outer", lambda f, i, r: C(A(f(3)), A(f(4))))
    add("kron", lambda f, i, r: C(A(f(2, 2)), A(f(2, 3))))
    add("cross", lambda f, i, r: C(A(f(4, 3)), A(f(4, 3))))
    # ---- math: unary ----
    for n in ("abs", "neg", "exp", "expm1", "sin", "cos", "tan", "atan",
              "sinh", "cosh", "tanh", "asinh", "erf", "floor", "ceil",
              "round", "trunc", "frac", "sign", "sgn", "square", "isnan",
              "isinf", "isfinite", "deg2rad", "rad2deg", "stanh", "real",
              "imag", "conj", "angle", "rsqrt_"):
        lo = 0.2 if n == "rsqrt_" else -1.0
        add(n, lambda f, i, r, lo=lo, n=n: C(A(f(3, 4, lo=lo, hi=2)),
                                             grad=n != "rsqrt_"))
    for n in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt",
              "reciprocal", "digamma", "lgamma", "gammaln", "i0", "i0e",
              "i1", "i1e"):
        add(n, lambda f, i, r: C(A(f(3, 4, lo=0.3, hi=3)),
                                 rtol=2e-5))
    for n in ("asin", "acos", "atanh", "erfinv"):
        add(n, lambda f, i, r: C(A(f(3, 4, lo=-0.9, hi=0.9)), rtol=2e-5))
    add("acosh", lambda f, i, r: C(A(f(3, 4, lo=1.2, hi=3))))
    add("logit", lambda f, i, r: C(A(f(3, 4, lo=0.1, hi=0.9))))
    add("clip", lambda f, i, r: C(A(f(3, 4)), -0.5, 0.5))
    add("nan_to_num", lambda f, i, r: C(
        A(np.array([1., np.nan, np.inf, -np.inf], "f4")), grad=False))
    add("lerp", lambda f, i, r: C(A(f(3)), A(f(3)), 0.3))
    add("scale", lambda f, i, r: C(A(f(3)), 2.0, 0.5))
    add("increment", lambda f, i, r: C(A(f(3), grad=False), 2.0))
    add("polygamma", lambda f, i, r: C(A(f(4, lo=0.5, hi=3)), 1,
                                       rtol=2e-5))
    add("gammainc", lambda f, i, r: C(A(f(4, lo=.5, hi=3)),
                                      A(f(4, lo=.5, hi=3)), grad=False,
                                      rtol=2e-5))
    add("gammaincc", lambda f, i, r: C(A(f(4, lo=.5, hi=3)),
                                       A(f(4, lo=.5, hi=3)), grad=False,
                                       rtol=2e-5))
    # ---- math: matmul family ----
    add("matmul", lambda f, i, r: C(A(f(2, 3, 4)), A(f(5, 4)),
                                    kw={"transpose_y": True}))
    add("mm", lambda f, i, r: C(A(f(3, 4)), A(f(4, 2))))
    add("bmm", lambda f, i, r: C(A(f(2, 3, 4)), A(f(2, 4, 2))))
    add("mv", lambda f, i, r: C(A(f(3, 4)), A(f(4))))
    add("dot", lambda f, i, r: C(A(f(3, 4)), A(f(3, 4))))
    add("addmm", lambda f, i, r: C(A(f(3, 2)), A(f(3, 4)), A(f(4, 2)), 0.5,
                                   2.0))
    add("t", lambda f, i, r: C(A(f(3, 4))))
    add("trace", lambda f, i, r: C(A(f(3, 4)), 1))
    add("diagonal", lambda f, i, r: C(A(f(2, 3, 4)), 0, 1, 2))
    add("einsum", lambda f, i, r: C("ij,jk->ik", A(f(3, 4)), A(f(4, 2))))
    add("tensordot", lambda f, i, r: C(A(f(3, 4, 5)), A(f(4, 5, 2)), 2))
    # ---- math: reductions ----
    for n in ("mean", "max", "min", "amax", "amin", "logsumexp", "nanmean"):
        add(n, lambda f, i, r: C(A(f(3, 4, 5)), [0, 2], True))
    for n in ("sum", "nansum"):
        add(n, lambda f, i, r: C(A(f(3, 4)), 1))
    add("prod", lambda f, i, r: C(A(f(3, 4, lo=0.5, hi=1.5)), [0, 1]))
    add("all", lambda f, i, r: C(A(f(3, 4) > -0.8), 1, grad=False))
    add("any", lambda f, i, r: C(A(f(3, 4) > 0.8), None, grad=False))
    add("std", lambda f, i, r: C(A(f(3, 4)), 1))
    add("var", lambda f, i, r: C(A(f(3, 4)), None, False))
    add("median", lambda f, i, r: C(A(f(3, 4)), 1))
    add("nanmedian", lambda f, i, r: C(A(f(3, 4)), 1, grad=False))
    add("quantile", lambda f, i, r: C(A(f(3, 5)), 0.3, 1))
    add("nanquantile", lambda f, i, r: C(A(f(3, 5)), 0.3, 1, grad=False))
    add("argmax", lambda f, i, r: C(A(f(3, 4)), 1, grad=False))
    add("argmin", lambda f, i, r: C(A(f(3, 4)), None, grad=False))
    add("count_nonzero", lambda f, i, r: C(A(i(3, 4, lo=-1, hi=2)), 1))
    add("cumsum", lambda f, i, r: C(A(f(3, 4)), 1))
    add("cumprod", lambda f, i, r: C(A(f(3, 4, lo=.5, hi=1.5)), 1))
    add("cummax", lambda f, i, r: C(A(f(3, 5)), 1))
    add("cummin", lambda f, i, r: C(A(f(3, 5)), None))
    add("logcumsumexp", lambda f, i, r: C(A(f(3, 4)), 1))
    # ---- math: comparison / logic ----
    for n in ("equal", "not_equal", "greater_than", "greater_equal",
              "less_than", "less_equal"):
        add(n, lambda f, i, r: C(A(i(3, 4, lo=0, hi=3)), A(i(4, lo=0, hi=3))))
    for n in ("logical_and", "logical_or", "logical_xor"):
        add(n, lambda f, i, r: C(A(f(5) > 0), A(f(5) > 0)))
    add("logical_not", lambda f, i, r: C(A(f(5) > 0)))
    for n in ("bitwise_and", "bitwise_or", "bitwise_xor", "left_shift",
              "right_shift"):
        add(n, lambda f, i, r: C(A(i(5, lo=-8, hi=8)), A(i(5, lo=0, hi=3))))
    add("bitwise_not", lambda f, i, r: C(A(i(5))))
    add("equal_all", lambda f, i, r: C(A(i(3)), A(i(3))))
    add("isclose", lambda f, i, r: C(A(np.array([1., 2., 3.], "f4")),
                                     A(np.array([1., 2.1, 3.], "f4"))))
    add("allclose", lambda f, i, r: C(A(np.array([1., 2.], "f4")),
                                      A(np.array([1., 2.], "f4"))))
    add("cast", lambda f, i, r: C(A(f(3, 4)), "float64"))
    add("astype", lambda f, i, r: C(A(f(3, 4) * 5), "int32", grad=False))
    # ---- math: the rest ----
    add("diff", lambda f, i, r: C(A(f(3, 5)), 1, -1, A(f(3, 1))))
    add("trapezoid", lambda f, i, r: C(A(f(3, 5)), None, 0.5))
    add("cumulative_trapezoid", lambda f, i, r: C(A(f(3, 5)), None, 0.5))
    add("frexp", lambda f, i, r: C(A(f(5, lo=-9, hi=9)), grad=False))
    add("ldexp", lambda f, i, r: C(A(f(5)), A(i(5, lo=0, hi=4)),
                                   grad=False))
    add("renorm", lambda f, i, r: C(A(f(3, 4)), 2.0, 0, 0.8))
    add("add_n", lambda f, i, r: C([A(f(3)), A(f(3)), A(f(3))]))
    add("rank", lambda f, i, r: C(A(f(3, 4))))
    add("shape", lambda f, i, r: C(A(f(3, 4))))
    add("is_complex", lambda f, i, r: C(A(f(3))))
    add("is_floating_point", lambda f, i, r: C(A(f(3))))
    add("is_integer", lambda f, i, r: C(A(i(3))))
    add("is_empty", lambda f, i, r: C(A(f(0, 2))))
    add("inverse", lambda f, i, r: C(A(f(3, 3) + 3 * np.eye(3, dtype="f4"))))
    add("dist", lambda f, i, r: C(A(f(3, 4)), A(f(3, 4)), 3.0))
    add("cdist", lambda f, i, r: C(A(f(3, 4)), A(f(2, 4)), 1.0))
    add("multiplex", lambda f, i, r: C([A(f(3, 2)), A(f(3, 2))],
                                       A(np.array([[1], [0], [1]])),
                                       grad=False))
    add("isin", lambda f, i, r: C(A(i(6)), A(i(3))))
    add("bucketize", lambda f, i, r: C(A(f(6)), A(np.sort(f(4)))))
    add("digitize", lambda f, i, r: C(A(f(6)), A(np.sort(f(4))), True))
    add("histogramdd", lambda f, i, r: C(A(f(20, 2)), 3, grad=False))
    add("vander", lambda f, i, r: C(A(f(4)), 3))

    # ---- manip ----
    add("reshape", lambda f, i, r: C(A(f(3, 4)), [2, -1]))
    add("reshape_", lambda f, i, r: C(A(f(3, 4), grad=False), [4, 3]))
    add("flatten", lambda f, i, r: C(A(f(2, 3, 4)), 1, 2))
    add("flatten_", lambda f, i, r: C(A(f(2, 3, 4), grad=False)))
    add("transpose", lambda f, i, r: C(A(f(2, 3, 4)), [2, 0, 1]))
    add("moveaxis", lambda f, i, r: C(A(f(2, 3, 4)), 0, 2))
    add("swapaxes", lambda f, i, r: C(A(f(2, 3, 4)), 0, 2))
    add("squeeze", lambda f, i, r: C(A(f(2, 1, 3, 1)), [1, 2]))
    add("unsqueeze", lambda f, i, r: C(A(f(2, 3)), [0, -1]))
    add("concat", lambda f, i, r: C([A(f(2, 3)), A(f(1, 3))], 0))
    add("stack", lambda f, i, r: C([A(f(2, 3)), A(f(2, 3))], 1))
    add("split", lambda f, i, r: C(A(f(6, 2)), [1, -1, 2]))
    add("chunk", lambda f, i, r: C(A(f(2, 6)), 3, 1))
    add("unbind", lambda f, i, r: C(A(f(3, 2)), 1))
    add("unstack", lambda f, i, r: C(A(f(3, 2)), 0))
    add("tile", lambda f, i, r: C(A(f(2, 3)), [2, 1]))
    add("expand", lambda f, i, r: C(A(f(1, 3)), [4, -1]))
    add("broadcast_to", lambda f, i, r: C(A(f(3)), [2, 3]))
    add("expand_as", lambda f, i, r: C(A(f(1, 3)), A(f(2, 3), grad=False)))
    add("broadcast_tensors", lambda f, i, r: C([A(f(1, 3)), A(f(2, 1))]))
    add("roll", lambda f, i, r: C(A(f(3, 4)), 1, 1))
    add("flip", lambda f, i, r: C(A(f(3, 4)), [0, 1]))
    add("rot90", lambda f, i, r: C(A(f(3, 4)), 1))
    add("gather", lambda f, i, r: C(A(f(4, 3)), A(np.array([3, 0, 3]))))
    add("gather_nd", lambda f, i, r: C(A(f(3, 4)), A(np.array([[0, 1],
                                                               [2, 3]]))))
    add("index_select", lambda f, i, r: C(A(f(3, 4)), A(np.array([1, 0])),
                                          1))
    add("index_sample", lambda f, i, r: C(A(f(3, 4)),
                                          A(np.array([[0, 3], [1, 1],
                                                      [2, 0]]))))
    add("take_along_axis", lambda f, i, r: C(A(f(3, 4)),
                                             A(np.array([[0], [3], [1]])), 1))
    add("put_along_axis", lambda f, i, r: C(A(f(3, 4)),
                                            A(np.array([[0], [3], [1]])),
                                            A(f(3, 1)), 1, "add"))
    add("scatter", lambda f, i, r: C(A(f(4, 3)), A(np.array([2, 0])),
                                     A(f(2, 3))))
    add("scatter_nd_add", lambda f, i, r: C(A(f(3, 4)),
                                            A(np.array([[0, 1], [2, 2]])),
                                            A(f(2))))
    add("scatter_nd", lambda f, i, r: C(A(np.array([[1], [3]])), A(f(2, 3)),
                                        [4, 3]))
    add("masked_select", lambda f, i, r: C(A(f(3, 4)), A(f(3, 4) > 0)))
    add("masked_fill", lambda f, i, r: C(A(f(3, 4)), A(f(3, 4) > 0), 2.0))
    add("where", lambda f, i, r: C(A(f(3, 4) > 0), A(f(3, 4)), A(f(4))))
    add("nonzero", lambda f, i, r: C(A(i(3, 4, lo=-1, hi=2)), grad=False))
    add("sort", lambda f, i, r: C(A(f(3, 5)), 1, True))
    add("argsort", lambda f, i, r: C(A(f(3, 5)), 0, True))
    add("topk", lambda f, i, r: C(A(f(3, 5)), 2))
    add("kthvalue", lambda f, i, r: C(A(f(3, 5)), 2, 1))
    add("mode", lambda f, i, r: C(A(np.array([[1, 2, 2, 3, 3],
                                             [4, 4, 1, 1, 0]])), -1))
    add("unique", lambda f, i, r: C(A(i(8, lo=0, hi=4)), True, True, True))
    add("unique_consecutive", lambda f, i, r: C(
        A(np.array([1, 1, 2, 2, 2, 3, 1])), True, True))
    add("one_hot", lambda f, i, r: C(A(i(4, lo=0, hi=5)), 5))
    add("slice", lambda f, i, r: C(A(f(4, 5)), [0, 1], [1, -3], [3, 100]))
    add("strided_slice", lambda f, i, r: C(A(f(6, 5)), [0, 1], [0, 4],
                                           [6, 0], [2, -2]))
    for mode in ("constant", "reflect", "replicate", "circular"):
        add("pad" if mode == "constant" else f"pad_{mode}",
            lambda f, i, r, mode=mode: C(A(f(2, 3, 4)), [1, 2, 2, 1],
                                         mode, kw={}))
    add("repeat_interleave", lambda f, i, r: C(A(f(2, 3)), 2, 1))
    add("as_strided", lambda f, i, r: C(A(f(4)), [2], [1], raises=True))
    add("numel", lambda f, i, r: C(A(f(3, 4))))
    add("shard_index", lambda f, i, r: C(A(i(6, lo=0, hi=20)), 20, 2, 1))
    add("bincount", lambda f, i, r: C(A(i(8, lo=0, hi=5)), None, 7))
    add("histogram", lambda f, i, r: C(A(f(20)), 4, -1, 1))
    add("searchsorted", lambda f, i, r: C(A(np.sort(f(5))), A(f(4))))
    add("index_add", lambda f, i, r: C(A(f(4, 3)), A(np.array([0, 2])), 0,
                                       A(f(2, 3))))
    add("index_fill", lambda f, i, r: C(A(f(4, 3)), A(np.array([1, 3])), 0,
                                        -2.0))
    add("index_put", lambda f, i, r: C(A(f(4, 3)), (A(np.array([0, 2])),),
                                       A(f(2, 3)), True))
    add("masked_scatter", lambda f, i, r: C(A(f(3, 4)), A(f(3, 4) > 0),
                                            A(f(12)), grad=False))
    add("vsplit", lambda f, i, r: C(A(f(4, 2)), 2))
    add("dsplit", lambda f, i, r: C(A(f(2, 2, 4)), [1, 3]))
    add("hsplit", lambda f, i, r: C(A(f(2, 4)), 2))
    add("tensor_split", lambda f, i, r: C(A(f(5, 2)), 3))
    add("take", lambda f, i, r: C(A(f(3, 4)), A(np.array([0, -1, 5])),
                                  "wrap"))
    add("unfold", lambda f, i, r: C(A(f(3, 7)), 1, 3, 2))
    add("unflatten", lambda f, i, r: C(A(f(3, 6)), 1, [2, 3]))
    add("view", lambda f, i, r: C(A(f(3, 4)), [4, 3]))
    add("view_as", lambda f, i, r: C(A(f(3, 4)), A(f(6, 2), grad=False)))
    add("crop", lambda f, i, r: C(A(f(4, 5)), [2, 3], [1, 1]))
    add("as_complex", lambda f, i, r: C(A(f(3, 2)), grad=False))
    add("as_real", lambda f, i, r: C(A(f(3) + 1j * f(3)), grad=False))
    add("polar", lambda f, i, r: C(A(f(3)), A(f(3)), grad=False))
    add("tolist", lambda f, i, r: C(A(i(2, 3))))
    add("fill_diagonal_tensor", lambda f, i, r: C(A(f(3, 4)), A(f(3)), 1))
    add("broadcast_shape", lambda f, i, r: C([2, 1, 3], [4, 1]))

    # ---- linalg ----
    def spd(f, n=3):
        a = f(n, n)
        return a @ a.T + n * np.eye(n, dtype="f4")
    add("norm", lambda f, i, r: C(A(f(3, 4)), 3.0, 1))
    add("norm_fro", lambda f, i, r: C(A(f(3, 4))))
    add("norm_nuc", lambda f, i, r: C(A(f(3, 4)), "nuc", [0, 1],
                                      rtol=1e-4))
    add("cond", lambda f, i, r: C(A(spd(f)), grad=False, rtol=1e-4))
    add("matrix_power", lambda f, i, r: C(A(f(3, 3)), 3))
    add("det", lambda f, i, r: C(A(spd(f))))
    add("slogdet", lambda f, i, r: C(A(spd(f))))
    add("inv", lambda f, i, r: C(A(spd(f)), rtol=1e-4))
    add("pinv", lambda f, i, r: C(A(f(4, 3)), rtol=1e-4, atol=1e-5))
    add("solve", lambda f, i, r: C(A(spd(f)), A(f(3, 2)), rtol=1e-4))
    add("triangular_solve", lambda f, i, r: C(A(np.triu(spd(f))), A(f(3, 2)),
                                              True, True, rtol=1e-4))
    add("cholesky", lambda f, i, r: C(A(spd(f)), rtol=1e-4))
    add("cholesky_solve", lambda f, i, r: C(A(f(3, 2)),
                                            A(np.linalg.cholesky(spd(f))),
                                            rtol=1e-4))
    add("qr", lambda f, i, r: C(A(f(4, 3)), check="qr"))
    add("svd", lambda f, i, r: C(A(f(4, 3)), check="svd"))
    add("eig", lambda f, i, r: C(A(f(3, 3)), check="eig", grad=False))
    add("eigh", lambda f, i, r: C(A(spd(f)), check="eigh"))
    add("eigvals", lambda f, i, r: C(A(spd(f)), check="eigvals",
                                     grad=False))
    add("eigvalsh", lambda f, i, r: C(A(spd(f)), rtol=1e-4))
    add("lu", lambda f, i, r: C(A(spd(f)), grad=False, rtol=1e-4))
    add("lu_unpack", lambda f, i, r: C(A(spd(f)), check="lu_unpack",
                                       grad=False))
    add("matrix_rank", lambda f, i, r: C(A(f(4, 3)), grad=False))
    add("multi_dot", lambda f, i, r: C([A(f(2, 3)), A(f(3, 4)), A(f(4, 2))]))
    add("lstsq", lambda f, i, r: C(A(f(5, 3)), A(f(5, 2)), grad=False,
                                   rtol=1e-4, atol=1e-5))
    add("corrcoef", lambda f, i, r: C(A(f(3, 6)), rtol=1e-4))
    add("cov", lambda f, i, r: C(A(f(3, 6))))
    add("householder_product", lambda f, i, r: C(A(f(4, 3)), A(f(3)),
                                                 rtol=1e-4))
    add("pca_lowrank", lambda f, i, r: C(A(f(5, 4)), 2, check="pca"))

    # ---- random: shape and dtype ----
    for n, args in (("rand", ([2, 3],)), ("randn", ([2, 3],)),
                    ("standard_normal", ([2, 3],)),
                    ("randint", (0, 5, [2, 3])),
                    ("uniform", ([2, 3], "float32", -2.0, 2.0)),
                    ("normal", (1.0, 2.0, [2, 3])),
                    ("randperm", (6,))):
        add(n, lambda f, i, r, args=args: C(*args, shape_only=True,
                                            grad=False))
    add("randint_like", lambda f, i, r: C(A(i(2, 3)), 0, 4, shape_only=True,
                                          grad=False))
    add("poisson", lambda f, i, r: C(A(f(2, 3, lo=1, hi=3)),
                                     shape_only=True, grad=False))
    add("bernoulli", lambda f, i, r: C(A(f(2, 3, lo=0, hi=1)),
                                       shape_only=True, grad=False))
    add("multinomial", lambda f, i, r: C(A(f(2, 4, lo=.1, hi=1)), 2,
                                         shape_only=True, grad=False))
    for n in ("exponential_", "uniform_", "normal_"):
        add(n, lambda f, i, r: C(A(f(2, 3), grad=False), shape_only=True,
                                 grad=False))
    add("gumbel_softmax", lambda f, i, r: C(A(f(2, 4)), shape_only=True,
                                            grad=False))
    # ---- breadth: stacking, scatter views, predicates, shifts ----
    add("atleast_1d", lambda f, i, r: C(A(f()), A(f(2, 2))))
    add("atleast_2d", lambda f, i, r: C(A(f(3))))
    add("atleast_3d", lambda f, i, r: C(A(f(2, 3))))
    add("hstack", lambda f, i, r: C([A(f(2, 3)), A(f(2, 2))]))
    add("vstack", lambda f, i, r: C([A(f(2, 3)), A(f(1, 3))]))
    add("row_stack", lambda f, i, r: C([A(f(2, 3)), A(f(1, 3))]))
    add("dstack", lambda f, i, r: C([A(f(2, 3)), A(f(2, 3))]))
    add("column_stack", lambda f, i, r: C([A(f(3)), A(f(3, 2))]))
    add("block_diag", lambda f, i, r: C([A(f(2, 2)), A(f(1, 3))]))
    add("diag_embed", lambda f, i, r: C(A(f(2, 3)), 1))
    add("combinations", lambda f, i, r: C(A(f(4)), 2))
    add("cartesian_prod", lambda f, i, r: C([A(f(2)), A(f(3))]))
    add("diagonal_scatter", lambda f, i, r: C(A(f(3, 4)), A(f(3)), 1))
    add("select_scatter", lambda f, i, r: C(A(f(3, 4)), A(f(4)), 0, 1))
    add("slice_scatter", lambda f, i, r: C(A(f(4, 6)), A(f(4, 2)), [1], [0],
                                           [6], [3]))
    add("signbit", lambda f, i, r: C(A(f(5))))
    special = np.array([np.inf, -np.inf, 1.0, np.nan], np.float32)
    for n in ("isposinf", "isneginf"):
        add(n, lambda f, i, r: C(A(special), grad=False))
    add("isreal", lambda f, i, r: C(A(f(3))))
    add("positive", lambda f, i, r: C(A(f(3, 4))))
    add("negative", lambda f, i, r: C(A(f(3, 4))))
    add("bitwise_left_shift", lambda f, i, r: C(A(i(5, lo=-20, hi=20)),
                                                A(i(5, lo=0, hi=5))))
    add("bitwise_right_shift", lambda f, i, r: C(A(i(5, lo=-20, hi=20)),
                                                 A(i(5, lo=0, hi=5))))
    add("bitwise_right_shift_logical",
        lambda f, i, r: C(A(i(5, lo=-20, hi=20)), A(i(5, lo=1, hi=5)),
                          kw={"is_arithmetic": False}))
    add("bitwise_invert", lambda f, i, r: C(A(i(5))))
    add("sinc", lambda f, i, r: C(A(f(6))))
    add("cbrt", lambda f, i, r: C(A(f(6, lo=0.2, hi=2) *
                                    np.array([1, -1] * 3, "f4"))))
    add("sigmoid", lambda f, i, r: C(A(f(3, 4))))
    add("pdist", lambda f, i, r: C(A(f(4, 3))))
    add("pdist_p", lambda f, i, r: C(A(f(4, 3)), 1.5))
    add("reduce_as", lambda f, i, r: C(A(f(2, 3, 4)),
                                       A(f(3, 1), grad=False)))
    add("rearrange", lambda f, i, r: C(A(f(2, 3, 4)), "a b c -> b (a c)"))
    add("reverse", lambda f, i, r: C(A(f(3, 4)), [0]))
    add("where_", lambda f, i, r: C(A(np.array([True, False, True])),
                                    A(f(3), grad=False), A(f(3), grad=False),
                                    grad=False))
    # the in-place family: the base op's case, nothing to differentiate
    for base in INPLACE_BASES:
        if base in out:
            c = out[base]
            out[base + "_"] = C(*[_no_grad(a) for a in c.args], kw=c.kw,
                                grad=False, rtol=c.rtol, atol=c.atol,
                                check=c.check, shape_only=c.shape_only)
    return out


INPLACE_BASES = (
    "abs", "acos", "add", "addmm", "atan", "bitwise_and", "bitwise_invert",
    "bitwise_not", "bitwise_or", "bitwise_xor", "cast", "ceil", "clip",
    "cos", "cumprod", "cumsum", "digamma", "divide", "equal", "erf",
    "erfinv", "exp", "expm1", "fill_diagonal_tensor", "floor",
    "floor_divide", "floor_mod", "frac", "gcd", "greater_equal",
    "greater_than", "i0", "index_add", "index_put", "lcm", "ldexp", "lerp",
    "less_equal", "less_than", "lgamma", "log", "log10", "log1p", "log2",
    "logical_and", "logical_not", "logical_or", "logical_xor", "logit",
    "mod", "multiply", "nan_to_num", "neg", "not_equal", "polygamma",
    "pow", "put_along_axis", "reciprocal", "remainder", "renorm", "round",
    "scale", "scatter", "sigmoid", "sin", "sinh", "sqrt", "square",
    "squeeze", "subtract", "tan", "tanh", "tril", "triu", "trunc",
    "unsqueeze")


def _no_grad(a):
    if isinstance(a, A):
        return A(a.arr, grad=False)
    if isinstance(a, (list, tuple)):
        return type(a)(_no_grad(x) for x in a)
    return a


CASES = cases()
ALIASES = {"pad_reflect": "pad", "pad_replicate": "pad",
           "pad_circular": "pad", "norm_fro": "norm", "norm_nuc": "norm",
           "bitwise_right_shift_logical": "bitwise_right_shift",
           "pdist_p": "pdist", "heaviside_int": "heaviside",
           "floor_divide_by_zero": "floor_divide"}




def module_of(name, ops):
    """(module name, op name) of a case in the op library ``ops`` (the
    port's or the JAX package's: the names are the same)."""
    base = ALIASES.get(name, name)
    for m in MODULES:
        if base in getattr(ops, m).__all__:
            return m, base
    raise KeyError(name)


# ---- the sweep: every case on a device against the same port op on the
# CPU (chip_smoke.py's eager phase, tests/test_torch_cuda.py) ----

SWEEP_TOL = (1e-4, 1e-5)     # float32 card vs CPU: rtol, atol


def _build(P, case, device, grads):
    def conv(a):
        if isinstance(a, A):
            diff = case.grad and a.grad and a.arr.dtype.kind == "f"
            t = P.to_tensor(a.arr.copy(), place=device,
                            stop_gradient=not diff)
            if diff:
                grads.append(t)
            return t
        if isinstance(a, list):
            return [conv(x) for x in a]
        if isinstance(a, tuple):
            return tuple(conv(x) for x in a)
        return a
    return [conv(a) for a in case.args]


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _flat(o)]
    return [out]


def _run(P, name, device, as_method=False):
    """(outputs, differentiable inputs) of the case on ``device`` (also the
    default device while it runs, for the creation ops)."""
    from paddle_tpu_torch.core import device as pdev
    prev = getattr(pdev._state, "device", None)
    P.set_device(device)
    try:
        return _run_on(P, name, device, as_method)
    finally:
        pdev._state.device = prev


def _run_on(P, name, device, as_method):
    import torch
    case = CASES[name]
    mod, base = module_of(name, P.ops)
    fn = getattr(getattr(P.ops, mod), base)
    grads = []
    args = _build(P, case, device, grads)
    if case.check == "lu_unpack":
        args = list(P.linalg.lu(args[0]))
    if case.raises:
        try:
            fn(*args, **case.kw)
        except NotImplementedError:
            return None, []
        raise AssertionError(f"{name}: did not raise")
    if as_method:
        out = getattr(args[0], base)(*args[1:], **case.kw)
    else:
        out = fn(*args, **case.kw)
    flat = [o for o in _flat(out) if isinstance(o, torch.Tensor)]
    if case.grad and grads:
        heads = [o for o in flat if o.is_floating_point() and o.requires_grad]
        if heads:
            w = _rng(name + "w").uniform(-1, 1, tuple(heads[0].shape))
            P.sum(P.multiply(heads[0], P.to_tensor(
                w.astype(np.float32), place=device).astype(
                    heads[0].dtype))).backward()
    return out, grads


def _np(t):
    return t.detach().cpu().float().numpy() if t.dtype.is_floating_point \
        and t.dtype.itemsize < 4 else t.detach().cpu().numpy()


def _factor_ok(kind, a, outs):
    o = [np.asarray(_np(t), np.complex128 if t.is_complex() else
                    np.float64) for t in outs]
    tol = dict(rtol=1e-3, atol=1e-4)
    if kind == "qr":
        np.testing.assert_allclose(o[0] @ o[1], a, **tol)
    elif kind == "svd":
        np.testing.assert_allclose((o[0] * o[1]) @ o[2], a, **tol)
    elif kind in ("eig", "eigh"):
        np.testing.assert_allclose(a @ o[1], o[1] * o[0], **tol)


def sweep_case(P, name, device):
    """Hold case ``name`` on ``device`` against the CPU; returns how many
    calls it checked (the function, and the method where ``Tensor`` has
    the op as one)."""
    import torch
    case = CASES[name]
    got, ggot = _run(P, name, device)
    want, gwant = _run(P, name, "cpu")
    if case.raises:
        return 1
    fg, fw = _flat(got), _flat(want)
    assert len(fg) == len(fw), name
    for k, (g, w) in enumerate(zip(fg, fw)):
        if not isinstance(g, torch.Tensor):
            assert g == w or isinstance(g, (float, bool)) and \
                abs(float(g) - float(w)) < 1e-5, (name, g, w)
            continue
        assert g.device.type == torch.device(device).type, \
            f"{name}[{k}] on {g.device}, not {device}"
        assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
        if case.shape_only or case.check in ("eig", "eigvals", "pca",
                                             "lu_unpack"):
            continue
        if case.check:
            continue
        if g.dtype.is_floating_point or g.is_complex():
            rtol, atol = max(case.rtol, SWEEP_TOL[0]), max(case.atol,
                                                          SWEEP_TOL[1])
            np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol,
                                       err_msg=f"{name}[{k}]")
        else:
            np.testing.assert_array_equal(_np(g), _np(w),
                                          err_msg=f"{name}[{k}]")
    if case.check in ("qr", "svd", "eig", "eigh"):
        _factor_ok(case.check, case.args[0].arr.astype(np.float64), fg)
    if not case.check:
        for k, (a, b) in enumerate(zip(ggot, gwant)):
            if b.grad is None:
                continue
            np.testing.assert_allclose(_np(a.grad), _np(b.grad),
                                       rtol=max(case.rtol, SWEEP_TOL[0]),
                                       atol=max(case.atol, SWEEP_TOL[1]),
                                       err_msg=f"{name} grad[{k}]")
    n = 1
    mod, base = module_of(name, P.ops)
    if case.args and isinstance(case.args[0], A) and not case.raises and \
            getattr(P.Tensor, base, None) is getattr(getattr(P.ops, mod),
                                                     base):
        m, _ = _run(P, name, device, as_method=True)
        if not (case.shape_only or case.check):
            for g, w in zip(_flat(m), fg):
                if isinstance(g, torch.Tensor):
                    assert g.device == w.device
                    np.testing.assert_array_equal(_np(g), _np(w))
        n += 1
    return n


# The in-place cases whose result changes the target's dtype or shape, so
# that the op rebinds the target (ops/breadth.py's docstring): ``cast_``
# (float32 to float64 here), the comparisons (bool) and the shape changes.
# Every other in-place case writes into the target's storage.
INPLACE_REBINDS = ("cast_", "equal_", "greater_equal_", "greater_than_",
                   "less_equal_", "less_than_", "not_equal_", "squeeze_",
                   "unsqueeze_")


def inplace_keeps_storage(P, name, device):
    """Run the in-place case ``name`` on ``device``: the op returns its
    first argument; a case of ``INPLACE_REBINDS`` changes its dtype or
    shape, and every other case keeps its dtype, shape and storage (a
    true in-place write). Returns whether the write was true in-place."""
    from paddle_tpu_torch.core import device as pdev
    case = CASES[name]
    mod, base = module_of(name, P.ops)
    fn = getattr(getattr(P.ops, mod), base)
    prev = getattr(pdev._state, "device", None)
    P.set_device(device)
    try:
        args = _build(P, case, device, [])
        x = args[1] if base == "where_" else args[0]
        ptr, dtype, shape = x.data_ptr(), x.dtype, tuple(x.shape)
        out = fn(*args, **case.kw)
    finally:
        pdev._state.device = prev
    assert out is x, f"{name}: the result is not the target tensor"
    assert x.device.type == device.split(":")[0], name
    kept = x.dtype == dtype and tuple(x.shape) == shape
    assert kept == (name not in INPLACE_REBINDS), \
        f"{name}: dtype {dtype} -> {x.dtype}, shape {shape} -> " \
        f"{tuple(x.shape)}; INPLACE_REBINDS says it " + \
        ("rebinds" if name in INPLACE_REBINDS else "writes in place")
    if kept:
        assert x.data_ptr() == ptr, f"{name}: the storage moved"
    return kept
