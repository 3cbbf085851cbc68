"""The ``nn`` case tables: the functionals (``FCASES``) and layers
(``LCASES``) of the port's ``nn``, with inputs made by numpy from a
per-name seed, and ``sweep_nn``, which holds every case, the in-place
family's storage, the initializers and ``BatchNorm2D``'s running
statistics on a device against the same port calls on the CPU.

JAX-free: ``tests/test_torch_nn_layers.py`` holds each case against the
JAX package on the CPU; ``chip_smoke.py`` (``--nn-only``) and
``tests/test_torch_cuda.py`` run ``sweep_nn`` on the card.
"""
import zlib

import numpy as np

RTOL, ATOL = 1e-5, 1e-6
SWEEP_TOL = (1e-4, 1e-5)     # float32 card vs CPU: rtol, atol


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _f32(r, *shape, lo=-1.0, hi=1.0):
    return r.uniform(lo, hi, shape).astype(np.float32)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _flat(o)]
    return [out]


def _ids(r, *shape, hi=5):
    return r.integers(0, hi, shape).astype(np.int64)


def _fcases():
    """name -> (fn(pkg, F, *tensors), inputs(r), tol)."""
    c = {}

    def add(name, fn, build, tol=(RTOL, ATOL)):
        c[name] = (fn, build, tol)

    x34 = (lambda r: [_f32(r, 3, 4, lo=-2, hi=2)])
    for n in ("relu", "relu6", "relu_", "elu", "selu", "celu", "silu",
              "swish", "mish", "softplus", "softshrink", "hardshrink",
              "tanhshrink", "sigmoid", "hardsigmoid", "hardswish",
              "hardtanh", "log_sigmoid", "softmax", "log_softmax",
              "softsign", "thresholded_relu", "tanh", "glu", "gelu"):
        add(n, lambda p, F, x, n=n: getattr(F, n)(x), x34)
    add("gelu_tanh", lambda p, F, x: F.gelu(x, approximate=True), x34)
    add("leaky_relu", lambda p, F, x: F.leaky_relu(x, 0.1), x34)
    add("prelu", lambda p, F, x, w: F.prelu(x, w),
        lambda r: [_f32(r, 2, 3, 4), _f32(r, 3)])
    add("maxout", lambda p, F, x: F.maxout(x, 2),
        lambda r: [_f32(r, 2, 4, 3)])
    add("rrelu_eval", lambda p, F, x: F.rrelu(x), x34)
    add("softmax_axis0_f64", lambda p, F, x: F.softmax(x, 0, "float64"),
        x34, (1e-10, 1e-12))
    # ---- common ----
    add("linear", lambda p, F, x, w, b: F.linear(x, w, b),
        lambda r: [_f32(r, 2, 3), _f32(r, 3, 4), _f32(r, 4)])
    add("embedding", lambda p, F, i, w: F.embedding(i, w, padding_idx=1),
        lambda r: [_ids(r, 2, 3), _f32(r, 5, 4)])
    add("dropout_p0", lambda p, F, x: F.dropout(x, 0.0), x34)
    add("dropout_infer", lambda p, F, x: F.dropout(
        x, 0.3, training=False, mode="downscale_in_infer"), x34)
    add("dropout2d_eval", lambda p, F, x: F.dropout2d(x, 0.5, False),
        lambda r: [_f32(r, 2, 3, 4, 4)])
    add("alpha_dropout_eval", lambda p, F, x: F.alpha_dropout(
        x, 0.5, training=False), x34)
    img = (lambda r: [_f32(r, 2, 3, 5, 6)])
    add("unfold", lambda p, F, x: F.unfold(x, [2, 3], 1, [1, 0, 0, 1]), img)
    add("unfold_strided", lambda p, F, x: F.unfold(x, 2, 2, 1, 1), img)
    add("fold", lambda p, F, x: F.fold(x, [4, 5], 2),
        lambda r: [_f32(r, 2, 12, 12)])
    for mode in ("nearest", "bilinear", "bicubic"):
        add(f"interpolate_{mode}_up", lambda p, F, x, m=mode: F.interpolate(
            x, scale_factor=2, mode=m), img)
        add(f"interpolate_{mode}_down", lambda p, F, x, m=mode:
            F.interpolate(x, size=[3, 4], mode=m), img)
    add("interpolate_align_corners", lambda p, F, x: F.interpolate(
        x, size=[7, 9], mode="bilinear", align_corners=True), img)
    add("interpolate_linear_nwc", lambda p, F, x: F.interpolate(
        x, size=[7], mode="linear", data_format="NWC"),
        lambda r: [_f32(r, 2, 5, 3)])
    add("upsample", lambda p, F, x: F.upsample(x, size=[10, 3]), img)
    add("pixel_shuffle", lambda p, F, x: F.pixel_shuffle(x, 2),
        lambda r: [_f32(r, 2, 8, 3, 3)])
    add("pixel_shuffle_nhwc", lambda p, F, x: F.pixel_shuffle(
        x, 2, "NHWC"), lambda r: [_f32(r, 2, 3, 3, 8)])
    add("pixel_unshuffle", lambda p, F, x: F.pixel_unshuffle(x, 2),
        lambda r: [_f32(r, 2, 2, 4, 6)])
    add("channel_shuffle", lambda p, F, x: F.channel_shuffle(x, 2),
        lambda r: [_f32(r, 2, 6, 3, 3)])
    for mode in ("constant", "reflect", "replicate", "circular"):
        add(f"pad_{mode}", lambda p, F, x, m=mode: F.pad(
            x, [1, 2, 2, 1], mode=m, value=0.5), img)
    add("zeropad2d", lambda p, F, x: F.zeropad2d(x, [1, 0, 2, 1]), img)
    add("cosine_similarity", lambda p, F, a, b: F.cosine_similarity(a, b),
        lambda r: [_f32(r, 3, 4), _f32(r, 3, 4)])
    add("label_smooth", lambda p, F, x: F.label_smooth(x, epsilon=0.2), x34)
    add("label_smooth_prior", lambda p, F, x, d: F.label_smooth(x, d, 0.1),
        lambda r: [_f32(r, 3, 4), _f32(r, 4)])
    add("bilinear", lambda p, F, a, b, w, bias: F.bilinear(a, b, w, bias),
        lambda r: [_f32(r, 2, 3), _f32(r, 2, 4), _f32(r, 5, 3, 4),
                   _f32(r, 5)])
    # ---- norm ----
    add("normalize", lambda p, F, x: F.normalize(x, p=3, axis=0), x34)
    add("layer_norm", lambda p, F, x, w, b: F.layer_norm(x, [4], w, b),
        lambda r: [_f32(r, 2, 3, 4), _f32(r, 4), _f32(r, 4)])
    add("layer_norm_2d", lambda p, F, x: F.layer_norm(x, [3, 4]),
        lambda r: [_f32(r, 2, 3, 4)])
    add("batch_norm_global", lambda p, F, x, m, v, w, b: F.batch_norm(
        x, m, v, w, b), lambda r: [_f32(r, 2, 3, 4), _f32(r, 3),
                                   _f32(r, 3, lo=0.5, hi=2), _f32(r, 3),
                                   _f32(r, 3)])
    add("instance_norm", lambda p, F, x, w, b: F.instance_norm(
        x, weight=w, bias=b), lambda r: [_f32(r, 2, 3, 4, 4), _f32(r, 3),
                                         _f32(r, 3)])
    add("group_norm", lambda p, F, x, w, b: F.group_norm(x, 2, w, b),
        lambda r: [_f32(r, 2, 4, 3, 3), _f32(r, 4), _f32(r, 4)])
    add("group_norm_nhwc", lambda p, F, x: F.group_norm(
        x, 2, data_format="NHWC"), lambda r: [_f32(r, 2, 3, 3, 4)])
    add("local_response_norm", lambda p, F, x: F.local_response_norm(
        x, 3, alpha=0.1), lambda r: [_f32(r, 2, 5, 3, 3)])
    add("rms_norm", lambda p, F, x, w: F.rms_norm(x, w),
        lambda r: [_f32(r, 3, 4), _f32(r, 4)])
    # ---- losses, with their reductions and ignore_index ----
    logits = (lambda r: [_f32(r, 6, 5, lo=-3, hi=3),
                         np.array([0, 4, -100, 2, 1, -100], np.int64)])
    for red in ("mean", "sum", "none"):
        add(f"cross_entropy_{red}", lambda p, F, x, y, red=red:
            F.cross_entropy(x, y, reduction=red), logits)
        add(f"nll_loss_{red}", lambda p, F, x, y, red=red: F.nll_loss(
            F.log_softmax(x), y, reduction=red), logits)
        add(f"mse_loss_{red}", lambda p, F, a, b, red=red: F.mse_loss(
            a, b, red), lambda r: [_f32(r, 3, 4), _f32(r, 3, 4)])
        add(f"l1_loss_{red}", lambda p, F, a, b, red=red: F.l1_loss(
            a, b, red), lambda r: [_f32(r, 3, 4), _f32(r, 3, 4)])
    add("cross_entropy_weighted", lambda p, F, x, y, w: F.cross_entropy(
        x, y, weight=w, label_smoothing=0.1),
        lambda r: logits(r) + [_f32(r, 5, lo=0.5, hi=2)])
    add("cross_entropy_soft", lambda p, F, x, y: F.cross_entropy(
        x, F.softmax(y), soft_label=True),
        lambda r: [_f32(r, 4, 5), _f32(r, 4, 5)])
    add("softmax_with_cross_entropy", lambda p, F, x, y:
        F.softmax_with_cross_entropy(x, y, return_softmax=True), logits)
    add("nll_loss_weighted", lambda p, F, x, y, w: F.nll_loss(
        F.log_softmax(x), y, w),
        lambda r: logits(r) + [_f32(r, 5, lo=0.5, hi=2)])
    probs = (lambda r: [_f32(r, 3, 4, lo=0.05, hi=0.95),
                        (_f32(r, 3, 4) > 0).astype(np.float32)])
    add("binary_cross_entropy", lambda p, F, a, y: F.binary_cross_entropy(
        a, y), probs)
    add("binary_cross_entropy_weighted", lambda p, F, a, y, w:
        F.binary_cross_entropy(a, y, w, "sum"),
        lambda r: probs(r) + [_f32(r, 4)])
    add("bce_with_logits", lambda p, F, a, y, pw:
        F.binary_cross_entropy_with_logits(a, y, pos_weight=pw),
        lambda r: probs(r) + [_f32(r, 4, lo=0.5, hi=2)])
    add("smooth_l1_loss", lambda p, F, a, b: F.smooth_l1_loss(
        a, b, delta=0.5), lambda r: [_f32(r, 3, 4), _f32(r, 3, 4)])
    add("huber_loss", lambda p, F, a, b: F.huber_loss(a, b, 0.7, "sum"),
        lambda r: [_f32(r, 3, 4), _f32(r, 3, 4)])
    add("square_error_cost", lambda p, F, a, b: F.square_error_cost(a, b),
        lambda r: [_f32(r, 3, 4), _f32(r, 3, 4)])
    for red in ("mean", "batchmean", "none"):
        add(f"kl_div_{red}", lambda p, F, x, y, red=red: F.kl_div(
            F.log_softmax(x), F.softmax(y), red),
            lambda r: [_f32(r, 3, 4), _f32(r, 3, 4)])
    add("log_loss", lambda p, F, a, y: F.log_loss(a, y), probs)
    sign = (lambda r: np.where(_f32(r, 6) > 0, 1.0, -1.0).astype("f4"))
    add("margin_ranking_loss", lambda p, F, a, b, y:
        F.margin_ranking_loss(a, b, y, 0.1),
        lambda r: [_f32(r, 6), _f32(r, 6), sign(r)])
    add("hinge_embedding_loss", lambda p, F, a, y: F.hinge_embedding_loss(
        a, y, 0.5, "sum"), lambda r: [_f32(r, 6), sign(r)])
    add("cosine_embedding_loss", lambda p, F, a, b, y:
        F.cosine_embedding_loss(a, b, y, 0.1),
        lambda r: [_f32(r, 6, 4), _f32(r, 6, 4), sign(r)])
    add("triplet_margin_loss", lambda p, F, a, b, c: F.triplet_margin_loss(
        a, b, c, swap=True), lambda r: [_f32(r, 5, 4), _f32(r, 5, 4),
                                        _f32(r, 5, 4)])
    add("sigmoid_focal_loss", lambda p, F, a, y, n: F.sigmoid_focal_loss(
        a, y, n), lambda r: probs(r) + [np.array([3.0], np.float32)])
    add("ctc_loss", lambda p, F, lp, lab, il, ll: F.ctc_loss(
        F.log_softmax(lp), lab, il, ll),
        lambda r: [_f32(r, 8, 2, 5, lo=-2, hi=2),
                   np.array([[1, 2, 2], [3, 1, 0]], np.int64),
                   np.array([8, 6], np.int64), np.array([3, 2], np.int64)],
        (1e-4, 1e-5))
    # ---- attention ----
    qkv = (lambda r: [_f32(r, 2, 5, 2, 4), _f32(r, 2, 5, 2, 4),
                      _f32(r, 2, 5, 2, 4)])
    add("sdpa_masked", lambda p, F, q, k, v, m:
        F.scaled_dot_product_attention(q, k, v, m),
        lambda r: qkv(r) + [_f32(r, 1, 1, 5, 5)])
    add("sdpa_causal", lambda p, F, q, k, v:
        F.scaled_dot_product_attention(q, k, v, is_causal=True), qkv,
        (1e-4, 1e-5))
    add("flash_attention", lambda p, F, q, k, v: F.flash_attention(
        q, k, v, causal=True)[0], qkv, (1e-4, 1e-5))
    return c



FCASES = _fcases()


def _lcases():
    """name -> (build(pkg), inputs(r), call(layer, *ts))."""
    def nn(pkg):
        return pkg.nn

    img = (lambda r: [_f32(r, 2, 3, 4, 4)])
    seq = (lambda r: [_f32(r, 2, 5, 8)])
    one = (lambda layer, *ts: layer(*ts))
    c = {
        "Linear": (lambda p: nn(p).Linear(4, 3), lambda r: [_f32(r, 2, 4)],
                   one),
        "Bilinear": (lambda p: nn(p).Bilinear(3, 4, 2),
                     lambda r: [_f32(r, 2, 3), _f32(r, 2, 4)], one),
        "PReLU": (lambda p: nn(p).PReLU(3, 0.1), img, one),
        "LeakyReLU": (lambda p: nn(p).LeakyReLU(0.2), img, one),
        "ELU": (lambda p: nn(p).ELU(0.5), img, one),
        "Softplus": (lambda p: nn(p).Softplus(2.0, 1.0), img, one),
        "Hardtanh": (lambda p: nn(p).Hardtanh(-0.5, 0.5), img, one),
        "Maxout": (lambda p: nn(p).Maxout(3), lambda r: [_f32(r, 2, 6, 2)],
                   one),
        "Softmax": (lambda p: nn(p).Softmax(1), img, one),
        "Flatten": (lambda p: nn(p).Flatten(), img, one),
        "Identity": (lambda p: nn(p).Identity(), img, one),
        "Upsample": (lambda p: nn(p).UpsamplingBilinear2D(scale_factor=2),
                     img, one),
        "UpsamplingNearest2D": (lambda p: nn(p).UpsamplingNearest2D(
            size=[6, 5]), img, one),
        "Pad2D": (lambda p: nn(p).Pad2D([1, 0, 1, 2], mode="reflect"), img,
                  one),
        "ZeroPad2D": (lambda p: nn(p).ZeroPad2D([1, 1, 0, 2]), img, one),
        "CosineSimilarity": (lambda p: nn(p).CosineSimilarity(1),
                             lambda r: [_f32(r, 3, 4), _f32(r, 3, 4)], one),
        "PixelShuffle": (lambda p: nn(p).PixelShuffle(2),
                         lambda r: [_f32(r, 1, 8, 2, 2)], one),
        "Unfold": (lambda p: nn(p).Unfold(2, paddings=1), img, one),
        "Fold": (lambda p: nn(p).Fold([3, 3], 2),
                 lambda r: [_f32(r, 1, 8, 4)], one),
        "LayerNorm": (lambda p: nn(p).LayerNorm(8), seq, one),
        "GroupNorm": (lambda p: nn(p).GroupNorm(1, 3), img, one),
        "InstanceNorm2D": (lambda p: nn(p).InstanceNorm2D(3), img, one),
        "LocalResponseNorm": (lambda p: nn(p).LocalResponseNorm(2), img,
                              one),
        "BatchNorm2D_eval": (lambda p: nn(p).BatchNorm2D(3).eval(), img,
                             one),
        "SpectralNorm": (lambda p: nn(p).SpectralNorm([4, 3], 0, 2),
                         lambda r: [_f32(r, 4, 3)], one),
        "CrossEntropyLoss": (lambda p: nn(p).CrossEntropyLoss(
            ignore_index=1), lambda r: [_f32(r, 4, 5), _ids(r, 4)], one),
        "BCEWithLogitsLoss": (lambda p: nn(p).BCEWithLogitsLoss(),
                              lambda r: [_f32(r, 4), _f32(r, 4, lo=0, hi=1)],
                              one),
        "TripletMarginLoss": (lambda p: nn(p).TripletMarginLoss(0.5),
                              lambda r: [_f32(r, 3, 4), _f32(r, 3, 4),
                                         _f32(r, 3, 4)], one),
        "MultiHeadAttention": (
            lambda p: nn(p).MultiHeadAttention(8, 2),
            lambda r: seq(r) + [np.triu(np.full((5, 5), -1e9, np.float32),
                                        1)],
            lambda layer, x, m: layer(x, attn_mask=m)),
        "TransformerEncoder": (
            lambda p: nn(p).TransformerEncoder(nn(p).TransformerEncoderLayer(
                8, 2, 16, dropout=0.0, normalize_before=True), 2),
            seq, one),
        "TransformerDecoderLayer": (
            lambda p: nn(p).TransformerDecoderLayer(8, 2, 16, dropout=0.0,
                                                   activation="gelu"),
            lambda r: [_f32(r, 2, 4, 8), _f32(r, 2, 5, 8)], one),
        "Transformer": (
            lambda p: nn(p).Transformer(8, 2, 1, 1, 16, dropout=0.0,
                                        normalize_before=True),
            lambda r: [_f32(r, 2, 5, 8), _f32(r, 2, 4, 8)], one),
    }
    return c



LCASES = _lcases()


# ---- conv, pooling, rnn and the rest of nn (the convolution, pooling,
# recurrent and extras slice): tables of their own, so each test file
# holds its own slice against the JAX package; sweep_nn runs them all ----

def _conv_pool_fcases():
    c = {}

    def add(name, fn, build, tol=(RTOL, ATOL)):
        c[name] = (fn, build, tol)

    img = (lambda r: [_f32(r, 2, 3, 7, 8), _f32(r, 4, 3, 3, 3), _f32(r, 4)])
    add("conv2d", lambda p, F, x, w, b: F.conv2d(x, w, b, 1, 1), img)
    add("conv2d_same_stride2", lambda p, F, x, w, b: F.conv2d(
        x, w, b, 2, "SAME"), img)
    add("conv2d_valid", lambda p, F, x, w, b: F.conv2d(x, w, b, 1, "VALID"),
        img)
    add("conv2d_asymmetric_pad", lambda p, F, x, w, b: F.conv2d(
        x, w, b, 1, [1, 0, 2, 1]), img)
    add("conv2d_dilation", lambda p, F, x, w, b: F.conv2d(
        x, w, b, 1, 2, dilation=2), img)
    add("conv2d_nhwc", lambda p, F, x, w, b: F.conv2d(
        x, w, b, 1, 1, data_format="NHWC"),
        lambda r: [_f32(r, 2, 7, 8, 3), _f32(r, 4, 3, 3, 3), _f32(r, 4)])
    add("conv2d_groups", lambda p, F, x, w: F.conv2d(x, w, None, 1, 1,
                                                     groups=2),
        lambda r: [_f32(r, 2, 4, 5, 5), _f32(r, 6, 2, 3, 3)])
    add("conv1d_same_stride2", lambda p, F, x, w: F.conv1d(
        x, w, None, 2, "SAME"), lambda r: [_f32(r, 2, 3, 9), _f32(r, 4, 3, 3)])
    add("conv1d_nlc", lambda p, F, x, w, b: F.conv1d(
        x, w, b, 1, [0, 2], data_format="NLC"),
        lambda r: [_f32(r, 2, 9, 3), _f32(r, 4, 3, 3), _f32(r, 4)])
    add("conv3d", lambda p, F, x, w, b: F.conv3d(x, w, b, 1, 1),
        lambda r: [_f32(r, 1, 2, 4, 4, 4), _f32(r, 3, 2, 3, 3, 3),
                   _f32(r, 3)])
    timg = (lambda r: [_f32(r, 2, 3, 4, 5), _f32(r, 3, 4, 3, 3),
                       _f32(r, 4)])
    add("conv2d_transpose", lambda p, F, x, w, b: F.conv2d_transpose(
        x, w, b, 2, 1), timg)
    add("conv2d_transpose_output_size", lambda p, F, x, w, b:
        F.conv2d_transpose(x, w, b, 2, 1, output_size=[8, 10]), timg)
    add("conv2d_transpose_asymmetric_pad", lambda p, F, x, w, b:
        F.conv2d_transpose(x, w, b, 2, [1, 0, 0, 2]), timg)
    add("conv2d_transpose_same", lambda p, F, x, w, b: F.conv2d_transpose(
        x, w, b, 2, "SAME"), timg)
    add("conv2d_transpose_output_padding", lambda p, F, x, w, b:
        F.conv2d_transpose(x, w, b, 2, 1, output_padding=1), timg)
    add("conv2d_transpose_nhwc", lambda p, F, x, w, b: F.conv2d_transpose(
        x, w, b, 2, 1, data_format="NHWC"),
        lambda r: [_f32(r, 2, 4, 5, 3), _f32(r, 3, 4, 3, 3), _f32(r, 4)])
    add("conv1d_transpose_dilation", lambda p, F, x, w: F.conv1d_transpose(
        x, w, None, 3, 0, dilation=2),
        lambda r: [_f32(r, 2, 3, 5), _f32(r, 3, 2, 3)])
    add("conv3d_transpose", lambda p, F, x, w: F.conv3d_transpose(
        x, w, None, 2, 1), lambda r: [_f32(r, 1, 2, 3, 3, 3),
                                      _f32(r, 2, 2, 3, 3, 3)])
    # pools; L=5, k=2, s=2, p=1 with ceil_mode: a 4th window wholly in the
    # padding (-inf for max, nan for exclusive avg, in both packages)
    row = (lambda r: [_f32(r, 1, 2, 5)])
    add("max_pool1d_ceil_all_pad_window", lambda p, F, x: F.max_pool1d(
        x, 2, 2, 1, ceil_mode=True), row)
    add("avg_pool1d_ceil_all_pad_window", lambda p, F, x: F.avg_pool1d(
        x, 2, 2, 1, ceil_mode=True), row)
    add("avg_pool1d_ceil_inclusive", lambda p, F, x: F.avg_pool1d(
        x, 2, 2, 1, exclusive=False, ceil_mode=True), row)
    add("max_pool1d_mask_ceil", lambda p, F, x: F.max_pool1d(
        x, 2, 2, 1, return_mask=True, ceil_mode=True), row)
    pimg = (lambda r: [_f32(r, 2, 3, 7, 8)])
    add("max_pool2d", lambda p, F, x: F.max_pool2d(x, 3, 2, 1), pimg)
    add("max_pool2d_ceil", lambda p, F, x: F.max_pool2d(
        x, 3, 2, 1, ceil_mode=True), pimg)
    add("max_pool2d_same", lambda p, F, x: F.max_pool2d(x, 3, 2, "SAME"),
        pimg)
    add("max_pool2d_nhwc", lambda p, F, x: F.max_pool2d(
        x, 2, 2, [0, 1, 1, 0], data_format="NHWC"), pimg)
    add("max_pool2d_mask", lambda p, F, x: F.max_pool2d(
        x, 2, 2, 1, return_mask=True), pimg)
    add("max_pool2d_mask_ceil", lambda p, F, x: F.max_pool2d(
        x, 3, 2, 1, return_mask=True, ceil_mode=True), pimg)
    add("avg_pool2d", lambda p, F, x: F.avg_pool2d(x, 3, 2, 1), pimg)
    add("avg_pool2d_inclusive", lambda p, F, x: F.avg_pool2d(
        x, 3, 2, 1, exclusive=False), pimg)
    add("avg_pool2d_ceil", lambda p, F, x: F.avg_pool2d(
        x, 2, 2, [0, 1, 1, 0], ceil_mode=True), pimg)
    add("avg_pool2d_nhwc_divisor", lambda p, F, x: F.avg_pool2d(
        x, 2, 2, 1, divisor_override=3, data_format="NHWC"), pimg)
    vol = (lambda r: [_f32(r, 1, 2, 4, 5, 6)])
    add("max_pool3d_mask", lambda p, F, x: F.max_pool3d(
        x, 2, 2, return_mask=True), vol)
    add("max_pool3d", lambda p, F, x: F.max_pool3d(x, 3, 2, 1), vol)
    add("avg_pool3d", lambda p, F, x: F.avg_pool3d(x, 2, 1, 1), vol)
    add("adaptive_avg_pool1d", lambda p, F, x: F.adaptive_avg_pool1d(x, 4),
        lambda r: [_f32(r, 2, 3, 9)])
    add("adaptive_max_pool1d", lambda p, F, x: F.adaptive_max_pool1d(x, 4),
        lambda r: [_f32(r, 2, 3, 9)])
    add("adaptive_avg_pool2d", lambda p, F, x: F.adaptive_avg_pool2d(
        x, [3, 5]), pimg)
    add("adaptive_avg_pool2d_1", lambda p, F, x: F.adaptive_avg_pool2d(
        x, 1), pimg)
    add("adaptive_max_pool2d", lambda p, F, x: F.adaptive_max_pool2d(
        x, [3, 5]), pimg)
    add("adaptive_avg_pool3d", lambda p, F, x: F.adaptive_avg_pool3d(
        x, [2, 3, 2]), vol)
    add("adaptive_max_pool3d_nhwc", lambda p, F, x: F.adaptive_max_pool3d(
        x, [2, 3, 2], data_format="NDHWC"), vol)
    return c


def _unpool_idx(r, n, c, hw, k):
    """Valid within-plane indices of a k x k, stride k pool over hw x hw."""
    o = hw // k
    di = r.integers(0, k, (n, c, o, o))
    dj = r.integers(0, k, (n, c, o, o))
    ii = np.arange(o)[:, None] * k + di
    jj = np.arange(o)[None, :] * k + dj
    return (ii * hw + jj).astype(np.int32)


def _extras_fcases():
    c = {}

    def add(name, fn, build, tol=(RTOL, ATOL)):
        c[name] = (fn, build, tol)

    x34 = (lambda r: [_f32(r, 3, 4, lo=-2, hi=2)])
    two = (lambda r: [_f32(r, 3, 4), _f32(r, 3, 4)])
    add("pairwise_distance", lambda p, F, a, b: F.pairwise_distance(a, b),
        two)
    add("pairwise_distance_p1_keepdim", lambda p, F, a, b:
        F.pairwise_distance(a, b, 1.0, keepdim=True), two)
    for n, args in (("elu_", (0.5,)), ("hardtanh_", (-0.5, 0.5)),
                    ("leaky_relu_", (0.1,)), ("softmax_", (0,)),
                    ("tanh_", ()), ("thresholded_relu_", (0.3,))):
        # the target is a non-leaf (a leaf that needs a grad is refused)
        add(n, lambda p, F, x, n=n, args=args: getattr(F, n)(
            p.multiply(x, p.to_tensor(np.float32(1.0))), *args), x34)
    add("diag_embed", lambda p, F, x: F.diag_embed(x, 1), x34)
    add("sequence_mask", lambda p, F, n: F.sequence_mask(n, 6),
        lambda r: [np.array([0, 3, 6, 2], np.int64)])
    add("sequence_mask_maxlen_none", lambda p, F, n: F.sequence_mask(
        n, dtype="float32"), lambda r: [np.array([1, 3, 2], np.int64)])
    add("one_hot", lambda p, F, i: F.one_hot(i, 5),
        lambda r: [np.array([[0, 4, 7], [2, -1, 3]], np.int64)])
    add("max_unpool1d_of_max_pool1d_mask", lambda p, F, x: F.max_unpool1d(
        *F.max_pool1d(x, 2, 2, return_mask=True), 2, 2),
        lambda r: [_f32(r, 2, 3, 8)])
    add("max_unpool2d_of_max_pool2d_mask", lambda p, F, x: F.max_unpool2d(
        *F.max_pool2d(x, 2, 2, return_mask=True), 2, 2),
        lambda r: [_f32(r, 2, 3, 6, 8)])
    add("max_unpool2d_output_size", lambda p, F, x, i: F.max_unpool2d(
        x, i, 2, output_size=[5, 4]),
        lambda r: [_f32(r, 1, 2, 2, 2), _unpool_idx(r, 1, 2, 4, 2)])
    add("max_unpool3d_of_max_pool3d_mask", lambda p, F, x: F.max_unpool3d(
        *F.max_pool3d(x, 2, 2, return_mask=True), 2, 2),
        lambda r: [_f32(r, 1, 2, 4, 4, 6)])
    add("dice_loss", lambda p, F, x, y: F.dice_loss(F.softmax(x), y),
        lambda r: [_f32(r, 3, 4, 5), _ids(r, 3, 4, 1)])
    pos = (lambda r: [_f32(r, 3, 4), _f32(r, 3, 4, lo=0.5, hi=3)])
    add("poisson_nll_loss", lambda p, F, a, b: F.poisson_nll_loss(a, b), pos)
    add("poisson_nll_loss_full", lambda p, F, a, b: F.poisson_nll_loss(
        F.softplus(a), b, log_input=False, full=True, reduction="sum"), pos)
    add("npair_loss", lambda p, F, a, b, y: F.npair_loss(a, b, y),
        lambda r: [_f32(r, 4, 3), _f32(r, 4, 3),
                   np.array([0, 1, 0, 2], np.int64)])
    sign = (lambda r: np.where(_f32(r, 3, 4) > 0, 1.0, -1.0).astype("f4"))
    add("soft_margin_loss", lambda p, F, a, y: F.soft_margin_loss(a, y),
        lambda r: [_f32(r, 3, 4), sign(r)])
    add("multi_label_soft_margin_loss", lambda p, F, a, y, w:
        F.multi_label_soft_margin_loss(a, y, w, "sum"),
        lambda r: [_f32(r, 3, 4), (_f32(r, 3, 4) > 0).astype("f4"),
                   _f32(r, 4, lo=0.5, hi=2)])
    add("multi_margin_loss", lambda p, F, a, y, w: F.multi_margin_loss(
        a, y, 2, 0.5, w), lambda r: [_f32(r, 4, 5), _ids(r, 4),
                                     _f32(r, 5, lo=0.5, hi=2)])
    trip = (lambda r: [_f32(r, 5, 4), _f32(r, 5, 4), _f32(r, 5, 4)])
    add("triplet_margin_with_distance_loss", lambda p, F, a, b, c:
        F.triplet_margin_with_distance_loss(a, b, c, swap=True), trip)
    add("triplet_margin_with_distance_loss_l1", lambda p, F, a, b, c:
        F.triplet_margin_with_distance_loss(
            a, b, c, lambda u, v: F.pairwise_distance(u, v, 1.0),
            margin=0.5, reduction="none"), trip)
    add("gaussian_nll_loss", lambda p, F, a, b, v: F.gaussian_nll_loss(
        a, b, v, full=True), lambda r: [_f32(r, 3, 4), _f32(r, 3, 4),
                                        _f32(r, 3, 4, lo=0.1, hi=2)])
    add("hsigmoid_loss", lambda p, F, x, y, w, b: F.hsigmoid_loss(
        x, y, 6, w, b), lambda r: [_f32(r, 4, 3), _ids(r, 4, hi=6),
                                   _f32(r, 5, 3), _f32(r, 5)])
    add("hsigmoid_loss_custom_tree", lambda p, F, x, y, w, t, c:
        F.hsigmoid_loss(x, y, 4, w, None, t, c),
        lambda r: [_f32(r, 3, 3), np.array([0, 2, 1], np.int64),
                   _f32(r, 3, 3),
                   np.array([[0, 1, -1], [0, 2, -1], [0, 1, 2]], np.int64),
                   np.array([[1, 0, 0], [0, 1, 0], [1, 1, 0]], np.int64)])
    add("margin_cross_entropy", lambda p, F, x, y: F.margin_cross_entropy(
        x, y, return_softmax=True),
        lambda r: [_f32(r, 4, 6, lo=-0.9, hi=0.9), _ids(r, 4, hi=6)],
        (1e-4, 1e-5))
    add("rnnt_loss", lambda p, F, a, y, tl, ul: F.rnnt_loss(a, y, tl, ul),
        lambda r: [_f32(r, 2, 4, 3, 5, lo=-2, hi=2),
                   np.array([[1, 2], [3, 0]], np.int32),
                   np.array([4, 3], np.int32), np.array([2, 1], np.int32)],
        (1e-4, 1e-5))
    add("affine_grid", lambda p, F, t: F.affine_grid(t, [2, 3, 4, 5]),
        lambda r: [_f32(r, 2, 2, 3)])
    add("affine_grid_half_pixel", lambda p, F, t: F.affine_grid(
        t, [2, 3, 4, 5], align_corners=False), lambda r: [_f32(r, 2, 2, 3)])
    samp = (lambda r: [_f32(r, 2, 3, 5, 6), _f32(r, 2, 4, 3, 2, lo=-1.2,
                                                   hi=1.2)])
    add("grid_sample", lambda p, F, x, g: F.grid_sample(x, g), samp)
    add("grid_sample_border_half_pixel", lambda p, F, x, g: F.grid_sample(
        x, g, padding_mode="border", align_corners=False), samp)
    add("grid_sample_nearest", lambda p, F, x, g: F.grid_sample(
        x, g, mode="nearest"), samp)
    add("temporal_shift", lambda p, F, x: F.temporal_shift(x, 3, 0.25),
        lambda r: [_f32(r, 6, 8, 2, 2)])
    add("gather_tree", lambda p, F, i, q: F.gather_tree(i, q),
        lambda r: [_ids(r, 4, 2, 3, hi=9), _ids(r, 4, 2, 3, hi=3)])
    add("sparse_attention", lambda p, F, q, k, v, o, c: F.sparse_attention(
        q, k, v, o, c), lambda r: [
            _f32(r, 1, 2, 4, 3), _f32(r, 1, 2, 4, 3), _f32(r, 1, 2, 4, 3),
            np.array([[[0, 2, 3, 5, 6]] * 2], np.int32),
            np.array([[[0, 1, 1, 0, 2, 3]] * 2], np.int32)])
    return c


def _conv_pool_lcases():
    def nn(pkg):
        return pkg.nn

    one = (lambda layer, *ts: layer(*ts))
    img = (lambda r: [_f32(r, 2, 3, 6, 6)])
    seq = (lambda r: [_f32(r, 2, 3, 9)])
    vol = (lambda r: [_f32(r, 1, 2, 4, 4, 4)])
    return {
        "Conv1D": (lambda p: nn(p).Conv1D(3, 4, 3, padding="SAME"), seq,
                   one),
        "Conv2D": (lambda p: nn(p).Conv2D(3, 4, 3, 2, 1), img, one),
        "Conv2D_no_bias_groups": (lambda p: nn(p).Conv2D(
            4, 6, 3, padding=1, groups=2, bias_attr=False),
            lambda r: [_f32(r, 2, 4, 5, 5)], one),
        "Conv3D": (lambda p: nn(p).Conv3D(2, 3, 3, padding=1), vol, one),
        "Conv1DTranspose": (lambda p: nn(p).Conv1DTranspose(3, 2, 3, 2),
                            seq, one),
        "Conv2DTranspose": (lambda p: nn(p).Conv2DTranspose(3, 2, 4, 4),
                            img, one),
        "Conv2DTranspose_output_size": (
            lambda p: nn(p).Conv2DTranspose(3, 2, 3, 2, 1), img,
            lambda layer, x: layer(x, output_size=[12, 12])),
        "Conv3DTranspose": (lambda p: nn(p).Conv3DTranspose(2, 3, 2, 2),
                            vol, one),
        "AvgPool1D": (lambda p: nn(p).AvgPool1D(2, 2, 1, ceil_mode=True),
                      seq, one),
        "AvgPool2D": (lambda p: nn(p).AvgPool2D(3, 2, 1, exclusive=False),
                      img, one),
        "AvgPool3D": (lambda p: nn(p).AvgPool3D(2), vol, one),
        "MaxPool1D": (lambda p: nn(p).MaxPool1D(3, 2, 1), seq, one),
        "MaxPool2D": (lambda p: nn(p).MaxPool2D(3, 2, 1), img, one),
        "MaxPool3D": (lambda p: nn(p).MaxPool3D(2, 2, 1, ceil_mode=True),
                      vol, one),
        "AdaptiveAvgPool1D": (lambda p: nn(p).AdaptiveAvgPool1D(4), seq,
                              one),
        "AdaptiveAvgPool2D": (lambda p: nn(p).AdaptiveAvgPool2D((1, 1)),
                              img, one),
        "AdaptiveAvgPool3D": (lambda p: nn(p).AdaptiveAvgPool3D(3), vol,
                              one),
        "AdaptiveMaxPool1D": (lambda p: nn(p).AdaptiveMaxPool1D(5), seq,
                              one),
        "AdaptiveMaxPool2D": (lambda p: nn(p).AdaptiveMaxPool2D([4, 3]),
                              img, one),
        "AdaptiveMaxPool3D": (lambda p: nn(p).AdaptiveMaxPool3D(2), vol,
                              one),
    }


def _rnn_lcases():
    """The recurrent layers (outputs; tests/test_torch_rnn.py holds the
    final states, directions, depths and time_major)."""
    def nn(pkg):
        return pkg.nn

    seq = (lambda r: [_f32(r, 2, 4, 5)])
    out = (lambda layer, x: layer(x)[0])
    cell_in = (lambda r: [_f32(r, 3, 5)])
    return {
        "LSTM": (lambda p: nn(p).LSTM(5, 6, direction="bidirect"), seq,
                 out),
        "GRU": (lambda p: nn(p).GRU(5, 6, num_layers=2), seq, out),
        "SimpleRNN": (lambda p: nn(p).SimpleRNN(5, 6, activation="relu"),
                      seq, out),
        "LSTMCell": (lambda p: nn(p).LSTMCell(5, 6), cell_in,
                     lambda layer, x: layer(x)[1][1]),
        "GRUCell": (lambda p: nn(p).GRUCell(5, 6), cell_in, out),
    }


def _extras_lcases():
    def nn(pkg):
        return pkg.nn

    one = (lambda layer, *ts: layer(*ts))
    two = (lambda r: [_f32(r, 3, 4), _f32(r, 3, 4)])
    seq = (lambda r: [_f32(r, 2, 4, 5)])
    return {
        "PairwiseDistance": (lambda p: nn(p).PairwiseDistance(3.0), two,
                             one),
        "Softmax2D": (lambda p: nn(p).Softmax2D(),
                      lambda r: [_f32(r, 2, 3, 2, 2)], one),
        "Unflatten": (lambda p: nn(p).Unflatten(1, [2, 2]),
                      lambda r: [_f32(r, 3, 4)], one),
        "MaxUnPool1D": (lambda p: nn(p).MaxUnPool1D(2),
                        lambda r: [_f32(r, 1, 2, 3),
                                   (np.arange(3) * 2 + r.integers(0, 2, (
                                       1, 2, 3))).astype(np.int32)], one),
        "MaxUnPool2D": (lambda p: nn(p).MaxUnPool2D(2, 2),
                        lambda r: [_f32(r, 1, 2, 2, 2),
                                   _unpool_idx(r, 1, 2, 4, 2)], one),
        "MaxUnPool3D": (lambda p: nn(p).MaxUnPool3D(2),
                        lambda r: [_f32(r, 1, 1, 1, 1, 1),
                                   np.array([[[[[5]]]]], np.int32)], one),
        "PoissonNLLLoss": (lambda p: nn(p).PoissonNLLLoss(),
                           lambda r: [_f32(r, 3, 4), _f32(r, 3, 4, lo=0,
                                                          hi=3)], one),
        "SoftMarginLoss": (lambda p: nn(p).SoftMarginLoss("sum"), two, one),
        "MultiLabelSoftMarginLoss": (
            lambda p: nn(p).MultiLabelSoftMarginLoss(),
            lambda r: [_f32(r, 3, 4), (_f32(r, 3, 4) > 0).astype("f4")],
            one),
        "MultiMarginLoss": (lambda p: nn(p).MultiMarginLoss(margin=0.7),
                            lambda r: [_f32(r, 4, 5), _ids(r, 4)], one),
        "TripletMarginWithDistanceLoss": (
            lambda p: nn(p).TripletMarginWithDistanceLoss(margin=0.3),
            lambda r: [_f32(r, 5, 4), _f32(r, 5, 4), _f32(r, 5, 4)], one),
        "GaussianNLLLoss": (lambda p: nn(p).GaussianNLLLoss(),
                            lambda r: [_f32(r, 3, 4), _f32(r, 3, 4),
                                       _f32(r, 3, 4, lo=0.1, hi=2)], one),
        "HSigmoidLoss": (lambda p: nn(p).HSigmoidLoss(3, 7),
                         lambda r: [_f32(r, 4, 3), _ids(r, 4, hi=7)], one),
        "RNNTLoss": (lambda p: nn(p).RNNTLoss(fastemit_lambda=0.0),
                     lambda r: [_f32(r, 2, 3, 3, 4),
                                np.array([[1, 2], [3, 1]], np.int32),
                                np.array([3, 2], np.int32),
                                np.array([2, 1], np.int32)], one),
        "SimpleRNNCell": (lambda p: nn(p).SimpleRNNCell(5, 6),
                          lambda r: [_f32(r, 3, 5)],
                          lambda layer, x: layer(x)[0]),
        "RNN": (lambda p: nn(p).RNN(nn(p).SimpleRNNCell(5, 6)), seq,
                lambda layer, x: layer(x)[0]),
        "RNN_reverse_lstm_cell": (
            lambda p: nn(p).RNN(nn(p).LSTMCell(5, 6), is_reverse=True),
            seq, lambda layer, x: layer(x)[0]),
        "BiRNN": (lambda p: nn(p).BiRNN(nn(p).GRUCell(5, 3),
                                        nn(p).GRUCell(5, 3)), seq,
                  lambda layer, x: layer(x)[0]),
    }


CONV_POOL_FCASES = _conv_pool_fcases()
EXTRAS_FCASES = _extras_fcases()
CONV_POOL_LCASES = _conv_pool_lcases()
RNN_LCASES = _rnn_lcases()
EXTRAS_LCASES = _extras_lcases()
# every table, for sweep_nn on a device
ALL_FCASES = {**FCASES, **CONV_POOL_FCASES, **EXTRAS_FCASES}
ALL_LCASES = {**LCASES, **CONV_POOL_LCASES, **RNN_LCASES, **EXTRAS_LCASES}
# two stacked layers: the traced JAX reference's fused sums round in
# another order (its eager tape agrees within RTOL, ATOL)
LAYER_TOL = {"Transformer": (1e-4, 1e-5), "TransformerEncoder": (1e-4, 1e-5)}


def _on(P, device, f):
    """``f()`` with ``device`` as the default device (the layers and
    creation ops land there)."""
    from paddle_tpu_torch.core import device as pdev
    prev = getattr(pdev._state, "device", None)
    P.set_device(device)
    try:
        return f()
    finally:
        pdev._state.device = prev


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype.is_floating_point and t.dtype.itemsize < 4
            else t).numpy()


def _same(got, want, label, device):
    import torch
    if not isinstance(got, torch.Tensor):
        return
    assert got.device.type == device.split(":")[0], \
        f"{label} on {got.device}, not {device}"
    assert got.dtype == want.dtype and got.shape == want.shape, label
    if got.dtype.is_floating_point:
        np.testing.assert_allclose(_np(got), _np(want), rtol=SWEEP_TOL[0],
                                   atol=SWEEP_TOL[1], err_msg=label)
    else:
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=label)


def _fn_run(P, name, device):
    fn, build, _ = ALL_FCASES[name]
    arrays = build(_rng(name))

    def run():
        ts = [P.to_tensor(a.copy(), place=device,
                          stop_gradient=a.dtype.kind != "f") for a in arrays]
        out = _flat(fn(P, P.nn.functional, *ts))
        head = next((o for o in out if o is not None and o.requires_grad),
                    None)
        if head is not None:
            w = _rng(name + "w").uniform(-1, 1, tuple(head.shape))
            P.sum(P.multiply(head, P.to_tensor(
                w.astype(np.float32), place=device))).backward()
        return out, [t.grad for t in ts]
    return _on(P, device, run)


def _layer_run(P, name, device, state):
    build, inputs, call = ALL_LCASES[name]
    arrays = inputs(_rng(name))

    def run():
        layer = build(P)
        layer.set_state_dict(state)
        for n, p in layer.named_parameters():
            assert p.device.type == device.split(":")[0], \
                f"{name}.{n} on {p.device}"
        ts = [P.to_tensor(a.copy(), place=device,
                          stop_gradient=a.dtype.kind != "f") for a in arrays]
        out = call(layer, *ts)
        w = _rng(name + "w").uniform(-1, 1, tuple(out.shape))
        P.sum(P.multiply(out, P.to_tensor(w.astype(np.float32),
                                          place=device))).backward()
        return out, {n: p.grad for n, p in layer.named_parameters()
                     if p.grad is not None}
    return _on(P, device, run)


INITIALIZERS = {
    "Constant": ((4, 5), lambda I: I.Constant(0.5)),
    "Assign": ((2, 3), lambda I: I.Assign(np.arange(6.0).reshape(2, 3))),
    "Uniform": ((64, 64), lambda I: I.Uniform(-2.0, 3.0)),
    "Normal": ((64, 64), lambda I: I.Normal(0.5, 0.1)),
    "TruncatedNormal": ((64, 64), lambda I: I.TruncatedNormal(0.0, 2.0)),
    "XavierUniform": ((64, 32), lambda I: I.XavierUniform()),
    "XavierNormal": ((64, 32), lambda I: I.XavierNormal()),
    "KaimingUniform": ((64, 32), lambda I: I.KaimingUniform()),
    "KaimingNormal": ((64, 32), lambda I: I.KaimingNormal()),
    "Orthogonal": ((16, 40), lambda I: I.Orthogonal(1.5)),
    "Dirac": ((4, 2, 3, 3), lambda I: I.Dirac()),
    "Bilinear": ((2, 2, 4, 4), lambda I: I.Bilinear()),
}


def _init_check(name, v):
    if name == "TruncatedNormal":
        assert np.abs(v).max() <= 4.0, name
    if name == "Orthogonal":
        np.testing.assert_allclose(v @ v.T, 2.25 * np.eye(16), atol=1e-4)
    if name == "Uniform":
        assert v.min() >= -2.0 and v.max() < 3.0, name


def sweep_nn(P, device):
    """Every ``FCASES`` and ``LCASES`` case on ``device`` against the same
    port call on the CPU (outputs, input and parameter grads, placement),
    every initializer on a ``device`` parameter (placement, bounds,
    ``Orthogonal``'s ``QQᵀ``, the same values as on the CPU where nothing
    is random), dropout's keep rate there, and ``BatchNorm2D``'s running
    statistics after 3 training steps on ``device`` against the CPU's.
    Returns the number of names checked."""
    n = 0
    for name in sorted(ALL_FCASES):
        (got, ggot), (want, gwant) = (_fn_run(P, name, device),
                                      _fn_run(P, name, "cpu"))
        assert len(got) == len(want), name
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{name}[{k}]", device)
        for k, (g, w) in enumerate(zip(ggot, gwant)):
            if w is not None:
                _same(g, w, f"{name} grad[{k}]", device)
        n += 1
    for name in sorted(ALL_LCASES):
        state = {k: v.detach().cpu().numpy() for k, v in
                 _on(P, "cpu", lambda: ALL_LCASES[name][0](P)).state_dict()
                 .items()}
        (got, ggot), (want, gwant) = (_layer_run(P, name, device, state),
                                      _layer_run(P, name, "cpu", state))
        _same(got, want, name, device)
        assert sorted(ggot) == sorted(gwant), name
        for k in gwant:
            _same(ggot[k], gwant[k], f"{name} grad {k}", device)
        n += 1
    I = P.nn.initializer
    for name, (shape, make) in sorted(INITIALIZERS.items()):
        def draw(dev, shape=shape, make=make):
            return _on(P, dev, lambda: make(I)(
                P.create_parameter(list(shape), "float32")))
        p = draw(device)
        assert p.device.type == device.split(":")[0], name
        v = p.detach().cpu().numpy()
        assert np.isfinite(v).all(), name
        _init_check(name, v)
        if name in ("Constant", "Assign", "Dirac", "Bilinear"):
            np.testing.assert_array_equal(v, draw("cpu").detach().numpy())
        n += 1
    n += 2                     # calculate_gain, set_global_initializer
    keep = _on(P, device, lambda: P.nn.functional.dropout(
        P.ones([256, 256]), 0.3))
    rate = float((keep != 0).float().mean())
    assert keep.device.type == device.split(":")[0] and \
        abs(rate - 0.7) < 0.01, f"dropout keep rate {rate}"
    bn = {}
    for dev in (device, "cpu"):
        def steps():
            layer = P.nn.BatchNorm2D(3)
            r = _rng("bn-sweep")
            for _ in range(3):
                layer(P.to_tensor(_f32(r, 4, 3, 5, 5, lo=-2, hi=3)))
            return layer
        bn[dev] = _on(P, dev, steps)
    for buf in ("_mean", "_variance"):
        np.testing.assert_allclose(
            _np(getattr(bn[device], buf)), _np(getattr(bn["cpu"], buf)),
            rtol=SWEEP_TOL[0], atol=SWEEP_TOL[1],
            err_msg=f"BatchNorm2D {buf} after 3 steps")
    return n + _sweep_rest(P, device)


def _rest_on(P, dev):
    """The names outside the tables, run on ``dev`` from the same seeded
    weights: beam search, the weight / spectral norm hooks, the grad
    clips and the quantised linears."""
    r = _rng("rest")
    cell_state = {"weight_ih": _f32(r, 12, 3), "weight_hh": _f32(r, 12, 4),
                  "bias_ih": _f32(r, 12), "bias_hh": _f32(r, 12)}
    emb, proj = _f32(r, 6, 3), _f32(r, 4, 6, lo=-3, hi=3)
    init, x = _f32(r, 2, 4), _f32(r, 5, 4)
    w, g = _f32(r, 8, 6, lo=-2, hi=2), _f32(r, 4, 3, lo=-3, hi=3)
    xq = _f32(r, 3, 8, lo=-8, hi=8)

    def run():
        F, U, Q = P.nn.functional, P.nn.utils, P.nn.quant
        cell = P.nn.GRUCell(3, 4)
        cell.set_state_dict(cell_state)
        e, pr = P.to_tensor(emb), P.to_tensor(proj)
        dec = P.nn.BeamSearchDecoder(
            cell, 0, 5, 3, embedding_fn=lambda ids: F.embedding(ids, e),
            output_fn=lambda h: P.matmul(h, pr))
        ids, scores = P.nn.dynamic_decode(dec, P.to_tensor(init),
                                          max_step_num=6)
        lin = P.nn.Linear(4, 3)
        lin.set_state_dict({"weight": w[:4, :3], "bias": w[0, :3]})
        U.weight_norm(lin)
        wn = lin(P.to_tensor(x))
        U.remove_weight_norm(lin)
        U.spectral_norm(lin, n_power_iterations=2)
        sn = lin(P.to_tensor(x))
        p = P.create_parameter([4, 3], "float32")
        p.set_value(w[:4, 3:])
        p.grad = P.to_tensor(g.copy())
        total = U.clip_grad_norm_([p], 1.0)
        vec = U.parameters_to_vector([p])
        q, sc = Q.weight_quantize(P.to_tensor(w), "weight_only_int4")
        xt = P.to_tensor(xq)
        return [ids, scores, wn, sn, total, p.grad, vec, q, sc,
                Q.weight_only_linear(xt, q, None, sc),
                Q.llm_int8_linear(xt, q, None, sc), Q.Stub()(xt)]
    return _on(P, dev, run)


def _sweep_rest(P, device):
    got, want = _rest_on(P, device), _rest_on(P, "cpu")
    names = ["dynamic_decode ids", "dynamic_decode scores", "weight_norm",
             "spectral_norm", "clip_grad_norm_", "clipped grad",
             "parameters_to_vector", "weight_quantize", "weight scales",
             "weight_only_linear", "llm_int8_linear", "Stub"]
    for label, a, b in zip(names, got, want):
        _same(a, b, label, device)
    soft = _on(P, device, lambda: P.nn.functional.gumbel_softmax(
        P.zeros([4096, 4]), hard=False))
    hard = _on(P, device, lambda: P.nn.functional.gumbel_softmax(
        P.zeros([64, 4]), hard=True))
    assert soft.device.type == device.split(":")[0]
    np.testing.assert_allclose(_np(soft).sum(-1), 1.0, rtol=1e-5)
    freq = np.bincount(_np(soft).argmax(-1), minlength=4) / 4096
    assert np.abs(freq - 0.25).max() < 0.05, f"gumbel_softmax {freq}"
    assert (_np(hard).sum(-1) == 1).all() and set(np.unique(_np(hard))) \
        <= {0.0, 1.0}
    # dynamic_decode, BeamSearchDecoder, weight_norm, remove_weight_norm,
    # spectral_norm, clip_grad_norm_, parameters_to_vector,
    # weight_quantize, weight_only_linear, llm_int8_linear, Stub and
    # gumbel_softmax
    return 12
