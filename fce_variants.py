#!/usr/bin/env python3
"""Variants and planted faults of the fused cross-entropy backward kernels
(K6 dh, K7 dW in ``paddle_tpu_torch/csrc/fused_ce.cu``), for measuring on
one NVIDIA GPU what holds them back and that the checks catch a fault.

    python3 fce_variants.py make NAME [NAME ...]   # copies under build/v_NAME
    python3 fce_variants.py time                   # in a copy (or the tree)
    python3 fce_variants.py faults                 # in a copy (or the tree)

``make`` copies ``paddle_tpu_torch/`` and ``chip_smoke.py`` into
``build/v_NAME`` (ignored by git) and applies one edit from ``VARIANTS`` to
the copy's ``fused_ce.cu``. Run ``time`` or ``faults`` from inside a copy:
each builds that copy's kernels, and prints one JSON line.

- ``time``: K6/K7 against their plain versions over chip_smoke.py's
  ``FCE_CASES`` in bf16 and fp16 and at the training head's shape, then
  each timed three times there (N = H = 4096, V = 32000, bf16; CUDA-graph
  replays, chip_smoke.cuda_ms). A copy whose results are wrong on purpose
  (``nored``, ``p1only``) reports its failures as a count.
- ``faults``: per case the worst share of the tolerance of dh and dW under
  chip_smoke.py's rule (above 1 fails), for planted-fault copies.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
K6_RED = "      ws_red_add(acc, dh32,"
K7_RED = "      ws_red_add(acc, dw32,"
VARIANTS = {
    "tree": [],
    # the CTA order: K6 in plain row-major order (one group of all rows)
    "k6old": [("constexpr int kGroupRows = 8;",
               "constexpr int kGroupRows = 1 << 20;")],
    "gr4": [("constexpr int kGroupRows = 8;", "constexpr int kGroupRows = 4;")],
    "gr16": [("constexpr int kGroupRows = 8;",
              "constexpr int kGroupRows = 16;")],
    # the ring against the slice width
    "st2": [("constexpr int kWsStages = 3;", "constexpr int kWsStages = 2;")],
    "s384st4": [("constexpr int kWsStages = 3;", "constexpr int kWsStages = 4;"),
                ("constexpr int kSlice = 512;", "constexpr int kSlice = 384;")],
    "s256st5": [("constexpr int kWsStages = 3;", "constexpr int kWsStages = 5;"),
                ("constexpr int kSlice = 512;", "constexpr int kSlice = 256;")],
    # breakdown (wrong results on purpose): no reductions; phase 1 only
    "nored": [(K6_RED, "      if (N < 0) ws_red_add(acc, dh32,"),
              (K7_RED, "      if (N < 0) ws_red_add(acc, dw32,")],
    "p1only": [("const int nk = (H + 63) / 64, nh = (H + 127) / 128;",
                "const int nk = (H + 63) / 64, nh = 0;")],
    # planted faults
    "mut_lastchunk": [(K6_RED, "      if (hc < nh - 1) ws_red_add(acc, dh32,"),
                      (K7_RED, "      if (hc < nh - 1) ws_red_add(acc, dw32,")],
    "mut_onehot": [("(v == lab[rr] ? 1.f : 0.f)",
                    "(v == lab[rr] + 1 ? 1.f : 0.f)")],
    "mut_mask": [("x[e] = v < V ? (expf", "x[e] = v < V - 1 ? (expf")],
    "mut_nomask": [("x[e] = v < V ? (expf", "x[e] = true ? (expf")],
}


def make(names):
    for name in names:
        d = ROOT / "build" / f"v_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "paddle_tpu_torch", d / "paddle_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", d / "chip_smoke.py")
        src = d / "paddle_tpu_torch" / "csrc" / "fused_ce.cu"
        text = src.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        src.write_text(text)
        print("made", d)


def _setup():
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fce_variants: no CUDA device")
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_ce as fce
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch, cs, fce, _build.build()


def time_kernels():
    torch, cs, fce, build_s = _setup()
    worst, bad = 0.0, 0
    cases = list(cs.FCE_CASES) + [("train", 4096, 4096, 32000, 0, False)]
    for dt in (torch.bfloat16, torch.float16):
        for name, N, H, V, off, last in cases:
            h, w, lab, gr = cs.fce_inputs(torch, N, H, V, off, last, dt, 4)
            try:
                _, shares, _ = cs.fce_check(torch, fce, h, w, lab, gr, off,
                                            name)
                worst = max(worst, max(shares.values()))
            except cs.SmokeFailure:
                bad += 1
    h, w, lab, gr = cs.fce_inputs(torch, 4096, 4096, 32000, 0, False,
                                  torch.bfloat16, 8)
    m, l, _ = fce.fused_ce_fwd_ref(h, w, lab)
    args = [(h, w, lab, (m + torch.log(l)).contiguous(), gr)]
    print(json.dumps({
        "dir": os.path.basename(os.getcwd()), "build_s": build_s,
        "worst_share": worst, "failures": bad,
        "k6_ms": [cs.cuda_ms(fce.fused_ce_bwd_dh, args) for _ in range(3)],
        "k7_ms": [cs.cuda_ms(fce.fused_ce_bwd_dw, args) for _ in range(3)],
        "card": torch.cuda.get_device_name(0)}), flush=True)


def fault_shares():
    torch, cs, fce, _ = _setup()
    cases = list(cs.FCE_CASES) + [("train", 4096, 4096, 32000, 0, False)]
    out = {}
    for dt in (torch.bfloat16, torch.float16):
        for name, N, H, V, off, last in cases:
            if name == "train" and dt == torch.float16:
                continue
            h, w, lab, gr = cs.fce_inputs(torch, N, H, V, off, last, dt, 4)
            m, l, _ = fce.fused_ce_fwd_ref(h, w, lab, off)
            lse = (m + torch.log(l)).contiguous()
            dn = str(dt).replace("torch.", "")
            got = {"dh": fce.fused_ce_bwd_dh(h, w, lab, lse, gr, off),
                   "dW": fce.fused_ce_bwd_dw(h, w, lab, lse, gr, off).t()}
            want = {"dh": fce.fused_ce_bwd_dh_ref(h, w, lab, lse, gr, off),
                    "dW": fce.fused_ce_bwd_dw_ref(h, w, lab, lse, gr,
                                                  off).t()}
            out[f"{name}_{dn}"] = {
                t: round(cs.flash_close(got[t], want[t], dn, 2.0)[2], 3)
                for t in got}
    worst = {k: max(v.values()) for k, v in out.items()}
    fail = [w for w in worst.values() if w > 1]
    print(json.dumps({
        "dir": os.path.basename(os.getcwd()), "failing_cases": len(fail),
        "of": len(out), "min_fail_share": min(fail, default=None),
        "max_share": max(worst.values()),
        "passing_worst": max((w for w in worst.values() if w <= 1),
                             default=None),
        "cases": out}), flush=True)


def main(argv):
    if argv[:1] == ["make"] and argv[1:]:
        make(argv[1:])
    elif argv == ["time"]:
        time_kernels()
    elif argv == ["faults"]:
        fault_shares()
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
