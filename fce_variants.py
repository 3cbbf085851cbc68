#!/usr/bin/env python3
"""Variants and planted faults of the fused cross-entropy kernels (K5
forward, K6 dh, K7 dW in ``paddle_tpu_torch/csrc/fused_ce.cu``), for
measuring on one NVIDIA GPU what holds them back and that the checks catch
a fault.

    python3 fce_variants.py make NAME [NAME ...]   # copies under build/v_NAME
    python3 fce_variants.py time                   # in a copy (or the tree)
    python3 fce_variants.py faults                 # in a copy (or the tree)
    python3 fce_variants.py clocks                 # in a copy (or the tree)

``make`` copies ``paddle_tpu_torch/`` and ``chip_smoke.py`` into
``build/v_NAME`` (ignored by git) and applies the edits of ``VARIANTS`` to
the copy: ``(old, new)`` to ``fused_ce.cu``, ``(path, old, new)`` to the
copy's file at ``path``; a design the tree does not keep (K5's 2 x 1
cluster, its 128-wide tile) is carried here as such edits. Run ``time``
or ``faults`` from inside a copy: each builds that copy's kernels, and
prints one JSON line.

- ``time``: K5-K7 against their plain versions over chip_smoke.py's
  ``FCE_CASES`` in bf16 and fp16 and at the training head's shape, then
  each timed three times there (N = H = 4096, V = 32000, bf16; CUDA-graph
  replays, chip_smoke.cuda_ms), beside ``torch.matmul(h, w)`` alone. A copy
  whose results are wrong on purpose (``nored``, ``p1only``) reports its
  failures as a count.
- ``faults``: per case the worst share of the tolerance of K5's m, lse and
  loss (chip_smoke.py's atol 1e-4 / rtol 1e-5) and of dh and dW (its
  per-line rule); above 1 fails. For planted-fault copies.
- ``clocks``: K5 and ``torch.matmul(h, w)`` at the training head's shape,
  each replayed for about 3 s, with the SM clock and power draw that
  nvidia-smi reads meanwhile (medians).
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
TMA = "paddle_tpu_torch/csrc/tma.cuh"
K5_SPLITS = "wg ? sms / rb :"
K5_STAGES = "constexpr int kFwdStages = 4;"
K5_RELEASE = """  asm volatile(
      "{\\n.reg .pred p;\\nsetp.eq.u32 p, %1, 0;\\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\\n}\\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}"""
K5_INIT = """      mbar_init(empty0 + 8 * i, 8);  // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();"""
K5_LOAD_W = """            tma_load_2d(st + 16384 + c * 8192, &tw, full, vt * kFwdN + c * 64,
                        ks * 64);"""
K5_END = """        part[2 * plane + o] = z[rr];
      }
    }
  }
}"""
K5_LAUNCH = """  const dim3 grid((a.N + kTile - 1) / kTile, splits);
  kernel<<<grid, kWsThreads, kFwdSmem, st>>>(th, tw, a.labels, a.offset, part,
                                             a.N, a.H, a.V, tps);
  return cudaSuccess;"""
# K5 with two row blocks a 2 x 1 cluster on the same vocab tiles: each CTA
# loads half of the W boxes and multicasts them to both, a stage's empty
# barrier counts the consumer warps of both CTAs, whose lane 0 arrives on
# it in both (remote arrivals at the default CTA-scope release).
K5_CLUSTER = [
    (TMA, "__device__ __forceinline__ void tma_load_1d(", """\
__device__ __forceinline__ void tma_load_2d_mc(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4}], [%2], %5;\\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release;\\n"
      "barrier.cluster.wait.acquire;\\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void tma_load_1d("""),
    (K5_RELEASE, """#pragma unroll
  for (int r = 0; r < 2; ++r) {
    asm volatile(
        "{\\n.reg .pred p;\\n.reg .b32 ra;\\nsetp.eq.u32 p, %2, 0;\\n"
        "mapa.shared::cluster.u32 ra, %0, %1;\\n"
        "@p mbarrier.arrive.shared::cluster.b64 _, [ra];\\n"
        "}\\n" ::"r"(bar), "r"(r), "r"(lane)
        : "memory");
  }
}"""),
    (K5_INIT, K5_INIT.replace("i, 8);  // consumer warps",
                              "i, 16);  // consumer warps of both CTAs")
     .replace("__syncthreads();", "cluster_sync_all();")),
    (K5_LOAD_W, """            if (c % 2 == (int)cluster_rank()) {
              tma_load_2d_mc(st + 16384 + c * 8192, &tw, full,
                             vt * kFwdN + c * 64, ks * 64, 3);
            }"""),
    (K5_END, K5_END[:-1] + "  cluster_sync_all();  // the peer may still "
     "arrive here\n}"),
    (K5_LAUNCH, """  const int rb = (a.N + kTile - 1) / kTile;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rb + 1) / 2 * 2, splits);
  cfg.blockDim = dim3(kWsThreads);
  cfg.dynamicSmemBytes = kFwdSmem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, th, tw, a.labels, a.offset, part,
                            a.N, a.H, a.V, tps);"""),
]
K5_CLUSTER_REL = [("@p mbarrier.arrive.shared::cluster.b64",
                   "@p mbarrier.arrive.release.cluster.shared::cluster.b64")]
VARIANTS = {
    "tree": [],
    # K5: the tile width against the ring depth (128 x 128 tiles with six
    # 32 KB stages, K6/K7's phase 1 without the dl tile; 128 x 256 with
    # two to four 48 KB stages), W multicast over a 2 x 1 cluster (its
    # consumers' remote arrivals at CTA or cluster scope), and two waves
    # of CTAs instead of one
    "k5_n128s6": [("constexpr int kFwdN = 256;", "constexpr int kFwdN = 128;"),
                  (K5_STAGES, "constexpr int kFwdStages = 6;"),
                  ("Wg<T>::template ss256x<0, 1>(",
                   "Wg<T>::template ss128x<0, 1>(")],
    "k5_s3": [(K5_STAGES, "constexpr int kFwdStages = 3;")],
    "k5_s2": [(K5_STAGES, "constexpr int kFwdStages = 2;")],
    "k5_cl2": K5_CLUSTER,
    "k5_cl2rel": K5_CLUSTER + K5_CLUSTER_REL,
    "k5_w2": [(K5_SPLITS, "wg ? 2 * sms / rb :")],
    # one wave of 96 CTAs (3 splits at N = 4096), without and with the
    # cluster: whether the cluster's loss is a second wave of clusters
    "k5_w96": [(K5_SPLITS, "wg ? 96 / rb :")],
    "k5_cl2w96": K5_CLUSTER + K5_CLUSTER_REL + [(K5_SPLITS, "wg ? 96 / rb :")],
    # breakdown (wrong results on purpose): the products without the fold
    "k5_nofold": [("      if (v0 + kFwdN > V) {\n        fwd_fold<true>",
                   "      if (N < 0) {\n        fwd_fold<true>"),
                  ("      } else {\n        fwd_fold<false>",
                   "      } else if (N < 0) {\n        fwd_fold<false>")],
    # K6/K7: the CTA order: K6 in plain row-major order (one group of all
    # rows)
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
    # planted faults: K5 without the V mask (padded columns enter the max
    # and the sum as s = 0), the merge without its last split, the label's
    # logit taken one column late
    "mut_k5_nomask": [("      if (v0 + kFwdN > V) {\n        fwd_fold<true>",
                       "      if (false) {\n        fwd_fold<true>")],
    "mut_k5_merge": [("for (int s = 0; s < splits; ++s)",
                      "for (int s = 0; s < splits - 1; ++s)")],
    "mut_k5_label": [("if (8 * j + e == lc) z[rr]",
                      "if (8 * j + e == lc + 1) z[rr]")],
    # K6/K7
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
        for edit in VARIANTS[name]:
            rel, old, new = (edit if len(edit) == 3 else
                             ("paddle_tpu_torch/csrc/fused_ce.cu", *edit))
            src = d / rel
            text = src.read_text()
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in {rel}")
            src.write_text(text.replace(old, new))
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


def _train_inputs(torch, cs, fce):
    h, w, lab, gr = cs.fce_inputs(torch, 4096, 4096, 32000, 0, "any",
                                  torch.bfloat16, 8)
    m, l, _ = fce.fused_ce_fwd_ref(h, w, lab)
    return h, w, lab, gr, (m + torch.log(l)).contiguous()


def time_kernels():
    torch, cs, fce, build_s = _setup()
    worst, bad = 0.0, 0
    cases = list(cs.FCE_CASES) + [("train", 4096, 4096, 32000, 0, "any")]
    for dt in (torch.bfloat16, torch.float16):
        for name, N, H, V, off, kind in cases:
            h, w, lab, gr = cs.fce_inputs(torch, N, H, V, off, kind, dt, 4)
            try:
                _, shares, _ = cs.fce_check(torch, fce, h, w, lab, gr, off,
                                            name)
                worst = max(worst, max(shares.values()))
            except cs.SmokeFailure:
                bad += 1
    h, w, lab, gr, lse = _train_inputs(torch, cs, fce)
    args = [(h, w, lab, lse, gr)]
    print(json.dumps({
        "dir": os.path.basename(os.getcwd()), "build_s": build_s,
        "worst_share": worst, "failures": bad,
        "k5_ms": [cs.cuda_ms(fce.fused_ce_fwd, [(h, w, lab)])
                  for _ in range(3)],
        "gemm_ms": cs.cuda_ms(torch.matmul, [(h, w)]),
        "k6_ms": [cs.cuda_ms(fce.fused_ce_bwd_dh, args) for _ in range(3)],
        "k7_ms": [cs.cuda_ms(fce.fused_ce_bwd_dw, args) for _ in range(3)],
        "card": torch.cuda.get_device_name(0)}), flush=True)


def _fwd_share(got, want):
    """Worst |got - want| over chip_smoke.py's atol 1e-4 + rtol 1e-5."""
    return float(((got - want).abs() / (1e-4 + 1e-5 * want.abs())).max())


def fault_shares():
    torch, cs, fce, _ = _setup()
    cases = list(cs.FCE_CASES) + [("train", 4096, 4096, 32000, 0, "any")]
    out = {}
    for dt in (torch.bfloat16, torch.float16):
        for name, N, H, V, off, kind in cases:
            if name == "train" and dt == torch.float16:
                continue
            h, w, lab, gr = cs.fce_inputs(torch, N, H, V, off, kind, dt, 4)
            m, l, z = fce.fused_ce_fwd(h, w, lab, off)
            wm, wl, wz = fce.fused_ce_fwd_ref(h, w, lab, off)
            lse = (wm + torch.log(wl)).contiguous()
            dn = str(dt).replace("torch.", "")
            got = {"dh": fce.fused_ce_bwd_dh(h, w, lab, lse, gr, off),
                   "dW": fce.fused_ce_bwd_dw(h, w, lab, lse, gr, off).t()}
            want = {"dh": fce.fused_ce_bwd_dh_ref(h, w, lab, lse, gr, off),
                    "dW": fce.fused_ce_bwd_dw_ref(h, w, lab, lse, gr,
                                                  off).t()}
            row = {t: round(cs.flash_close(got[t], want[t], dn, 2.0)[2], 3)
                   for t in got}
            for t, a, b in (("m", m, wm), ("lse", m + torch.log(l), lse),
                            ("loss", m + torch.log(l) - z, lse - wz)):
                row[t] = round(_fwd_share(a, b), 3)
            out[f"{name}_{dn}"] = row
    worst = {k: max(v.values()) for k, v in out.items()}
    fail = [w for w in worst.values() if w > 1]
    print(json.dumps({
        "dir": os.path.basename(os.getcwd()), "failing_cases": len(fail),
        "of": len(out), "min_fail_share": min(fail, default=None),
        "max_share": max(worst.values()),
        "passing_worst": max((w for w in worst.values() if w <= 1),
                             default=None),
        "cases": out}), flush=True)


def clocks():
    """K5 and torch.matmul(h, w) at the training head's shape, each from a
    CUDA graph of 20 calls replayed for about 3 s while nvidia-smi samples
    the SM clock and the power draw every 100 ms."""
    import subprocess
    import time
    torch, cs, fce, _ = _setup()
    h, w, lab, _, _ = _train_inputs(torch, cs, fce)
    out = {"card": cs.gpu_name_and_power("0")}
    for name, fn, args in (("k5", fce.fused_ce_fwd, (h, w, lab)),
                           ("gemm", torch.matmul, (h, w))):
        cs.cuda_ms(fn, [args] * 20)          # warm-up, graph capture path
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                fn(*args)
        smi = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        n, t0 = 0, time.perf_counter()
        start.record()
        while time.perf_counter() - t0 < 3.0:
            graph.replay()
            n += 1
            if n % 10 == 0:
                torch.cuda.synchronize()
        end.record()
        end.synchronize()
        smi.terminate()
        rows = [r.split(",") for r in smi.communicate()[0].splitlines()[5:]]
        mhz = sorted(float(r[0]) for r in rows if len(r) == 2)
        watts = sorted(float(r[1]) for r in rows if len(r) == 2)
        out[name] = {"ms": start.elapsed_time(end) / (20 * n),
                     "sm_mhz_median": mhz[len(mhz) // 2] if mhz else None,
                     "power_w_median": watts[len(watts) // 2] if watts
                     else None, "samples": len(mhz)}
        del graph
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["make"] and argv[1:]:
        make(argv[1:])
    elif argv == ["time"]:
        time_kernels()
    elif argv == ["faults"]:
        fault_shares()
    elif argv == ["clocks"]:
        clocks()
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
