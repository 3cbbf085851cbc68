#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out PATH]

Run from the repo root on a machine with a CUDA card, nvcc and PyTorch
built for CUDA. It imports nothing of JAX or of ``paddle_tpu``; it drives
``paddle_tpu_torch`` and fails (non-zero exit, traceback) if any phase
fails:

1. environment: the card's name and power limit (nvidia-smi), torch/CUDA;
2. build: every kernel of the serving and training paths (K1 decode
   attention, K2-K4 flash attention forward, dQ and dK/dV, K5-K7 fused
   linear + cross-entropy forward, dh and dW), from
   ``paddle_tpu_torch/csrc``, one nvcc per source for sm_90a, all started
   together (the build time is printed);
3. each kernel against its plain PyTorch version on the card, at the
   listed shapes and dtypes, with the tolerance stated per dtype and
   tensor;
4. a reference check at a small size in fp32: the engine's tokens equal
   ``generate()`` with and without the KV cache (the cache-free path runs
   K2, flash attention, once per layer and new token: its launches are
   counted and checked);
5. serving at the full ``LlamaConfig.llama_7b()`` width (32 layers, bf16,
   seeded random weights): 16 requests through ``ServingEngine`` with a
   late join; every request must finish with its prompt plus its new
   tokens, sampled logits rows must be finite, and the decode kernel's
   launch count must be exactly ``decode_steps * num_hidden_layers``;
6. a full batch after the serving run: every slot refilled with a greedy
   request (each prefill timed alone), then the decode kernel on every
   layer's caches at the slots' lengths, held against the plain version
   and timed (one CUDA graph of 32 calls, one per layer's caches so each
   call finds L2 cold, its replays timed with CUDA events) beside the
   plain version, ``F.scaled_dot_product_attention`` as the library
   yardstick, and the least time the card could take (``bound_ms``, from
   the bytes and flops the inputs need); then decode steps timed on the
   host clock and a few traced with ``torch.profiler``: device time per
   step by kernel, and the device's busy share of a step;
7. the serving model is freed; a small fp32 training check, with the
   fused loss off and on: three steps of ``build_hybrid_train_step`` on
   the card (K2-K4, and K5-K7) equal the same steps on the CPU (the plain
   versions) in loss at AdamW's default epsilon, and in loss and
   parameters at epsilon 1e-3;
8. training at ``llama_7b`` width (hidden 4096, 32 heads, intermediate
   11008, vocab 32000) cut to 8 layers, batch 2 x seq 2048, bf16 amp with
   fp32 masters, remat, AdamW(1e-4), once with fused_loss off and once on:
   2 warm-up and 10 timed steps on one seeded batch each; every loss
   finite, the last below the first, and per step exactly 2 x layers K2
   launches (forward and the remat recompute) and layers K3 and K4
   launches, and with the fused loss one K5, K6 and K7 launch; then one
   step of each traced with ``torch.profiler``;
9. K2, K3 and K4 timed at the training shape (B=2, S=2048, H=32, D=128,
   bf16, causal) from CUDA-graph replays, beside their plain versions,
   ``F.scaled_dot_product_attention(is_causal=True)`` forward and its
   autograd backward (one time for K3 and K4 together) as the library
   yardstick, and the least time the card could take (``bound_ms``);
10. K5, K6 and K7 held against their plain versions and timed the same way
   at the training head's shape (N = B x S = 4096, H = 4096, V = 32000,
   bf16), beside the unfused head as the yardstick: no single PyTorch call
   computes linear + cross-entropy, so it is ``F.cross_entropy(
   torch.matmul(h, w).float(), labels, reduction="none")`` forward and its
   autograd backward (one time for K6 and K7 together).

The last lines are ``{"decode_profile": ...}``, ``{"training": ...}``,
``{"training_fused": ...}``, ``{"kernels": [...]}`` (all seven kernels),
``{"serving": ...}``, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. The run uses one card: it shows torch
only the first of ``CUDA_VISIBLE_DEVICES`` (default 0). ``--out`` also writes every
number as JSON.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s
# and bf16/fp16 tensor-core flop/s, float32 flop/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
DEVICE = "cuda"
# (atol, rtol), outputs compared in fp32. The kernel and the plain version
# both accumulate in fp32 and round once to the output dtype, so in bf16 and
# fp16 they may differ by one rounding step: rtol is the dtype's machine
# epsilon, and atol covers outputs near zero.
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 2.0 ** -7),
       "float16": (1e-5, 2.0 ** -10)}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def use_one_card() -> str:
    """Show torch only one card (the first of CUDA_VISIBLE_DEVICES, in
    nvidia-smi's PCI order), so the device count printed is the count the
    run used. Called before torch is imported; returns the card's id."""
    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    return card


def gpu_name_and_power(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, arg_sets, reps=5, stream=None):
    """Device ms per call of fn, one call per entry of arg_sets: the calls
    are captured into one CUDA graph on `stream` (a new side stream by
    default) after a warm-up there, and the graph's replays are timed with
    CUDA events, so the host's launch cost does not enter the number."""
    import torch
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * len(arg_sets))
    del graph
    return ms


def decode_bound(q, k_cache, lengths):
    """Least time (ms) for ragged decode attention on these inputs: the
    live K/V rows, q, lengths and the output each moved once, and
    4 * sum(len) * H * D flops, over the card's peaks; the larger wins."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    live = int(lengths.clamp(0, S).sum())
    esize = q.element_size()
    nbytes = 2 * live * Hkv * D * esize + 2 * q.numel() * esize + 4 * B
    flops = 4 * live * H * D
    dt = str(q.dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_attention(q, k_cache, v_cache, lengths):
    """One PyTorch call computing the same function (timed, never used by
    the port): SDPA with a boolean length mask."""
    import torch
    import torch.nn.functional as tF
    S = k_cache.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    gqa = q.shape[2] != k_cache.shape[2]
    out = tF.scaled_dot_product_attention(
        q.transpose(1, 2), k_cache.transpose(1, 2), v_cache.transpose(1, 2),
        attn_mask=mask, enable_gqa=gqa)
    return out.transpose(1, 2)


# Decode-kernel cases: (name, B, S_max, H, Hkv, D, dtypes, lengths). The
# split-KV cases run in every dtype: ranks of 256 keys at S_max 2048 with
# lengths at a rank boundary, one below and one above it and one key in
# the last rank; S_max not a multiple of splits x chunk; S_max under 256
# (one rank); ranks of 512 keys at S_max 4096.
LENS_7B = [0, 1, 17, 255, 256, 777, 2047, 2048]
ALL_DTYPES = ("float32", "bfloat16", "float16")
DECODE_CASES = [
    ("7b_mha", 8, 2048, 32, 32, 128, ("bfloat16", "float16"), LENS_7B),
    ("gqa", 8, 2048, 32, 8, 128, ("bfloat16",), LENS_7B),
    ("small", 3, 384, 8, 4, 64, ("float32",), [1, 200, 384]),
    ("split_edges", 4, 2048, 8, 8, 128, ALL_DTYPES, [256, 255, 257, 1793]),
    ("split_s2047", 3, 2047, 8, 2, 128, ALL_DTYPES, [2047, 1792, 1]),
    ("split_one_rank", 3, 200, 8, 8, 64, ALL_DTYPES, [200, 199, 0]),
    ("split_s4096", 3, 4096, 8, 4, 128, ALL_DTYPES, [4096, 512, 3585]),
    # GQA groups above 8 (chunks of query heads along the grid, one launch)
    # and head widths off the TMA path (element loads).
    ("group16", 2, 300, 16, 1, 128, ALL_DTYPES, [300, 77]),
    ("group32_mqa", 3, 600, 32, 1, 64, ALL_DTYPES, [600, 1, 0]),
    ("d80", 2, 300, 8, 2, 80, ALL_DTYPES, [300, 41]),
    ("d100", 2, 300, 8, 2, 100, ALL_DTYPES, [300, 41]),
    ("d320", 2, 300, 4, 1, 320, ALL_DTYPES, [300, 257]),
]


def decode_check(torch, attn, attn_ref, q, k, v, lengths, label):
    """K1 against its plain version on one input set: logs the largest
    abs error and the worst share of the tolerance (|got - want| over
    atol + rtol |want|), then raises on a disagreement."""
    got = attn(q, k, v, lengths)
    torch.cuda.synchronize()
    want = attn_ref(q, k, v, lengths)
    got, want = got.float(), want.float()
    atol, rtol = TOL[str(q.dtype).replace("torch.", "")]
    diff = (got - want).abs()
    err = float(diff.max())
    share = float((diff / (atol + rtol * want.abs())).max())
    B, _, H, D = q.shape
    log(f"kernel-vs-plain {label}: B={B} S_max={k.shape[1]} H={H} "
        f"Hkv={k.shape[2]} D={D} {q.dtype} max_abs_err={err:.3g} "
        f"({share:.3g} of tol; atol {atol}, rtol {rtol})")
    check(torch.allclose(got, want, atol=atol, rtol=rtol),
          f"decode kernel disagrees with its plain version in case {label}: "
          f"max_abs_err={err}")
    return err


def phase_kernel_cases(torch, attn, attn_ref):
    """Kernel vs plain version on random inputs (0.5 * randn)."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}
    for name, B, S, H, Hkv, D, dtypes, lens in DECODE_CASES:
        for dt_name in dtypes:
            dt = getattr(torch, dt_name)
            q, k, v = ((0.5 * torch.randn(shape, generator=g,
                                          device=DEVICE)).to(dt)
                       for shape in ((B, 1, H, D), (B, S, Hkv, D),
                                     (B, S, Hkv, D)))
            lengths = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
            label = f"{name}_{dt_name}"
            out[label] = decode_check(torch, attn, attn_ref, q, k, v,
                                      lengths, label)
    return out


def phase_small_reference(torch, LlamaConfig, LlamaForCausalLM,
                          ServingEngine, fa):
    """fp32, tiny width: engine tokens == generate() with the decode kernel
    (use_cache=True) == generate() without a cache, whose full-sequence
    forwards run K2 (flash attention) once per layer and new token."""
    cfg = LlamaConfig.tiny(vocab=64, hidden=256, layers=2, heads=4,
                           inter=512, seq=64)
    cfg.num_key_value_heads = 2
    m = LlamaForCausalLM(cfg, device=DEVICE, dtype=torch.float32, seed=1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, n) for n in (5, 9, 13)]
    eng = ServingEngine(m, max_batch=2, max_seq_len=64)
    outs = eng.generate(prompts, max_new_tokens=8)
    for p, o in zip(prompts, outs):
        ids = torch.from_numpy(p.reshape(1, -1)).to(DEVICE)
        cached = m.generate(ids, max_new_tokens=8).cpu().numpy()[0]
        before = fa.flash_attention_fwd.launches
        plain = m.generate(ids, max_new_tokens=8,
                           use_cache=False).cpu().numpy()[0]
        n = fa.flash_attention_fwd.launches - before
        check(n == 8 * cfg.num_hidden_layers,
              f"generate(use_cache=False) launched K2 {n} times, want "
              f"new tokens x layers = {8 * cfg.num_hidden_layers}")
        check(np.array_equal(o, cached) and np.array_equal(o, plain),
              f"small fp32 reference: engine {o.tolist()} vs generate "
              f"{cached.tolist()} vs no-cache {plain.tolist()}")
    log(f"small fp32 reference: {len(prompts)} requests, engine == "
        f"generate(use_cache=True) == generate(use_cache=False), the latter "
        f"through K2 ({8 * cfg.num_hidden_layers} launches each)")


def phase_serve(torch, args, LlamaConfig, LlamaForCausalLM, ServingEngine,
                RequestState, attn):
    cfg = LlamaConfig.llama_7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE, dtype=torch.bfloat16,
                             seed=args.seed)
    torch.cuda.synchronize()
    log(f"llama_7b width: {cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, inter "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}, bf16; "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params "
        f"built in {time.perf_counter() - t0:.1f}s")
    eng = ServingEngine(model, max_batch=8, max_seq_len=2048)
    rng = np.random.default_rng(args.seed)
    specs = []
    for i in range(16):
        plen = int(rng.integers(16, 1001))
        specs.append(dict(prompt=rng.integers(0, cfg.vocab_size, plen),
                          max_new=int(rng.integers(32, 129)),
                          sampled=(i % 4 == 3)))

    def submit(s):
        kw = dict(temperature=0.8, top_p=0.95, seed=1000 + len(reqs)) \
            if s["sampled"] else {}
        reqs.append(eng.submit(s["prompt"], max_new_tokens=s["max_new"],
                               **kw))

    n_layers = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    reqs = []
    step_ms, decode_only_ms = [], []
    steps = 0
    attn.launches = 0    # the main path's run starts here
    t_serve = time.perf_counter()
    for s in specs[:12]:
        submit(s)
    while not eng.scheduler.idle or len(reqs) < len(specs):
        prefills = eng.info()["prefills"]
        t0 = time.perf_counter()
        eng.step()
        dt = (time.perf_counter() - t0) * 1e3
        steps += 1
        step_ms.append(dt)
        if eng.info()["prefills"] == prefills:
            decode_only_ms.append(dt)
        if steps == 2:
            for s in specs[12:]:
                submit(s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_serve
    launches = attn.launches
    info = eng.info()

    for r, s in zip(reqs, specs):
        check(r.state is RequestState.FINISHED,
              f"request {r.rid} ended {r.state.name}")
        out = r.result()
        check(out.size == s["prompt"].size + s["max_new"]
              and np.array_equal(out[:s["prompt"].size], s["prompt"]),
              f"request {r.rid}: {out.size} tokens, want "
              f"{s['prompt'].size} + {s['max_new']}")
    want = info["decode_steps"] * n_layers
    check(launches == want,
          f"decode kernel launched {launches} times in the serving run, "
          f"want decode_steps x layers = {want}")
    check(info["sampled_tokens"] > 0, "no sampled token was drawn")
    ttft = [(r.token_times[0] - r.submit_time) * 1e3 for r in reqs]
    serving = {
        "requests": len(reqs), "max_batch": eng.max_batch,
        "max_seq_len": eng.max_seq_len, "layers": n_layers,
        "prompt_tokens": int(sum(s["prompt"].size for s in specs)),
        "generated_tokens": info["tokens_generated"],
        "decode_steps": info["decode_steps"], "engine_steps": steps,
        "kernel_launches": launches,
        "decode_step_ms_p50": float(np.percentile(decode_only_ms, 50)),
        "decode_step_ms_p90": float(np.percentile(decode_only_ms, 90)),
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p90": float(np.percentile(ttft, 90)),
        "tokens_per_s": info["tokens_generated"] / wall,
        "wall_s": wall, "avg_occupancy": info["avg_occupancy"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"served {len(reqs)} requests: {info['decode_steps']} decode steps, "
        f"{launches} decode-kernel launches (= steps x {n_layers}), all "
        f"FINISHED with prompt + max_new tokens")
    return model, eng, reqs, specs, serving


def phase_teacher_forced(torch, model, reqs, specs):
    """The 7B-width greedy tokens against the cache-free forward (flash
    attention, K2, instead of the decode kernel) over the same sequence:
    the share of positions whose argmax agrees. bf16 rounding over 32
    layers may flip near-ties; a broken decode path agrees at chance level
    (~1/32000)."""
    i = min((j for j, s in enumerate(specs) if not s["sampled"]),
            key=lambda j: specs[j]["prompt"].size)
    out = reqs[i].result()
    plen = specs[i]["prompt"].size
    ids = torch.from_numpy(out[None, :-1]).to(DEVICE)
    logits = model(ids)
    pred = torch.argmax(logits[0, plen - 1:], dim=-1).cpu().numpy()
    agree = float((pred == out[plen:]).mean())
    log(f"7b teacher-forced check on request {reqs[i].rid}: {agree:.3f} of "
        f"{out.size - plen} greedy tokens equal the cache-free argmax")
    check(agree >= 0.5, f"greedy tokens agree with the cache-free forward "
                        f"at only {agree:.3f} of positions")
    return agree


def phase_full_batch(torch, eng, vocab, seed):
    """After the serving run, refill every slot with a greedy request of a
    seeded prompt length, prefill each alone (timed: host clock around
    work that ends in a host sync), and run one decode step. Returns the
    per-prefill ms and the lengths the next decode step attends over."""
    rng = np.random.default_rng(seed + 1)
    plens = sorted(int(n) for n in rng.integers(16, 1001, eng.max_batch))
    for n in plens:
        eng.submit(rng.integers(0, vocab, n), max_new_tokens=64)
    joined, _ = eng.scheduler.schedule()
    check(len(joined) == eng.max_batch,
          f"{len(joined)} of {eng.max_batch} requests joined an idle engine")
    prefill_ms = {}
    for req in joined:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._prefill(req)
        torch.cuda.synchronize()
        prefill_ms[f"{req.prompt.size}@{eng._bucket_for(req.prompt.size)}"] \
            = (time.perf_counter() - t0) * 1e3
    eng.step()
    active = eng._active_slots()
    check(len(active) == eng.max_batch, "a slot of the full batch is idle")
    lengths = np.zeros(eng.max_batch, np.int32)
    for slot, r in active:
        lengths[slot] = r.cache_len + 1
    return prefill_ms, lengths


def phase_real_caches(torch, eng, lengths_np, attn, attn_ref):
    """The decode kernel on the engine's own caches at the full batch's
    lengths: held against the plain version on every layer, then timed
    there and at full length."""
    lengths = torch.from_numpy(lengths_np).to(DEVICE)
    B = lengths.shape[0]
    rows = torch.arange(B, device=DEVICE)
    pos = (lengths - 2).clamp(min=0).long()   # each slot's last cached row

    def q_from(kc):
        return kc[rows, pos].unsqueeze(1).contiguous()    # [B, 1, H, D]

    atol, rtol = TOL["bfloat16"]
    err = 0.0
    for layer, (kc, vc) in enumerate(eng._caches):
        q = q_from(kc)
        got = attn(q, kc, vc, lengths)
        torch.cuda.synchronize()
        want = attn_ref(q, kc, vc, lengths)
        e = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
              f"decode kernel disagrees with its plain version on the "
              f"engine's layer-{layer} caches: max_abs_err={e}")
        err = max(err, e)
    log(f"kernel-vs-plain on the engine's caches, all {len(eng._caches)} "
        f"layers, at lengths {lengths_np.tolist()}: max_abs_err={err:.3g} "
        f"(atol {atol}, rtol {rtol})")

    def timed(lens):
        sets = [(q_from(kc), kc, vc, lens) for kc, vc in eng._caches]
        res = {"ms": cuda_ms(attn, sets),
               "plain_ms": cuda_ms(attn_ref, sets),
               "library_ms": cuda_ms(library_attention, sets)}
        bound, by = decode_bound(sets[0][0], sets[0][1], lens)
        res.update(bound_ms=bound, bound_by=by)
        return res

    live = timed(lengths)
    full = timed(torch.full_like(lengths, eng.max_seq_len))
    return err, live, full


def phase_decode_profile(torch, eng, n_steps=20, n_traced=5):
    """Decode steps of the full batch: n_steps timed on the host clock
    (each ends in the step's host sync), then n_traced under
    torch.profiler. The device's busy share is the traced kernel time per
    step over the untraced step's p50 (the profiler slows the host, so the
    traced steps' wall time is reported apart)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):                       # warm-up
        eng.step()
    step_ms = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_traced):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_traced
    check(len(eng._active_slots()) == eng.max_batch,
          "a slot of the full batch finished during the profile")
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.key, dev_us / 1e3 / n_traced,
                            ev.count // n_traced))
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    p50 = float(np.percentile(step_ms, 50))
    return {
        "decode_step_ms_p50": p50, "decode_step_ms_min": float(min(step_ms)),
        "profiled_step_wall_ms": wall_ms,
        "device_kernel_ms_per_step": device_ms if kernels else None,
        "device_busy_share": device_ms / p50 if kernels else None,
        "decode_kernel_ms_per_step": sum(
            k[1] for k in kernels if "ragged_decode" in k[0])
        if kernels else None,
        "kernel_launches_per_step": sum(k[2] for k in kernels),
        "top_kernels": [{"name": k[0][:90], "ms_per_step": k[1],
                         "calls_per_step": k[2]} for k in kernels[:12]],
    }


# Training at llama_7b width, cut in depth: fp32 masters, grads and AdamW
# moments of all 32 layers (6.74e9 params x 16 B = 108 GB) exceed the
# card's 80 GB; 8 layers hold 1.88e9 params (30 GB of state).
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 8, 2, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# Flash-attention cases: (name, B, Sq, Sk, H, Hkv, D, causal).
FLASH_CASES = [
    ("d64_mha_causal_s200", 2, 200, 200, 8, 8, 64, True),
    ("d64_gqa4_s200", 2, 200, 200, 8, 2, 64, False),
    ("d128_gqa4_causal_sq64_sk160", 1, 64, 160, 8, 2, 128, True),
    ("d128_mha_sq130_sk300", 2, 130, 300, 4, 4, 128, False),
    ("d128_mha_causal_s1000", 1, 1000, 1000, 8, 8, 128, True),
    ("d128_mha_causal_s129", 2, 129, 129, 4, 4, 128, True),
    ("d128_gqa8_causal_sq300_sk129", 1, 300, 129, 8, 1, 128, True),
    ("d96_gqa8_causal_s129", 1, 129, 129, 8, 1, 96, True),
    ("d64_gqa8_sq129_sk257", 1, 129, 257, 8, 1, 64, False),
    ("d128_mha_causal_sq1_sk129", 1, 1, 129, 4, 4, 128, True),
    ("d64_gqa4_causal_s257", 1, 257, 257, 8, 2, 64, True),
    ("d80_gqa2_causal_s130", 1, 130, 130, 4, 2, 80, True),
    ("d100_mha_sq100_sk140", 2, 100, 140, 4, 4, 100, False),
    ("d320_mha_causal_sq70_sk90", 1, 70, 90, 2, 2, 320, True),
]
# (rtol, step) per dtype. Every row of D values (one batch, position and
# head: a query row of O and dQ, a key row of dK and dV) is held to its own
# scale: |got - want| <= atol + rtol x |want| with atol = step x the row's
# max|want| (at least FLASH_FLOOR). O within one step: the kernel rounds P
# to the dtype against the running row max, the plain version against the
# final one, and each rounds O once. Grads within two steps: both round the
# same P and dS from fp32 sums taken in another order, where a tie can
# round one element a step apart. FLASH_FLOOR covers rows that are fp32
# noise in both (dQ of causal row 0, where dS = P (dP - delta) cancels).
# LSE is fp32 in both: atol 1e-4, rtol 1e-5.
FLASH_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -7),
             "float16": (2.0 ** -10, 2.0 ** -10)}
FLASH_FLOOR = 1e-6


def flash_close(got, want, dtype_name, mult=1.0):
    """(ok, max abs error, worst share of the tolerance) under the row-wise
    rule above; a share above 1 fails, and a NaN fails."""
    rtol, step = FLASH_TOL[dtype_name]
    got, want = got.float(), want.float()
    atol = (mult * step * want.abs().amax(-1, keepdim=True)).clamp_min(
        FLASH_FLOOR)
    diff = (got - want).abs()
    share = float((diff / (atol + rtol * want.abs())).max())
    return share <= 1.0, float(diff.max()), share


def flash_inputs(torch, B, Sq, Sk, H, Hkv, D, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return [(0.5 * torch.randn(shape, generator=g, device=DEVICE)).to(dtype)
            for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                          (B, Sq, H, D))]


def flash_check(torch, fa, q, k, v, do, causal, label):
    """K2, K3 and K4 against their plain versions on one input set: logs
    every tensor's reading, then raises on a disagreement. Returns the
    largest abs error and the worst share of the tolerance per tensor."""
    name = str(q.dtype).replace("torch.", "")
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_attention_fwd_ref(q, k, v, causal)
    delta = (do.float() * want_o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, want_lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, want_lse, delta, causal)
    torch.cuda.synchronize()
    want_dq = fa.flash_attention_bwd_dq_ref(q, k, v, do, want_lse, delta,
                                            causal)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_ref(q, k, v, do, want_lse,
                                                      delta, causal)
    errs, shares, bad = {}, {}, []
    for tname, got, want, mult in (("O", o, want_o, 1.0),
                                   ("dq", dq, want_dq, 2.0),
                                   ("dk", dk, want_dk, 2.0),
                                   ("dv", dv, want_dv, 2.0)):
        ok, errs[tname], shares[tname] = flash_close(got, want, name, mult)
        if not ok or got.dtype != q.dtype:
            bad.append(tname)
    errs["lse"] = float((lse - want_lse).abs().max())
    if not torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-4):
        bad.append("lse")
    log(f"flash kernels-vs-plain {label}: " + ", ".join(
        f"{t} {e:.3g}" + (f" ({shares[t]:.3g} of tol)" if t in shares else "")
        for t, e in errs.items()))
    check(not bad, f"flash kernel disagrees with its plain version in case "
                   f"{label}: {', '.join(bad)}")
    return errs, shares


def phase_flash_cases(torch, fa):
    """K2-K4 vs their plain versions over D 64/96/128, groups 1/4/8,
    causal or not (Sq < Sk and Sq > Sk, a single query row), S not a
    multiple of any tile (one row past a 128-row tile), in every dtype."""
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for name, B, Sq, Sk, H, Hkv, D, causal in FLASH_CASES:
            q, k, v, do = flash_inputs(torch, B, Sq, Sk, H, Hkv, D, dt, 3)
            label = f"{name}_{str(dt).replace('torch.', '')}"
            errs, shares = flash_check(torch, fa, q, k, v, do, causal, label)
            out[label] = {"max_abs_err": max(errs[t] for t in shares),
                          "tol_share": max(shares.values())}
    return out


def phase_small_train(torch, LlamaConfig, LlamaForCausalLM, build, AdamW):
    """fp32, tiny width, GQA, labels with ignored rows, the fused loss off
    and on: three train steps on the card (flash through K2-K4, the fused
    loss through K5-K7) against three on the CPU (their plain versions),
    rtol 1e-4 / atol 1e-5. At AdamW's default epsilon (1e-8) an early step
    moves an element by about lr x sign(grad), so an element whose grad is
    near 0,
    where the card's and the CPU's fp32 sums may differ in sign, can land
    2 x lr apart: that run compares the losses, and logs how many elements
    differ. With epsilon 1e-3 the update is a smooth function of the grads,
    and that run compares every parameter as well."""
    cfg = LlamaConfig.tiny(vocab=64, hidden=256, layers=2, heads=4,
                           inter=512, seq=64)
    cfg.num_key_value_heads = 2
    ids = np.random.RandomState(1).randint(0, 64, (2, 65))
    labels = ids[:, 1:].copy()
    labels[:, ::7] = -100                  # ignored rows, for the fused loss
    batch = {"input_ids": ids[:, :-1], "labels": labels}
    for fused in (False, True):
        for eps, whole in ((1e-8, False), (1e-3, True)):
            losses, states = [], []
            for dev in (DEVICE, "cpu"):
                m = LlamaForCausalLM(cfg, device="cpu", seed=5).to(dev)
                opt = AdamW(learning_rate=1e-3, epsilon=eps,
                            parameters=m.parameters())
                step = build(m, opt, remat=True, amp=False, fused_loss=fused)
                losses.append([float(step(batch)) for _ in range(3)])
                states.append({n: p.detach().cpu()
                               for n, p in m.named_parameters()})
            what = f"fused_loss={fused}, epsilon {eps}"
            check(np.allclose(losses[0], losses[1], rtol=1e-4),
                  f"small train, {what}: card losses {losses[0]} vs CPU "
                  f"{losses[1]}")
            apart = {n: int((~torch.isclose(p, states[1][n], rtol=1e-4,
                                            atol=1e-5)).sum())
                     for n, p in states[0].items()}
            n_apart = sum(apart.values())
            log(f"small fp32 train check, {what}: 3 steps, card losses "
                f"{losses[0]} vs CPU (plain versions) {losses[1]}; "
                f"{n_apart} of {sum(p.numel() for p in states[0].values())} "
                f"parameter elements outside rtol 1e-4 / atol 1e-5")
            if whole:
                check(n_apart == 0, f"small train, {what}: parameters differ "
                      "between card and CPU: "
                      + str({n: c for n, c in apart.items() if c}))


def train_flops(n_params, layers, batch, seq, hidden):
    """bench.py:203-209: 6ND matmul flops plus causal attention, fwd 4 x B
    x S^2 x H per layer, x3 for fwd + bwd, x0.5 causal."""
    return 6.0 * n_params * batch * seq + 12.0 * layers * batch * seq \
        * seq * hidden * 0.5


def phase_train(torch, args, LlamaConfig, LlamaForCausalLM, build, AdamW,
                fa, fce, fused):
    """The training main path at llama_7b width, cut to TRAIN_LAYERS, with
    the fused loss (K5-K7) on or off."""
    from torch.profiler import ProfilerActivity, profile
    base = LlamaConfig.llama_7b()
    cfg = LlamaConfig(vocab_size=base.vocab_size,
                      hidden_size=base.hidden_size,
                      intermediate_size=base.intermediate_size,
                      num_hidden_layers=TRAIN_LAYERS,
                      num_attention_heads=base.num_attention_heads,
                      max_position_embeddings=TRAIN_SEQ)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE, dtype=torch.float32,
                             seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = build(model, opt, remat=True, amp=True, fused_loss=fused)
    rng = np.random.RandomState(args.seed)
    ids = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    batch = {"input_ids": torch.from_numpy(ids[:, :-1]).to(DEVICE),
             "labels": torch.from_numpy(ids[:, 1:]).to(DEVICE)}
    torch.cuda.synchronize()
    log(f"train model: {TRAIN_LAYERS} layers at llama_7b width, "
        f"{n_params / 1e9:.3f}B fp32 params, built in "
        f"{time.perf_counter() - t0:.1f}s")
    losses = []
    for _ in range(TRAIN_WARMUP):
        losses.append(float(step(batch)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, fce.fused_ce_fwd,
               fce.fused_ce_bwd_dh, fce.fused_ce_bwd_dw)
    for kern in kernels:
        kern.launches = 0     # the main path's run starts here
    step_ms = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = [kern.launches for kern in kernels]
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = [TRAIN_STEPS * 2 * TRAIN_LAYERS, TRAIN_STEPS * TRAIN_LAYERS,
            TRAIN_STEPS * TRAIN_LAYERS] + [TRAIN_STEPS * int(fused)] * 3
    check(launches == want,
          f"kernels launched {launches} times (K2, K3, K4, K5, K6, K7) in "
          f"{TRAIN_STEPS} train steps with fused_loss={fused}, want {want}")
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0],
          f"training loss did not fall: {losses[0]} -> {losses[-1]}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    p50 = float(np.percentile(step_ms, 50))
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)

    def share(*keys):
        return sum(r[1] for r in rows if any(k in r[0] for k in keys))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(n_params, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ,
                        cfg.hidden_size)
    training = {
        "fused_loss": fused, "layers": TRAIN_LAYERS,
        "hidden": cfg.hidden_size,
        "heads": cfg.num_attention_heads,
        "intermediate": cfg.intermediate_size, "vocab": cfg.vocab_size,
        "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "step_ms_p50": p50, "step_ms_min": float(min(step_ms)),
        "tokens_per_s": tokens / (p50 / 1e3),
        "mfu": flops / (p50 / 1e3) / PEAK_FLOPS["bfloat16"],
        "flops_per_step": flops, "peak_mem_gib": peak,
        "launches_per_step": dict(zip(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_ce_fwd",
             "fused_ce_bwd_dh", "fused_ce_bwd_dw"),
            (n // TRAIN_STEPS for n in launches))),
        "traced_device_ms": device_ms if rows else None,
        "busy_share": device_ms / p50 if rows else None,
        "traced_kernel_launches": sum(r[2] for r in rows),
        "device_ms_by_part": {
            "flash_fwd": share("flash_fwd"),
            "flash_bwd_dq": share("flash_bwd_dq"),
            "flash_bwd_dkv": share("flash_bwd_dkv"),
            "fused_ce_fwd": share("fce_fwd", "fce_merge"),
            "fused_ce_bwd_dh": share("fce_bwd_dh"),
            "fused_ce_bwd_dw": share("fce_bwd_dw"),
            "gemm": share("gemm", "Gemm", "cutlass", "sm90_xmma", "nvjet"),
        } if rows else None,
        "top_kernels": [{"name": r[0][:90], "ms": r[1], "calls": r[2]}
                        for r in rows[:15]],
    }
    log(f"trained {TRAIN_WARMUP}+{TRAIN_STEPS} steps, fused_loss={fused}: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, step p50 {p50:.1f} ms, "
        f"launches {launches} (= steps x [2L, L, L, f, f, f], f = "
        f"{int(fused)})")
    return model, opt, step, training


def flash_bound(q, k, causal, kind):
    """Least time (ms) for one flash kernel on these inputs: bytes (each
    input read once, each output written once) over HBM, or flops over
    the dtype's peak, whichever is larger. Pairs (query, key) are what the
    causal mask keeps: S(S+1)/2 per (batch, head) when Sq == Sk."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    pairs = B * H * (sum(min(i + 1, Sk) for i in range(Sq)) if causal
                     else Sq * Sk)
    e = q.element_size()
    qb, kb, stat = q.numel() * e, k.numel() * e, B * H * Sq * 4
    if kind == "fwd":       # read q, k, v; write O, LSE
        nbytes, flops = 2 * qb + 2 * kb + stat, 4 * D * pairs
    elif kind == "dq":      # read q, k, v, dO, LSE, delta; write dQ
        nbytes, flops = 3 * qb + 2 * kb + 2 * stat, 6 * D * pairs
    else:                   # read q, k, v, dO, LSE, delta; write dK, dV
        nbytes, flops = 2 * qb + 4 * kb + 2 * stat, 8 * D * pairs
    dt = str(q.dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash_timing(torch, fa, heads, head_dim):
    """K2, K3 and K4 at the training shape (bf16, causal), each beside its
    plain version, SDPA (forward; autograd backward for K3 + K4 together)
    and its bound; the kernels are also held against the plain versions
    here."""
    import torch.nn.functional as tF
    q, k, v, do = flash_inputs(torch, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ,
                               heads, heads, head_dim, torch.bfloat16, 7)
    errs, shares = flash_check(torch, fa, q, k, v, do, True,
                               "training_shape_bf16")
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    fwd_args = [(q, k, v, True)]
    bwd_args = [(q, k, v, do, lse, delta, True)]
    res = {
        "fwd": {"ms": cuda_ms(fa.flash_attention_fwd, fwd_args),
                "plain_ms": cuda_ms(fa.flash_attention_fwd_ref, fwd_args),
                "max_abs_err": errs["O"], "tol_share": shares["O"]},
        "dq": {"ms": cuda_ms(fa.flash_attention_bwd_dq, bwd_args),
               "plain_ms": cuda_ms(fa.flash_attention_bwd_dq_ref, bwd_args),
               "max_abs_err": errs["dq"], "tol_share": shares["dq"]},
        "dkv": {"ms": cuda_ms(fa.flash_attention_bwd_dkv, bwd_args),
                "plain_ms": cuda_ms(fa.flash_attention_bwd_dkv_ref,
                                    bwd_args),
                "max_abs_err": max(errs["dk"], errs["dv"]),
                "tol_share": max(shares["dk"], shares["dv"])},
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    res["fwd"]["library_ms"] = cuda_ms(
        lambda a, b, c: tF.scaled_dot_product_attention(a, b, c,
                                                        is_causal=True),
        [(qt, kt, vt)])
    # Autograd runs a backward op on its forward op's stream, so the SDPA
    # forward runs on the stream its backward is captured on.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        out = tF.scaled_dot_product_attention(*leaves, is_causal=True)
    dot = do.transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, dot, retain_graph=True), [()], stream=side)
    res["dq"]["library_ms"] = res["dkv"]["library_ms"] = lib_bwd
    for kind in ("fwd", "dq", "dkv"):
        bound, by = flash_bound(q, k, True, kind)
        res[kind].update(bound_ms=bound, bound_by=by)
    del out, leaves
    return res


# Fused CE cases: (name, N, H, V, vocab_offset, last). Ragged N, H and V
# (element loads), V not a multiple of 8 (the mma.sync kernels), the 16-byte
# path with a vocab offset (a third of the labels outside the shard),
# labels all in the last vocab tile (last=True).
FCE_CASES = [
    ("n13_h50_v777", 13, 50, 777, 0, False),
    ("n200_h136_v1030", 200, 136, 1030, 0, False),
    ("n300_h256_v4096_off1000", 300, 256, 4096, 1000, False),
    ("n130_h512_v2000_lasttile", 130, 512, 2000, 0, True),
    # bf16/fp16 with H and V multiples of 8 run the wgmma K6/K7: N, H and V
    # off their tiles, many vocab tiles, an 8-column last vocab slice with
    # labels in it, two 512-row slices with a vocab offset.
    ("n200_h520_v1032", 200, 520, 1032, 0, False),
    ("n256_h4096_v32000", 256, 4096, 32000, 0, False),
    ("n333_h136_v2056_lasttile", 333, 136, 2056, 0, True),
    ("n1000_h128_v1024_off300", 1000, 128, 1024, 300, False),
]
# m, lse and loss per row: atol 1e-4 / rtol 1e-5 (fp32 sums of the same
# products in another order). dh row by row and dW column by column under
# FLASH_TOL's rule with two steps: both round the same dl to the dtype, from
# fp32 logits summed in another order, and round an fp32 sum once; K6 and
# K7 add their products with fp32 reductions, in an order that changes
# between runs.


def fce_inputs(torch, N, H, V, offset, last, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    h = torch.randn(N, H, generator=g, device=DEVICE).to(dtype)
    w = (0.05 * torch.randn(H, V, generator=g, device=DEVICE)).to(dtype)
    top = V + offset + (V // 2 if offset else 0)
    labels = torch.randint(0, top, (N,), generator=g, device=DEVICE)
    if last:                     # the last vocab tile of 128 columns
        labels = V - 1 - labels % (V - (V - 1) // 128 * 128)
    gr = torch.randn(N, generator=g, device=DEVICE) / N
    gr[::5] = 0.0                        # rows that add nothing
    return h, w, labels, gr


def fce_check(torch, fce, h, w, labels, gr, offset, label):
    """K5, K6 and K7 against their plain versions on one input set: logs
    every tensor's reading, then raises on a disagreement. Returns the
    largest abs error per tensor, the worst share of the tolerance of dh
    and dW, and the plain lse (the backward's input)."""
    name = str(h.dtype).replace("torch.", "")
    m, l, z = fce.fused_ce_fwd(h, w, labels, offset)
    torch.cuda.synchronize()
    wm, wl, wz = fce.fused_ce_fwd_ref(h, w, labels, offset)
    lse = (wm + torch.log(wl)).contiguous()
    dh = fce.fused_ce_bwd_dh(h, w, labels, lse, gr, offset)
    dw = fce.fused_ce_bwd_dw(h, w, labels, lse, gr, offset)
    torch.cuda.synchronize()
    want_dh = fce.fused_ce_bwd_dh_ref(h, w, labels, lse, gr, offset)
    want_dw = fce.fused_ce_bwd_dw_ref(h, w, labels, lse, gr, offset)
    errs, shares, bad = {}, {}, []
    for tname, got, want in (("m", m, wm),
                             ("lse", m + torch.log(l), lse),
                             ("loss", m + torch.log(l) - z, lse - wz)):
        errs[tname] = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=1e-4, rtol=1e-5):
            bad.append(tname)
    # rows of dh, columns of dW (transposed to rows for flash_close)
    for tname, got, want in (("dh", dh, want_dh),
                             ("dW", dw.t(), want_dw.t())):
        ok, errs[tname], shares[tname] = flash_close(got, want, name, 2.0)
        if not ok or got.dtype != h.dtype:
            bad.append(tname)
    log(f"fused CE kernels-vs-plain {label}: " + ", ".join(
        f"{t} {e:.3g}" + (f" ({shares[t]:.3g} of tol)" if t in shares else "")
        for t, e in errs.items()))
    check(not bad, f"fused CE kernel disagrees with its plain version in "
                   f"case {label}: {', '.join(bad)}")
    return errs, shares, lse


def phase_fce_cases(torch, fce):
    """K5-K7 vs their plain versions over ragged and aligned shapes, a
    vocab offset and labels in the last tile, in every dtype."""
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for name, N, H, V, offset, last in FCE_CASES:
            h, w, labels, gr = fce_inputs(torch, N, H, V, offset, last, dt,
                                          4)
            label = f"{name}_{str(dt).replace('torch.', '')}"
            errs, shares, _ = fce_check(torch, fce, h, w, labels, gr, offset,
                                        label)
            out[label] = {"max_abs_err": max(errs.values()),
                          "tol_share": max(shares.values())}
    return out


def fce_bound(N, H, V, esize, kind):
    """Least time (ms) for one fused CE kernel at these shapes: bytes (each
    input read once, each output written once) over HBM, or flops over the
    bf16/fp16 peak, whichever is larger."""
    hb, wb = N * H * esize, H * V * esize
    if kind == "fwd":       # read h, W, labels; write m, l, z
        nbytes, flops = hb + wb + 4 * N + 12 * N, 2.0 * N * H * V
    elif kind == "dh":      # read h, W, labels, lse, g; write dh
        nbytes, flops = 2 * hb + wb + 12 * N, 4.0 * N * H * V
    else:                   # read h, W, labels, lse, g; write dW
        nbytes, flops = hb + 2 * wb + 12 * N, 4.0 * N * H * V
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_fce_timing(torch, fce, N, H, V):
    """K5, K6 and K7 at the training head's shape (bf16): held against
    their plain versions, then each timed beside its plain version, the
    unfused head (forward; autograd backward for K6 + K7 together) and its
    bound."""
    import torch.nn.functional as tF
    h, w, labels, gr = fce_inputs(torch, N, H, V, 0, False, torch.bfloat16,
                                  8)
    errs, shares, lse = fce_check(torch, fce, h, w, labels, gr, 0,
                                  "training_head_bf16")
    fwd_args = [(h, w, labels)]
    bwd_args = [(h, w, labels, lse, gr)]
    res = {
        "fwd": {"ms": cuda_ms(fce.fused_ce_fwd, fwd_args),
                "plain_ms": cuda_ms(fce.fused_ce_fwd_ref, fwd_args),
                "max_abs_err": max(errs["m"], errs["lse"], errs["loss"])},
        "dh": {"ms": cuda_ms(fce.fused_ce_bwd_dh, bwd_args),
               "plain_ms": cuda_ms(fce.fused_ce_bwd_dh_ref, bwd_args),
               "max_abs_err": errs["dh"], "tol_share": shares["dh"]},
        "dw": {"ms": cuda_ms(fce.fused_ce_bwd_dw, bwd_args),
               "plain_ms": cuda_ms(fce.fused_ce_bwd_dw_ref, bwd_args),
               "max_abs_err": errs["dW"], "tol_share": shares["dW"]},
    }

    def unfused(a, b, lab):
        return tF.cross_entropy(torch.matmul(a, b).float(), lab,
                                reduction="none")
    res["fwd"]["library_ms"] = cuda_ms(unfused, fwd_args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [x.detach().requires_grad_() for x in (h, w)]
        out = unfused(*leaves, labels)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, gr, retain_graph=True), [()], stream=side)
    res["dh"]["library_ms"] = res["dw"]["library_ms"] = lib_bwd
    for kind in ("fwd", "dh", "dw"):
        bound, by = fce_bound(N, H, V, h.element_size(), kind)
        res[kind].update(bound_ms=bound, bound_by=by)
    del out, leaves
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    args = ap.parse_args(argv)

    card_id = use_one_card()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card only", file=sys.stderr)
        return 2
    from paddle_tpu_torch.inference.serving import (RequestState,
                                                    ServingEngine)
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               build_hybrid_train_step)
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as fce
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        ragged_decode_attention as attn, ragged_decode_attention_ref)
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power(card_id)
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")

    build_s = _build.build(force=True)
    _build.library()
    log(f"built {', '.join(_build.SOURCES)} -> {_build.LIB_PATH} with nvcc "
        f"(sm_90a, one process per source) in {build_s:.1f}s")

    case_errs = phase_kernel_cases(torch, attn, ragged_decode_attention_ref)
    flash_cases = phase_flash_cases(torch, fa)
    fce_cases = phase_fce_cases(torch, fce)
    phase_small_reference(torch, LlamaConfig, LlamaForCausalLM,
                          ServingEngine, fa)
    model, eng, reqs, specs, serving = phase_serve(
        torch, args, LlamaConfig, LlamaForCausalLM, ServingEngine,
        RequestState, attn)
    agree = phase_teacher_forced(torch, model, reqs, specs)
    prefill_ms, live_lengths = phase_full_batch(
        torch, eng, model.config.vocab_size, args.seed)
    err, live, full = phase_real_caches(
        torch, eng, live_lengths, attn, ragged_decode_attention_ref)
    log(f"decode kernel at full length {eng.max_seq_len}: "
        + json.dumps(full))
    profile = {"lengths": live_lengths.tolist(), "prefill_ms": prefill_ms,
               **phase_decode_profile(torch, eng)}
    heads = model.config.num_attention_heads
    head_dim = model.config.hidden_size // heads
    del model, eng, reqs          # free the serving model for training
    gc.collect()
    torch.cuda.empty_cache()

    phase_small_train(torch, LlamaConfig, LlamaForCausalLM,
                      build_hybrid_train_step, AdamW)
    trained = {}
    for fused in (False, True):
        tmodel, opt, step, trained[fused] = phase_train(
            torch, args, LlamaConfig, LlamaForCausalLM,
            build_hybrid_train_step, AdamW, fa, fce, fused)
        vocab = tmodel.config.vocab_size
        del tmodel, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    training, training_fused = trained[False], trained[True]
    flash = phase_flash_timing(torch, fa, heads, head_dim)
    log(f"flash kernels at B={TRAIN_BATCH} S={TRAIN_SEQ} H={heads} "
        f"D={head_dim} bf16 causal: " + json.dumps(flash))
    head_n = TRAIN_BATCH * TRAIN_SEQ
    fused_ce = phase_fce_timing(torch, fce, head_n, heads * head_dim, vocab)
    log(f"fused CE kernels at N={head_n} H={heads * head_dim} V={vocab} "
        f"bf16: " + json.dumps(fused_ce))

    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    pallas = "paddle_tpu/ops/pallas/flash_attention.py"
    per_step = training["launches_per_step"]
    kernels = {"kernels": [{
        "name": "ragged_decode_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:37",
        "launches": serving["kernel_launches"], "max_abs_err": err,
        "ms": live["ms"], "plain_ms": live["plain_ms"],
        "bound_ms": live["bound_ms"], "bound_by": live["bound_by"],
        "library_ms": live["library_ms"], "full_ms": full["ms"],
        "full_bound_ms": full["bound_ms"],
        "full_library_ms": full["library_ms"]}]}
    for name, key, line in (("flash_attention_fwd", "fwd", 47),
                            ("flash_attention_bwd_dq", "dq", 129),
                            ("flash_attention_bwd_dkv", "dkv", 166)):
        r = flash[key]
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"{pallas}:{line}",
            "launches": per_step[name.replace("attention_", "")]
            * training["steps"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    fused_steps = training_fused["launches_per_step"]
    for name, key, line in (("fused_ce_fwd", "fwd", 67),
                            ("fused_ce_bwd_dh", "dh", 131),
                            ("fused_ce_bwd_dw", "dw", 156)):
        r = fused_ce[key]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_ce.cu",
            "replaces": f"paddle_tpu/ops/pallas/fused_ce.py:{line}",
            "launches": fused_steps[name] * training_fused["steps"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": "unfused head: F.cross_entropy(matmul(h, w).float())"
                       + (" forward" if key == "fwd" else
                          " autograd backward, K6 + K7 together")})
    serving["teacher_forced_agreement"] = agree
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"card": card, "kind": kind, "build_s": build_s,
                       "case_max_abs_err": case_errs,
                       "flash_cases": flash_cases,
                       "fused_ce_cases": fce_cases,
                       "fused_ce_timing": fused_ce,
                       "training_fused": training_fused,
                       "live_lengths": live_lengths.tolist(),
                       "kernel_live": live, "kernel_full": full,
                       "flash_timing": flash, "serving": serving,
                       "decode_profile": profile, "training": training,
                       **kernels}, f, indent=1)
    log(json.dumps({"decode_profile": profile}))
    log(json.dumps({"training": training}))
    log(json.dumps({"training_fused": training_fused}))
    log(json.dumps(kernels))
    log(json.dumps({"serving": serving}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
