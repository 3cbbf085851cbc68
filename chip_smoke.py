#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out PATH] [--mesh-backend gloo|nccl]
                          [--mesh-only | --deepfm-only | --elastic-only |
                           --eager-only | --nn-only | --gpt-only |
                           --measure-only | --vision-only | --bert-only |
                           --static-only]

Run from the repo root on a machine with a CUDA card, nvcc and PyTorch
built for CUDA. It imports nothing of JAX or of ``paddle_tpu``; it drives
``paddle_tpu_torch`` and fails (non-zero exit, traceback) if any phase
fails:

1. environment: the card's name and power limit (nvidia-smi), torch/CUDA;
2. build: every kernel of the serving and training paths (K1 decode
   attention, K2-K4 flash attention forward, dQ and dK/dV, K5-K7 fused
   linear + cross-entropy forward, dh and dW, U1 and U2 the multi-tensor
   sum of squares with finite flag and Adam/AdamW update), from
   ``paddle_tpu_torch/csrc``, one nvcc per source for sm_90a, all started
   together (the build time is printed);
3. each kernel against its plain PyTorch version on the card, at the
   listed shapes and dtypes, with the tolerance stated per dtype and
   tensor; U1 and U2 over size classes (one element, an empty tensor,
   odd sizes, a misaligned view, the 8-layer model's 75 shapes at 1/64)
   in fp32, bf16 and fp16, with and without the loss and clip scales (U2
   bit for bit), a finite flag of 0 that must leave every byte, and one
   CUDA-graph capture of U1 + U2 replayed against the eager launches;
4. a reference check at a small size in fp32: the engine's tokens equal
   ``generate()`` with and without the KV cache (the cache-free path runs
   K2, flash attention, once per layer and new token: its launches are
   counted and checked);
5. serving at the full ``LlamaConfig.llama_7b()`` width (32 layers, bf16,
   seeded random weights): 16 requests through ``ServingEngine`` with a
   late join, once with step capture off (eager steps) and once on (each
   step kind a CUDA graph, ``jit.capture``); every request must finish
   with its prompt plus its new tokens, the two runs' tokens must be
   bitwise equal (greedy and seeded sampled), the decode kernel's launch
   count must be exactly ``decode_steps * num_hidden_layers`` in each, and
   no captured signature may bail out;
6. a full batch after the serving run: every slot refilled with a greedy
   request (each prefill timed alone), then the decode kernel on every
   layer's caches at the slots' lengths, held against the plain version
   and timed (one CUDA graph of 32 calls, one per layer's caches so each
   call finds L2 cold, its replays timed with CUDA events) beside the
   plain version, ``F.scaled_dot_product_attention`` as the library
   yardstick, and the least time the card could take (``bound_ms``, from
   the bytes and flops the inputs need); then decode steps timed on the
   host clock and a few traced with ``torch.profiler``, captured and then
   eager: device time per step by kernel, host launch calls, and the
   device's busy share of a step;
   then the rest of serving on the same model, each against an engine
   without the feature (tokens equal at >= 0.5 of positions and at a
   teacher-forced share >= 0.5, their first divergence printed: bf16
   rounds the masked window path and the decode kernel differently): speculative decoding at k=4 with the n-gram
   drafter (8 requests over repeated-segment prompts) and with the target
   as its own draft model (4 requests; at least 0.8 (k + 1) tokens per
   verify; the decode kernel launched exactly (decode steps - verify steps
   + draft steps) x layers times); prefix sharing (8 requests over one
   1024-token prefix: at least 7 shared joins and 7 x 64 pages saved);
   chunked prefill (a 1900-token prompt in 8 windows of 256, a decode step
   between any two, beside 7 decoding requests); the gateway (8 requests
   from 4 client threads over a socket: the in-process engine's tokens,
   HEALTH ready, METRICS with the serving and capture series, and no
   thread left after drain and stop);
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
   launches, with the fused loss one K5, K6 and K7 launch, and one U2
   launch (the update; no clip, as bench.py trains, so no U1); then one
   step of each traced with ``torch.profiler``;
9. ``compile_train_step`` at llama_7b width cut to 2 layers, fp32, with
   a GradScaler (2**15, growth every 2 steps) and a global-norm clip: 3
   steps, one whose loss a batch field multiplies by inf, 2 more; the bad
   step skipped with every parameter and moment unchanged (checksums),
   the scale halved there and doubled after 2 good steps, the loss finite
   and falling, U1 and U2 launched once a step; the step is one CUDA graph
   (``jit.capture.lower_step``: no bailout, the first call its warm-up and
   five replays, U1 and U2 counted through them) and its losses equal the
   same run with capture off (bitwise, else within two eager runs'
   spread); then DeepFM (``phase_deepfm``) at ``models/deepfm.py``'s
   default widths (9-wide factors, 13 dense features, 26 fields,
   512-256-128) over 2**24 hashed rows, batch 512 a rank, Adam(1e-3),
   seeded power-law ids over 2**32 raw ids: 3 + 20 steps captured (0
   bailouts, one replay a step, U1 and U2 inside the graph) and the same
   steps eager, losses equal, finite and falling; step ms p50 of each,
   samples/s, ``memory_stats()`` and the peak; then 2 ranks sharing the
   card over gloo (the table row-sharded, the exchange's sites recorded,
   the step's gloo bailout counted, losses equal to dp1's on the same
   global batches at rtol 1e-4; inside ``comms.quantized("int8")`` rows
   wire / logical <= 0.27 and the last loss within 10% of exact), or with
   ``--mesh-backend nccl`` 4 ranks a card each, the step captured; then
   ``LlamaConfig(recompute=True)`` through the fleet's ``recompute`` at
   llama_7b width cut to 2 layers (S=2048, B=2, bf16): ``compute_loss``
   forward + backward against recompute off on the same model, loss and
   grads bitwise (a tensor two plain runs disagree on, within their
   spread), K2 2 x layers and K3, K4 layers, each path's ms;
10. K2, K3 and K4 timed at the training shape (B=2, S=2048, H=32, D=128,
   bf16, causal) from CUDA-graph replays, beside their plain versions,
   ``F.scaled_dot_product_attention(is_causal=True)`` forward and its
   autograd backward (one time for K3 and K4 together) as the library
   yardstick, and the least time the card could take (``bound_ms``);
11. K5, K6 and K7 held against their plain versions and timed the same way
   at the training head's shape (N = B x S = 4096, H = 4096, V = 32000,
   bf16), beside the unfused head as the yardstick: no single PyTorch call
   computes linear + cross-entropy, so it is ``F.cross_entropy(
   torch.matmul(h, w).float(), labels, reduction="none")`` forward and its
   autograd backward (one time for K6 and K7 together); and beside
   ``torch.matmul(h, w)`` alone (``gemm_ms``), the product all three
   contain;
12. U1 and U2 over the 8-layer training model's 75 fp32 tensors (1.881e9
   elements), held against their plain versions, then timed the same way
   beside ``torch._foreach_norm`` and ``torch.optim.AdamW(fused=True)``
   (same math, other rounding) and their byte bounds;
13. phase_mesh, multi-GPU training part 1, on ranks that are processes
   sharing the one card over **gloo** (NCCL refuses two ranks on one
   device), spawned after the kernels are built (``_build.py``'s file lock
   makes each rank load that build), each with a deadline: 4 ranks of
   dp2 x mp2 run the small fp32 model of phase 7 for 3 steps (losses equal
   to one rank's on the card at rtol 1e-5, parameters at AdamW epsilon
   1e-3 within rtol 1e-4 / atol 1e-5), then 4 layers at llama_7b width
   (S=2048, global batch 2, bf16 amp, remat, AdamW(1e-4), a global-norm
   clip; 2 warm-up + 5 timed steps: losses finite and falling, equal on
   every rank, per step and rank K2 2 x layers, K3 and K4 layers, U1 and
   U2 once); then 2 ranks: sep2 ring and sep2 Ulysses at the same width
   and depth (S=4096, 2048 a rank, batch 1; 1 warm-up + 1 timed step;
   rank i of the ring launches K2 2 (i+1) x layers, K3 and K4 (i+1) x
   layers a step, Ulysses 2 x layers and layers; the first losses equal at
   one bf16 step), ``fused_linear_cross_entropy_tp`` at N=H=4096, V=32000
   over mp2 against the unsharded K5-K7 on the rank (m, lse and loss per
   row, dh per row, the dW shard per column; K5, K6 and K7 once each),
   and the dp2 grad sync exact, int8 and fp8 (2 layers, S=1024, 3 steps:
   wire / logical at most 0.27 for int8, losses within 1% of exact).
   Then multi-GPU training part 2 (``phase_mesh_pp``): 4 ranks of
   dp2 x pp2 run the small fp32 model as gpipe and 1f1b_compact with
   ``DygraphShardingOptimizer`` (ZeRO stage 1 over dp; losses and
   parameters equal to one unpipelined rank, each rank holding half its
   Adam state), then 1f1b and vpp (n_virtual=2) at llama_7b width cut to
   4 layers (S=2048, B=8, M=4, bf16 amp, remat, the fused loss, a clip,
   ZeRO stage 1; 1 warm-up + 2 timed steps: losses finite, falling and
   equal on every rank, K2-K7, U1 and U2 launched exactly as each stage
   must, every state tensor sharded); then (gloo only) 16 ranks of
   dp2 x pp2 x sharding2 x mp2 run the vpp step of a tiny model with
   sequence parallelism and ZeRO over the sharding axis, equal to one
   unpipelined rank. Then the checkpoint job: 4 ranks of dp2 x mp2 at
   llama_7b width cut to 2 layers (S=2048, bf16 amp, remat, a clip,
   ZeRO-1 over dp) take 3 steps, commit a sharded generation of the
   step's state under ``build/`` (one owner a rank; free disk checked
   first), take 3 more; a fresh step from other weights restores it (its
   pieces' CRC32 equal to the saved ones) and repeats them: losses
   bitwise (or within the spread of two uninterrupted runs), launches a
   step and rank exact; save and restore seconds, bytes a rank, GB/s and
   ``wait_commit`` seconds printed, the generations deleted. Then the MoE
   job: 2 ranks of ep2 run a gshard ``MoELayer(4096, 8 experts, 11008,
   top-2)`` on 4096 fp32 tokens against the ep1 layer from the same seed
   (output, l_aux and the grads at rtol 1e-4), forward + backward ms of
   each and the ep all-reduce bytes.
   Times are the gloo path's, labelled so, with no bound claimed.
   ``--mesh-backend nccl --mesh-only`` runs the same phase (and only it,
   after the build) with one card a rank over NCCL, on a machine with 4
   cards; with no arguments the script needs one card.
14. phase_elastic, durability and elasticity: the script hosts the master
   ``TCPStore`` (the native host runtime must load: a Python fallback
   fails) and a c10d store, then starts two worker processes of its own
   (``--elastic-worker``) that share the card over gloo, each an
   ``ElasticManager`` and a ``Supervisor`` over a dp2 ``TrainStep`` at
   llama_7b width cut to ``ELASTIC_LAYERS`` layers (S=2048, B=2 a rank,
   bf16 autocast, remat, a global-norm clip, AdamW under ZeRO-1), fed a
   global-order stream of seeded token ids, committing every 2 steps. Two
   fresh 6-step runs, at the same time (two fleets of two workers, each
   with its own stores, process groups and generations; their times
   include each other's load), lose worker b after step 3: by SIGKILL at
   ``supervisor.detect`` (b's exit code must be -SIGKILL; a rolls back to
   the last generation and resumes on dp1 within PT_SUPERVISOR_TIMEOUT)
   and by a coordinated drain (zero replayed steps; the bytes moved
   through the store equal b's moment shards). a's losses and final state
   must be bitwise a fresh dp1 step loaded with the state the event handed
   a (the generation the rollback read; the drained state) and run over
   the same samples from the same cursor (else within two such runs'
   spread; the final tensors compared on the card);
   launches per step and rank exactly K2 2 x layers, K3 and K4 layers, U2
   1 and U1 2 at dp2 (the finite flag before the sync, the clip after it)
   and 1 at dp1; each rank holds 1/dp of the Adam state. Generations go
   under ``build/chip_smoke_elastic`` (free disk checked, deleted after).
   ``--elastic-only`` runs the build and this phase alone (with
   ``--deepfm-only``, the DeepFM phase first). With ``--mesh-backend
   nccl`` (4 cards) each worker holds a card of its own over NCCL (the
   crash fleet cards 0-1, the drain fleet 2-3), and the survivor aborts
   the old world's communicators before it forms the new one.
13. the eager core (``phase_eager``): every case of the op table
   (``tests/torch_op_cases.py``, one per public name of the JAX op
   modules, and the ``Tensor`` method where the op is one) on card
   tensors against the same port op on CPU tensors (float32 rtol 1e-4,
   atol 1e-5; factors by reconstruction), every output on the card, the
   count printed; then Paddle's dygraph loop at llama_7b width cut to
   EAGER_LAYERS (B=2, S=2048): ``to_tensor`` inputs, ``auto_cast(O1,
   bf16)``, ``logits``, ``mean(cross_entropy)``, ``backward()``,
   ``AdamW.step()``, ``clear_grad()``, 2 warm-up and 5 timed steps. The
   step must equal the same step with ``sdpa_ref`` under the same casts
   (loss within 1e-2, each grad within 5e-2 relative L2); the operator
   stats show linear/sdpa in bf16 and rms_norm/cross_entropy/mean in fp32
   (matmul bf16, softmax fp32 in the sdpa_ref step); launches are exactly
   K2 = K3 = K4 = layers and U2 1 a step; an inf planted in a weight
   raises naming the op with FLAGS_check_nan_inf on, and with it off no
   scan runs; the loss falls. Printed: step ms p50 beside
   ``build_hybrid_train_step(amp=True)`` at the same size, ops a step,
   host us an op, peak GiB, and host us a call of an add on plain
   tensors, on port Tensors and through the op library. ``--eager-only``
   runs the build and this phase alone.
15. ``phase_nn_sweep``: every ported breadth op and in-place op (true
   in-place ones keep their storage), every functional, layer and
   initializer of ``tests/torch_nn_cases.py`` on card tensors against the
   CPU (float32 rtol 1e-4, atol 1e-5), BatchNorm2D's running statistics
   after 3 steps equal to the CPU's; the count of names checked printed.
   ``phase_gpt``: GPT-2 small (``GPTConfig()``) trained at full width and
   depth, B=8, S=1024, AdamW(1e-4), O1 bf16, dropout as configured, 2
   warm-up and 5 timed steps: the loss falls, K2-K4 launch 0 times (the
   causal mask takes ``sdpa_ref``) and U2 once per 80 tensors a step, the
   operator dtypes follow the amp lists, and a 2-layer fp32 copy with
   dropout 0 gives the same step (the losses before and after one AdamW
   step at rtol 1e-5; each grad within 1e-4 of its L2 norm plus 1e-6
   sqrt(numel)) and the same 16 greedy ids on the card as on the CPU.
   ``phase_measure``: the measurement API over phase_eager's loop: a
   ``Profiler`` (closed 1, ready 1, record 3) with RecordEvents exports a
   Chrome trace whose recorded steps hold their 3 user spans and the
   dispatch's ops; ``device``'s counters equal ``torch.cuda``'s, an Event
   times a step within 10% of the wall p50, a side Stream's matmul equals
   the default stream's, ``benchmark().ips`` equals the steps' rate.
   Printed: GPT step p50, tokens/s, peak GiB, ops a step, host us an op;
   the LLaMA step p50 with the profiler recording and closed.
   ``--nn-only``, ``--gpt-only`` and ``--measure-only`` run the build and
   the phases named (together: all three).
16. ``phase_vision``: ResNet-50 (``resnet50()``, 1000 classes, 25.6M
   parameters) trained as PaddleClas's ResNet50.yaml trains it on a card:
   B=64 seeded 3x224x224 images, ``Momentum(0.025, 0.9,
   weight_decay=1e-4)`` (its lr 0.1 is for 4 cards' 256 images, scaled
   linearly), O1 bf16, 2 warm-up and 5 timed steps; gates: every
   parameter and BatchNorm buffer on the card, the loss finite and the
   last step's below the first's, K2-K4 and U2 0 launches; a fp32
   ``ResNet(BottleneckBlock, [1, 1, 1, 1], 10)`` at 64x64, B=4, gives the
   same step on the card as on the CPU (loss, each grad within GPT's
   tolerance, the running statistics and the eval-mode logits). Then the
   OCR pair at the JAX defaults, fp32, ``Adam(1e-3)``, 2 + 5 steps each:
   CRNN on [256, 3, 32, 100] (PaddleOCR's rec input; T=25 steps of the
   bidirectional LSTM, CTC over 1-10 long labels) and DBNet on [16, 3,
   640, 640] (det_db's crop) with ``db_loss`` on seeded maps; gates: the
   loss finite and falling, U2 once per 80 tensors a step, U2 over the
   model's own tensors bit for bit its plain version (Adam and AdamW), a
   small copy equal card vs CPU.
   ``phase_bert``: BERT-base GLUE fine-tuning at full width as PaddleNLP's
   run_glue: ``BertForSequenceClassification(BertConfig(), 2)``, B=32,
   S=128 (lengths 16-128 padded with id 0, token types 0 / 1),
   ``AdamW(2e-5, weight_decay=0.01)``, O1 bf16, dropout 0.1, 2 + 5 steps,
   beside one O1 step of ``BertForPretraining`` with
   ``bert_pretraining_loss`` on 15% masked labels; gates: the losses
   finite and falling, K2-K4 0 launches (the pad mask takes ``sdpa_ref``)
   and U2 once per 80 tensors a step, U2 over each model's own tensors
   bit for bit its plain version, the pad mask live (other ids at
   padded positions leave the eval-mode logits equal), a 2-layer fp32
   copy with dropout 0 equal card vs CPU. Printed: step ms p50,
   images or sequences/s, peak GiB, ops a step, forward host ms.
   ``--vision-only`` and ``--bert-only`` run the build and the phase
   named (with the flags above: those phases together).
17. ``phase_static``, the static-graph world and the compile/export tier,
   all at llama_7b width cut to EAGER_LAYERS (B=2, S=2048) with the eager
   loop's seed and batch: ``to_static(model.llama)`` O1 bf16 with
   ``AdamW(1e-4)`` stepped in turns with phase_eager's loop on a second
   model of the same weights (2 + 5 steps; gates: step-1 grads and the
   losses against the eager loop's, K2 = K3 = K4 = layers and U2 once a
   step, one forward and one backward graph, no bailout; a tensor ``if``
   bails out with its reason; dropout's replays differ); the same step
   as a static ``Program`` (``static.data``, ``compute_loss``,
   ``AdamW.minimize``, 2 + 5 ``Executor.run``s fetching the loss; gates:
   the losses track the eager loop's, the same launches a run, one cache
   entry captured as one graph); deployment: the LLaMA saved at bf16
   with the fixed spec ``[1, 2048]``, loaded by ``inference.
   create_predictor`` and run through the handles (logits against the
   eager model, K2 = layers a run), a tiny LLaMA saved on the CPU and
   loaded on the card (it launches K2 and matches the card model), and
   ResNet-50 fp32 eval saved with a dynamic batch, run by the Predictor
   at batch 1 and 64 against eager, ``PredictorPool(2)`` on one weight
   storage. Printed: step and run ms p50 beside the eager loop's, the
   host µs of K2 through its operator and through its launcher, save and
   load seconds and file sizes, images/s. ``--static-only`` runs the
   build and this phase.

The serving features print ``spec:``, ``prefix:``, ``chunked:`` and
``gateway:`` lines as they finish. The last lines are
``{"decode_profile": ...}``, ``{"training": ...}``,
``{"training_fused": ...}``, ``{"trainstep": ...}``, ``{"recompute": ...}``,
``{"deepfm": ...}``, ``{"eager": ...}``, ``{"static": ...}``,
``{"nn_sweep": ...}``,
``{"gpt": ...}``, ``{"measure": ...}``, ``{"vision": ...}``,
``{"bert": ...}``, ``{"mesh": ...}``,
``{"elastic": ...}``,
``{"kernels": [...]}`` (K1-K7, U1 and U2, with the mesh paths'
launches),
``{"serving": ...}``, the total run time, the card's
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


def serve_traffic(torch, eng, specs, attn, RequestState, n_layers):
    """The 16-request traffic through ``eng``: 12 requests, 4 more after two
    engine steps, every 4th sampled. The decode kernel's count is set to 0
    just before and read just after. Returns the requests and the run's
    numbers (host clock; every engine step ends in a host sync)."""
    reqs = []

    def submit(s):
        kw = dict(temperature=0.8, top_p=0.95, seed=1000 + len(reqs)) \
            if s["sampled"] else {}
        reqs.append(eng.submit(s["prompt"], max_new_tokens=s["max_new"],
                               **kw))

    decode_only_ms = []
    steps = 0
    attn.launches = 0
    t_serve = time.perf_counter()
    for s in specs[:12]:
        submit(s)
    while not eng.scheduler.idle or len(reqs) < len(specs):
        prefills = eng.info()["prefills"]
        t0 = time.perf_counter()
        eng.step()
        dt = (time.perf_counter() - t0) * 1e3
        steps += 1
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
    return reqs, {
        "decode_steps": info["decode_steps"], "engine_steps": steps,
        "generated_tokens": info["tokens_generated"],
        "kernel_launches": launches,
        "decode_step_ms_p50": float(np.percentile(decode_only_ms, 50)),
        "decode_step_ms_p90": float(np.percentile(decode_only_ms, 90)),
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p90": float(np.percentile(ttft, 90)),
        "tokens_per_s": info["tokens_generated"] / wall, "wall_s": wall,
        "avg_occupancy": info["avg_occupancy"]}


def check_no_bailouts(capture, label):
    info = capture.capture_info()
    check(info["bailouts"] == 0,
          f"{label}: {info['bailouts']} captured signature(s) bailed out: "
          f"{info['last_bailout']}")
    return info


def phase_serve(torch, args, LlamaConfig, LlamaForCausalLM, ServingEngine,
                RequestState, attn, capture):
    """The serving traffic at llama_7b width twice on one model and seeds:
    with step capture off (eager steps), then on (CUDA graphs). Greedy
    tokens must be bitwise equal (the same kernels on the same shapes),
    sampled ones too (equal logits, equal seeds), the decode kernel must
    launch exactly decode_steps x layers times in each run, and no captured
    signature may bail out."""
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
    rng = np.random.default_rng(args.seed)
    specs = []
    for i in range(16):
        plen = int(rng.integers(16, 1001))
        specs.append(dict(prompt=rng.integers(0, cfg.vocab_size, plen),
                          max_new=int(rng.integers(32, 129)),
                          sampled=(i % 4 == 3)))
    n_layers = cfg.num_hidden_layers

    capture.set_step_capture_enabled(False)
    eng = ServingEngine(model, max_batch=8, max_seq_len=2048)
    eager_reqs, eager = serve_traffic(torch, eng, specs, attn, RequestState,
                                      n_layers)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    capture.set_step_capture_enabled(True)
    capture.capture_clear()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, max_batch=8, max_seq_len=2048)
    reqs, captured = serve_traffic(torch, eng, specs, attn, RequestState,
                                   n_layers)
    for a, b, s in zip(eager_reqs, reqs, specs):
        check(np.array_equal(a.result(), b.result()),
              f"request {b.rid} ({'sampled' if s['sampled'] else 'greedy'})"
              f": captured tokens differ from the eager run's")
    cinfo = check_no_bailouts(capture, "serving")
    check(cinfo["lowerings"] > 0 and cinfo["hits"] > 0,
          f"the captured run replayed no graph: {cinfo}")
    serving = {
        "requests": len(reqs), "max_batch": eng.max_batch,
        "max_seq_len": eng.max_seq_len, "layers": n_layers,
        "prompt_tokens": int(sum(s["prompt"].size for s in specs)),
        **captured,
        "eager": {k: eager[k] for k in (
            "decode_step_ms_p50", "decode_step_ms_p90", "ttft_ms_p50",
            "tokens_per_s", "wall_s", "kernel_launches", "decode_steps")},
        "captured_equals_eager": True,
        "capture": {k: cinfo[k] for k in (
            "lowerings", "hits", "bailouts", "fallback_calls", "graphs")},
        "graph_pool_mib": cinfo["pool_mib"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"served {len(reqs)} requests eager, then captured: "
        f"{captured['decode_steps']} decode steps, {captured['kernel_launches']}"
        f" decode-kernel launches (= steps x {n_layers}) in each run, tokens "
        f"equal; capture {serving['capture']}, pool "
        f"{serving['graph_pool_mib']} MiB; decode step p50 "
        f"{eager['decode_step_ms_p50']:.2f} ms eager, "
        f"{captured['decode_step_ms_p50']:.2f} ms captured")
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
        eng.submit(rng.integers(0, vocab, n), max_new_tokens=128)
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
    api = {}        # host-side launch calls a step, by runtime API name
    for ev in prof.key_averages():
        if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx",
                      "cudaGraphLaunch"):
            api[ev.key] = ev.count / n_traced
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
        "host_launch_calls_per_step": api,
        "top_kernels": [{"name": k[0][:90], "ms_per_step": k[1],
                         "calls_per_step": k[2]} for k in kernels[:12]],
    }


# ---------------------------------------------------------------------------
# the rest of serving: speculative decoding, prefix sharing, chunked
# prefill, the gateway (llama_7b width, the serving model, capture on)
# ---------------------------------------------------------------------------

def run_engine(torch, eng, prompts, max_new, RequestState):
    """Submit every prompt, step until idle; every request must finish
    with its prompt and max_new tokens. Returns the outputs, the host ms
    of each engine step with no prefill, the TTFT of each request (ms)
    and the wall seconds."""
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, max_new)]
    step_ms = []
    while not eng.scheduler.idle:
        prefills = eng.info()["prefills"]
        ts = time.perf_counter()
        eng.step()
        if eng.info()["prefills"] == prefills:
            step_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = []
    for r, p, n in zip(reqs, prompts, max_new):
        check(r.state is RequestState.FINISHED,
              f"request {r.rid} ended {r.state.name}")
        out = r.result()
        check(out.size == p.size + n and np.array_equal(out[:p.size], p),
              f"request {r.rid}: {out.size} tokens, want {p.size} + {n}")
        outs.append(out)
    ttft = [(r.token_times[0] - r.submit_time) * 1e3 for r in reqs]
    return outs, step_ms, ttft, wall


def teacher_forced_share(torch, model, prompts, outs):
    """The share of generated positions whose token equals the argmax of
    the cache-free forward (flash attention) over the same sequence: the
    metric of phase_teacher_forced, for each of ``outs``."""
    agree = total = 0
    for p, out in zip(prompts, outs):
        ids = torch.from_numpy(out[None, :-1]).to(DEVICE)
        pred = torch.argmax(model(ids)[0, p.size - 1:], dim=-1).cpu().numpy()
        agree += int((pred == out[p.size:]).sum())
        total += out.size - p.size
    return agree / total


def divergence(prompts, want, got):
    """Per request, the first generated position where ``got`` leaves
    ``want`` (None when equal), and the share of positions equal."""
    first, equal, total = [], 0, 0
    for p, w, g in zip(prompts, want, got):
        a, b = w[p.size:], g[p.size:]
        diff = np.nonzero(a != b)[0]
        first.append(int(diff[0]) if diff.size else None)
        equal += int((a == b).sum())
        total += a.size
    return first, equal / total


TEACHER_FORCED_MIN = 0.5   # phase_teacher_forced's threshold


def check_agreement(torch, model, label, prompts, ref, outs):
    """Tokens of a feature's run against the engine's without it: bf16
    rounds the masked window path and the decode kernel differently, so
    after a near-tie the two continue from different contexts. Both the
    share of positions equal to the reference run and the teacher-forced
    share of the feature's tokens must reach the threshold of
    phase_teacher_forced; the first divergent positions are printed."""
    first, equal = divergence(prompts, ref, outs)
    tf = teacher_forced_share(torch, model, prompts, outs)
    tf_ref = teacher_forced_share(torch, model, prompts, ref)
    log(f"{label}: first divergence from the reference run per request "
        f"{first}, {equal:.3f} of positions equal; teacher-forced "
        f"agreement {tf:.3f} (reference run {tf_ref:.3f})")
    check(equal >= TEACHER_FORCED_MIN,
          f"{label}: tokens equal the engine's without the feature at only "
          f"{equal:.3f} of positions")
    check(tf >= TEACHER_FORCED_MIN,
          f"{label}: tokens agree with the cache-free forward at only "
          f"{tf:.3f} of positions")
    return {"first_divergence": first, "equal_share": equal,
            "teacher_forced": tf, "teacher_forced_reference": tf_ref}


def release(torch):
    """Return the memory of the engines the caller dropped to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_spec(torch, model, ServingEngine, RequestState, attn, capture,
               seed, k=4):
    """spec_k=4 at llama_7b width. The n-gram drafter on 8 requests whose
    prompts repeat a random 64-token segment to 256-768 tokens (so the
    drafter finds continuations), 64-128 new tokens each, against the
    non-speculative captured engine on the same prompts; then the model
    drafter with the target as its own draft on 4 requests of 126 new
    tokens (125 after the prefill's first: 25 full windows of k + 1)."""
    vocab = model.config.vocab_size
    n_layers = model.config.num_hidden_layers
    rng = np.random.default_rng(seed + 2)
    prompts, max_new = [], []
    for _ in range(8):
        seg = rng.integers(0, vocab, 64)
        n = int(rng.integers(256, 769))
        prompts.append(np.tile(seg, -(-n // 64))[:n])
        max_new.append(int(rng.integers(64, 129)))
    base = ServingEngine(model, max_batch=8, max_seq_len=2048)
    ref, ref_ms, _, ref_wall = run_engine(torch, base, prompts, max_new,
                                          RequestState)
    ref_tps = base.info()["tokens_generated"] / ref_wall
    base = None
    release(torch)

    eng = ServingEngine(model, max_batch=8, max_seq_len=2048, spec_k=k)
    attn.launches = 0
    outs, verify_ms, _, wall = run_engine(torch, eng, prompts, max_new,
                                          RequestState)
    info = eng.info()
    want = (info["decode_steps"] - info["spec"]["verify_steps"]) * n_layers
    check(attn.launches == want,
          f"n-gram spec run: decode kernel launched {attn.launches} times, "
          f"want (decode steps - verify steps) x layers = {want}")
    agree = check_agreement(torch, model, "spec n-gram", prompts, ref, outs)
    ngram = {
        "requests": len(prompts), "k": k,
        "acceptance_rate": info["spec"]["acceptance_rate"],
        "tokens_per_verify": info["spec"]["tokens_per_verify"],
        "tokens_per_verify_hist": info["spec"]["tokens_per_verify_hist"],
        "verify_steps": info["spec"]["verify_steps"],
        "verify_step_ms_p50": float(np.percentile(verify_ms, 50)),
        "decode_step_ms_p50_nonspec": float(np.percentile(ref_ms, 50)),
        "tokens_per_s": info["tokens_generated"] / wall,
        "tokens_per_s_nonspec": ref_tps, "kernel_launches": attn.launches,
        **agree}
    eng = None
    release(torch)

    m_prompts, m_new = prompts[:4], [126] * 4
    base = ServingEngine(model, max_batch=8, max_seq_len=2048)
    ref4, ref4_ms, _, ref4_wall = run_engine(torch, base, m_prompts, m_new,
                                             RequestState)
    ref4_tps = base.info()["tokens_generated"] / ref4_wall
    base = None
    release(torch)
    eng = ServingEngine(model, max_batch=8, max_seq_len=2048, spec_k=k,
                        drafter="model", draft_model=model)
    attn.launches = 0
    outs4, verify4_ms, _, wall4 = run_engine(torch, eng, m_prompts, m_new,
                                             RequestState)
    info = eng.info()
    joins = info["prefills"]
    draft_steps = info["spec"]["drafter"]["draft_calls"] - joins
    want = (info["decode_steps"] - info["spec"]["verify_steps"]
            + draft_steps) * n_layers
    check(attn.launches == want,
          f"model-drafter run: decode kernel launched {attn.launches} times,"
          f" want (decode steps - verify steps + draft steps) x layers = "
          f"{want}")
    tpv = info["spec"]["tokens_per_verify"]
    model_drafter = {
        "requests": len(m_prompts), "k": k,
        "acceptance_rate": info["spec"]["acceptance_rate"],
        "tokens_per_verify": tpv,
        "tokens_per_verify_hist": info["spec"]["tokens_per_verify_hist"],
        "verify_steps": info["spec"]["verify_steps"],
        "draft_steps": draft_steps,
        "step_ms_p50": float(np.percentile(verify4_ms, 50)),
        "decode_step_ms_p50_nonspec": float(np.percentile(ref4_ms, 50)),
        "tokens_per_s": info["tokens_generated"] / wall4,
        "tokens_per_s_nonspec": ref4_tps, "kernel_launches": attn.launches}
    log("spec: " + json.dumps({"ngram": ngram, "model": model_drafter}))
    model_drafter.update(check_agreement(torch, model, "spec model drafter",
                                         m_prompts, ref4, outs4))
    check(tpv >= 0.8 * (k + 1),
          f"model drafter with the target as its own draft: {tpv:.3f} "
          f"tokens per verify, want >= 0.8 x (k + 1) = {0.8 * (k + 1)}")
    eng = None
    release(torch)
    check_no_bailouts(capture, "spec")
    return {"ngram": ngram, "model": model_drafter}


def phase_prefix(torch, model, ServingEngine, RequestState, capture, seed):
    """prefix_sharing=True at llama_7b width: 8 requests over one
    1024-token prefix with distinct 16-64-token tails, 32 new tokens each,
    submitted together (the first prefills whole and commits; the others
    find its 64 pages at join), against an engine without sharing. Each
    engine serves a warm-up round over another prefix first, so the timed
    round replays graphs (the first use of a window scratch records its
    graph) and the tree holds the warm-up's pages beside the new ones."""
    vocab = model.config.vocab_size
    rng = np.random.default_rng(seed + 3)

    def prompts():
        common = rng.integers(0, vocab, 1024)
        return [np.concatenate([common, rng.integers(
            0, vocab, int(rng.integers(16, 65)))]) for _ in range(8)]

    warm, timed, max_new = prompts(), prompts(), [32] * 8
    base = ServingEngine(model, max_batch=8, max_seq_len=2048)
    run_engine(torch, base, warm, max_new, RequestState)
    ref, _, ref_ttft, ref_wall = run_engine(torch, base, timed, max_new,
                                            RequestState)
    base = None
    release(torch)
    eng = ServingEngine(model, max_batch=8, max_seq_len=2048,
                        prefix_sharing=True)
    run_engine(torch, eng, warm, max_new, RequestState)
    before = eng.info()
    lowered = capture.capture_info()["lowerings"]
    outs, _, ttft, wall = run_engine(torch, eng, timed, max_new,
                                     RequestState)
    lowered = capture.capture_info()["lowerings"] - lowered
    info = eng.info()
    joins = info["shared_prefix_joins"] - before["shared_prefix_joins"]
    saved = info["prefill_pages_saved"] - before["prefill_pages_saved"]
    page = eng.pool.page_size
    check(joins >= 7, f"prefix: {joins} shared joins, want >= 7")
    check(saved >= 7 * 1024 // page,
          f"prefix: {saved} pages saved, want >= {7 * 1024 // page}")
    agree = check_agreement(torch, model, "prefix sharing", timed, ref,
                            outs)
    out = {"requests": len(timed), "prefix_tokens": 1024, "page": page,
           "shared_prefix_joins": joins, "prefill_pages_saved": saved,
           "prefill_chunks": info["prefill_chunks"]
           - before["prefill_chunks"],
           "ttft_ms_p50_sharers": float(np.percentile(ttft[1:], 50)),
           "ttft_ms_donor": ttft[0],
           "ttft_ms_p50_no_sharing": float(np.percentile(ref_ttft, 50)),
           "wall_s": wall, "wall_s_no_sharing": ref_wall,
           "graphs_recorded_in_timed_round": lowered,
           "tree": info["prefix"], **agree}
    eng = None
    release(torch)
    check_no_bailouts(capture, "prefix")
    log("prefix: " + json.dumps(out))
    return out


def phase_chunked(torch, model, ServingEngine, RequestState, capture, seed,
                  chunk=256, long_len=1900):
    """prefill_chunk=256 at llama_7b width: 7 requests decode, then one
    1900-token prompt joins. The long prompt prefills in ceil(1900/256)
    windows, one per engine step, each step also decoding the 7; the same
    script on an engine without chunking gives the tokens to compare and
    the longest host gap between decode steps (one 2048-bucket prefill).
    Each engine runs the script once to warm its graphs, then again on
    other prompts, timed."""
    vocab = model.config.vocab_size
    rng = np.random.default_rng(seed + 4)

    def prompts():
        return ([rng.integers(0, vocab, int(rng.integers(64, 257)))
                 for _ in range(7)], rng.integers(0, vocab, long_len))

    rounds = [prompts(), prompts()]

    def script(eng, short, long_p):
        before = eng.info()
        reqs = [eng.submit(p, max_new_tokens=96) for p in short]
        for _ in range(3):
            eng.step()
        big = eng.submit(long_p, max_new_tokens=64)
        events, gaps = [], []
        while not big.done and big.state is not RequestState.DECODING:
            b = eng.info()
            t0 = time.perf_counter()
            eng.step()
            gaps.append((time.perf_counter() - t0) * 1e3)
            a = eng.info()
            events += ["chunk"] * (a["prefill_chunks"] - b["prefill_chunks"])
            events += ["decode"] * (a["decode_steps"] - b["decode_steps"])
        eng.run()
        torch.cuda.synchronize()
        for r in reqs + [big]:
            check(r.state is RequestState.FINISHED,
                  f"chunked phase: request {r.rid} ended {r.state.name}")
        chunks = eng.info()["prefill_chunks"] - before["prefill_chunks"]
        return [r.result() for r in reqs + [big]], events, gaps, chunks

    base = ServingEngine(model, max_batch=8, max_seq_len=2048)
    script(base, *rounds[0])
    ref, _, ref_gaps, _ = script(base, *rounds[1])
    base = None
    release(torch)
    eng = ServingEngine(model, max_batch=8, max_seq_len=2048,
                        prefill_chunk=chunk)
    script(eng, *rounds[0])
    lowered = capture.capture_info()["lowerings"]
    outs, events, gaps, chunks = script(eng, *rounds[1])
    lowered = capture.capture_info()["lowerings"] - lowered
    want_chunks = -(-long_len // chunk)
    check(chunks == want_chunks,
          f"chunked: {chunks} chunks, want {want_chunks}")
    chunk_at = [i for i, e in enumerate(events) if e == "chunk"]
    check(all("decode" in events[a:b]
              for a, b in zip(chunk_at, chunk_at[1:])),
          f"chunked: two chunks with no decode step between them: {events}")
    short, long_p = rounds[1]
    agree = check_agreement(torch, model, "chunked prefill", short + [long_p],
                            ref, outs)
    out = {"chunk": chunk, "long_prompt": long_len, "prefill_chunks": chunks,
           "decode_steps_during_prefill": events.count("decode"),
           "longest_step_gap_ms_chunked": max(gaps),
           "longest_step_gap_ms_bucketed": max(ref_gaps),
           "graphs_recorded_in_timed_round": lowered, **agree}
    eng = None
    release(torch)
    check_no_bailouts(capture, "chunked")
    log("chunked: " + json.dumps(out))
    return out


def phase_gateway(torch, model, ServingEngine, capture, seed):
    """A ServingGateway on 127.0.0.1:0 over a captured engine: 8
    GatewayClient.generate calls from 4 threads must give the in-process
    engine's tokens; HEALTH says ready, METRICS carries the serving and
    capture series, drain and stop leave no thread."""
    import threading
    from paddle_tpu_torch.inference.serving.gateway import (GatewayClient,
                                                            ServingGateway)
    vocab = model.config.vocab_size
    rng = np.random.default_rng(seed + 5)
    prompts = [rng.integers(0, vocab, int(rng.integers(32, 513)))
               for _ in range(8)]
    base = ServingEngine(model, max_batch=8, max_seq_len=2048)
    ref = base.generate(prompts, max_new_tokens=32)
    base = None
    release(torch)
    eng = ServingEngine(model, max_batch=8, max_seq_len=2048)
    gw = ServingGateway(eng)
    got, errs = {}, []

    def client(ids):
        try:
            cli = GatewayClient("127.0.0.1", gw.port)
            for i in ids:
                got[i] = cli.generate(prompts[i], max_new_tokens=32,
                                      timeout=300.0)
            cli.close()
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=((2 * j, 2 * j + 1),))
               for j in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    wall = time.perf_counter() - t0
    try:
        check(not errs and len(got) == 8, f"gateway clients failed: {errs}")
        mism = [i for i in range(8) if not np.array_equal(got[i], ref[i])]
        check(not mism, f"gateway tokens differ from the in-process "
                        f"engine's for requests {mism}")
        cli = GatewayClient("127.0.0.1", gw.port)
        health = cli.health()
        text = cli.metrics()
        cli.close()
        check(health["ready"] and not health["draining"],
              f"gateway HEALTH: {health}")
        for series in ("pt_serving_tokens_generated", "pt_step_capture_hits",
                       "pt_gateway_requests"):
            check(series in text, f"METRICS lacks {series}")
    finally:
        drained = gw.stop(drain=True, timeout=60.0)
    left = gw.threads()
    check(drained and not left, f"gateway stop: drained={drained}, threads "
                                f"left {left}")
    out = {"requests": 8, "clients": 4, "wall_s": wall, "health": health,
           "metrics_lines": len(text.splitlines()),
           "status_counts": gw.info()["status_counts"]}
    eng = gw = None
    release(torch)
    check_no_bailouts(capture, "gateway")
    log("gateway: " + json.dumps(out))
    return out


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
                fa, fce, mt, fused):
    """The training main path at llama_7b width, cut to TRAIN_LAYERS, with
    the fused loss (K5-K7) on or off; the update is one U2 launch a step
    (no clip, as bench.py trains: no U1)."""
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
               fce.fused_ce_bwd_dh, fce.fused_ce_bwd_dw,
               mt.multi_tensor_sumsq_finite, mt.multi_tensor_adam)
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
            TRAIN_STEPS * TRAIN_LAYERS] + [TRAIN_STEPS * int(fused)] * 3 \
        + [0, TRAIN_STEPS]
    check(launches == want,
          f"kernels launched {launches} times (K2, K3, K4, K5, K6, K7, U1, "
          f"U2) in {TRAIN_STEPS} train steps with fused_loss={fused}, want "
          f"{want}")
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
             "fused_ce_bwd_dh", "fused_ce_bwd_dw", "multi_tensor_sumsq",
             "multi_tensor_adam"),
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
            "multi_tensor_adam": share("adam_kernel"),
            "gemm": share("gemm", "Gemm", "cutlass", "sm90_xmma", "nvjet"),
        } if rows else None,
        "top_kernels": [{"name": r[0][:90], "ms": r[1], "calls": r[2]}
                        for r in rows[:15]],
    }
    log(f"trained {TRAIN_WARMUP}+{TRAIN_STEPS} steps, fused_loss={fused}: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, step p50 {p50:.1f} ms, "
        f"launches {launches} (= steps x [2L, L, L, f, f, f, 0, 1], f = "
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


# Fused CE cases: (name, N, H, V, vocab_offset, kind). Ragged N, H and V
# (element loads), V not a multiple of 8 (the mma.sync kernels), the 16-byte
# path with a vocab offset (a third of the labels outside the shard); kind
# "last": labels all in the last 128-column vocab tile, "neg": every logit
# negative (h >= 0, W <= 0), so a padded column taken as s = 0 would win
# the max; "any": neither.
FCE_CASES = [
    ("n13_h50_v777", 13, 50, 777, 0, "any"),
    ("n200_h136_v1030", 200, 136, 1030, 0, "any"),
    ("n300_h256_v4096_off1000", 300, 256, 4096, 1000, "any"),
    ("n130_h512_v2000_lasttile", 130, 512, 2000, 0, "last"),
    # bf16/fp16 with H and V multiples of 8 run the Hopper K5-K7: N, H and V
    # off their tiles, many vocab tiles, an 8-column last vocab tile (256
    # wide in K5, a 512-column slice in K6) with labels in it, two 512-row
    # slices with a vocab offset, one row, a row past 32 row blocks, H off
    # the 64-deep chunk, all logits negative with a ragged last tile.
    ("n200_h520_v1032", 200, 520, 1032, 0, "any"),
    ("n256_h4096_v32000", 256, 4096, 32000, 0, "any"),
    ("n333_h136_v2056_lasttile", 333, 136, 2056, 0, "last"),
    ("n1000_h128_v1024_off300", 1000, 128, 1024, 300, "any"),
    ("n1_h256_v2048", 1, 256, 2048, 0, "any"),
    ("n4097_h256_v1032", 4097, 256, 1032, 0, "any"),
    ("n77_h4104_v1000", 77, 4104, 1000, 0, "any"),
    ("n300_h512_v2056_neg", 300, 512, 2056, 0, "neg"),
]
# m, lse and loss per row: atol 1e-4 / rtol 1e-5 (fp32 sums of the same
# products in another order). dh row by row and dW column by column under
# FLASH_TOL's rule with two steps: both round the same dl to the dtype, from
# fp32 logits summed in another order, and round an fp32 sum once; K6 and
# K7 add their products with fp32 reductions, in an order that changes
# between runs.


def fce_inputs(torch, N, H, V, offset, kind, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    h = torch.randn(N, H, generator=g, device=DEVICE)
    w = 0.05 * torch.randn(H, V, generator=g, device=DEVICE)
    if kind == "neg":            # every logit negative
        h, w = h.abs(), -w.abs()
    h, w = h.to(dtype), w.to(dtype)
    top = V + offset + (V // 2 if offset else 0)
    labels = torch.randint(0, top, (N,), generator=g, device=DEVICE)
    if kind == "last":           # the last vocab tile of 128 columns
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
        for name, N, H, V, offset, kind in FCE_CASES:
            h, w, labels, gr = fce_inputs(torch, N, H, V, offset, kind, dt,
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
    unfused head (forward; autograd backward for K6 + K7 together), the bare
    product h W that all three contain (cuBLAS, ``gemm_ms``) and its
    bound."""
    import torch.nn.functional as tF
    h, w, labels, gr = fce_inputs(torch, N, H, V, 0, "any", torch.bfloat16,
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
    gemm = cuda_ms(torch.matmul, [(h, w)])
    for kind in ("fwd", "dh", "dw"):
        res[kind]["gemm_ms"] = gemm
        bound, by = fce_bound(N, H, V, h.element_size(), kind)
        res[kind].update(bound_ms=bound, bound_by=by)
    del out, leaves
    return res


# U1 and U2 size classes (tests/test_torch_cuda.py's MT_SIZES): one
# element; an empty tensor beside one element; odd sizes 1-1031 (no multiple
# of a 16-byte vector); a view 2 or 4 bytes past a 16-byte boundary; the
# 8-layer training model's 75 shapes at 1/64 of each dim; a 20-layer
# model's 183 at 1/64, more than 2 x 80 tensors, so U2 launches 3 times and
# U1 twice.
def model_shapes(layers, hidden=4096, inter=11008, vocab=32000, div=1):
    """LlamaForCausalLM's parameter shapes at llama_7b width (each dim
    divided by div), in named_parameters order: 2 + 9 x layers + 1."""
    h, i, v = hidden // div, inter // div, vocab // div
    layer = [(h,), (h, h), (h, h), (h, h), (h, h), (h,), (h, i), (h, i),
             (i, h)]
    return [(v, h)] + layer * layers + [(h,), (h, v)]


MT_SIZES = {
    "one": [(1,)],
    "empty": [(0,), (1,), (0,)],
    "odd": [(n,) for n in (1, 3, 7, 15, 17, 31, 33, 127, 129, 255, 257,
                           1023, 1031)],
    "misaligned": "misaligned",
    "model_div64": model_shapes(TRAIN_LAYERS, div=64),
    "model20_div64": model_shapes(20, div=64),
}
# U1's per-tensor fp32 sums against float64 sums: each CTA adds up to 2**16
# squares in 4-8 running sums a thread, then in fixed trees, so the relative
# error stays far below 1e-5 for sums of non-negative terms. U2 is held bit
# for bit: every op is an IEEE-rounded intrinsic, rounded to the dtype as
# the plain version's PyTorch ops round it.
U1_RTOL = 1e-5
ADAM_KW = dict(lr=0.01, beta1=0.8, beta2=0.95, epsilon=1e-8,
               weight_decay=0.05)


def mt_lists(torch, sizes, dtype, seed, grad_scale=1.0):
    """(params, grads, exp_avgs, exp_avg_sqs) on the card for a size class."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    if sizes == "misaligned":          # 2 or 4 bytes off the boundary
        out = []
        for scale in (1.0, grad_scale, 0.1, -0.1):
            base = scale * torch.randn(1032, generator=g, device=DEVICE)
            out.append([(base.abs() if scale < 0 else base).to(dtype)[1:]])
        check(all(t[0].data_ptr() % 16 for t in out),
              "the misaligned case is aligned")
        return out

    def make(scale):
        return [(scale * torch.randn(s, generator=g, device=DEVICE)).to(dtype)
                for s in sizes]
    ps, gs, ms, vs = make(1.0), make(grad_scale), make(0.1), make(0.1)
    return ps, gs, ms, [v.abs() for v in vs]


def u1_check(torch, mt, gs, inv, label):
    """U1 against float64 sums and its total against the list-order fp32
    sum of its own per-tensor sums (bit for bit). Returns (max abs error,
    max relative error) of the per-tensor sums."""
    sumsq, total, finite = mt.multi_tensor_sumsq_finite(gs, inv)
    torch.cuda.synchronize()
    abs_err = rel_err = 0.0
    acc = torch.zeros((), device=DEVICE)
    for x, gr in zip(sumsq, gs):
        want = (gr * inv.to(gr.dtype) if inv is not None else gr).double() \
            .square().sum()
        err = float((x.double() - want).abs())
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / max(float(want), 1e-300))
        acc = acc + x
    check(rel_err <= U1_RTOL, f"U1 sums disagree with float64 in case "
                              f"{label}: rel err {rel_err}")
    check(torch.equal(total, acc), f"U1 total is not the list-order sum of "
                                   f"its per-tensor sums in case {label}")
    check(int(finite) == 1, f"U1 found a non-finite grad in case {label}")
    return abs_err, rel_err


def u2_check(torch, mt, ps, gs, ms, vs, inv, clip, label, steps=(1, 2, 3)):
    """U2 against its plain version on clones, Adam and AdamW, bit for bit.
    Returns the largest abs difference (0.0 when equal)."""
    err = 0.0
    for decoupled in (False, True):
        ref = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
        for step in steps:
            mt.multi_tensor_adam(ps, gs, ms, vs, decoupled=decoupled,
                                 step=step, inv_scale=inv, clip_scale=clip,
                                 **ADAM_KW)
            mt.multi_tensor_adam_ref(ref[0], gs, ref[1], ref[2],
                                     decoupled=decoupled, step=step,
                                     inv_scale=inv, clip_scale=clip,
                                     **ADAM_KW)
        torch.cuda.synchronize()
        for got, want in zip(ps + ms + vs, ref[0] + ref[1] + ref[2]):
            if got.numel():
                err = max(err, float((got.float() - want.float()).abs()
                                     .max()))
            check(torch.equal(got, want), f"U2 disagrees with its plain "
                  f"version in case {label}, decoupled={decoupled}")
        del ref
    return err


def phase_multi_tensor_cases(torch, mt, clip_cls):
    """U1 and U2 against their plain versions on the card: every size
    class in fp32, bf16 and fp16, with and without inv_scale and
    clip_scale; then a finite flag of 0 (a nan, +inf or -inf in any grad)
    leaves every byte of p, m and v; then U1 + U2 captured in one CUDA
    graph: a replay gives the eager launches' bits."""
    out = {}
    for sizes, shapes in MT_SIZES.items():
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            for scaled in (False, True):
                label = f"{sizes}_{str(dt).replace('torch.', '')}" \
                    + ("_scaled" if scaled else "")
                ps, gs, ms, vs = mt_lists(torch, shapes, dt, 5,
                                          8.0 if scaled else 1.0)
                inv = torch.tensor(0.125, device=DEVICE) if scaled else None
                clip = torch.tensor(0.43, device=DEVICE) if scaled else None
                abs_err, rel_err = u1_check(torch, mt, gs, inv, label)
                err = u2_check(torch, mt, ps, gs, ms, vs, inv, clip, label)
                out[label] = {"u1_rel_err": rel_err, "u2_max_abs_err": err}
    log(f"multi-tensor kernels-vs-plain: {len(out)} cases (size classes "
        f"{', '.join(MT_SIZES)} x fp32/bf16/fp16 x scaled or not): U2 bit "
        f"for bit, U1 worst rel err "
        f"{max(v['u1_rel_err'] for v in out.values()):.3g} (rtol {U1_RTOL})")

    for dt in (torch.float32, torch.bfloat16, torch.float16):
        ps, gs, ms, vs = mt_lists(torch, MT_SIZES["model_div64"], dt, 6)
        before = [t.clone() for t in ps + ms + vs]
        for i, bad in ((0, float("nan")), (len(gs) // 2, float("inf")),
                       (len(gs) - 1, float("-inf"))):
            poisoned = [x.clone() for x in gs]
            poisoned[i].view(-1)[7] = bad
            _, total, finite = mt.multi_tensor_sumsq_finite(
                poisoned, torch.tensor(0.5, device=DEVICE))
            check(int(finite) == 0, f"U1 missed a {bad} in grad {i}, {dt}")
            mt.multi_tensor_adam(ps, poisoned, ms, vs, decoupled=True,
                                 step=1, clip_scale=torch.sqrt(total),
                                 finite=finite, **ADAM_KW)
        torch.cuda.synchronize()
        check(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                  for a, b in zip(before, ps + ms + vs)),
              f"U2 wrote under a finite flag of 0 ({dt})")
    log("multi-tensor finite flag: a nan, +inf or -inf in any of 75 grads "
        "found by U1; U2 under the flag left every byte of p, m, v (fp32, "
        "bf16, fp16)")

    clip = clip_cls(1.0)
    inv = torch.tensor(2.0 ** -4, device=DEVICE)

    def step(ps, gs, ms, vs):
        _, total, finite = mt.multi_tensor_sumsq_finite(gs, inv)
        mt.multi_tensor_adam(ps, gs, ms, vs, decoupled=True, step=3,
                             inv_scale=inv,
                             clip_scale=clip.scale_from_sumsq(total),
                             finite=finite, **ADAM_KW)

    eager = mt_lists(torch, MT_SIZES["model_div64"], torch.float32, 7, 16.0)
    graphed = [[t.clone() for t in ts] for ts in eager]
    warm = [[t.clone() for t in ts] for ts in eager]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(*warm)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(*graphed)
    for ts, es in zip(graphed, eager):
        for t, e in zip(ts, es):
            t.copy_(e)
    graph.replay()
    step(*eager)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(sum(graphed, []),
                                                 sum(eager, []))),
          "U1 + U2 replayed from a CUDA graph differ from the eager launches")
    del graph
    log("multi-tensor CUDA graph: U1 + clip scale + U2 captured once, the "
        "replay bit for bit the eager launches")
    return out


# compile_train_step at llama_7b width cut to 2 layers (fp32 masters,
# grads, moments and fp32 compute for 6.7e8 params fit beside nothing else;
# 2 layers keep the phase to seconds).
TRAINSTEP_LAYERS, TRAINSTEP_BATCH, TRAINSTEP_SEQ = 2, 2, 1024


def phase_trainstep(torch, args, LlamaConfig, LlamaForCausalLM, mt,
                    compile_train_step, GradScaler, ClipGradByGlobalNorm,
                    AdamW, capture, capture_on=True):
    """The general train step's path: compile_train_step, fp32, with a
    GradScaler (2**15, growth every 2 good steps) and a global-norm clip;
    3 steps, one whose loss is multiplied by inf through a batch field,
    then 2 more. The bad step is skipped (params and moments bit for bit,
    by checksum), the scale halves there and doubles after 2 good steps,
    the loss stays finite and falls; U1 and U2 launch once a step. With
    ``capture_on`` the step is one CUDA graph (``jit.capture.lower_step``):
    no bailout, the first call the warm-up and five replays; without it
    (``PT_STEP_CAPTURE=0``'s switch) every step eager."""
    base = LlamaConfig.llama_7b()
    cfg = LlamaConfig(vocab_size=base.vocab_size,
                      hidden_size=base.hidden_size,
                      intermediate_size=base.intermediate_size,
                      num_hidden_layers=TRAINSTEP_LAYERS,
                      num_attention_heads=base.num_attention_heads,
                      max_position_embeddings=TRAINSTEP_SEQ)
    model = LlamaForCausalLM(cfg, device=DEVICE, dtype=torch.float32,
                             seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    scaler = GradScaler(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2)

    def loss_fn(m, b):
        return m.compute_loss(b["input_ids"], b["labels"]) * b["loss_mul"]

    step = compile_train_step(model, loss_fn, opt, scaler=scaler)
    rng = np.random.RandomState(args.seed + 2)
    ids = rng.randint(0, cfg.vocab_size, (TRAINSTEP_BATCH, TRAINSTEP_SEQ + 1))
    good = {"input_ids": torch.from_numpy(ids[:, :-1]).to(DEVICE),
            "labels": torch.from_numpy(ids[:, 1:]).to(DEVICE),
            "loss_mul": torch.ones((), device=DEVICE)}
    bad = dict(good, loss_mul=torch.full((), float("inf"), device=DEVICE))

    def checksum():
        ts = [p.detach() for p in model.parameters()] + [
            t for st in step._opt_state for t in st.values()]
        return torch.stack([t.view(torch.int32).sum(dtype=torch.int64)
                            for t in ts]).tolist()

    log(f"trainstep model: {TRAINSTEP_LAYERS} of llama_7b's 32 layers at "
        f"its width (depth cut to fit beside nothing and run in seconds), "
        f"{n_params / 1e9:.3f}B fp32 params, batch {TRAINSTEP_BATCH} x seq "
        f"{TRAINSTEP_SEQ}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.multi_tensor_sumsq_finite.launches = 0   # this path's run starts here
    mt.multi_tensor_adam.launches = 0
    capture.set_step_capture_enabled(capture_on)
    capture.capture_clear()
    losses, scales, step_ms = [], [], []
    for i, b in enumerate([good] * 3 + [bad] + [good] * 2):
        if i == 3:
            before = checksum()
        t0 = time.perf_counter()
        loss = float(step(b))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        scales.append(step.loss_scale)
        if i == 3:
            after = checksum()
    capture.set_step_capture_enabled(True)
    cinfo = {k: v for k, v in capture.capture_info().items()
             if k != "enabled"}
    if capture_on:
        check(cinfo["bailouts"] == 0 and cinfo["lowerings"] == 1
              and cinfo["hits"] == 5 and step.captured_program is not None,
              f"TrainStep not captured: {cinfo}")
    else:
        check(cinfo["lowerings"] == cinfo["hits"] == 0
              and step.captured_program is None,
              f"TrainStep captured with capture off: {cinfo}")
    launches = [mt.multi_tensor_sumsq_finite.launches,
                mt.multi_tensor_adam.launches]
    peak = torch.cuda.max_memory_allocated() / 2**30
    good_losses = losses[:3] + losses[4:]
    check(launches == [6, 6], f"U1/U2 launched {launches} times in 6 "
                              f"TrainStep steps, want [6, 6]")
    check(step.skipped_steps == 1, f"{step.skipped_steps} skipped steps, "
                                   f"want 1")
    check(before == after, "a parameter or moment changed across the "
                           "skipped step")
    check(not np.isfinite(losses[3]), f"the bad step's loss {losses[3]}")
    check(all(np.isfinite(good_losses)) and good_losses[-1] < good_losses[0],
          f"TrainStep losses not finite and falling: {losses}")
    check(scales[3] == scales[2] / 2 and scales[5] == 2 * scales[4]
          and scales == [2.0 ** 15, 2.0 ** 16, 2.0 ** 16, 2.0 ** 15,
                         2.0 ** 15, 2.0 ** 16],
          f"loss scales {scales}: want halved on the bad step, doubled "
          f"after 2 good steps")
    scaler_after = step.sync_scaler()._scale
    res = {"layers": TRAINSTEP_LAYERS, "hidden": cfg.hidden_size,
           "params": n_params, "batch": TRAINSTEP_BATCH,
           "seq": TRAINSTEP_SEQ, "losses": losses, "loss_scales": scales,
           "scaler_scale_after_sync": scaler_after,
           "skipped_steps": step.skipped_steps,
           "params_and_moments_unchanged_across_skip": before == after,
           "launches": {"multi_tensor_sumsq": launches[0],
                        "multi_tensor_adam": launches[1]},
           "step_ms": step_ms, "peak_mem_gib": peak, "capture": cinfo,
           "kernels_in_graph": None if step.captured_program is None
           else step.captured_program.kernel_launches()}
    log(f"trainstep ({'captured' if capture_on else 'eager'}): 6 steps, "
        f"losses {[round(x, 4) for x in losses]}, scales {scales}, skipped "
        f"{step.skipped_steps}, U1/U2 launches {launches}, capture {cinfo}")
    del model, opt, step
    return res


def phase_multi_tensor_timing(torch, mt, shapes):
    """U1 and U2 over the 8-layer training model's fp32 tensors (its 75
    shapes, 1.881e9 elements): each held against its plain version there
    (U1's sums against float64, U2 bit for bit on clones), then timed from
    CUDA-graph replays beside its plain version, one PyTorch call with the
    same math and other rounding (U1: ``torch._foreach_norm``; U2:
    ``torch.optim.AdamW(fused=True, capturable=True).step()``) and the
    least time the card could take."""
    g = torch.Generator(device=DEVICE).manual_seed(11)

    def make(scale):
        return [scale * torch.randn(s, generator=g, device=DEVICE)
                for s in shapes]
    ps, gs, ms, vs = make(0.02), make(1e-3), make(1e-4), make(1e-3)
    for v in vs:
        v.square_()
    n = sum(p.numel() for p in ps)
    u1_abs, u1_rel = u1_check(torch, mt, gs, None, "training_model_fp32")
    u2_err = u2_check(torch, mt, ps, gs, ms, vs, None, None,
                      "training_model_fp32", steps=(5,))
    log(f"multi-tensor kernels at the training model's {len(shapes)} fp32 "
        f"tensors ({n / 1e9:.3f}e9 elements): U1 rel err {u1_rel:.3g}, U2 "
        f"bit for bit")
    adam = dict(decoupled=True, step=5, lr=1e-4, beta1=0.9, beta2=0.999,
                epsilon=1e-8, weight_decay=0.01)
    res = {"u1": {"ms": cuda_ms(mt.multi_tensor_sumsq_finite, [(gs,)]),
                  "plain_ms": cuda_ms(mt.multi_tensor_sumsq_finite_ref,
                                      [(gs,)]),
                  "library_ms": cuda_ms(torch._foreach_norm, [(gs,)]),
                  "max_abs_err": u1_abs, "max_rel_err": u1_rel},
           "u2": {"ms": cuda_ms(lambda: mt.multi_tensor_adam(
                      ps, gs, ms, vs, **adam), [()]),
                  "plain_ms": cuda_ms(lambda: mt.multi_tensor_adam_ref(
                      ps, gs, ms, vs, **adam), [()]),
                  "max_abs_err": u2_err}}
    for p, gr in zip(ps, gs):
        p.grad = gr
    lib = torch.optim.AdamW(ps, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01, fused=True, capturable=True)
    res["u2"]["library_ms"] = cuda_ms(lib.step, [()])
    del lib
    for p in ps:
        p.grad = None
    esize = 4
    flops = {"u1": 2.0 * n, "u2": 16.0 * n}
    nbytes = {"u1": n * esize + 4 * len(shapes) + 8,
              "u2": 7 * n * esize}
    for k in ("u1", "u2"):
        t_bytes = nbytes[k] / HBM_BYTES_PER_S * 1e3
        t_ops = flops[k] / PEAK_FLOPS["float32"] * 1e3
        res[k].update(bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations",
                      elements=n, tensors=len(shapes))
    return res


# ---------------------------------------------------------------------------
# phase_mesh: multi-GPU training, part 1, on ranks that share the card
# ---------------------------------------------------------------------------

MESH_LAYERS, MESH_SEQ, MESH_BATCH = 4, 2048, 2
MESH_WARMUP, MESH_STEPS = 2, 5
SEP_SEQ, SEP_WARMUP, SEP_STEPS = 4096, 1, 1
QUANT_LAYERS, QUANT_SEQ, QUANT_STEPS = 2, 1024, 3
TP_N, TP_H, TP_V = 4096, 4096, 32000
EAGER_LAYERS, EAGER_BATCH, EAGER_SEQ = 2, 2, 2048
EAGER_WARMUP, EAGER_STEPS = 2, 5
# the step with flash attention against the same step with sdpa_ref under
# the same O1 bf16 casts: the loss, and each grad's relative L2 error (bf16
# attention rounds its probabilities and outputs, 2**-8 each, and the two
# sum in different orders)
EAGER_LOSS_RTOL = 1e-2
EAGER_GRAD_RTOL = 5e-2


def phase_eager_sweep(torch, P):
    """Every case of the op table (tests/torch_op_cases.py: one per public
    name of the JAX op modules, and the Tensor method where the op is one)
    on card tensors against the same port op on CPU tensors; every output
    on the card."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_op_cases import CASES, SWEEP_TOL, sweep_case
    t0 = time.perf_counter()
    n = 0
    for name in sorted(CASES):
        try:
            n += sweep_case(P, name, DEVICE)
        except Exception as e:  # noqa: BLE001 — name the op, then fail
            raise SmokeFailure(f"op sweep: {name} on the card: "
                               f"{type(e).__name__}: {e}") from e
    # the Tensor's own methods (not from the op tables) on the card
    x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                    place=DEVICE, stop_gradient=False)
    seen = []
    x.register_hook(lambda g: seen.append(g.place) or g)
    h = x * 2.0
    h.retain_grads()
    P.sum(h * h).backward()
    check(x.grad.place.startswith(DEVICE) and isinstance(x.grad, P.Tensor)
          and seen and seen[0].startswith(DEVICE),
          f"grad of a card tensor: {x.grad.place}, hooks saw {seen}")
    check(np.allclose(x.gradient(), 8 * np.arange(6).reshape(2, 3))
          and np.allclose(h.grad.numpy(), 4 * np.arange(6).reshape(2, 3)),
          "Tensor.gradient / retain_grads on the card")
    d = x.detach()
    d.set_value(np.ones((2, 3)))
    d.copy_(P.to_tensor(np.full((2, 3), 2.0, np.float32), place=DEVICE))
    check(d.place.startswith(DEVICE) and float(d.sum().item()) == 12.0
          and x.astype("bfloat16").place.startswith(DEVICE)
          and d.astype("int32").numpy().dtype == np.int32,
          "detach / set_value / copy_ / astype / numpy on the card")
    x.clear_grad()
    x.detach_()
    check(x.grad is None and x.stop_gradient, "clear_grad / detach_")
    n += len(("register_hook", "retain_grads", "backward", "gradient",
              "detach", "set_value", "copy_", "astype", "numpy",
              "clear_grad", "detach_"))
    log(f"eager op sweep: {n} op and method calls on the card held against "
        f"the CPU (float32 rtol {SWEEP_TOL[0]}, atol {SWEEP_TOL[1]}; "
        f"factors by reconstruction) in {time.perf_counter() - t0:.1f}s")
    return {"ops_checked": n, "cases": len(CASES),
            "seconds": time.perf_counter() - t0}


def eager_config(LlamaConfig):
    base = LlamaConfig.llama_7b()
    return LlamaConfig(vocab_size=base.vocab_size,
                       hidden_size=base.hidden_size,
                       intermediate_size=base.intermediate_size,
                       num_hidden_layers=EAGER_LAYERS,
                       num_attention_heads=base.num_attention_heads,
                       max_position_embeddings=EAGER_SEQ)


def eager_loss(P, F, model, ids, labels):
    """The dygraph loop's forward and loss: logits, the per-token cross
    entropy, their mean."""
    logits = model.logits(ids)
    return P.mean(F.cross_entropy(logits, labels, reduction="none"))


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30))


def host_us_per_op(torch, P):
    """Host µs a call, a small card tensor, 2000 calls: torch's add on
    plain tensors, torch's add on port Tensors (the subclass), and the op
    library's add on port Tensors (dispatch and promotion too)."""
    a = torch.ones(8, device=DEVICE)
    b = torch.ones(8, device=DEVICE)
    pa, pb = P.Tensor(a), P.Tensor(b)
    out = {}
    for label, fn in (("torch_plain", lambda: torch.add(a, b)),
                      ("torch_subclass", lambda: torch.add(pa, pb)),
                      ("op_library", lambda: P.add(pa, pb))):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        out[label] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    return out


def phase_eager(torch, args, LlamaConfig, LlamaForCausalLM, build, AdamW,
                fa, mt):
    """The Paddle dygraph loop on the eager core at llama_7b width, cut to
    EAGER_LAYERS: inputs from ``to_tensor``, ``auto_cast(level="O1",
    dtype="bfloat16")``, forward, loss, ``loss.backward()``,
    ``AdamW.step()``, ``clear_grad()``. Gates: the op sweep; the step equal
    to the same step with sdpa_ref under the same casts; the operator
    stats' dtypes as ``amp_dtype_for`` rules; launches exact (K2 = K3 = K4
    = layers, U2 once a step); an inf planted in a weight raises naming
    the op with FLAGS_check_nan_inf on, and no scan runs with it off; the
    loss finite and falling."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import dispatch
    out = {"sweep": phase_eager_sweep(torch, P)}
    out["host_us_per_call"] = host_us_per_op(torch, P)
    cfg = eager_config(LlamaConfig)
    model = LlamaForCausalLM(cfg, device=DEVICE, dtype=torch.float32,
                             seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    rng = np.random.RandomState(args.seed + 1)
    tok = rng.randint(0, cfg.vocab_size, (EAGER_BATCH, EAGER_SEQ + 1))
    ids = P.to_tensor(tok[:, :-1])
    labels = P.to_tensor(tok[:, 1:])
    check(ids.place.startswith(DEVICE) and isinstance(ids, P.Tensor)
          and str(ids.dtype) == "torch.int64",
          f"to_tensor put the batch on {ids.place} as {ids.dtype}")

    def amp():
        return P.amp.auto_cast(level="O1", dtype="bfloat16")

    # the step against the same step with the plain attention, same casts
    with amp(), debugging.collect_operator_stats() as st_flash:
        loss_a = eager_loss(P, F, model, ids, labels)
    loss_a.backward()
    grads_a = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.clear_grad()
    flash = F._flash
    F._flash = lambda q, k, v, causal, scale: F.sdpa_ref(
        q, k, v, causal=causal, scale=scale)
    try:
        with amp(), debugging.collect_operator_stats() as st_ref:
            loss_b = eager_loss(P, F, model, ids, labels)
        loss_b.backward()
    finally:
        F._flash = flash
    grad_err = {n: rel_l2(grads_a[n], p.grad)
                for n, p in model.named_parameters()}
    opt.clear_grad()
    del grads_a
    la, lb = float(loss_a.detach()), float(loss_b.detach())
    worst = max(grad_err, key=grad_err.get)
    check(abs(la - lb) <= EAGER_LOSS_RTOL * abs(lb),
          f"eager step: loss {la} with flash, {lb} with sdpa_ref")
    check(grad_err[worst] <= EAGER_GRAD_RTOL,
          f"eager step: grad of {worst} differs from the sdpa_ref step's "
          f"by {grad_err[worst]:.3g} (relative L2)")
    want = {"linear": "bfloat16", "sdpa": "bfloat16", "embedding": "float32",
            "rms_norm": "float32", "cross_entropy": "float32",
            "mean": "float32"}
    for name, dt in want.items():
        check(st_flash.dtypes.get(name) and set(st_flash.dtypes[name])
              == {dt}, f"operator stats: {name} output "
              f"{st_flash.dtypes.get(name)}, want {dt} only")
    for name, dt in (("matmul", "bfloat16"), ("softmax", "float32")):
        check(set(st_ref.dtypes.get(name, ())) == {dt},
              f"operator stats of the sdpa_ref step: {name} output "
              f"{st_ref.dtypes.get(name)}, want {dt} only")
    check(st_flash.stats["sdpa"] == EAGER_LAYERS
          and st_flash.stats["linear"] == 7 * EAGER_LAYERS + 1,
          f"operator counts {st_flash.stats}")

    # FLAGS_check_nan_inf: an inf planted in a weight names its op
    w = model.llama.layers[0].mlp.down_proj.weight
    keep = w.detach()[0, 0].clone()
    with torch.no_grad():
        w[0, 0] = float("inf")
    P.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with amp():
            eager_loss(P, F, model, ids, labels)
        raised = ""
    except FloatingPointError as e:
        raised = str(e)
    finally:
        P.set_flags({"FLAGS_check_nan_inf": False})
        with torch.no_grad():
            w[0, 0] = keep
    check("'linear'" in raised,
          f"inf in down_proj's weight with FLAGS_check_nan_inf: {raised!r}")
    opt.clear_grad()

    scans = []
    scan = dispatch._scan_nan_inf
    dispatch._scan_nan_inf = lambda o, n: scans.append(n) or scan(o, n)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, mt.multi_tensor_adam)
    losses, step_ms, fwd_host_ms = [], [], []
    try:
        for i in range(EAGER_WARMUP + EAGER_STEPS):
            if i == EAGER_WARMUP:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for kern in kernels:
                    kern.launches = 0    # the main path's run starts here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with amp():
                loss = eager_loss(P, F, model, ids, labels)
            t1 = time.perf_counter()
            loss.backward()
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
            if i >= EAGER_WARMUP:
                step_ms.append((time.perf_counter() - t0) * 1e3)
                fwd_host_ms.append((t1 - t0) * 1e3)
            losses.append(float(loss.detach()))
    finally:
        dispatch._scan_nan_inf = scan
    launches = [kern.launches for kern in kernels]
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_l = [EAGER_STEPS * EAGER_LAYERS] * 3 + [EAGER_STEPS]
    check(launches == want_l,
          f"eager loop launched K2, K3, K4, U2 {launches} times in "
          f"{EAGER_STEPS} steps, want {want_l}")
    check(not scans and dispatch._quiet,
          f"with FLAGS_check_nan_inf off the dispatch scanned {len(scans)} "
          f"outputs")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"eager loss not finite or not falling: {losses}")

    # ops a step and host µs per dispatched op (the forward's host time
    # over its ops: the backward is torch's engine, not the dispatch)
    with amp(), debugging.collect_operator_stats() as st:
        torch.cuda.synchronize()
        eager_loss(P, F, model, ids, labels)
    n_ops = sum(st.stats.values())
    opt.clear_grad()
    p50 = float(np.percentile(step_ms, 50))
    fwd_p50 = float(np.percentile(fwd_host_ms, 50))
    out.update({
        "layers": EAGER_LAYERS, "batch": EAGER_BATCH, "seq": EAGER_SEQ,
        "hidden": cfg.hidden_size, "params": n_params,
        "warmup_steps": EAGER_WARMUP, "steps": EAGER_STEPS,
        "losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
        "forward_host_ms_p50": fwd_p50, "ops_per_step": n_ops,
        "op_counts": st.stats, "op_dtypes": st_flash.dtypes,
        "ref_op_dtypes": {k: st_ref.dtypes[k] for k in ("matmul", "softmax")},
        "host_us_per_op": fwd_p50 * 1e3 / n_ops,
        "launches_per_step": dict(zip(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "multi_tensor_adam"), (n // EAGER_STEPS for n in launches))),
        "peak_mem_gib": peak, "ref_loss_flash": la, "ref_loss_sdpa_ref": lb,
        "ref_grad_rel_l2_max": grad_err[worst], "ref_grad_worst": worst,
        "nan_check_error": raised[:160]})
    # the same size through build_hybrid_train_step(amp=True), no remat
    del opt
    hopt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = build(model, hopt, remat=False, amp=True)
    batch = {"input_ids": ids.as_subclass(torch.Tensor),
             "labels": labels.as_subclass(torch.Tensor)}
    hyb_ms = []
    for i in range(EAGER_WARMUP + EAGER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(batch))
        if i >= EAGER_WARMUP:
            hyb_ms.append((time.perf_counter() - t0) * 1e3)
    out["hybrid_step_ms"] = hyb_ms
    out["hybrid_step_ms_p50"] = float(np.percentile(hyb_ms, 50))
    del step, hopt, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"eager O1 loop, {EAGER_LAYERS} layers at llama_7b width, "
        f"B={EAGER_BATCH} S={EAGER_SEQ}: step p50 {p50:.2f} ms "
        f"(build_hybrid_train_step(amp=True) {out['hybrid_step_ms_p50']:.2f}"
        f" ms), {n_ops} ops dispatched a step, "
        f"{out['host_us_per_op']:.1f} host us an op, peak {peak:.2f} GiB, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return out


# ---- the static-graph world and the compile/export tier: to_static over
# the decoder, the LLaMA step as a static Program, and deployment

STATIC_DIR = os.path.join("build", "chip_smoke_static")
STATIC_WARMUP, STATIC_STEPS = 2, 5
# the deployed LLaMA's bf16 logits against the eager model's (relative L2
# over the whole logits): the same kernels replay, and every reading so
# far was bitwise equal; one bf16 rounding more in an op would show
DEPLOY_LOGITS_RTOL = 1e-4
# ResNet-50 fp32 eval through the Predictor against the eager model:
# max |diff| over max |eager| (the same cuDNN convolutions, but the
# exported graph may pick other algorithms or fold BN another way)
DEPLOY_RESNET_RTOL = 1e-3
TINY_ARTIFACT = dict(vocab=128, hidden=64, layers=2, heads=4, inter=128)


def op_host_us(torch, fa):
    """Host µs a call of K2 on one small bf16 input (2000 calls each, the
    card synchronised around them) three ways: through its
    ``torch.library`` operator (the dispatcher: what every caller goes
    through), through its wrapper (the shape checks, then the operator)
    and straight through the operator's ``cuda`` body."""
    g = torch.Generator(device=DEVICE).manual_seed(1)
    q, k, v = ((0.5 * torch.randn(1, 128, 8, 64, generator=g,
                                  device=DEVICE)).to(torch.bfloat16)
               for _ in range(3))
    op = torch.ops.paddle_tpu_torch.flash_attention_fwd
    out = {}
    for label, fn in (("operator", lambda: op(q, k, v, True, None)),
                      ("wrapper", lambda: fa.flash_attention_fwd(
                          q, k, v, True)),
                      ("launcher", lambda: fa._fwd_cuda(q, k, v, True,
                                                        None))):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        out[label] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    fa.flash_attention_fwd.launches -= 3 * 2200   # timing, not the path
    out["dispatcher_us"] = out["operator"] - out["launcher"]
    return out


def trace_call(torch, fn):
    """One call of ``fn`` under torch.profiler: the device's kernel ms,
    the kernel launches and the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.key, dev_us / 1e3, ev.count))
    kernels.sort(key=lambda k: -k[1])
    return {"device_kernel_ms": sum(k[1] for k in kernels) if kernels
            else None, "kernel_launches": sum(k[2] for k in kernels),
            "top_kernels": [{"name": k[0][:90], "ms": k[1], "calls": k[2]}
                            for k in kernels[:6]]}


def _deltas(kernels, before):
    return [k.launches - b for k, b in zip(kernels, before)]


def static_batches(args, vocab):
    """The static phases' two batches of ``[EAGER_BATCH, EAGER_SEQ + 1]``
    tokens; step i takes batch ``i % 2``, so every replay after the first
    is fed another batch than the step before it (a stale feed would show
    in the losses)."""
    rng = np.random.RandomState(args.seed + 1)
    return [rng.randint(0, vocab, (EAGER_BATCH, EAGER_SEQ + 1))
            for _ in range(2)]


def phase_to_static(torch, args, P, fa, mt):
    """``P.jit.to_static(model.llama)`` at llama_7b width cut to
    EAGER_LAYERS, B=EAGER_BATCH, S=EAGER_SEQ, O1 bf16, ``AdamW(1e-4)``,
    the head and the cross entropy eager, against phase_eager's loop on a
    second model with the same weights, the two stepped in turns (2
    warm-up, 5 timed) on the two ``static_batches`` in turn. Gates: step-1 grads and every loss against the
    eager loop's; per to_static step K2 = K3 = K4 = layers and U2 once;
    one forward and one backward graph, 0 bailouts. Then a dy2static
    function with a tensor ``if`` on the card (both signs right, the
    bailout counted with its reason) and dropout under to_static (two
    replays draw different masks)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    F = P.nn.functional
    t_phase = time.perf_counter()
    cfg = eager_config(LlamaConfig)
    models = [LlamaForCausalLM(cfg, device=DEVICE, dtype=torch.float32,
                               seed=args.seed) for _ in range(2)]
    eager_m, static_m = models
    opts = [P.optimizer.AdamW(learning_rate=1e-4, parameters=m.parameters())
            for m in models]
    batches = [(P.to_tensor(t[:, :-1], place=DEVICE),
                P.to_tensor(t[:, 1:], place=DEVICE))
               for t in static_batches(args, cfg.vocab_size)]
    sp = P.jit.to_static(static_m.llama)
    check(sp is static_m.llama, "to_static(Layer) returns the layer")
    sf = static_m.llama._static_function
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, mt.multi_tensor_adam)

    def amp():
        return P.amp.auto_cast(level="O1", dtype="bfloat16")

    losses = {"eager": [], "to_static": []}
    ms = {"eager": [], "to_static": []}
    per_step, grad_err, bitwise = [], {}, None
    for i in range(STATIC_WARMUP + STATIC_STEPS):
        ids, labels = batches[i % 2]
        for key, m, opt in (("eager", eager_m, opts[0]),
                            ("to_static", static_m, opts[1])):
            torch.cuda.synchronize()
            before = [k.launches for k in kernels]
            t0 = time.perf_counter()
            with amp():
                loss = eager_loss(P, F, m, ids, labels)
            loss.backward()
            if i == 0 and key == "to_static":
                # step 1: the warm-up call runs the eager loop's kernels
                twin = dict(eager_m.named_parameters())
                grad_err = {n: rel_l2(p.grad, twin[n].grad)
                            for n, p in static_m.named_parameters()}
                bitwise = all(torch.equal(p.grad, twin[n].grad)
                              for n, p in static_m.named_parameters())
                opts[0].step()
                opts[0].clear_grad()
            if i or key == "to_static":   # the eager grads wait for that
                opt.step()
                opt.clear_grad()
            torch.cuda.synchronize()
            if i >= STATIC_WARMUP:
                ms[key].append((time.perf_counter() - t0) * 1e3)
                if key == "to_static":
                    per_step.append(_deltas(kernels, before))
            losses[key].append(float(loss.detach()))
    L = EAGER_LAYERS
    worst = max(grad_err, key=grad_err.get)
    check(grad_err[worst] <= EAGER_GRAD_RTOL,
          f"to_static step 1: grad of {worst} {grad_err[worst]:.3g} "
          f"(relative L2) from the eager loop's")
    spread = max(abs(a - b) / abs(b) for a, b in
                 zip(losses["to_static"], losses["eager"]))
    check(spread <= EAGER_LOSS_RTOL,
          f"to_static losses {losses['to_static']} against the eager "
          f"loop's {losses['eager']}")
    check(all(d == [L, L, L, 1] for d in per_step),
          f"to_static steps launched K2, K3, K4, U2 {per_step}, want "
          f"{[L, L, L, 1]} each")
    info = sf.cache_info()
    check(info["graphs"] == 2 and info["bailouts"] == 0
          and info["lowerings"] == 1 and info["in_flight"] == 0,
          f"to_static of the decoder: {info}, want one forward and one "
          f"backward graph, no bailout")
    check(falls(losses["to_static"]), f"to_static loss not falling: "
          f"{losses['to_static']}")
    del eager_m, static_m, models, opts, sp
    gc.collect()
    torch.cuda.empty_cache()

    # a tensor `if` under to_static on the card: each call syncs to read
    # the predicate, so the signature bails out to eager, counted
    @P.jit.to_static
    def branchy(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = -x
        return y + 1.0
    outs = [branchy(P.to_tensor(v, place=DEVICE)).numpy().tolist()
            for v in ([1.0, 2.0], [-1.0, -2.0], [3.0, -1.0])]
    check(outs == [[3.0, 5.0], [2.0, 3.0], [7.0, -1.0]],
          f"dy2static tensor if on the card: {outs}")
    binfo = branchy._static_function.cache_info()
    check(binfo["bailouts"] == 1 and binfo["graphs"] == 0
          and "host sync" in binfo["bailout_reason"],
          f"dy2static tensor if: {binfo}, want one bailout with its reason")
    drop = P.nn.Dropout(0.5)
    drop.train()
    sdrop = P.jit.to_static(drop)
    x = P.to_tensor(np.ones(4096, np.float32), place=DEVICE)
    y = [sdrop(x).numpy().copy() for _ in range(3)]
    dinfo = drop._static_function.cache_info()
    check(dinfo["graphs"] == 1 and dinfo["hits"] == 2
          and not np.array_equal(y[1], y[2])
          and set(np.unique(y[2])) <= {0.0, 2.0},
          f"dropout under to_static: {dinfo}, replays equal "
          f"{np.array_equal(y[1], y[2])}")
    out = {
        "layers": L, "batch": EAGER_BATCH, "seq": EAGER_SEQ,
        "warmup_steps": STATIC_WARMUP, "steps": STATIC_STEPS,
        "losses": losses["to_static"], "eager_losses": losses["eager"],
        "loss_rel_spread": spread, "step1_grad_rel_l2_max": grad_err[worst],
        "step1_grad_worst": worst, "step1_grads_bitwise": bitwise,
        "step_ms": ms["to_static"], "eager_step_ms": ms["eager"],
        "step_ms_p50": float(np.percentile(ms["to_static"], 50)),
        "eager_step_ms_p50": float(np.percentile(ms["eager"], 50)),
        "launches_per_step": dict(zip(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "multi_tensor_adam"), per_step[0])),
        "tier": info, "dy2static_if": binfo, "dropout": dinfo,
        "op_host_us": op_host_us(torch, fa),
        "seconds": time.perf_counter() - t_phase}
    log(f"to_static(model.llama), {L} layers at llama_7b width, "
        f"B={EAGER_BATCH} S={EAGER_SEQ}, O1 bf16: step p50 "
        f"{out['step_ms_p50']:.2f} ms (eager loop {out['eager_step_ms_p50']:.2f}"
        f" ms, in turns), losses {spread:.2g} apart, step-1 grads "
        f"{'bitwise' if bitwise else f'{grad_err[worst]:.3g} apart'}; "
        f"K2 host us a call: operator {out['op_host_us']['operator']:.1f}, "
        f"wrapper {out['op_host_us']['wrapper']:.1f}, launcher "
        f"{out['op_host_us']['launcher']:.1f}")
    return out


def phase_static_program(torch, args, P, fa, mt, eager_losses):
    """The same model and batch as a static Program: ``static.data`` for
    ids and labels, ``compute_loss`` under auto_cast O1 bf16,
    ``AdamW(1e-4).minimize``; ``Executor.run(startup)`` and 2 + 5 runs
    fetching the loss (numpy feed and fetch), fed the two
    ``static_batches`` in turn. Gates: the losses track
    phase_to_static's eager loop; per run K2 = K3 = K4 = layers and U2
    once; one cache entry, captured as one CUDA graph, 0 bailouts."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    t_phase = time.perf_counter()
    cfg = eager_config(LlamaConfig)
    feeds = [{"ids": t[:, :-1], "labels": t[:, 1:].copy()}
             for t in static_batches(args, cfg.vocab_size)]
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, mt.multi_tensor_adam)
    static.enable_static()
    try:
        main, startup = static.Program(), static.Program()
        t0 = time.perf_counter()
        with static.program_guard(main, startup):
            model = LlamaForCausalLM(cfg, device=DEVICE, dtype=torch.float32,
                                     seed=args.seed)
            ids = static.data("ids", [EAGER_BATCH, EAGER_SEQ], "int64")
            lab = static.data("labels", [EAGER_BATCH, EAGER_SEQ], "int64")
            with P.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = model.compute_loss(ids, lab)
            P.optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters()).minimize(loss)
        record_s = time.perf_counter() - t0
        exe = static.Executor()
        scope = static.Scope()
        losses, run_ms, per_run = [], [], []
        with static.scope_guard(scope):
            exe.run(startup)
            for i in range(STATIC_WARMUP + STATIC_STEPS):
                torch.cuda.synchronize()
                before = [k.launches for k in kernels]
                t0 = time.perf_counter()
                (lv,) = exe.run(main, feed=feeds[i % 2],
                                fetch_list=[loss])
                run_ms.append((time.perf_counter() - t0) * 1e3)
                per_run.append(_deltas(kernels, before))
                losses.append(float(lv))
    finally:
        static.disable_static()
    L = EAGER_LAYERS
    info = exe.cache_info()
    spread = max(abs(a - b) / abs(b) for a, b in zip(losses, eager_losses))
    check(spread <= EAGER_LOSS_RTOL,
          f"static Program losses {losses} against the eager loop's "
          f"{eager_losses}")
    check(all(d == [L, L, L, 1] for d in per_run),
          f"static runs launched K2, K3, K4, U2 {per_run}, want "
          f"{[L, L, L, 1]} each")
    check(info["entries"] == 1 and info["steps"][0]["graphs"] == 1
          and info["steps"][0]["bailouts"] == 0,
          f"Executor cache {info}: want one entry captured as one graph")
    n_ops = len(main.ops)
    timed = run_ms[STATIC_WARMUP:]
    out = {"layers": L, "batch": EAGER_BATCH, "seq": EAGER_SEQ,
           "ops_recorded": n_ops, "record_s": record_s,
           "losses": losses, "eager_losses": eager_losses,
           "loss_rel_spread": spread, "run_ms": timed,
           "first_run_ms": run_ms[0],
           "run_ms_p50": float(np.percentile(timed, 50)),
           "launches_per_run": dict(zip(
               ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                "multi_tensor_adam"), per_run[-1])),
           "executor": info, "seconds": time.perf_counter() - t_phase}
    del model, main, startup, exe, scope
    gc.collect()
    torch.cuda.empty_cache()
    log(f"static Program of the same step ({n_ops} ops recorded in "
        f"{record_s:.1f}s): run p50 {out['run_ms_p50']:.2f} ms with numpy "
        f"feed and fetch (first run, warm-up and capture, "
        f"{run_ms[0]:.0f} ms), losses {spread:.2g} from the eager loop's")
    return out


def _predictor_config(inference, prefix):
    """``inference.Config`` of ``prefix`` on the run's device (the card;
    the CPU in a rehearsal)."""
    c = inference.Config(prefix)
    if DEVICE == "cpu":
        c.disable_gpu()
    return c


def _sizes(prefix, exts):
    return {e: os.path.getsize(prefix + e) for e in exts}


def _timed(torch, fn, n):
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def phase_deploy(torch, args, P, fa):
    """(a) LLaMA at llama_7b width cut to EAGER_LAYERS, bf16:
    ``jit.save`` with the fixed spec ``[1, EAGER_SEQ]`` int64, then
    ``jit.load`` and ``inference.create_predictor`` through the handles;
    gates: logits against the eager ``model.logits``, K2 = layers a run.
    (b) a tiny LLaMA saved on the CPU and loaded on the card: it launches
    K2 and matches the card model with the same weights. (c) ResNet-50,
    full width and depth, fp32 eval, saved once with ``InputSpec([None,
    3, 224, 224])``, the Predictor at batch 1 and 64 against eager, and
    ``PredictorPool(2)``'s clones on one weight storage. Each input shape
    is also run once more, a graph replay fed a fresh input, and held
    against eager on that input."""
    import shutil
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.vision.models import resnet as R
    t_phase = time.perf_counter()
    shutil.rmtree(STATIC_DIR, ignore_errors=True)
    os.makedirs(STATIC_DIR, exist_ok=True)
    L = EAGER_LAYERS
    out = {}
    try:
        # (a) LLaMA
        cfg = eager_config(LlamaConfig)
        model = LlamaForCausalLM(cfg, device=DEVICE, dtype=torch.bfloat16,
                                 seed=args.seed)
        tok = np.random.RandomState(args.seed + 2).randint(
            0, cfg.vocab_size, (1, EAGER_SEQ))
        prefix = os.path.join(STATIC_DIR, "llama")
        t0 = time.perf_counter()
        P.jit.save(model, prefix, input_spec=[P.jit.InputSpec(
            [1, EAGER_SEQ], "int64", name="input_ids")])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = inference.create_predictor(_predictor_config(inference,
                                                            prefix))
        load_s = time.perf_counter() - t0
        h = pred.get_input_handle("input_ids")
        before = fa.flash_attention_fwd.launches
        h.copy_from_cpu(tok)
        pred.run()
        got = pred.get_output_handle(pred.get_output_names()[0])
        logits = got._value
        k2 = fa.flash_attention_fwd.launches - before
        with torch.no_grad():
            want = model.logits(P.to_tensor(tok, place=DEVICE))
        err = rel_l2(logits, want)
        check(err <= DEPLOY_LOGITS_RTOL,
              f"deployed LLaMA logits {err:.3g} (relative L2) from eager")
        check(k2 == L, f"deployed LLaMA launched K2 {k2} times, want {L}")

        def run_pred():
            h.copy_from_cpu(tok)
            pred.run()
            pred.get_output_handle(pred.get_output_names()[0])
        before = fa.flash_attention_fwd.launches
        pred_ms = _timed(torch, run_pred, 5)
        k2_runs = fa.flash_attention_fwd.launches - before
        check(k2_runs == 5 * L, f"5 Predictor runs launched K2 {k2_runs} "
              f"times, want {5 * L}")
        # a replay fed another sequence, against eager on that sequence
        tok2 = np.random.RandomState(args.seed + 5).randint(
            0, cfg.vocab_size, (1, EAGER_SEQ))
        h.copy_from_cpu(tok2)
        pred.run()
        logits2 = pred.get_output_handle(pred.get_output_names()[0])._value
        with torch.no_grad():
            want2 = model.logits(P.to_tensor(tok2, place=DEVICE))
        err2 = rel_l2(logits2, want2)
        check(err2 <= DEPLOY_LOGITS_RTOL,
              f"deployed LLaMA's replay on a fresh sequence: logits "
              f"{err2:.3g} (relative L2) from eager")
        pcap = pred._layer._step.cache_info()
        check(pcap["lowerings"] == 1 and pcap["bailouts"] == 0
              and pcap["hits"] == 6,
              f"deployed LLaMA's runs: {pcap}, want one graph replayed")
        ids_t = P.to_tensor(tok, place=DEVICE)
        eager_ms = _timed(torch, lambda: model(ids_t), 5)
        out["llama"] = {
            "dtype": "bfloat16", "layers": L, "spec": [1, EAGER_SEQ],
            "save_s": save_s, "load_s": load_s,
            "bytes": _sizes(prefix, (".pdmodel", ".pdiparams", ".pdmeta")),
            "logits_rel_l2": err, "replay_logits_rel_l2": err2,
            "logits_max_abs_err": float((logits.float() - want.float())
                                        .abs().max()),
            "k2_per_run": k2, "capture": pcap, "run_ms": pred_ms,
            "run_ms_p50": float(np.percentile(pred_ms, 50)),
            "eager_forward_ms_p50": float(np.percentile(eager_ms, 50))}
        del model, pred, h, got, logits, want, logits2, want2
        gc.collect()
        torch.cuda.empty_cache()

        # (b) an artifact saved on the CPU, loaded on the card
        tcfg = LlamaConfig.tiny(**TINY_ARTIFACT)
        cpu_m = LlamaForCausalLM(tcfg, device="cpu", seed=args.seed)
        card_m = LlamaForCausalLM(tcfg, device=DEVICE, seed=args.seed)
        card_m.load_state_dict(cpu_m.state_dict())
        tprefix = os.path.join(STATIC_DIR, "tiny_cpu")
        P.jit.save(cpu_m, tprefix, input_spec=[P.jit.InputSpec(
            [2, 64], "int64")])
        loaded = P.jit.load(tprefix, device=DEVICE)
        trng = np.random.RandomState(args.seed + 3)
        k2s, terrs = [], []
        for _ in range(2):         # the warm-up, then a replay
            tids = trng.randint(0, tcfg.vocab_size, (2, 64))
            before = fa.flash_attention_fwd.launches
            got = loaded(P.to_tensor(tids, place=DEVICE))
            k2s.append(fa.flash_attention_fwd.launches - before)
            want = card_m.logits(P.to_tensor(tids, place=DEVICE)).detach()
            terr = float((got - want).abs().max())
            terrs.append(terr)
            check(terr <= 1e-4 * max(1.0, float(want.abs().max())),
                  f"CPU-saved artifact on the card: logits {terr:.3g} from "
                  f"the card model's")
        check(k2s == [tcfg.num_hidden_layers] * 2,
              f"CPU-saved artifact on the card launched K2 {k2s} times a "
              f"call, want {tcfg.num_hidden_layers}")
        out["cpu_artifact"] = {"k2": k2s[0], "k2_calls": k2s,
                               "max_abs_err": max(terrs),
                               "program_device": str(got.device)}

        # (c) ResNet-50, fp32 eval, dynamic batch
        P.seed(args.seed, DEVICE)
        rn = R.resnet50(device=DEVICE)
        rn.eval()
        rprefix = os.path.join(STATIC_DIR, "resnet50")
        t0 = time.perf_counter()
        P.jit.save(rn, rprefix, input_spec=[P.jit.InputSpec(
            [None, 3, 224, 224], "float32", name="image")])
        rsave_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pool = inference.PredictorPool(_predictor_config(inference,
                                                         rprefix), size=2)
        rload_s = time.perf_counter() - t0
        pr = pool.retrieve(0)
        share = [t.data_ptr() for t in pr._layer._param_vals] == \
            [t.data_ptr() for t in pool.retrieve(1)._layer._param_vals]
        check(share, "PredictorPool(2): the clones do not share the weights")
        rng = np.random.RandomState(args.seed + 4)
        res = {}
        for bs in (1, 64):
            x = rng.standard_normal((bs, 3, 224, 224)).astype(np.float32)
            hx = pr.get_input_handle("image")
            hx.copy_from_cpu(x)
            pr.run()
            y = pr.get_output_handle(pr.get_output_names()[0])._value
            with torch.no_grad():
                ye = rn(P.to_tensor(x, place=DEVICE))
            rerr = float((y - ye).abs().max() / ye.abs().max())
            check(tuple(y.shape) == (bs, 1000) and rerr <= DEPLOY_RESNET_RTOL,
                  f"ResNet-50 Predictor at batch {bs}: {tuple(y.shape)}, "
                  f"{rerr:.3g} of max|eager| from eager")
            xt = P.to_tensor(x, place=DEVICE)
            r_ms = _timed(torch, lambda: pr.run([xt]), 5)
            with torch.no_grad():
                e_ms = _timed(torch, lambda: rn(xt), 5)
            # a replay fed other images, against eager on those images
            x2 = rng.standard_normal((bs, 3, 224, 224)).astype(np.float32)
            hx.copy_from_cpu(x2)
            pr.run()
            y2 = pr.get_output_handle(pr.get_output_names()[0])._value
            with torch.no_grad():
                ye2 = rn(P.to_tensor(x2, place=DEVICE))
            rerr2 = float((y2 - ye2).abs().max() / ye2.abs().max())
            check(rerr2 <= DEPLOY_RESNET_RTOL,
                  f"ResNet-50 Predictor's replay at batch {bs} on fresh "
                  f"images: {rerr2:.3g} of max|eager| from eager")
            res[bs] = {"rel_err": rerr, "replay_rel_err": rerr2,
                       "run_ms_p50": float(np.percentile(r_ms, 50)),
                       "eager_ms_p50": float(np.percentile(e_ms, 50)),
                       "images_per_s": bs * 1e3 / float(np.percentile(
                           r_ms, 50))}
        with torch.no_grad():
            traces = {"predictor": trace_call(torch, lambda: pr.run([xt])),
                      "eager": trace_call(torch, lambda: rn(xt))}
        rcap = pr._layer._step.cache_info()
        check(rcap["lowerings"] == 2 and rcap["bailouts"] == 0,
              f"ResNet-50 Predictor: {rcap}, want a graph a batch size")
        out["resnet50"] = {"save_s": rsave_s, "load_s": rload_s,
                           "trace_batch_64": traces, "capture": rcap,
                           "bytes": _sizes(rprefix, (".pdmodel",
                                                     ".pdiparams")),
                           "pool_shares_weights": share, "batch": res}
    finally:
        shutil.rmtree(STATIC_DIR, ignore_errors=True)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["seconds"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    ll, rr = out["llama"], out["resnet50"]
    log(f"deployment: LLaMA {L} layers bf16 [1, {EAGER_SEQ}] saved in "
        f"{ll['save_s']:.1f}s ({ll['bytes']['.pdiparams'] / 2**30:.2f} GiB "
        f"of weights), loaded in {ll['load_s']:.1f}s, Predictor run p50 "
        f"{ll['run_ms_p50']:.2f} ms (eager forward "
        f"{ll['eager_forward_ms_p50']:.2f} ms), logits {ll['logits_rel_l2']:.2g}"
        f" from eager; ResNet-50 fp32 at batch 64 "
        f"{rr['batch'][64]['images_per_s']:.0f} images/s "
        f"(eager {64e3 / rr['batch'][64]['eager_ms_p50']:.0f}); a CPU "
        f"artifact launched K2 {out['cpu_artifact']['k2']} times on the card")
    return out


def phase_static(torch, args, P, fa, mt):
    """The three phases of the static/compile tier, in order."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ts = phase_to_static(torch, args, P, fa, mt)
    prog = phase_static_program(torch, args, P, fa, mt, ts["eager_losses"])
    deploy = phase_deploy(torch, args, P, fa)
    return {"to_static": ts, "program": prog, "deploy": deploy,
            "seconds": time.perf_counter() - t0}


# ---- this slice's phases: the nn sweep, GPT-2 small, the measurement API


def _tests_path():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if path not in sys.path:
        sys.path.insert(0, path)


def phase_nn_sweep(torch, P):
    """Every ported breadth op and in-place op (the op table's cases, the
    in-place ones also keeping their storage, all but the ones of
    INPLACE_REBINDS, whose dtype or shape changes), every new functional,
    layer and initializer of tests/torch_nn_cases.py on card tensors
    against the same port call on CPU tensors (float32 rtol 1e-4, atol
    1e-5), every output and parameter on the card, dropout's keep rate
    there, and BatchNorm2D's running statistics after 3 training steps
    equal to the CPU's."""
    _tests_path()
    from torch_nn_cases import SWEEP_TOL, sweep_nn
    from torch_op_cases import (CASES, INPLACE_REBINDS,
                                inplace_keeps_storage, module_of, sweep_case)
    t0 = time.perf_counter()
    breadth = sorted(n for n in CASES
                     if module_of(n, P.ops)[0] == "breadth")
    n_ops = n_true = 0
    for name in breadth:
        try:
            n_ops += sweep_case(P, name, DEVICE)
            if name.endswith("_"):
                n_true += inplace_keeps_storage(P, name, DEVICE)
        except Exception as e:  # noqa: BLE001 — name the op, then fail
            raise SmokeFailure(f"nn sweep: {name} on the card: "
                               f"{type(e).__name__}: {e}") from e
    try:
        n_nn = sweep_nn(P, DEVICE)
    except Exception as e:  # noqa: BLE001 — the message names the case
        raise SmokeFailure(f"nn sweep: {type(e).__name__}: {e}") from e
    n_inplace = sum(n.endswith("_") for n in breadth)
    check(n_true == n_inplace - len(INPLACE_REBINDS),
          f"{n_true} of {n_inplace} in-place ops wrote in place, want all "
          f"but the {len(INPLACE_REBINDS)} that rebind")
    out = {"breadth_cases": len(breadth), "breadth_calls": n_ops,
           "inplace": n_inplace, "inplace_kept_storage": n_true,
           "nn_names": n_nn, "names_checked": len(breadth) + n_nn,
           "tol": SWEEP_TOL, "seconds": time.perf_counter() - t0}
    log(f"nn sweep: {out['names_checked']} names checked on the card "
        f"against the CPU ({len(breadth)} breadth ops with {n_inplace} "
        f"in-place, {n_true} of them keeping their storage; {n_nn} "
        f"functionals, layers and initializers) in {out['seconds']:.1f}s")
    return out


GPT_BATCH, GPT_SEQ, GPT_WARMUP, GPT_STEPS = 8, 1024, 2, 5
GPT_SMALL_LAYERS, GPT_SMALL_BATCH, GPT_SMALL_SEQ = 2, 2, 128
GPT_LOSS_RTOL = 1e-5          # fp32 card vs CPU, dropout 0, amp off
# each grad card vs CPU: |a - b| <= 1e-4 |b| + 1e-6 sqrt(numel) (L2); the
# absolute term holds grads that are rounding noise in both (the key
# projection's bias: softmax ignores a shift shared by a row's logits)
GPT_GRAD_RTOL, GPT_GRAD_ATOL = 1e-4, 1e-6


def gpt_small_step(torch, P, G, model, ids):
    """One fp32 AdamW step of the small copy: the loss before and after
    it, and every grad."""
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters())
    _, loss = model(ids, labels=ids)
    loss.backward()
    grads = {n: p.grad.detach().float().cpu().clone()
             for n, p in model.named_parameters()}
    opt.step()
    opt.clear_grad()
    with torch.no_grad():
        _, after = model(ids, labels=ids)
    return [float(loss.detach()), float(after)], grads


def grad_excess(a, b) -> float:
    """How far ``a`` is from ``b`` in units of GPT's grad tolerance (<= 1
    passes)."""
    return float((a - b).norm() / (GPT_GRAD_RTOL * b.norm()
                                   + GPT_GRAD_ATOL * b.numel() ** 0.5))


def phase_gpt(torch, args, P, fa, mt):
    """GPT-2 small (GPTConfig(): vocab 50304, hidden 768, 12 layers, 12
    heads, intermediate 3072, 1024 positions) trained on the card: B=8,
    S=1024, seeded ids, AdamW(1e-4), auto_cast O1 bf16, dropout as
    configured, 2 warm-up and 5 timed steps on a repeated batch. Gates:
    the loss finite and falling; K2-K4 launched 0 times (the causal mask
    takes sdpa_ref, as in the JAX package) and U2 once per 80 tensors a
    step; U2 over the model's own params, grads and moments bit for bit
    its plain version (Adam and AdamW, 3 steps each); the operator stats'
    dtypes as the amp lists rule; a 2-layer fp32 copy with dropout 0 gives
    the same step on the card as on the CPU port (the losses before and
    after one AdamW step at rtol 1e-5, each grad within 1e-4 of its L2
    norm plus 1e-6 sqrt(n), for grads that are rounding noise in both) and
    the same 16 greedy ids."""
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.ops.kernels.multi_tensor import ADAM_MAX
    t_phase = time.perf_counter()
    P.seed(args.seed, DEVICE)
    cfg = G.GPTConfig()
    model = G.GPTForCausalLM(cfg, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(model.parameters())
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters())
    rng = np.random.RandomState(args.seed + 2)
    ids = P.to_tensor(rng.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ)))
    check(ids.place.startswith(DEVICE), f"ids on {ids.place}")

    def amp():
        return P.amp.auto_cast(level="O1", dtype="bfloat16")
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, mt.multi_tensor_adam)

    def gpt_loss(m):
        return m(ids, labels=ids)[1]
    losses, step_ms, fwd_ms, launches, peak = train_loop(
        torch, model, opt, gpt_loss, GPT_WARMUP, GPT_STEPS, kernels, amp)
    u2_per_step = -(-n_tensors // ADAM_MAX)
    want = [0, 0, 0, GPT_STEPS * u2_per_step]
    check(launches == want, f"GPT launched K2, K3, K4, U2 {launches} times "
          f"in {GPT_STEPS} steps, want {want}")
    check(falls(losses), f"GPT loss not finite or not falling: {losses}")
    u2_model = u2_model_check(torch, mt, model, opt, gpt_loss, amp,
                              "GPT-2 small")
    with amp(), debugging.collect_operator_stats() as st:
        model(ids, labels=ids)
    opt.clear_grad()
    dts = {"linear": "bfloat16", "matmul": "bfloat16", "sdpa": "bfloat16",
           "layer_norm": "float32", "softmax": "float32",
           "gpt_logits": "float32", "gpt_lm_loss": "float32"}
    for name, dt in dts.items():
        check(set(st.dtypes.get(name, ())) == {dt},
              f"GPT operator stats: {name} output {st.dtypes.get(name)}, "
              f"want {dt} only")
    n_ops = sum(st.stats.values())
    p50 = float(np.percentile(step_ms, 50))
    del opt, model
    gc.collect()
    torch.cuda.empty_cache()

    # a 2-layer fp32 copy, dropout 0, amp off: the card against the CPU
    small = G.GPTConfig(num_hidden_layers=GPT_SMALL_LAYERS,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    P.seed(args.seed, "cpu")
    cpu_m = G.GPTForCausalLM(small, device="cpu")
    card_m = G.GPTForCausalLM(small, device=DEVICE)
    G.load_paddle_tpu_state(card_m, G.paddle_tpu_state(cpu_m))
    sids = rng.randint(0, small.vocab_size,
                       (GPT_SMALL_BATCH, GPT_SMALL_SEQ))
    prompt = sids[:, :8]
    want_ids = cpu_m.generate(P.to_tensor(prompt, place="cpu"),
                              max_new_tokens=16).numpy()
    got_ids = card_m.generate(P.to_tensor(prompt, place=DEVICE),
                              max_new_tokens=16).numpy()
    check(np.array_equal(got_ids, want_ids),
          f"GPT greedy ids on the card {got_ids.tolist()} != CPU "
          f"{want_ids.tolist()}")
    lc, gc_ = gpt_small_step(torch, P, G, card_m,
                             P.to_tensor(sids, place=DEVICE))
    lw, gw = gpt_small_step(torch, P, G, cpu_m,
                            P.to_tensor(sids, place="cpu"))
    check(all(abs(a - b) <= GPT_LOSS_RTOL * abs(b) for a, b in zip(lc, lw)),
          f"GPT fp32 step: losses {lc} on the card, {lw} on the CPU")
    excess = {n: grad_excess(gc_[n], gw[n]) for n in gw}
    errs = {n: rel_l2(gc_[n], gw[n]) for n in gw}
    worst = max(excess, key=excess.get)
    check(excess[worst] <= 1.0,
          f"GPT fp32 step: grad of {worst} off by {errs[worst]:.3g} "
          f"relative L2 ({excess[worst]:.3g}x the tolerance) card vs CPU")
    del cpu_m, card_m
    gc.collect()
    torch.cuda.empty_cache()
    out = {
        "config": "GPTConfig() (GPT-2 small)", "params": n_params,
        "tensors": n_tensors, "batch": GPT_BATCH, "seq": GPT_SEQ,
        "warmup_steps": GPT_WARMUP, "steps": GPT_STEPS, "losses": losses,
        "step_ms": step_ms, "step_ms_p50": p50,
        "tokens_per_s": GPT_BATCH * GPT_SEQ / (p50 / 1e3),
        "forward_host_ms_p50": float(np.percentile(fwd_ms, 50)),
        "ops_per_step": n_ops, "op_counts": st.stats,
        "op_dtypes": {k: st.dtypes[k] for k in dts},
        "host_us_per_op": float(np.percentile(fwd_ms, 50)) * 1e3 / n_ops,
        "peak_mem_gib": peak,
        "u2_model_check": u2_model,
        "launches_per_step": dict(zip(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "multi_tensor_adam"), (n // GPT_STEPS for n in launches))),
        "small_check": {"layers": GPT_SMALL_LAYERS,
                        "batch": GPT_SMALL_BATCH, "seq": GPT_SMALL_SEQ,
                        "losses_card": lc, "losses_cpu": lw,
                        "grad_worst": worst,
                        "grad_worst_rel_l2": errs[worst],
                        "grad_worst_of_tolerance": excess[worst],
                        "grad_rel_l2_max_above_1e-3_norm": max(
                            e for n, e in errs.items()
                            if float(gw[n].norm()) > 1e-3),
                        "greedy_ids_equal": True},
        "seconds": time.perf_counter() - t_phase}
    log(f"GPT-2 small, B={GPT_BATCH} S={GPT_SEQ}, O1 bf16: step p50 "
        f"{p50:.2f} ms, {out['tokens_per_s']:.0f} tokens/s, peak "
        f"{peak:.2f} GiB, {n_ops} ops a step, {out['host_us_per_op']:.1f} "
        f"host us an op, loss {losses[0]:.4f} -> {losses[-1]:.4f}; U2 on "
        f"its {n_tensors} tensors ({u2_per_step} launches) bit for bit the "
        f"plain version, Adam and AdamW; fp32 "
        f"2-layer step card vs CPU: loss {lc[0]:.6f} / {lw[0]:.6f}, worst "
        f"grad {worst} at {excess[worst]:.3g}x the tolerance")
    return out


# ---- the convolution, recurrent and BERT slice: ResNet-50, the OCR pair
# (CRNN, DBNet) and BERT-base, trained on the card at full width

RESNET_BATCH, RESNET_SIZE, RESNET_WARMUP, RESNET_STEPS = 64, 224, 2, 5
# PaddleClas's ResNet50.yaml sets lr 0.1 for its 4-card launch, 256 images
# a step; one card's 64 take a quarter of it (the linear scaling rule)
RESNET_LR = 0.1 * RESNET_BATCH / 256
RESNET_SMALL_BATCH, RESNET_SMALL_SIZE = 4, 64
CRNN_BATCH, CRNN_SHAPE, CRNN_MAX_LABEL = 256, (3, 32, 100), 10
DBNET_BATCH, DBNET_SIZE = 16, 640
OCR_WARMUP, OCR_STEPS = 2, 5
BERT_BATCH, BERT_SEQ, BERT_WARMUP, BERT_STEPS = 32, 128, 2, 5
BERT_SMALL_LAYERS, BERT_SMALL_BATCH = 2, 2
SMALL_STAT_TOL = (1e-4, 1e-5)  # fp32 card vs CPU: running stats, logits


def falls(losses) -> bool:
    """Every loss finite and the last step's below the first step's."""
    return bool(all(np.isfinite(losses)) and losses[-1] < losses[0])


def on_card(model) -> bool:
    """Every parameter and buffer of ``model`` on the run's device."""
    return all(t.device.type == DEVICE.split(":")[0] for t in
               list(model.parameters()) + list(model.buffers()))


def train_loop(torch, model, opt, loss_fn, warmup, steps, kernels, amp=None):
    """``warmup + steps`` optimizer steps of ``loss_fn(model)``; the
    kernels' counters and the peak memory reset where the timed steps
    start. Returns losses, step ms and forward host ms (timed steps), the
    kernels' launches in the timed steps and the peak GiB."""
    from contextlib import nullcontext
    losses, step_ms, fwd_ms = [], [], []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in kernels:
                kern.launches = 0    # the main path's run starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (amp() if amp else nullcontext()):
            loss = loss_fn(model)
        t1 = time.perf_counter()
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        if i >= warmup:
            step_ms.append((time.perf_counter() - t0) * 1e3)
            fwd_ms.append((t1 - t0) * 1e3)
        losses.append(float(loss.detach()))
    return (losses, step_ms, fwd_ms, [k.launches for k in kernels],
            torch.cuda.max_memory_allocated() / 2 ** 30)


def u2_model_check(torch, mt, model, opt, loss_fn, amp=None, label=""):
    """U2 over a model's own tensors, chunked as its step chunks them,
    against its plain version: one more forward and backward, then
    ``u2_check`` on plain clones of the params, their grads and the
    optimizer's moments (Adam and AdamW, 3 steps, bit for bit). The
    model and its optimizer are left as they were, grads cleared."""
    from contextlib import nullcontext
    from paddle_tpu_torch.ops.kernels.multi_tensor import ADAM_MAX
    with (amp() if amp else nullcontext()):
        loss = loss_fn(model)
    loss.backward()
    params = model.parameters()
    check(all(p.grad is not None for p in params), f"{label}: a grad is "
          f"missing")
    states = [opt._states[id(p)] for p in params]

    def plain(ts):
        return [t.detach().as_subclass(torch.Tensor).clone() for t in ts]
    err = u2_check(torch, mt, plain(params), plain(p.grad for p in params),
                   plain(s["moment1"] for s in states),
                   plain(s["moment2"] for s in states), None, None,
                   f"{label}'s {len(params)} tensors")
    opt.clear_grad()
    return {"tensors": len(params),
            "launches_per_call": -(-len(params) // ADAM_MAX),
            "max_abs_err": err}


def trace_step(torch, model, opt, loss_fn, step_p50, amp=None):
    """One more training step under torch.profiler: the device's kernel
    time, its share of the untraced step's p50, the kernel launches and
    the kernels that take the most time, and the optimizer's host ms."""
    from contextlib import nullcontext
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with (amp() if amp else nullcontext()):
            loss = loss_fn(model)
        loss.backward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        opt.clear_grad()
        opt_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.key, dev_us / 1e3, ev.count))
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    return {"device_kernel_ms": device_ms if kernels else None,
            "device_busy_share": device_ms / step_p50 if kernels else None,
            "kernel_launches": sum(k[2] for k in kernels),
            "optimizer_host_ms_traced": opt_ms,
            "top_kernels": [{"name": k[0][:90], "ms": k[1], "calls": k[2]}
                            for k in kernels[:10]]}


def ops_per_step(P, model, loss_fn, amp=None):
    """Ops the dispatch runs in one forward + loss (operator stats)."""
    from contextlib import nullcontext
    from paddle_tpu_torch.amp import debugging
    with (amp() if amp else nullcontext()), \
            debugging.collect_operator_stats() as st:
        loss_fn(model)
    return sum(st.stats.values())


def small_card_vs_cpu(torch, P, build, loss_fn, make_opt, inputs, label):
    """One fp32 step of the same small model on the card and on the CPU
    (the port's weights carried across): the loss, every grad within
    GPT's grad tolerance, the running statistics the forward left and the
    eval-mode output at the step's weights, then the loss after the
    update. ``inputs`` are numpy arrays."""
    from paddle_tpu_torch.models.gpt import (load_paddle_tpu_state,
                                             paddle_tpu_state)
    P.seed(0, "cpu")
    cpu_m = build("cpu")
    card_m = build(DEVICE)
    load_paddle_tpu_state(card_m, paddle_tpu_state(cpu_m))
    res = {}
    for dev, m in (("cpu", cpu_m), (DEVICE, card_m)):
        ts = [P.to_tensor(a.copy(), place=dev) for a in inputs]
        opt = make_opt(P, m)
        loss = loss_fn(m, ts)
        loss.backward()
        grads = {n: p.grad.detach().float().cpu().clone()
                 for n, p in m.named_parameters()}
        bufs = {n: b.detach().float().cpu().clone()
                for n, b in m.named_buffers()}
        m.eval()
        with torch.no_grad():
            out = m(ts[0])
        m.train()
        out = out if isinstance(out, torch.Tensor) else out["maps"]
        opt.step()
        opt.clear_grad()
        with torch.no_grad():
            after = float(loss_fn(m, ts))
        res[dev] = (float(loss.detach()), grads, bufs,
                    out.detach().float().cpu(), after)
    (lc, gc_, bc, oc, ac), (lw, gw, bw, ow, aw) = res[DEVICE], res["cpu"]
    check(abs(lc - lw) <= GPT_LOSS_RTOL * abs(lw),
          f"{label} fp32 step: loss {lc} on the card, {lw} on the CPU")
    # after the update: Adam turns the rounding noise of a grad that a
    # BatchNorm cancels into a full lr step, so the loss after it is held
    # at SMALL_STAT_TOL's rtol
    check(abs(ac - aw) <= SMALL_STAT_TOL[0] * abs(aw),
          f"{label} fp32 step: loss after the update {ac} on the card, "
          f"{aw} on the CPU")
    excess = {n: grad_excess(gc_[n], gw[n]) for n in gw}
    worst = max(excess, key=excess.get)
    check(excess[worst] <= 1.0,
          f"{label} fp32 step: grad of {worst} off by "
          f"{rel_l2(gc_[worst], gw[worst]):.3g} relative L2 "
          f"({excess[worst]:.3g}x the tolerance) card vs CPU")
    for n in bw:
        check(torch.allclose(bc[n], bw[n], *SMALL_STAT_TOL),
              f"{label}: buffer {n} after the step differs card vs CPU")
    check(torch.allclose(oc, ow, *SMALL_STAT_TOL),
          f"{label}: eval-mode output differs card vs CPU (max |d| "
          f"{float((oc - ow).abs().max()):.3g})")
    del cpu_m, card_m
    return {"loss_card": lc, "loss_cpu": lw, "loss_after_card": ac,
            "loss_after_cpu": aw, "grad_worst": worst,
            "grad_worst_of_tolerance": excess[worst],
            "buffers": len(bw),
            "eval_max_abs_diff": float((oc - ow).abs().max())}


def phase_vision(torch, args, P, fa, mt):
    """ResNet-50 (``resnet50()``: 1000 classes, 25.6M parameters) trained
    at full width as PaddleClas's ResNet50.yaml trains it on a card: B=64
    seeded 3x224x224 images, ``Momentum(RESNET_LR, 0.9,
    weight_decay=1e-4)``, auto_cast O1 bf16, 2 warm-up and 5 timed steps
    on a repeated batch. Gates: every parameter and BN buffer on the
    card, the loss finite and the last step's below the first's, K2-K4 and
    U2 launched 0 times (no attention; Momentum is a
    per-tensor update); a fp32 ResNet(BottleneckBlock, [1, 1, 1, 1], 10
    classes) at 64x64, B=4, gives the same step on the card as on the CPU
    (loss at rtol 1e-5, each grad within GPT's tolerance, the running
    statistics and eval-mode logits at 1e-4 / 1e-5). Then the OCR pair at
    the JAX defaults, fp32, Adam(1e-3), 2 + 5 steps each: CRNN (base 16,
    hidden 96, 63 classes) on [256, 3, 32, 100] with 1-10 long labels
    (T = 25 steps of the bidirectional LSTM), DBNet (base 16) on [16, 3,
    640, 640] with db_loss on seeded maps; gates: the loss finite and
    falling, U2 once per 80 tensors a step, U2 over the model's own
    tensors bit for bit its plain version, and a small copy equal card vs
    CPU."""
    from paddle_tpu_torch.models import ocr as O
    from paddle_tpu_torch.ops.kernels.multi_tensor import ADAM_MAX
    from paddle_tpu_torch.vision.models import resnet as R
    t_phase = time.perf_counter()
    F = P.nn.functional
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, mt.multi_tensor_adam)
    rng = np.random.RandomState(args.seed + 17)
    P.seed(args.seed, DEVICE)
    model = R.resnet50(device=DEVICE)
    check(on_card(model), "ResNet-50: a parameter or buffer is not on the "
          "card")
    n_params = sum(p.numel() for p in model.parameters())
    opt = P.optimizer.Momentum(RESNET_LR, 0.9,
                               parameters=model.parameters(),
                               weight_decay=1e-4)
    x = P.to_tensor(rng.standard_normal(
        (RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE)).astype(np.float32),
        place=DEVICE)
    y = P.to_tensor(rng.randint(0, 1000, RESNET_BATCH), place=DEVICE)

    def amp():
        return P.amp.auto_cast(level="O1", dtype="bfloat16")

    def resnet_loss(m):
        return F.cross_entropy(m(x), y)
    losses, step_ms, fwd_ms, launches, peak = train_loop(
        torch, model, opt, resnet_loss, RESNET_WARMUP, RESNET_STEPS, kernels,
        amp)
    check(launches == [0, 0, 0, 0], f"ResNet-50 launched K2, K3, K4, U2 "
          f"{launches} times, want none")
    check(falls(losses),
          f"ResNet-50 loss not finite or not falling: {losses}")
    n_ops = ops_per_step(P, model, resnet_loss, amp)
    p50 = float(np.percentile(step_ms, 50))
    trace = trace_step(torch, model, opt, resnet_loss, p50, amp)
    resnet = {
        "config": "resnet50() (ResNet-50, 1000 classes)", "params": n_params,
        "batch": RESNET_BATCH, "image": RESNET_SIZE,
        "optimizer": f"Momentum({RESNET_LR}, 0.9, weight_decay=1e-4)",
        "amp": "O1 bfloat16", "cudnn_benchmark":
            bool(torch.backends.cudnn.benchmark),
        "warmup_steps": RESNET_WARMUP, "steps": RESNET_STEPS,
        "losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
        "images_per_s": RESNET_BATCH / (p50 / 1e3),
        "forward_host_ms_p50": float(np.percentile(fwd_ms, 50)),
        "ops_per_step": n_ops, "peak_mem_gib": peak, "trace": trace,
        "launches_per_step": dict(zip(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "multi_tensor_adam"), (n // RESNET_STEPS for n in launches)))}
    del opt, model, x, y
    gc.collect()
    torch.cuda.empty_cache()
    small_x = rng.standard_normal((RESNET_SMALL_BATCH, 3, RESNET_SMALL_SIZE,
                                   RESNET_SMALL_SIZE)).astype(np.float32)
    small_y = rng.randint(0, 10, RESNET_SMALL_BATCH)
    resnet["small_check"] = small_card_vs_cpu(
        torch, P, lambda dev: R.ResNet(R.BottleneckBlock, layers=[1, 1, 1, 1],
                                       num_classes=10, device=dev),
        lambda m, ts: F.cross_entropy(m(ts[0]), ts[1]),
        lambda pkg, m: pkg.optimizer.Momentum(
            0.1, 0.9, parameters=m.parameters(), weight_decay=1e-4),
        [small_x, small_y], "ResNet small copy")
    log(f"ResNet-50, B={RESNET_BATCH} {RESNET_SIZE}x{RESNET_SIZE}, O1 bf16, "
        f"Momentum({RESNET_LR}): step p50 {p50:.2f} ms, "
        f"{resnet['images_per_s']:.0f} images/s, peak {peak:.2f} GiB, "
        f"{n_ops} ops a step, forward host "
        f"{resnet['forward_host_ms_p50']:.1f} ms, device busy "
        f"{trace['device_busy_share']}, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; fp32 small copy card vs CPU: worst grad "
        f"{resnet['small_check']['grad_worst']} at "
        f"{resnet['small_check']['grad_worst_of_tolerance']:.3g}x the "
        f"tolerance")

    # the OCR pair, fp32, Adam
    def adam(pkg, m):
        return pkg.optimizer.Adam(1e-3, parameters=m.parameters())
    lengths = rng.randint(1, CRNN_MAX_LABEL + 1, CRNN_BATCH)
    labels = np.zeros((CRNN_BATCH, CRNN_MAX_LABEL), np.int64)
    for b, n in enumerate(lengths):
        labels[b, :n] = rng.randint(1, 63, n)
    crnn_in = [rng.standard_normal((CRNN_BATCH,) + CRNN_SHAPE).astype(
        np.float32), labels, lengths.astype(np.int64)]
    gt = (rng.uniform(0, 1, (DBNET_BATCH, 1, DBNET_SIZE // 32,
                             DBNET_SIZE // 32)) > 0.7).astype(np.float32)
    gt = np.kron(gt, np.ones((1, 1, 32, 32), np.float32))   # text boxes
    db_in = [rng.standard_normal((DBNET_BATCH, 3, DBNET_SIZE, DBNET_SIZE))
             .astype(np.float32), gt,
             rng.uniform(0.3, 0.7, gt.shape).astype(np.float32)]
    ocr = {}
    for name, build, loss_of, inputs, small_build, small_inputs in (
            ("crnn", lambda dev: O.CRNN(device=dev),
             lambda m, ts: O.ctc_rec_loss(m(ts[0]), ts[1], ts[2]), crnn_in,
             lambda dev: O.CRNN(base=4, hidden=8, num_classes=11,
                                device=dev),
             [crnn_in[0][:2], np.minimum(labels[:2], 10), lengths[:2]]),
            ("dbnet", lambda dev: O.DBNet(device=dev),
             lambda m, ts: O.db_loss(m(ts[0]), ts[1], ts[2]), db_in,
             lambda dev: O.DBNet(base=4, device=dev),
             [a[:2, :, :64, :64] for a in db_in])):
        P.seed(args.seed, DEVICE)
        m = build(DEVICE)
        check(on_card(m), f"{name}: a parameter or buffer is not on the card")
        n_tensors = len(m.parameters())
        ts = [P.to_tensor(a, place=DEVICE) for a in inputs]
        o = adam(P, m)
        losses, step_ms, fwd_ms, launches, peak = train_loop(
            torch, m, o, lambda mm: loss_of(mm, ts), OCR_WARMUP, OCR_STEPS,
            kernels)
        u2 = -(-n_tensors // ADAM_MAX)
        check(launches == [0, 0, 0, OCR_STEPS * u2],
              f"{name} launched K2, K3, K4, U2 {launches} times in "
              f"{OCR_STEPS} steps, want [0, 0, 0, {OCR_STEPS * u2}]")
        check(falls(losses),
              f"{name} loss not finite or not falling: {losses}")
        p50 = float(np.percentile(step_ms, 50))
        trace = trace_step(torch, m, o, lambda mm: loss_of(mm, ts), p50)
        n_ops = ops_per_step(P, m, lambda mm: loss_of(mm, ts))
        u2_model = u2_model_check(torch, mt, m, o, lambda mm: loss_of(mm, ts),
                                  label=name)
        ocr[name] = {
            "params": sum(p.numel() for p in m.parameters()),
            "tensors": n_tensors, "input": list(inputs[0].shape),
            "optimizer": "Adam(1e-3)", "amp": "off (fp32)",
            "losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
            "samples_per_s": inputs[0].shape[0] / (p50 / 1e3),
            "forward_host_ms_p50": float(np.percentile(fwd_ms, 50)),
            "ops_per_step": n_ops, "peak_mem_gib": peak, "trace": trace,
            "u2_model_check": u2_model,
            "launches_per_step": {"multi_tensor_adam": u2}}
        del m, o, ts
        gc.collect()
        torch.cuda.empty_cache()
        ocr[name]["small_check"] = small_card_vs_cpu(
            torch, P, small_build, loss_of, adam, small_inputs,
            f"{name} small copy")
        log(f"{name} {list(inputs[0].shape)} fp32 Adam: step p50 "
            f"{p50:.2f} ms, peak {ocr[name]['peak_mem_gib']:.2f} GiB, "
            f"{ocr[name]['ops_per_step']} ops a step, device busy "
            f"{trace['device_busy_share']}, loss {losses[0]:.4f} "
            f"-> {losses[-1]:.4f}; U2 on its {n_tensors} tensors bit for "
            f"bit the plain version; small copy card = CPU")
    return {"resnet50": resnet, **ocr,
            "seconds": time.perf_counter() - t_phase}


def bert_batch(rng, vocab, batch, seq):
    """Seeded ids with per-row lengths of 16..seq, padded with id 0, and
    token types split 0 / 1 at the middle of each row's length."""
    ids = rng.randint(1, vocab, (batch, seq))
    types = np.zeros((batch, seq), np.int64)
    for b, n in enumerate(rng.randint(16, seq + 1, batch)):
        ids[b, n:] = 0
        types[b, n // 2:n] = 1
    return ids.astype(np.int64), types


def phase_bert(torch, args, P, fa, mt):
    """BERT-base GLUE fine-tuning at full width, as PaddleNLP's run_glue
    defaults: ``BertForSequenceClassification(BertConfig(), 2)`` (12 x 768,
    12 heads, 3072, vocab 30522, 512 positions), B=32, S=128 with per-row
    lengths of 16-128 padded with id 0 and token types 0 / 1,
    ``AdamW(2e-5, weight_decay=0.01)``, O1 bf16, dropout 0.1, 2 warm-up
    and 5 timed steps. Beside it one O1 step of ``BertForPretraining``
    with ``bert_pretraining_loss`` on 15% masked labels. Gates: the losses
    finite, the eval-mode (dropout-free) losses falling over the steps;
    K2-K4 launched 0 times (the additive pad mask takes sdpa_ref, as in
    the JAX package) and U2 once per 80 tensors a step; the mask is live
    (in eval mode, other ids at the padded positions under the ids' pad
    mask leave the logits equal, and move them under an all-zero mask); a
    2-layer fp32 copy with dropout 0 gives the same step on the card as on
    the CPU; U2 over each model's own tensors (201 and 206, 3 launches)
    bit for bit its plain version, Adam and AdamW."""
    from paddle_tpu_torch.models import bert as Bm
    from paddle_tpu_torch.ops.kernels.multi_tensor import ADAM_MAX
    t_phase = time.perf_counter()
    F = P.nn.functional
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, mt.multi_tensor_adam)
    rng = np.random.RandomState(args.seed + 23)
    cfg = Bm.BertConfig()
    P.seed(args.seed, DEVICE)
    model = Bm.BertForSequenceClassification(cfg, 2, device=DEVICE)
    check(on_card(model), "BERT: a parameter is not on the card")
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(model.parameters())
    opt = P.optimizer.AdamW(2e-5, parameters=model.parameters(),
                            weight_decay=0.01)
    ids_np, types_np = bert_batch(rng, cfg.vocab_size, BERT_BATCH, BERT_SEQ)
    ids = P.to_tensor(ids_np, place=DEVICE)
    types = P.to_tensor(types_np, place=DEVICE)
    labels = P.to_tensor(rng.randint(0, 2, BERT_BATCH), place=DEVICE)

    def amp():
        return P.amp.auto_cast(level="O1", dtype="bfloat16")

    def cls_loss(m):
        return F.cross_entropy(m(ids, types), labels)

    def eval_loss(m, loss_fn):
        """The loss without dropout (eval mode), under the same casts."""
        m.eval()
        with torch.no_grad(), amp():
            out = float(loss_fn(m))
        m.train()
        return out
    # dropout makes the training losses noisy: the loss that must fall is
    # the eval-mode one, before and after the steps
    before = eval_loss(model, cls_loss)
    losses, step_ms, fwd_ms, launches, peak = train_loop(
        torch, model, opt, cls_loss, BERT_WARMUP, BERT_STEPS, kernels, amp)
    after = eval_loss(model, cls_loss)
    u2 = -(-n_tensors // ADAM_MAX)
    want = [0, 0, 0, BERT_STEPS * u2]
    check(launches == want, f"BERT launched K2, K3, K4, U2 {launches} times "
          f"in {BERT_STEPS} steps, want {want}")
    check(all(np.isfinite(losses)) and after < before,
          f"BERT loss not finite or not falling: {losses}; without dropout "
          f"{before} -> {after}")
    n_ops = ops_per_step(P, model, cls_loss, amp)
    p50 = float(np.percentile(step_ms, 50))
    trace = trace_step(torch, model, opt, cls_loss, p50, amp)
    u2_model = u2_model_check(torch, mt, model, opt, cls_loss, amp,
                              "BERT-base")
    # the mask is live: eval mode, fp32
    model.eval()
    pad = ids_np == 0
    other = P.to_tensor(np.where(pad, 7, ids_np), place=DEVICE)
    mask = P.to_tensor(np.where(pad, -1e9, 0.0).astype(np.float32)[
        :, None, None, :], place=DEVICE)
    zero = P.zeros([BERT_BATCH, 1, 1, BERT_SEQ])
    with torch.no_grad():
        # the ids' own mask, then the same mask given, over other pad ids
        a, b = model(ids, types), model(other, types, attention_mask=mask)
        c, d = (model(ids, types, attention_mask=zero),
                model(other, types, attention_mask=zero))
    mask_diff = float((a - b).abs().max())
    check(pad.any() and mask_diff <= 1e-5 * float(a.abs().max()),
          f"BERT: other ids at padded positions moved the logits by "
          f"{mask_diff}")
    check(not torch.allclose(c, d), "BERT: without the mask the padded "
          "ids did not move the logits")
    del opt, model, a, b, c, d
    gc.collect()
    torch.cuda.empty_cache()
    # one O1 step of the pretraining model on 15% masked labels
    P.seed(args.seed, DEVICE)
    pre = Bm.BertForPretraining(cfg, device=DEVICE)
    popt = P.optimizer.AdamW(2e-5, parameters=pre.parameters(),
                             weight_decay=0.01)
    masked = np.where(rng.uniform(0, 1, ids_np.shape) < 0.15, ids_np, -100)
    masked[pad] = -100
    mlab = P.to_tensor(masked, place=DEVICE)
    nsp = P.to_tensor(rng.randint(0, 2, BERT_BATCH), place=DEVICE)

    def pre_loss(m):
        mlm, ns = m(ids, types)
        return Bm.bert_pretraining_loss(mlm, ns, mlab, nsp)
    pre_before = eval_loss(pre, pre_loss)
    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with amp():
        ploss = pre_loss(pre)
    ploss.backward()
    popt.step()
    popt.clear_grad()
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    pre_tensors = len(pre.parameters())
    pre_launches = [k.launches for k in kernels]
    check(np.isfinite(float(ploss.detach())) and pre_launches == [
        0, 0, 0, -(-pre_tensors // ADAM_MAX)],
          f"BERT pretraining step: loss {float(ploss.detach())}, launches "
          f"{pre_launches}")
    pre_after = eval_loss(pre, pre_loss)
    pre_u2 = u2_model_check(torch, mt, pre, popt, pre_loss, amp,
                            "BERT pretraining")
    check(pre_after < pre_before, f"BERT pretraining loss without dropout "
          f"did not fall: {pre_before} -> {pre_after}")
    pretraining = {"loss": float(ploss.detach()),
                   "eval_loss_before": pre_before,
                   "eval_loss_after": pre_after,
                   "masked_labels": int((masked != -100).sum()),
                   "step_ms": pre_ms, "tensors": pre_tensors,
                   "u2_model_check": pre_u2,
                   "launches": dict(zip(("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv",
                                         "multi_tensor_adam"),
                                        pre_launches))}
    del pre, popt, ploss
    gc.collect()
    torch.cuda.empty_cache()
    small_cfg = Bm.BertConfig(num_hidden_layers=BERT_SMALL_LAYERS,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    sids, stypes = bert_batch(rng, cfg.vocab_size, BERT_SMALL_BATCH,
                              BERT_SEQ)
    small = small_card_vs_cpu(
        torch, P, lambda dev: Bm.BertForSequenceClassification(
            small_cfg, 2, device=dev),
        lambda m, ts: F.cross_entropy(m(ts[0], ts[1]), ts[2]),
        lambda pkg, m: pkg.optimizer.AdamW(2e-5, parameters=m.parameters(),
                                           weight_decay=0.01),
        [sids, stypes, np.array([0, 1])], "BERT 2-layer copy")
    out = {
        "config": "BertConfig() (BERT-base), 2 classes", "params": n_params,
        "tensors": n_tensors, "batch": BERT_BATCH, "seq": BERT_SEQ,
        "real_tokens": int((~pad).sum()),
        "optimizer": "AdamW(2e-5, weight_decay=0.01)", "amp": "O1 bfloat16",
        "dropout": cfg.hidden_dropout_prob,
        "warmup_steps": BERT_WARMUP, "steps": BERT_STEPS, "losses": losses,
        "eval_loss_before": before, "eval_loss_after": after,
        "step_ms": step_ms, "step_ms_p50": p50,
        "sequences_per_s": BERT_BATCH / (p50 / 1e3),
        "forward_host_ms_p50": float(np.percentile(fwd_ms, 50)),
        "ops_per_step": n_ops,
        "host_us_per_op": float(np.percentile(fwd_ms, 50)) * 1e3 / n_ops,
        "peak_mem_gib": peak, "mask_max_abs_diff": mask_diff,
        "trace": trace, "u2_model_check": u2_model,
        "launches_per_step": dict(zip(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "multi_tensor_adam"), (n // BERT_STEPS for n in launches))),
        "pretraining": pretraining, "small_check": small,
        "seconds": time.perf_counter() - t_phase}
    log(f"BERT-base GLUE, B={BERT_BATCH} S={BERT_SEQ}, O1 bf16, AdamW: step "
        f"p50 {p50:.2f} ms, {out['sequences_per_s']:.0f} sequences/s, peak "
        f"{peak:.2f} GiB, {n_ops} ops a step, device busy "
        f"{trace['device_busy_share']}, loss without dropout "
        f"{before:.4f} -> {after:.4f}; K2-K4 0, U2 {u2} a step, on the "
        f"model's {n_tensors} tensors (and the pretraining model's "
        f"{pre_tensors}) bit for bit the plain version; pad mask "
        f"live (max |d| {mask_diff:.3g}); pretraining step {pre_ms:.1f} ms, "
        f"loss {pre_before:.4f} -> {pre_after:.4f}; 2-layer fp32 copy card "
        f"vs CPU worst grad {small['grad_worst']} at "
        f"{small['grad_worst_of_tolerance']:.3g}x the tolerance")
    return out


MEASURE_STEPS = 5             # closed, ready, then 3 recorded
MEASURE_AFTER = 3             # closed steps after the profiler stops
EVENT_WALL_RTOL = 0.10        # Event-timed step against the wall p50


def phase_measure(torch, args, LlamaConfig, LlamaForCausalLM, P, fa, mt):
    """The measurement API over phase_eager's loop (llama_7b width, 2
    layers, B=2, S=2048, O1 bf16): Profiler(make_scheduler(closed=1,
    ready=1, record=3), export_chrome_tracing) around 5 steps with
    RecordEvents for forward, backward and the optimizer. Gates: the
    exported file loads; each recorded step holds its 3 user spans and
    the dispatch's ops of a step (counted by collect_operator_stats),
    each op inside a user span; summary() lists sdpa; device's counters
    equal torch.cuda's; an Event-timed step within 10% of the wall p50;
    a matmul on a side Stream under stream_guard, after wait_stream,
    equal to the default stream's; get_device_properties().name equal to
    nvidia-smi's; benchmark().ips equal to B*S over the steps' time;
    launches K2 = K3 = K4 = layers and U2 once a step."""
    import glob
    import shutil
    import tempfile
    from paddle_tpu_torch import device as D
    from paddle_tpu_torch import profiler as prof_mod
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import dispatch
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = eager_config(LlamaConfig)
    model = LlamaForCausalLM(cfg, device=DEVICE, dtype=torch.float32,
                             seed=args.seed)
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters())
    rng = np.random.RandomState(args.seed + 1)
    tok = rng.randint(0, cfg.vocab_size, (EAGER_BATCH, EAGER_SEQ + 1))
    ids, labels = P.to_tensor(tok[:, :-1]), P.to_tensor(tok[:, 1:])
    RE = prof_mod.RecordEvent

    def step():
        with RE("forward"):
            with P.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = eager_loss(P, F, model, ids, labels)
        with RE("backward"):
            loss.backward()
        with RE("optimizer"):
            opt.step()
            opt.clear_grad()
        return loss

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    timed()                                      # warm-up
    with debugging.collect_operator_stats() as st:
        timed()
    ops_per_step = sum(st.stats.values())
    check(dispatch._quiet, "the dispatch hook stayed on after the stats")
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, mt.multi_tensor_adam)
    for kern in kernels:
        kern.launches = 0            # the main path's run starts here
    prof = prof_mod.Profiler(
        scheduler=prof_mod.make_scheduler(closed=1, ready=1, record=3),
        on_trace_ready=prof_mod.export_chrome_tracing(trace_dir))
    states, ms, marks = [], [], []
    prof.start()
    for _ in range(MEASURE_STEPS):
        states.append(prof._state.name)
        ms.append(timed())
        marks.append(time.perf_counter())
        prof.step(num_samples=EAGER_BATCH * EAGER_SEQ)
    prof.stop()
    launches = [k.launches for k in kernels]
    want_l = [MEASURE_STEPS * EAGER_LAYERS] * 3 + [MEASURE_STEPS]
    check(launches == want_l, f"profiled loop launched K2, K3, K4, U2 "
          f"{launches} times, want {want_l}")
    check(dispatch._quiet, "the dispatch hook stayed on after stop()")
    bench = prof_mod.benchmark()
    intervals = np.diff(marks)
    want_ips = EAGER_BATCH * EAGER_SEQ * len(intervals) / intervals.sum()
    check(abs(bench.ips() - want_ips) <= 0.01 * want_ips,
          f"benchmark().ips {bench.ips():.1f}, steps give {want_ips:.1f}")
    closed = [m for m, s in zip(ms, states) if s in ("CLOSED", "READY")]
    recorded = [m for m, s in zip(ms, states) if s.startswith("RECORD")]
    closed += [timed() for _ in range(MEASURE_AFTER)]
    check(len(recorded) == 3, f"recorded steps: {states}")

    files = glob.glob(os.path.join(trace_dir, "*.paddle_trace.json"))
    try:
        check(len(files) == 1, f"trace files: {files}")
        events = prof_mod.load_profiler_result(files[0])["traceEvents"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    user = sorted((e for e in events if e["cat"] == "UserDefined"),
                  key=lambda e: e["ts"])
    ops = [e for e in events if e["cat"] == "op"]
    check([e["name"] for e in user] == ["forward", "backward",
                                        "optimizer"] * 3,
          f"user spans {[e['name'] for e in user]}")
    per_step = []
    for k in range(3):
        a = user[3 * k]["ts"]
        b = user[3 * k + 2]["ts"] + user[3 * k + 2]["dur"]
        mine = [e for e in ops if a <= e["ts"] <= b]
        per_step.append(len(mine))
        spans = user[3 * k:3 * k + 3]
        check(all(any(s["ts"] <= e["ts"] and e["ts"] + e["dur"]
                      <= s["ts"] + s["dur"] for s in spans) for e in mine),
              f"recorded step {k}: an op span outside its user spans")
    check(per_step == [ops_per_step] * 3 and len(ops) == 3 * ops_per_step,
          f"op spans per recorded step {per_step} (total {len(ops)}), the "
          f"dispatch counts {ops_per_step} ops a step")
    table = prof.summary()
    check(any(line.split()[:1] == ["sdpa"] for line in table.splitlines()),
          "summary() lists no sdpa row")

    torch.cuda.synchronize()
    counters = {"memory_allocated": (D.memory_allocated(),
                                     torch.cuda.memory_allocated()),
                "max_memory_allocated": (D.max_memory_allocated(),
                                         torch.cuda.max_memory_allocated()),
                "memory_reserved": (D.memory_reserved(),
                                    torch.cuda.memory_reserved())}
    check(all(a == b for a, b in counters.values()),
          f"device counters against torch.cuda: {counters}")
    e0, e1 = D.Event(enable_timing=True), D.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    step()
    e1.record()
    e1.synchronize()
    event_ms = e0.elapsed_time(e1)
    closed_p50 = float(np.percentile(closed, 50))
    check(abs(event_ms - closed_p50) <= EVENT_WALL_RTOL * closed_p50,
          f"Event-timed step {event_ms:.2f} ms, wall p50 {closed_p50:.2f}")
    x = torch.randn(4096, 4096, device=DEVICE)
    ref = x @ x
    side = D.Stream()
    side.wait_stream(D.current_stream())
    with D.stream_guard(side):
        check(D.current_stream() == side, "stream_guard did not switch")
        got = x @ x
    D.current_stream().wait_stream(side)
    D.synchronize()
    stream_err = float((got - ref).abs().max())
    check(stream_err <= 1e-5 * float(ref.abs().max()),
          f"matmul on a side stream differs by {stream_err}")
    name = D.cuda.get_device_properties().name
    smi_name = args.card.split(",")[0].strip()
    check(name == smi_name, f"device name {name!r}, nvidia-smi {smi_name!r}")
    peak = D.max_memory_allocated() / 2 ** 30
    del x, ref, got, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    rec_p50 = float(np.percentile(recorded, 50))
    out = {"layers": EAGER_LAYERS, "batch": EAGER_BATCH, "seq": EAGER_SEQ,
           "states": states, "step_ms": ms, "closed_step_ms": closed,
           "recorded_step_ms": recorded, "step_ms_p50_closed": closed_p50,
           "step_ms_p50_recording": rec_p50,
           "profiler_cost_ms": rec_p50 - closed_p50,
           "ops_per_step": ops_per_step, "op_spans_per_step": per_step,
           "user_spans": len(user), "event_step_ms": event_ms,
           "benchmark_ips": bench.ips(), "steps_ips": want_ips,
           "stream_matmul_max_abs_diff": stream_err,
           "stream_bitwise": stream_err == 0.0,
           "device_counters": counters, "device_name": name,
           "peak_mem_gib": peak,
           "launches_per_step": dict(zip(
               ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                "multi_tensor_adam"),
               (n // MEASURE_STEPS for n in launches))),
           "seconds": time.perf_counter() - t_phase}
    log(f"measurement API over the eager O1 loop ({EAGER_LAYERS} layers at "
        f"llama_7b width, B={EAGER_BATCH} S={EAGER_SEQ}): step p50 "
        f"{closed_p50:.2f} ms closed, {rec_p50:.2f} ms recording, "
        f"{ops_per_step} op spans a recorded step, Event {event_ms:.2f} "
        f"ms, ips {bench.ips():.0f}, peak {peak:.2f} GiB")
    return out


RANK_TIMEOUT_S = 600
MESH_LABEL = {"gloo": "gloo, ranks share one card",
              "nccl": "nccl, one card a rank"}
INT8_WIRE_SHARE = 0.27       # (1 + 4/256) / 4 = 0.254, padding aside
# the quantized dp2 losses against the exact run's, three steps: about
# three times the largest gap read on an H100 (int8 9.5e-4, fp8 3.5e-5)
QUANT_LOSS_RTOL = {"int8": 3e-3, "fp8": 3e-4}
# synthetic grads for the direct grad-sync check: the largest grad of the
# llama_7b layer (the MLP's [11008, 4096]) and one with an odd tail block
QUANT_SYNC_SHAPES = ((11008, 4096), (4097 * 13,))


def mesh_config(LlamaConfig, layers, seq, **knobs):
    base = LlamaConfig.llama_7b()
    return LlamaConfig(vocab_size=base.vocab_size,
                       hidden_size=base.hidden_size,
                       intermediate_size=base.intermediate_size,
                       num_hidden_layers=layers,
                       num_attention_heads=base.num_attention_heads,
                       max_position_embeddings=seq, **knobs)


def mesh_batch(torch, vocab, batch, seq, seed):
    ids = np.random.RandomState(seed).randint(0, vocab, (batch, seq + 1))
    return {"input_ids": torch.from_numpy(ids[:, :-1]).to(DEVICE),
            "labels": torch.from_numpy(ids[:, 1:]).to(DEVICE)}


def small_mesh_config(LlamaConfig):
    """phase_small_train's fp32 model and batch (GQA, ignored labels)."""
    cfg = LlamaConfig.tiny(vocab=64, hidden=256, layers=2, heads=4,
                           inter=512, seq=64)
    cfg.num_key_value_heads = 2
    ids = np.random.RandomState(1).randint(0, 64, (2, 65))
    labels = ids[:, 1:].copy()
    labels[:, ::7] = -100
    return cfg, {"input_ids": ids[:, :-1], "labels": labels}


def small_mesh_run(torch, LlamaConfig, LlamaForCausalLM, build, AdamW,
                   mesh=None):
    """Three fp32 steps of the small model at AdamW epsilon 1e-3: losses
    and the (gathered) parameters."""
    from paddle_tpu_torch.models.llama import paddle_tpu_state
    cfg, batch = small_mesh_config(LlamaConfig)
    m = LlamaForCausalLM(cfg, device=DEVICE, seed=5, mesh=mesh)
    opt = AdamW(learning_rate=1e-3, epsilon=1e-3, parameters=m.parameters())
    step = build(m, opt, mesh=mesh, remat=True, amp=False)
    losses = [float(step(batch)) for _ in range(3)]
    return losses, paddle_tpu_state(m)


def kernel_counters(fa, fce, mt):
    return {"flash_fwd": fa.flash_attention_fwd,
            "flash_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv,
            "fused_ce_fwd": fce.fused_ce_fwd,
            "fused_ce_bwd_dh": fce.fused_ce_bwd_dh,
            "fused_ce_bwd_dw": fce.fused_ce_bwd_dw,
            "multi_tensor_sumsq": mt.multi_tensor_sumsq_finite,
            "multi_tensor_adam": mt.multi_tensor_adam}


def comm_sites(comms, steps):
    """Per-site comm of the timed steps, per step: count, host ms,
    logical / wire / staged bytes."""
    info = comms.comm_info()
    return {site: {"count": s["count"] / steps, "ms": s["ms"] / steps,
                   "bytes_logical": s["bytes_logical"] / steps,
                   "bytes_wire": s["bytes_wire"] / steps,
                   "bytes_staged": s["staged_bytes"] / steps,
                   "quantized": s["quantized"]}
            for site, s in info["sites"].items()}


def mesh_train(torch, mods, cfg, mesh, batch, warmup, steps, clip=None,
               seed=0, zero=False, **build_kw):
    """Train ``warmup + steps`` steps of the hybrid step on ``mesh`` (bf16
    amp, remat, AdamW(1e-4), ``DygraphShardingOptimizer`` around it when
    ``zero``; ``build_kw`` to the step); the kernel counters and the comm
    records are zeroed after the warm-up and read after the timed steps.
    A pipelined step adds its clock (ticks, busy ticks, the stash's peak,
    hand-off bytes), a ZeRO step each rank's share of the Adam state."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        DygraphShardingOptimizer
    comms, counters = mods["comms"], mods["counters"]
    model = mods["LlamaForCausalLM"](cfg, device=DEVICE, seed=seed,
                                     mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    opt = mods["AdamW"](learning_rate=1e-4, parameters=model.parameters(),
                        grad_clip=clip)
    if zero:
        opt = DygraphShardingOptimizer(opt)
    step = mods["build"](model, opt, mesh=mesh, remat=True, amp=True,
                         **build_kw)
    losses = [float(step(batch)) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comms.comm_clear()
    for kern in counters.values():
        kern.launches = 0        # the main path's run starts here
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    comm = comm_sites(comms, steps)
    out = {"losses": losses, "step_ms": step_ms,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "launches": {k: kern.launches for k, kern in counters.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "comm": comm, "params_model": n_params,
           "params_local": sum(t.numel()
                               for t in step.state["params"].values())}
    info = step.state["pipeline"]
    if info:
        out.update(
            stage=mesh.coords["pp"], ticks=info["ticks"],
            busy_ticks=info["busy"],
            idle_share=1.0 - info["busy"] / info["ticks"],
            stash_peak=info["stash_peak"],
            handoff_bytes_sent=info["bytes_sent"],
            handoff_bytes_staged=sum(
                c["bytes_staged"] for k, c in comm.items()
                if k.startswith("pipeline.handoff")),
            bytes_staged_all=sum(c["bytes_staged"] for c in comm.values()))
    zs = step.state["zero"]
    if zs is not None:
        out.update(zero_axis=zs.axis,
                   zero_sharded=sum(d is not None for d in zs.dims),
                   zero_tensors=len(zs.dims), state_share=state_share(step))
    del model, opt, step
    release(torch)
    return out


def state_share(step) -> float:
    """This rank's Adam moments (fp32) over what it would hold without
    ZeRO: 1.0 with no ZeRO."""
    zs = step.state["zero"]
    if zs is None:
        return 1.0
    full = sum(2 * 4 * int(np.prod(zs.full_shape(k)))
               for k in range(len(zs.tensors)))
    return zs.state_bytes(list(step.state["opt"].values())) / full


def mesh_mods():
    from paddle_tpu_torch.distributed import comms
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               build_hybrid_train_step)
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_ce as fce
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    from paddle_tpu_torch.optimizer import AdamW
    return {"comms": comms, "LlamaConfig": LlamaConfig,
            "LlamaForCausalLM": LlamaForCausalLM,
            "build": build_hybrid_train_step, "AdamW": AdamW, "fa": fa,
            "fce": fce, "mt": mt, "counters": kernel_counters(fa, fce, mt)}


def job_dp_mp(torch, rank, seed):
    """4 ranks, dp2 x mp2: the small fp32 equality run, then 4 layers at
    llama_7b width."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    mods = mesh_mods()
    mesh = mesh_mod.init_mesh({"dp": 2, "mp": 2})
    out = {"coords": dict(mesh.coords)}
    losses, state = small_mesh_run(torch, mods["LlamaConfig"],
                                   mods["LlamaForCausalLM"], mods["build"],
                                   mods["AdamW"], mesh)
    out["small"] = {"losses": losses, "state": state if rank == 0 else None}
    cfg = mesh_config(mods["LlamaConfig"], MESH_LAYERS, MESH_SEQ)
    batch = mesh_batch(torch, cfg.vocab_size, MESH_BATCH, MESH_SEQ, seed)
    out["train"] = mesh_train(torch, mods, cfg, mesh, batch, MESH_WARMUP,
                              MESH_STEPS, ClipGradByGlobalNorm(1.0), seed)
    return out


def tp_fused_ce(torch, mods, mesh):
    """fused_linear_cross_entropy_tp on this rank's vocab half, held
    against the unsharded K5-K7 on the same rank; m and lse merged over mp
    by hand (what the entry point does inside) beside them."""
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_linear_cross_entropy_tp
    fce, comms, counters = mods["fce"], mods["comms"], mods["counters"]
    g = torch.Generator(device=DEVICE).manual_seed(11)
    h = torch.randn(TP_N, TP_H, generator=g, device=DEVICE).to(
        torch.bfloat16)
    w = (0.05 * torch.randn(TP_H, TP_V, generator=g, device=DEVICE)).to(
        torch.bfloat16)
    labels = torch.randint(0, TP_V, (TP_N,), generator=g, device=DEVICE)
    gr = torch.randn(TP_N, generator=g, device=DEVICE) / TP_N
    n, r = mesh.shape["mp"], mesh.coords["mp"]
    vl = TP_V // n
    off = r * vl
    w_shard = w[:, off:off + vl].contiguous()
    # the unsharded reference on this rank (K5-K7 on the whole vocab)
    m, l, z = fce.fused_ce_fwd(h, w, labels)
    lse = (m + torch.log(l)).contiguous()
    want_dh = fce.fused_ce_bwd_dh(h, w, labels, lse, gr)
    want_dw = fce.fused_ce_bwd_dw(h, w, labels, lse, gr)[:, off:off + vl]
    ms, ls, zs = fce.fused_ce_fwd(h, w_shard, labels, off)
    M = comms.wire_all_reduce(ms, "mp", "max", exact=True, mesh=mesh)
    L = comms.wire_all_reduce(ls * torch.exp(ms - M), "mp", "sum",
                              exact=True, mesh=mesh)

    def tp_call():
        hh = h.detach().requires_grad_(True)
        ww = w_shard.detach().requires_grad_(True)
        loss = fused_linear_cross_entropy_tp(hh, ww, labels, "mp")
        loss.backward(gr)
        return loss.detach(), hh.grad, ww.grad

    for kern in counters.values():
        kern.launches = 0        # the entry point's own launches
    loss, dh, dw = tp_call()
    torch.cuda.synchronize()
    launches = {k: counters[k].launches for k in
                ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw")}
    errs, shares, bad = {}, {}, []
    for name, got, want in (("m", M, m), ("lse", M + torch.log(L), lse),
                            ("loss", loss, lse - z)):
        errs[name] = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=1e-4, rtol=1e-5):
            bad.append(name)
    for name, got, want in (("dh", dh, want_dh), ("dW", dw.t(),
                                                   want_dw.t())):
        ok, errs[name], shares[name] = flash_close(got, want, "bfloat16",
                                                   2.0)
        if not ok:
            bad.append(name)

    def host_ms(fn, reps=5):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    def unsharded():
        hh = h.detach().requires_grad_(True)
        ww = w.detach().requires_grad_(True)
        fce.fused_linear_cross_entropy(hh, ww, labels).backward(gr)

    return {"bad": bad, "max_abs_err": errs, "tol_share": shares,
            "launches": launches, "tp_ms": host_ms(tp_call),
            "unsharded_ms": host_ms(unsharded), "vocab_local": vl}


def ring_check(torch, mods, mesh, cfg):
    """ring_attention at one sep layer's shapes (bf16, causal; this rank's
    chunk of SEP_SEQ): its output and its q/k/v grads against
    flash_attention on the whole sequence, sliced to this rank's rows. The
    ring rounds each block's O to bf16 before the fp32 merge and sums the
    grads of the blocks it meets in bf16: two steps of the row's max|want|
    for O, two per block met (n) for the grads."""
    from paddle_tpu_torch.parallel.context_parallel import ring_attention
    fa = mods["fa"]
    n, i = mesh.shape["sep"], mesh.coords["sep"]
    H = cfg.num_attention_heads
    D = cfg.hidden_size // H
    q, k, v, do = flash_inputs(torch, 1, SEP_SEQ, SEP_SEQ, H, H, D,
                               torch.bfloat16, 7)     # the same on each rank
    rows = slice(i * SEP_SEQ // n, (i + 1) * SEP_SEQ // n)
    full = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention(*full, causal=True)
    o.backward(do)
    want = [o.detach()[:, rows]] + [t.grad[:, rows] for t in full]
    # the JAX function's per-rank layout, [B, H, S_loc, D]
    loc = [t[:, rows].transpose(1, 2).detach().clone().requires_grad_(True)
           for t in (q, k, v)]
    o = ring_attention(*loc, "sep", True, mesh=mesh)
    o.backward(do[:, rows].transpose(1, 2).contiguous())
    torch.cuda.synchronize()
    errs, shares, bad = {}, {}, []
    for name, got, w, mult in zip(("O", "dq", "dk", "dv"),
                                  [o.detach().transpose(1, 2)]
                                  + [t.grad.transpose(1, 2) for t in loc],
                                  want, (2.0, 2.0 * n, 2.0 * n, 2.0 * n)):
        ok, errs[name], shares[name] = flash_close(got, w, "bfloat16", mult)
        if not ok:
            bad.append(name)
    return {"bad": bad, "max_abs_err": errs, "tol_share": shares}


def quant_sync_check(torch, mods, mesh):
    """The quantized dp grad sync on synthetic grads (QUANT_SYNC_SHAPES),
    held element by element against their exact mean, which every rank
    makes itself from every rank's seed. Bounds, for n ranks whose grads
    have absmax a_r: int8 rounds each rank's grad and the reduced sum
    once, each within half a step of absmax / 127, so the mean is within
    sum(a_r) / (127 n); fp8 e4m3 rounds each rank's value within 2^-4 of
    it and the reduced sum within 2^-4 of that sum (which may have grown
    by 2^-4), plus half its smallest subnormal (absmax 2^-10 / 448) each
    time. 1% slack covers the fp32 scales."""
    comms = mods["comms"]
    n, r = mesh.shape["dp"], mesh.coords["dp"]
    out = {}
    for wire in ("int8", "fp8"):
        errs, shares = [], []
        for j, shape in enumerate(QUANT_SYNC_SHAPES):
            gs = [(1.0 + q) * torch.randn(
                shape, device=DEVICE, generator=torch.Generator(
                    device=DEVICE).manual_seed(100 * j + q))
                for q in range(n)]
            want = sum(gs) / n
            with comms.quantized(wire):
                got = comms.grad_sync([gs[r]], mesh, "dp", op="avg",
                                      owner="smoke.quant_sync")[0]
            amax = sum(float(g.abs().max()) for g in gs)
            if wire == "int8":
                bound = amax / (127 * n)
            else:
                bound = (2.0 ** -4 * (2 + 2.0 ** -4)
                         * sum(g.abs() for g in gs)
                         + 3 * 2.0 ** -10 / 448 * amax) / n
            diff = (got - want).abs()
            errs.append(float(diff.max()))
            shares.append(float((diff / (1.01 * bound)).max()))
        out[wire] = {"max_abs_err": max(errs), "tol_share": max(shares)}
    return out


def job_sep_tp_quant(torch, rank, seed):
    """2 ranks: sep2 ring then Ulysses at llama_7b width, the TP fused
    loss, the quantized dp grad sync."""
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    mods = mesh_mods()
    out = {}
    LlamaConfig = mods["LlamaConfig"]
    mesh = mesh_mod.init_mesh({"sep": 2})
    for mode in ("ring", "ulysses"):
        cfg = mesh_config(LlamaConfig, MESH_LAYERS, SEP_SEQ,
                          context_parallel=mode)
        batch = mesh_batch(torch, cfg.vocab_size, 1, SEP_SEQ, seed + 1)
        out[mode] = mesh_train(torch, mods, cfg, mesh, batch, SEP_WARMUP,
                               SEP_STEPS, seed=seed)
    out["sep_rank"] = mesh.coords["sep"]
    out["ring_check"] = ring_check(torch, mods, mesh, cfg)
    release(torch)
    mesh = mesh_mod.init_mesh({"mp": 2})
    out["tp"] = tp_fused_ce(torch, mods, mesh)
    release(torch)
    mesh = mesh_mod.init_mesh({"dp": 2})
    cfg = mesh_config(LlamaConfig, QUANT_LAYERS, QUANT_SEQ)
    batch = mesh_batch(torch, cfg.vocab_size, 2, QUANT_SEQ, seed + 2)
    comms = mods["comms"]
    out["sync_check"] = quant_sync_check(torch, mods, mesh)
    release(torch)
    for wire in (None, "int8", "fp8"):
        if wire is None:
            out["exact"] = mesh_train(torch, mods, cfg, mesh, batch, 0,
                                      QUANT_STEPS, seed=seed)
            continue
        with comms.quantized(wire):
            out[wire] = mesh_train(torch, mods, cfg, mesh, batch, 0,
                                   QUANT_STEPS, seed=seed)
    return out


# multi-GPU training, part 2: pp2 x dp2 at llama_7b width (M=4, each dp
# rank one row of each microbatch), the small fp32 pipelines and the
# 4-axis tiny step; steps are cut to 1 warm-up + 2 timed to keep the run
# inside its time limit
PP_LAYERS, PP_SEQ, PP_BATCH, PP_MICRO = 4, 2048, 8, 4
PP_WARMUP, PP_STEPS = 1, 2
AXIS4 = {"dp": 2, "pp": 2, "sharding": 2, "mp": 2}


def small_pp_config(LlamaConfig, layers=2, sp=False):
    """A small fp32 model (GQA) and a 4-row batch with ignored labels at the
    same positions of every row (so every microbatch has as many)."""
    cfg = LlamaConfig.tiny(vocab=64, hidden=256, layers=layers, heads=4,
                           inter=512, seq=64)
    cfg.num_key_value_heads = 2
    cfg.sequence_parallel = sp
    ids = np.random.RandomState(2).randint(0, 64, (8, 33))
    labels = ids[:, 1:].copy()
    labels[:, ::7] = -100
    return cfg, {"input_ids": ids[:, :-1], "labels": labels}


def small_pp_run(torch, mods, mesh, schedule="gpipe", micro=1, virtual=1,
                 zero=False, layers=2, sp=False):
    """Three fp32 steps of the small model (AdamW epsilon 1e-3; ZeRO stage
    1 when ``zero``): losses, the gathered parameters and each rank's
    share of the Adam moments."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        DygraphShardingOptimizer
    from paddle_tpu_torch.models.llama import paddle_tpu_state
    cfg, batch = small_pp_config(mods["LlamaConfig"], layers, sp)
    m = mods["LlamaForCausalLM"](cfg, device=DEVICE, seed=5, mesh=mesh)
    opt = mods["AdamW"](learning_rate=1e-3, epsilon=1e-3,
                        parameters=m.parameters())
    if zero:
        opt = DygraphShardingOptimizer(opt)
    step = mods["build"](m, opt, mesh=mesh, remat=True, amp=False,
                         n_microbatches=micro, schedule=schedule,
                         n_virtual=virtual)
    losses = [float(step(batch)) for _ in range(3)]
    share = state_share(step)
    step.write_back()
    return losses, paddle_tpu_state(m), share


def job_pp_dp(torch, rank, seed):
    """4 ranks, dp2 x pp2: gpipe and 1f1b_compact on the small fp32 model
    with ZeRO stage 1 (held against one unpipelined rank by the parent),
    then 1f1b and vpp (n_virtual=2) at llama_7b width."""
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    mods = mesh_mods()
    mesh = mesh_mod.init_mesh({"dp": 2, "pp": 2})
    out = {"coords": dict(mesh.coords), "small": {}}
    for sched in ("gpipe", "1f1b_compact"):
        losses, state, share = small_pp_run(torch, mods, mesh, sched, 2,
                                            zero=True)
        out["small"][sched] = {"losses": losses, "state_share": share,
                               "state": state if rank == 0 else None}
    release(torch)
    cfg = mesh_config(mods["LlamaConfig"], PP_LAYERS, PP_SEQ)
    batch = mesh_batch(torch, cfg.vocab_size, PP_BATCH, PP_SEQ, seed + 3)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    for sched, v in (("1f1b", 1), ("vpp", 2)):
        out[sched] = mesh_train(
            torch, mods, cfg, mesh, batch, PP_WARMUP, PP_STEPS,
            ClipGradByGlobalNorm(1.0), seed, zero=True, fused_loss=True,
            n_microbatches=PP_MICRO, schedule=sched, n_virtual=v)
        out[sched]["n_virtual"] = v
    return out


def job_axis4(torch, rank, seed):
    """16 ranks, dp2 x pp2 x sharding2 x mp2: the vpp step (n_virtual=2) of
    a tiny fp32 model with sequence parallelism and ZeRO over the explicit
    sharding axis."""
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    mods = mesh_mods()
    mesh = mesh_mod.init_mesh(dict(AXIS4))
    losses, state, share = small_pp_run(torch, mods, mesh, "vpp", 4, 2,
                                        zero=True, layers=4, sp=True)
    return {"coords": dict(mesh.coords), "losses": losses,
            "state_share": share, "state": state if rank == 0 else None}


# the checkpoint job: dp2 x mp2 at llama_7b width cut to 2 layers (667M
# parameters: fp32 masters and Adam's m and v about 8.0 GB over the four
# ranks' files), 3 steps, a sharded generation, 3 more; a fresh step
# restores it and repeats the last 3
CKPT_LAYERS, CKPT_SEQ, CKPT_BATCH, CKPT_STEPS = 2, 2048, 2, 3
CKPT_DIR = os.path.join("build", "chip_smoke_ckpt")
CKPT_MIN_FREE_GB = 24
# the MoE job: a gshard layer at llama_7b's MLP width, fp32
MOE_D, MOE_E, MOE_H, MOE_K, MOE_TOKENS = 4096, 8, 11008, 2, (2, 2048)
MOE_RTOL = 1e-4
MOE_AUX_W = 0.1


def crc_of(bricks) -> dict:
    import zlib
    return {k: zlib.crc32(np.ascontiguousarray(v).view(np.uint8))
            for k, v in bricks.items()}


def job_ckpt_dp_mp(torch, rank, seed):
    """4 ranks, dp2 x mp2, bf16 amp, remat, a global-norm clip, AdamW and
    ZeRO-1 over dp: CKPT_STEPS steps, a sharded generation of
    ``step.state`` (one owner a rank: stage, then commit or wait for the
    commit), CKPT_STEPS more; a fresh step from other weights restores it
    (its pieces' CRCs against the saved ones) and repeats them, its
    kernels counted. If the repeat is not bitwise, a second uninterrupted
    run gives the run-to-run spread."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed import CheckpointManager, checkpoint
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        DygraphShardingOptimizer
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    mods = mesh_mods()
    counters = mods["counters"]
    mesh = mesh_mod.init_mesh({"dp": 2, "mp": 2})
    cfg = mesh_config(mods["LlamaConfig"], CKPT_LAYERS, CKPT_SEQ)
    batches = [mesh_batch(torch, cfg.vocab_size, CKPT_BATCH, CKPT_SEQ,
                          seed + 20 + i) for i in range(2 * CKPT_STEPS)]

    def build(model_seed):
        model = mods["LlamaForCausalLM"](cfg, device=DEVICE, seed=model_seed,
                                         mesh=mesh)
        opt = DygraphShardingOptimizer(mods["AdamW"](
            learning_rate=1e-4, parameters=model.parameters(),
            grad_clip=ClipGradByGlobalNorm(1.0)))
        return model, mods["build"](model, opt, mesh=mesh, remat=True,
                                    amp=True)

    def train(step, part):
        return [float(step(b)) for b in part]

    model, step = build(seed)
    losses = train(step, batches[:CKPT_STEPS])
    mgr = CheckpointManager(CKPT_DIR, keep_last_k=1)
    owners = [f"rank{r}" for r in range(tdist.get_world_size())]
    torch.cuda.synchronize()
    tdist.barrier()
    t0 = time.perf_counter()
    bricks, meta = checkpoint.shard_bricks(step.state)
    t1 = time.perf_counter()
    n_params = sum(int(np.prod(m["shape"])) for n, m in meta.items()
                   if n.startswith("params."))
    stats = mgr.stage_shards(CKPT_STEPS, owners[rank], bricks)
    t2 = time.perf_counter()
    if rank == 0:
        mgr.commit_sharded(CKPT_STEPS, owners, meta)
    else:
        mgr.wait_commit(CKPT_STEPS)
    t3 = time.perf_counter()
    saved = crc_of(bricks)
    del bricks
    losses += train(step, batches[CKPT_STEPS:])
    del model, step
    release(torch)
    model, step = build(seed + 1)
    torch.cuda.synchronize()
    tdist.barrier()
    t4 = time.perf_counter()
    got_step = mgr.restore(step.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t4
    restored = crc_of(checkpoint.shard_bricks(step.state)[0])
    for kern in counters.values():
        kern.launches = 0        # the resumed run's launches start here
    resumed = train(step, batches[CKPT_STEPS:])
    launches = {k: kern.launches / CKPT_STEPS for k, kern in counters.items()}
    del model, step
    release(torch)
    out = {"losses": losses, "resumed": resumed, "restored_step": got_step,
           "pieces": len(saved),
           "pieces_equal": saved == restored, "launches": launches,
           "bytes": stats["bytes"], "bricks_s": t1 - t0,
           "stage_s": t2 - t1, "commit_or_wait_s": t3 - t2,
           "save_s": t3 - t0, "restore_s": restore_s,
           "params_model": n_params, "spread": None}
    if resumed != losses[CKPT_STEPS:]:
        model, step = build(seed)
        again = train(step, batches)
        out["spread"] = [abs(a - b) for a, b in
                         zip(again[CKPT_STEPS:], losses[CKPT_STEPS:])]
        del model, step
        release(torch)
    return out


def job_moe_ep(torch, rank, seed):
    """2 ranks, ep2: the gshard MoE layer at ep1 (every expert on the rank,
    no mesh) and at ep2 (4 experts a rank), drawn from one seed, on the
    same tokens: output, l_aux and the grads of the input, the gate and
    this rank's experts compared; forward + backward timed (after a
    warm-up), the ep all-reduces' bytes read."""
    from paddle_tpu_torch.distributed import comms
    from paddle_tpu_torch.distributed.fleet.moe import MoELayer
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.init_mesh({"ep": 2})
    rng = np.random.RandomState(seed + 40)
    x = torch.from_numpy(rng.randn(*MOE_TOKENS, MOE_D).astype(np.float32)) \
        .to(DEVICE).requires_grad_(True)
    cot = torch.from_numpy(rng.randn(*MOE_TOKENS, MOE_D).astype(
        np.float32)).to(DEVICE)

    def layer(on_mesh):
        g = torch.Generator(device=DEVICE).manual_seed(seed + 41)
        return MoELayer(MOE_D, gate="gshard", num_experts=MOE_E, top_k=MOE_K,
                        d_hidden=MOE_H, device=DEVICE, generator=g,
                        mesh=on_mesh)

    def run(m, reps=2):
        ms = []
        for _ in range(reps):
            x.grad = None
            m.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = m(x)
            loss = (y * cot).sum() + MOE_AUX_W * m.l_aux
            loss.backward()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return y.detach(), float(m.l_aux.detach()), x.grad.clone(), ms[-1]

    one = layer(mesh_mod.DeviceMesh({"ep": 1}))
    y1, l1, dx1, ms1 = run(one)
    two = layer(mesh)
    comms.comm_clear()
    y2, l2, dx2, ms2 = run(two, reps=1)
    wire = {k: v["bytes_logical"] for k, v in
            comms.comm_info()["sites"].items() if k.startswith("moe.")}
    y2, l2, dx2, ms2 = run(two)

    def err(got, want):
        tol = MOE_RTOL * (want.abs() + 1e-2 * want.abs().max())
        return {"max_abs_err": float((got - want).abs().max()),
                "ok": bool(((got - want).abs() <= tol).all())}
    errs = {"y": err(y2, y1), "dx": err(dx2, dx1),
            "gate": err(two.gate.weight.grad, one.gate.weight.grad),
            "l_aux": {"max_abs_err": abs(l2 - l1),
                      "ok": abs(l2 - l1) <= MOE_RTOL * abs(l1)}}
    for i, e in enumerate(range(two.expert_offset,
                                two.expert_offset + two.local_experts)):
        for (n, p), q in zip(two.experts[i].named_parameters(),
                             one.experts[e].parameters()):
            errs[f"experts.{e}.{n}"] = err(p.grad, q.grad)
    out = {"ep1_ms": ms1, "ep2_ms": ms2, "allreduce_bytes": wire,
           "experts_local": two.local_experts, "offset": two.expert_offset,
           "capacity": two.capacity(MOE_TOKENS[0] * MOE_TOKENS[1]),
           "errs": errs, "l_aux": [l1, l2]}
    del one, two, x, cot, y1, y2, dx1, dx2
    release(torch)
    return out


MESH_JOBS = {"dp_mp": job_dp_mp, "sep_tp_quant": job_sep_tp_quant,
             "pp_dp": job_pp_dp, "axis4": job_axis4,
             "ckpt_dp_mp": job_ckpt_dp_mp, "moe_ep": job_moe_ep}


def mesh_rank(rank, world, root, job, seed, backend):
    """One rank: join the group (``backend`` named: gloo with every rank on
    card 0, or nccl with rank r on card r) through a FileStore in
    ``root``, run the job, pickle its result; a failure writes its
    traceback."""
    import pickle
    import traceback
    import torch
    try:
        import torch.distributed as dist
        from paddle_tpu_torch.distributed import init_parallel_env
        torch.set_num_threads(2 if world <= 4 else 1)   # 8 cores
        torch.backends.cuda.matmul.allow_tf32 = False
        card = 0 if backend == "gloo" else rank
        torch.cuda.set_device(card)
        init_parallel_env(backend=backend, device=f"cuda:{card}",
                          store=dist.FileStore(os.path.join(root, "store"),
                                               world),
                          rank=rank, world_size=world,
                          timeout=RANK_TIMEOUT_S)
        out = MESH_JOBS[job](torch, rank, seed)
        with open(os.path.join(root, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — the parent reports it and fails
        with open(os.path.join(root, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    # skip the interpreter's teardown, where a gloo rank's native threads
    # can abort a process whose result is already written
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_ranks(job, world, root, seed, backend):
    """Spawn ``world`` ranks of ``job``; fail if any is late or fails."""
    import torch.multiprocessing as mp
    import pickle
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank,
                         args=(r, world, root, job, seed, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + RANK_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = []
    for r in range(world):
        path = os.path.join(root, f"err{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"--- rank {r} ---\n{f.read()}")
    check(not late and not errs and all(p.exitcode == 0 for p in procs),
          f"mesh job {job}: late ranks {late}, exit codes "
          f"{[p.exitcode for p in procs]}\n" + "\n".join(errs))
    out = []
    for r in range(world):
        with open(os.path.join(root, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def pp_launches_want(sched, stage, L, M, v):
    """K2-K7, U1, U2 a step on pp stage ``stage`` of two (remat: a stage's
    forward runs under checkpoint, its backward recomputes the stage and
    the checkpoint recomputes each block). 1f1b: stage 0's forward units
    (M x L/2 K2), every backward unit 2 x L/2 K2 and L/2 K3, K4; the last
    stage skips the forward unit whose output goes nowhere and runs the
    fused loss (K5-K7) once a microbatch. vpp: every unit of L/(2 v)
    layers runs forward once and is recomputed twice in the backward; the
    last stage runs the fused loss once over the reassembled batch."""
    last = stage == 1
    if sched == "1f1b":
        lp = L // 2
        k2 = (2 if last else 3) * lp * M
        k3 = lp * M
        fce = M if last else 0
    else:
        lc = L // (2 * v)
        k2 = 3 * lc * M * v
        k3 = lc * M * v
        fce = 1 if last else 0
    return {"flash_fwd": k2, "flash_bwd_dq": k3, "flash_bwd_dkv": k3,
            "fused_ce_fwd": fce, "fused_ce_bwd_dh": fce,
            "fused_ce_bwd_dw": fce, "multi_tensor_sumsq": 1,
            "multi_tensor_adam": 1}


def small_equal(label, got_losses, got_state, want_losses, want_state):
    check(np.allclose(got_losses, want_losses, rtol=1e-5),
          f"{label} fp32 losses {got_losses} vs one rank {want_losses}")
    if got_state is None:
        return
    apart = {n: int((~np.isclose(got_state[n], want, rtol=1e-4,
                                 atol=1e-5)).sum())
             for n, want in want_state.items()}
    check(sum(apart.values()) == 0, f"{label} fp32 parameters differ from "
          "one rank's: " + str({n: c for n, c in apart.items() if c}))


def phase_mesh_pp(torch, args, root, backend):
    """Multi-GPU training, part 2: dp2 x pp2 on 4 ranks (the small fp32
    gpipe and 1f1b_compact pipelines with ZeRO stage 1 equal to one
    unpipelined rank; 1f1b and vpp at llama_7b width with the fused loss,
    a global-norm clip and ZeRO stage 1), then (gloo) the 16-rank
    dp2 x pp2 x sharding2 x mp2 vpp step of a tiny model with ZeRO over
    the sharding axis, equal to one unpipelined rank."""
    mods = mesh_mods()
    release(torch)
    want2 = small_pp_run(torch, mods, None, layers=2)
    want4 = small_pp_run(torch, mods, None, layers=4)
    release(torch)
    pp_res = run_ranks("pp_dp", 4, root, args.seed, backend)
    for sched in ("gpipe", "1f1b_compact"):
        for res in pp_res:
            sm = res["small"][sched]
            small_equal(f"dp2 x pp2 {sched}", sm["losses"], sm["state"],
                        want2[0], want2[1])
            check(sm["state_share"] == 0.5, f"dp2 x pp2 {sched}: a rank "
                  f"holds {sm['state_share']} of its Adam state, want 1/2")
    log(f"mesh dp2 x pp2 fp32 (small): gpipe and 1f1b_compact losses "
        f"{pp_res[0]['small']['gpipe']['losses']} = one unpipelined rank's "
        f"{want2[0]} (rtol 1e-5), parameters at rtol 1e-4 / atol 1e-5; "
        f"each rank holds 1/2 of its Adam state")
    for sched, v in (("1f1b", 1), ("vpp", 2)):
        legs = [res[sched] for res in pp_res]
        for r, tr in enumerate(legs):
            check(all(np.isfinite(tr["losses"])),
                  f"pp {sched} rank {r}: non-finite loss {tr['losses']}")
            check(tr["losses"][-1] < tr["losses"][0],
                  f"pp {sched} rank {r}: loss did not fall: {tr['losses']}")
            want = pp_launches_want(sched, tr["stage"], PP_LAYERS, PP_MICRO,
                                    v)
            got = {k: tr["launches"][k] / PP_STEPS for k in want}
            check(got == want, f"pp {sched} rank {r} (stage {tr['stage']}):"
                  f" launches a step {got}, want {want}")
            check(tr["zero_sharded"] == tr["zero_tensors"]
                  and tr["state_share"] == 0.5,
                  f"pp {sched} rank {r}: {tr['zero_sharded']} of "
                  f"{tr['zero_tensors']} state tensors sharded, a share of "
                  f"{tr['state_share']}, want all and 1/2")
        check(all(t["losses"] == legs[0]["losses"] for t in legs),
              f"pp {sched}: ranks report different losses")
        log(f"mesh dp2 x pp2 {sched} at llama_7b width ({PP_LAYERS} layers,"
            f" S={PP_SEQ}, B={PP_BATCH}, M={PP_MICRO}, fused loss, ZeRO-1): "
            f"step p50 {[round(t['step_ms_p50']) for t in legs]} ms, peak "
            f"{[round(t['peak_mem_gib'], 2) for t in legs]} GiB, idle "
            f"{[round(t['idle_share'], 3) for t in legs]}, losses "
            f"{legs[0]['losses']}")
    axis4 = {"skipped": "16 ranks need gloo on the one card"}
    if backend == "gloo":
        res16 = run_ranks("axis4", 16, root, args.seed, backend)
        for res in res16:
            small_equal("dp2 x pp2 x sharding2 x mp2 vpp", res["losses"],
                        res["state"], want4[0], want4[1])
            check(res["state_share"] == 0.5, f"4-axis: a rank holds "
                  f"{res['state_share']} of its Adam state, want 1/2")
        axis4 = {"mesh": AXIS4, "schedule": "vpp", "n_virtual": 2,
                 "losses": res16[0]["losses"], "one_rank_losses": want4[0],
                 "state_share": [res["state_share"] for res in res16]}
        log(f"mesh dp2 x pp2 x sharding2 x mp2 vpp (16 ranks, tiny fp32, "
            f"ZeRO over sharding): losses {res16[0]['losses']} = one "
            f"unpipelined rank's {want4[0]}")
    return pp_res, axis4


def phase_ckpt_moe(torch, args, root, backend):
    """The checkpoint job (dp2 x mp2 save, restore, continue) and the MoE
    job (ep2 against ep1), with their gates; the generations are deleted
    afterwards."""
    import shutil
    t0 = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    free_gb = shutil.disk_usage(CKPT_DIR).free / 1e9
    check(free_gb >= CKPT_MIN_FREE_GB, f"checkpoint job: {free_gb:.1f} GB "
          f"free under {CKPT_DIR}, want {CKPT_MIN_FREE_GB}")
    try:
        res = run_ranks("ckpt_dp_mp", 4, root, args.seed, backend)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    L = CKPT_LAYERS
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "multi_tensor_sumsq": 1, "multi_tensor_adam": 1}
    note = "bitwise"
    for r, c in enumerate(res):
        check(all(np.isfinite(c["losses"])), f"ckpt rank {r}: non-finite "
              f"loss {c['losses']}")
        check(c["restored_step"] == CKPT_STEPS and c["pieces_equal"],
              f"ckpt rank {r}: restored step {c['restored_step']}, pieces "
              f"bitwise the saved ones: {c['pieces_equal']}")
        got = {k: c["launches"][k] for k in want}
        check(got == want, f"ckpt rank {r}: launches a step {got}, want "
              f"{want}")
        tail = c["losses"][CKPT_STEPS:]
        if c["resumed"] != tail:
            check(c["spread"] is not None and all(
                abs(a - b) <= s for a, b, s in
                zip(c["resumed"], tail, c["spread"])),
                f"ckpt rank {r}: resumed losses {c['resumed']} vs the "
                f"uninterrupted {tail}, outside the run-to-run spread "
                f"{c['spread']}")
            note = ("within the run-to-run spread of two uninterrupted "
                    "runs (one of K2-K4, U1, U2 or the gloo all-reduce is "
                    "not run-to-run deterministic)")
    check(all(c["losses"] == res[0]["losses"] for c in res),
          "ckpt: ranks report different losses")
    total = sum(c["bytes"] for c in res)
    save_s = max(c["save_s"] for c in res)
    restore_s = max(c["restore_s"] for c in res)
    ckpt = {"layers": L, "seq": CKPT_SEQ, "batch": CKPT_BATCH,
            "steps": CKPT_STEPS, "params_model": res[0]["params_model"],
            "losses": res[0]["losses"], "resumed": res[0]["resumed"],
            "resumed_equal": note, "pieces_by_rank": [c["pieces"] for c in res],
            "bytes_by_rank": [c["bytes"] for c in res], "bytes_total": total,
            "save_s_by_rank": [c["save_s"] for c in res],
            "bricks_s_by_rank": [c["bricks_s"] for c in res],
            "stage_s_by_rank": [c["stage_s"] for c in res],
            "commit_s_rank0": res[0]["commit_or_wait_s"],
            "wait_commit_s_by_rank": [c["commit_or_wait_s"]
                                      for c in res[1:]],
            "restore_s_by_rank": [c["restore_s"] for c in res],
            "save_gb_per_s": total / 1e9 / save_s,
            "restore_gb_per_s": total / 1e9 / restore_s,
            "launches_per_step": res[0]["launches"], "free_gb": free_gb}
    log(f"ckpt dp2 x mp2 at llama_7b width ({L} layers, S={CKPT_SEQ}, "
        f"{ckpt['params_model']} parameters, ZeRO-1): {total / 1e9:.3f} GB "
        f"over 4 ranks ({[c['bytes'] for c in res]} bytes), save "
        f"{save_s:.2f}s ({ckpt['save_gb_per_s']:.3f} GB/s; wait_commit "
        f"{[round(s_, 3) for s_ in ckpt['wait_commit_s_by_rank']]}s), restore "
        f"{restore_s:.2f}s ({ckpt['restore_gb_per_s']:.3f} GB/s); resumed "
        f"losses {res[0]['resumed']} {note} to the uninterrupted "
        f"{res[0]['losses'][CKPT_STEPS:]}; {args.card}")
    moe_res = run_ranks("moe_ep", 2, root, args.seed, backend)
    for r, m in enumerate(moe_res):
        bad = {k: v["max_abs_err"] for k, v in m["errs"].items()
               if not v["ok"]}
        check(not bad, f"moe ep2 rank {r} vs ep1: {bad} outside rtol "
              f"{MOE_RTOL}")
        check(m["offset"] == r * MOE_E // 2 and m["experts_local"]
              == MOE_E // 2, f"moe rank {r}: experts {m['offset']} + "
              f"{m['experts_local']}")
    moe = {"d": MOE_D, "experts": MOE_E, "hidden": MOE_H, "top_k": MOE_K,
           "tokens": list(MOE_TOKENS), "dtype": "float32",
           "capacity": moe_res[0]["capacity"],
           "ep1_ms_by_rank": [m["ep1_ms"] for m in moe_res],
           "ep2_ms_by_rank": [m["ep2_ms"] for m in moe_res],
           "allreduce_bytes_rank0": moe_res[0]["allreduce_bytes"],
           "max_abs_err_by_rank": [{k: v["max_abs_err"] for k, v in
                                    m["errs"].items()} for m in moe_res],
           "l_aux": moe_res[0]["l_aux"]}
    log(f"moe gshard E={MOE_E} d={MOE_D} h={MOE_H} k={MOE_K} tokens "
        f"{list(MOE_TOKENS)} fp32: ep2 = ep1 within rtol {MOE_RTOL}; "
        f"forward + backward ep1 {moe['ep1_ms_by_rank']} ms, ep2 "
        f"{moe['ep2_ms_by_rank']} ms by rank; all-reduce bytes "
        f"{moe['allreduce_bytes_rank0']}; {args.card}")
    return {"ckpt_dp_mp": ckpt, "moe_ep": moe,
            "phase_s": time.perf_counter() - t0}


def phase_recompute(torch, args, LlamaConfig, LlamaForCausalLM, fa):
    """``LlamaConfig(recompute=True)`` through the fleet's ``recompute`` at
    llama_7b width cut to 2 layers, S=2048, B=2, bf16 parameters: loss and
    grads of ``compute_loss`` against ``recompute=False`` on the same
    model (bitwise for every tensor that two plain runs give bitwise; the
    others within the spread of two plain runs), K2 2 x layers, K3 and K4
    layers a recomputed step (layers, layers, layers without), forward +
    backward ms of each (the second of two runs)."""
    t0 = time.perf_counter()
    cfg = mesh_config(LlamaConfig, CKPT_LAYERS, CKPT_SEQ)
    model = LlamaForCausalLM(cfg, device=DEVICE, dtype=torch.bfloat16,
                             seed=args.seed + 5)
    batch = mesh_batch(torch, cfg.vocab_size, CKPT_BATCH, CKPT_SEQ,
                       args.seed + 6)
    counters = {"flash_fwd": fa.flash_attention_fwd,
                "flash_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_bwd_dkv": fa.flash_attention_bwd_dkv}

    def run(recompute):
        model.config.recompute = recompute
        model.zero_grad(set_to_none=True)
        for kern in counters.values():
            kern.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = model.compute_loss(batch["input_ids"], batch["labels"])
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        return (loss.detach(), [p.grad.clone() for p in model.parameters()],
                {k: kern.launches for k, kern in counters.items()}, ms)

    plain = [run(False) for _ in range(2)]
    rec = [run(True) for _ in range(2)]
    L = CKPT_LAYERS
    check(rec[1][2] == {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                        "flash_bwd_dkv": L}
          and plain[1][2] == {"flash_fwd": L, "flash_bwd_dq": L,
                              "flash_bwd_dkv": L},
          f"recompute launches {rec[1][2]}, plain {plain[1][2]}")
    names = [n for n, _ in model.named_parameters()]
    nondet, bad = [], {}
    for n, a, b, g in zip(names, plain[0][1], plain[1][1], rec[1][1]):
        if torch.equal(a, b):
            if not torch.equal(g, b):
                bad[n] = float((g.float() - b.float()).abs().max())
        else:
            nondet.append(n)
            spread = (a.float() - b.float()).abs().max()
            if (g.float() - b.float()).abs().max() > spread:
                bad[n] = float((g.float() - b.float()).abs().max())
    check(torch.equal(rec[1][0], plain[1][0]) or not torch.equal(
        plain[0][0], plain[1][0]), f"recompute loss {float(rec[1][0])} != "
        f"{float(plain[1][0])}")
    check(not bad, f"recompute grads differ from recompute=False: {bad}")
    out = {"layers": L, "seq": CKPT_SEQ, "batch": CKPT_BATCH,
           "dtype": "bfloat16", "loss": float(rec[1][0]),
           "loss_plain": float(plain[1][0]),
           "grads_bitwise": len(names) - len(nondet),
           "grads_nondeterministic": nondet,
           "launches": rec[1][2], "launches_plain": plain[1][2],
           "step_ms": rec[1][3], "step_ms_plain": plain[1][3]}
    del model, plain, rec
    release(torch)
    out["phase_s"] = time.perf_counter() - t0
    log(f"recompute at llama_7b width ({L} layers, S={CKPT_SEQ}, B="
        f"{CKPT_BATCH}, bf16): loss {out['loss']} = {out['loss_plain']}, "
        f"{out['grads_bitwise']} of {len(names)} grads bitwise (the others "
        f"within two plain runs' spread: {nondet}); forward + backward "
        f"{out['step_ms']:.1f} ms vs {out['step_ms_plain']:.1f} ms without; "
        f"launches {out['launches']}; {args.card}")
    return out


def pp_launches(mesh, key):
    """One kernel's launches a step by rank on the dp2 x pp2 legs."""
    return {f"pp2_dp2_{sched}_by_rank": [
        r[key] for r in mesh["pp2_dp2"][sched]["launches_per_step"]]
        for sched in ("1f1b", "vpp")}


def phase_mesh(torch, args, LlamaConfig, LlamaForCausalLM, build, AdamW):
    """Multi-GPU training, part 1, on ranks that are processes: by default
    sharing the one card over gloo (NCCL refuses two ranks on one device);
    with ``--mesh-backend nccl`` one card a rank over NCCL (4 cards). The
    kernels are built before the ranks start (the file lock in _build.py
    makes a rank load that build); each rank has a deadline. Returns the
    mesh line's dict."""
    backend = args.mesh_backend
    if backend == "nccl":
        check(torch.cuda.device_count() >= 4,
              f"--mesh-backend nccl needs 4 cards, found "
              f"{torch.cuda.device_count()}")
    root = os.path.join(args.mesh_dir, "ranks")
    t0 = time.perf_counter()
    release(torch)
    want_losses, want_state = small_mesh_run(
        torch, LlamaConfig, LlamaForCausalLM, build, AdamW)
    release(torch)
    dp_mp = run_ranks("dp_mp", 4, root, args.seed, backend)
    small = dp_mp[0]["small"]
    for res in dp_mp:
        check(np.allclose(res["small"]["losses"], want_losses, rtol=1e-5),
              f"dp2 x mp2 fp32 losses {res['small']['losses']} vs one rank "
              f"{want_losses}")
    apart = {n: int((~np.isclose(small["state"][n], want, rtol=1e-4,
                                 atol=1e-5)).sum())
             for n, want in want_state.items()}
    check(sum(apart.values()) == 0,
          "dp2 x mp2 fp32 parameters differ from one rank's: "
          + str({n: c for n, c in apart.items() if c}))
    log(f"mesh dp2 x mp2 fp32 (small): losses {small['losses']} = one "
        f"rank's {want_losses} (rtol 1e-5), parameters at rtol 1e-4 / atol "
        f"1e-5 after 3 steps")
    trains = [res["train"] for res in dp_mp]
    for r, tr in enumerate(trains):
        check(all(np.isfinite(tr["losses"])), f"rank {r}: non-finite loss "
              f"{tr['losses']}")
        check(tr["losses"][-1] < tr["losses"][0],
              f"rank {r}: loss did not fall: {tr['losses']}")
        L = MESH_LAYERS
        want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "multi_tensor_sumsq": 1, "multi_tensor_adam": 1}
        got = {k: tr["launches"][k] / MESH_STEPS for k in want}
        check(got == want, f"dp2 x mp2 rank {r}: launches a step {got}, "
              f"want {want}")
    # every rank (so every rank of each dp group) reports the same loss
    check(all(t["losses"] == trains[0]["losses"] for t in trains),
          "ranks report different losses")
    sep_tp = run_ranks("sep_tp_quant", 2, root, args.seed, backend)
    L = MESH_LAYERS
    for res in sep_tp:
        i = res["sep_rank"]
        for mode, blocks in (("ring", i + 1), ("ulysses", 1)):
            tr = res[mode]
            check(all(np.isfinite(tr["losses"])),
                  f"sep2 {mode}: non-finite loss {tr['losses']}")
            want = {"flash_fwd": 2 * L * blocks, "flash_bwd_dq": L * blocks,
                    "flash_bwd_dkv": L * blocks}
            got = {k: tr["launches"][k] / SEP_STEPS for k in want}
            check(got == want, f"sep2 {mode} rank {i}: launches a step "
                  f"{got}, want {want} (rank i meets i + 1 ring blocks)")
        rc = res["ring_check"]
        check(not rc["bad"], f"sep2 rank {i}: ring attention disagrees with "
              f"flash attention on the whole sequence: {rc['bad']} "
              f"{rc['max_abs_err']} ({rc['tol_share']} of tol)")
        ring0, uly0 = res["ring"]["losses"][0], res["ulysses"]["losses"][0]
        check(abs(ring0 - uly0) <= 2.0 ** -7 * abs(uly0),
              f"sep2 first loss: ring {ring0} vs ulysses {uly0}")
        tp = res["tp"]
        check(not tp["bad"], f"TP fused CE disagrees with the unsharded "
              f"kernels: {tp['bad']} {tp['max_abs_err']}")
        check(tp["launches"] == {"fused_ce_fwd": 1, "fused_ce_bwd_dh": 1,
                                 "fused_ce_bwd_dw": 1},
              f"TP fused CE launches {tp['launches']}")
        exact = res["exact"]["losses"]
        for wire in ("int8", "fp8"):
            q = res[wire]
            check(np.allclose(q["losses"], exact,
                              rtol=QUANT_LOSS_RTOL[wire]),
                  f"{wire} grad sync losses {q['losses']} vs exact {exact}")
            sc = res["sync_check"][wire]
            check(sc["tol_share"] <= 1.0, f"{wire} grad sync of synthetic "
                  f"grads off their exact mean: {sc}")
            sync = [s for k, s in q["comm"].items()
                    if k.startswith("trainer.grad_sync/all_reduce")
                    and s["quantized"] == wire]
            check(sync, f"{wire}: no quantized grad-sync record")
            share = sum(s["bytes_wire"] for s in sync) / sum(
                s["bytes_logical"] for s in sync)
            q["wire_share"] = share
            if wire == "int8":
                check(share <= INT8_WIRE_SHARE,
                      f"int8 wire / logical {share:.4f} > "
                      f"{INT8_WIRE_SHARE}")
    pp_res, axis4 = phase_mesh_pp(torch, args, root, backend)
    slice12 = phase_ckpt_moe(torch, args, root, backend)
    r0 = sep_tp[0]
    mesh = {
        "backend": MESH_LABEL[backend], "claim": "none: a smoke run "
        "(gloo carries every collective through the host); times "
        "labelled, no bound claimed",
        "dp2_mp2": {
            "layers": MESH_LAYERS, "seq": MESH_SEQ, "batch": MESH_BATCH,
            "steps": MESH_STEPS, "losses": trains[0]["losses"],
            "step_ms_p50_rank0": trains[0]["step_ms_p50"],
            "peak_mem_gib": [t["peak_mem_gib"] for t in trains],
            "params_local": trains[0]["params_local"],
            "launches_per_step": {k: v / MESH_STEPS for k, v in
                                  trains[0]["launches"].items()},
            "comm_rank0": trains[0]["comm"],
            "small_fp32_losses": small["losses"]},
        "sep2": {mode: {
            "seq": SEP_SEQ, "warmup_steps": SEP_WARMUP, "steps": SEP_STEPS,
            "losses": [res[mode]["losses"] for res in sep_tp],
            "step_ms_p50": [res[mode]["step_ms_p50"] for res in sep_tp],
            "peak_mem_gib": [res[mode]["peak_mem_gib"] for res in sep_tp],
            "launches_per_step": [{k: v / SEP_STEPS for k, v in
                                   res[mode]["launches"].items()
                                   if k.startswith("flash")}
                                  for res in sep_tp],
            "comm_rank0": r0[mode]["comm"]} for mode in ("ring", "ulysses")},
        "ring_check": {k: [res["ring_check"][k] for res in sep_tp]
                       for k in ("max_abs_err", "tol_share")},
        "tp_fused_ce": {"N": TP_N, "H": TP_H, "V": TP_V,
                        **{k: [res["tp"][k] for res in sep_tp] for k in
                           ("max_abs_err", "tol_share", "tp_ms",
                            "unsharded_ms", "launches")}},
        "quantized_dp2": {
            "layers": QUANT_LAYERS, "seq": QUANT_SEQ, "steps": QUANT_STEPS,
            "exact_losses": r0["exact"]["losses"],
            "loss_rtol": QUANT_LOSS_RTOL,
            "sync_check": [res["sync_check"] for res in sep_tp],
            **{w: {"losses": r0[w]["losses"],
                   "wire_share": r0[w]["wire_share"],
                   "step_ms_p50": r0[w]["step_ms_p50"],
                   "comm_rank0": r0[w]["comm"]} for w in ("int8", "fp8")},
            "exact_step_ms_p50": r0["exact"]["step_ms_p50"]},
        "pp2_dp2": {sched: {
            "layers": PP_LAYERS, "seq": PP_SEQ, "batch": PP_BATCH,
            "n_microbatches": PP_MICRO, "n_virtual": pp_res[0][sched][
                "n_virtual"], "warmup_steps": PP_WARMUP,
            "steps": PP_STEPS, "losses": pp_res[0][sched]["losses"],
            **{k: [res[sched][k] for res in pp_res] for k in (
                "stage", "step_ms_p50", "peak_mem_gib", "params_model",
                "params_local", "ticks", "busy_ticks", "idle_share",
                "stash_peak", "handoff_bytes_sent", "handoff_bytes_staged",
                "bytes_staged_all", "zero_axis", "zero_sharded",
                "zero_tensors", "state_share")},
            "launches_per_step": [{k: v / PP_STEPS for k, v in
                                   res[sched]["launches"].items()}
                                  for res in pp_res],
            "comm_rank0": pp_res[0][sched]["comm"]}
            for sched in ("1f1b", "vpp")},
        "pp_small_fp32": {sched: {
            "losses": pp_res[0]["small"][sched]["losses"],
            "state_share": [res["small"][sched]["state_share"]
                            for res in pp_res]}
            for sched in ("gpipe", "1f1b_compact")},
        "axis4": axis4,
        "ckpt_dp_mp": slice12["ckpt_dp_mp"], "moe_ep": slice12["moe_ep"],
        "ckpt_moe_phase_s": slice12["phase_s"],
        "phase_s": time.perf_counter() - t0,
    }
    log(f"mesh ({MESH_LABEL[backend]}): dp2 x mp2 step p50 "
        f"{mesh['dp2_mp2']['step_ms_p50_rank0']:.0f} ms (rank 0), losses "
        f"{trains[0]['losses']}; sep2 ring / ulysses first loss "
        f"{r0['ring']['losses'][0]:.4f} / {r0['ulysses']['losses'][0]:.4f}; "
        f"TP fused CE {[res['tp']['tp_ms'] for res in sep_tp]} ms vs "
        f"unsharded {[res['tp']['unsharded_ms'] for res in sep_tp]}; int8 "
        f"wire share {r0['int8']['wire_share']:.4f}, fp8 "
        f"{r0['fp8']['wire_share']:.4f}; {mesh['phase_s']:.1f}s")
    return mesh


# ---------------------------------------------------------------------------
# phase_deepfm: DeepFM over a row-sharded table, each step one CUDA graph
# ---------------------------------------------------------------------------

# deepfm.py's default widths (9-wide factors, 13 dense features, 26 fields,
# a 512-256-128 DNN) over 2**24 hashed rows: two fp32 tables of 16.8M x 9
# and 16.8M x 1 (0.67 GB) and 1.3 GB of Adam moments
DEEPFM_ROWS, DEEPFM_BATCH = 1 << 24, 512
DEEPFM_WARMUP, DEEPFM_STEPS, DEEPFM_MESH_STEPS = 3, 20, 3
DEEPFM_ZIPF = 1.1              # power-law id frequencies
DEEPFM_CYCLE = 4               # distinct batches, cycled over the steps
DEEPFM_LOSS_RTOL = 1e-4        # dp > 1 against dp1 (the exchange's sums)


def deepfm_batches(torch, seed, n, batch, cycle=None):
    """``n`` seeded batches (``cycle`` distinct ones repeated, default
    all distinct), made in bulk and moved to the card once: 26 fields of
    power-law (Zipf) ids spread over 2**32 raw ids (a field's frequent ids
    repeat, so the exchange's unique does work), 13 normal dense features,
    labels from a noisy linear rule of the dense ones."""
    if cycle:
        made = deepfm_batches(torch, seed, cycle, batch)
        return [made[i % cycle] for i in range(n)]
    rng = np.random.RandomState(seed + 40)
    z = rng.zipf(DEEPFM_ZIPF, (n, batch, 26)).astype(np.uint64)
    field = np.arange(26, dtype=np.uint64)
    with np.errstate(over="ignore"):
        raw = (z * np.uint64(0x9E3779B1) + field * np.uint64(0x85EBCA77)) \
            & np.uint64(0xFFFFFFFF)
    dense = rng.randn(n, batch, 13).astype(np.float32)
    y = (dense[..., :1] + 0.5 * rng.randn(n, batch, 1) > 0).astype(
        np.float32)
    sparse = torch.from_numpy(raw.astype(np.int64)).to(DEVICE)
    dense_t = torch.from_numpy(dense).to(DEVICE)
    y_t = torch.from_numpy(y).to(DEVICE)
    return [{"sparse": sparse[i], "dense": dense_t[i], "y": y_t[i]}
            for i in range(n)]


def deepfm_distinct(batches) -> float:
    """Distinct hashed rows over looked-up ids, averaged over batches."""
    from paddle_tpu_torch.distributed.embedding import hash_bucket
    shares = [float(hash_bucket(b["sparse"], DEEPFM_ROWS, True).unique()
                    .numel()) / b["sparse"].numel() for b in batches]
    return float(np.mean(shares))


def deepfm_train(torch, batches, seed, mesh=None, capture_on=True):
    """DeepFM (hashed ids, 2**24 rows) trained by ``compile_train_step``
    with Adam(1e-3) and the binary cross-entropy over ``batches``, capture
    on or off: the losses, host ms a step (ending in the loss's read), the
    capture tier's counters, the program, the U1/U2 launches and comms
    sites of the run, memory_stats and the peak."""
    from paddle_tpu_torch.distributed import comms
    from paddle_tpu_torch.jit import capture
    from paddle_tpu_torch.models import DeepFM
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import compile_train_step
    release(torch)
    capture.set_step_capture_enabled(capture_on)
    try:
        model = DeepFM(DEEPFM_ROWS, hash_ids=True, device=DEVICE, seed=seed,
                       mesh=mesh)
        opt = Adam(learning_rate=1e-3, parameters=model.parameters())
        step = compile_train_step(
            model, lambda m, b: F.binary_cross_entropy_with_logits(
                m(b["sparse"], b["dense"]), b["y"]), opt, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        capture.capture_clear()
        comms.comm_clear()
        mt.multi_tensor_sumsq_finite.launches = 0   # the run starts here
        mt.multi_tensor_adam.launches = 0
        losses, step_ms = [], []
        for b in batches:
            t0 = time.perf_counter()
            losses.append(float(step(b)))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        prog = step.captured_program
        out = {"losses": losses, "step_ms": step_ms,
               "capture": {k: v for k, v in capture.capture_info().items()
                           if k != "enabled"},
               "program_kernels": None if prog is None
               else prog.kernel_launches(),
               "program_ops": None if prog is None else prog.num_ops,
               "comm_tagged": None if prog is None
               else prog.pass_report.comm_tagged,
               "launches": {
                   "multi_tensor_sumsq": mt.multi_tensor_sumsq_finite.launches,
                   "multi_tensor_adam": mt.multi_tensor_adam.launches},
               "memory_stats": step.memory_stats(batches[0])._asdict(),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "params": sum(p.numel() for p in model.parameters()),
               "sites": comm_sites(comms, len(batches)),
               "shards": model.emb_factor.shards}
    finally:
        capture.set_step_capture_enabled(True)
    del model, opt, step
    release(torch)
    return out


def loss_spread(a, b) -> float:
    """Largest relative difference of two loss lists."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def job_deepfm_dp(torch, rank, seed):
    """DeepFM over a dp mesh of every rank, each its rows of both tables
    and ``DEEPFM_BATCH`` rows of each global batch: exact (capture on:
    a graph over NCCL, a counted gloo bailout), then inside
    ``comms.quantized("int8")``."""
    from paddle_tpu_torch.distributed import comms, get_world_size
    from paddle_tpu_torch.parallel import init_mesh
    world = get_world_size()
    mesh = init_mesh({"dp": world})
    batches = deepfm_batches(torch, seed, DEEPFM_MESH_STEPS,
                             DEEPFM_BATCH * world)
    exact = deepfm_train(torch, batches, seed, mesh=mesh)
    with comms.quantized("int8"):
        quant = deepfm_train(torch, batches, seed, mesh=mesh)
    return {"rank": rank, "exact": exact, "int8": quant}


MESH_JOBS["deepfm_dp"] = job_deepfm_dp


def phase_deepfm(torch, args):
    """DeepFM at deepfm.py's default widths over 2**24 hashed rows, batch
    ``DEEPFM_BATCH`` a rank, Adam(1e-3). One card: ``DEEPFM_WARMUP +
    DEEPFM_STEPS`` steps over ``DEEPFM_CYCLE`` batches in turn, captured (one
    CUDA graph a step: 0 bailouts, one replay a step after the first, U1/U2
    once a step through the replays) and the same steps eager
    (``PT_STEP_CAPTURE=0``'s switch), the losses equal (bitwise, else within
    two eager runs' spread), finite and falling (the last cycle's mean below
    the first's). Then the mesh: over gloo 2 ranks sharing the card (the step
    bails out of capture, counted; the exchange's sites recorded; the losses
    equal dp1's on the same global batches at DEEPFM_LOSS_RTOL; int8: rows wire
    / logical <= 0.27, last loss within 10% of exact), or over NCCL 4 ranks a
    card each (the step captured, with dp1's gates)."""
    t0 = time.perf_counter()
    backend = args.mesh_backend
    world = 2 if backend == "gloo" else 4
    n = DEEPFM_WARMUP + DEEPFM_STEPS
    batches = deepfm_batches(torch, args.seed, n, DEEPFM_BATCH,
                             DEEPFM_CYCLE)
    distinct = deepfm_distinct(batches[:DEEPFM_CYCLE])
    cap = deepfm_train(torch, batches, args.seed)
    eager = deepfm_train(torch, batches, args.seed, capture_on=False)
    spread, exact_eq = 0.0, cap["losses"] == eager["losses"]
    if not exact_eq:
        again = deepfm_train(torch, batches, args.seed, capture_on=False)
        spread = loss_spread(again["losses"], eager["losses"])
        check(loss_spread(cap["losses"], eager["losses"]) <= 2 * spread,
              f"DeepFM captured losses {cap['losses']} vs eager "
              f"{eager['losses']}: beyond two eager runs' spread {spread}")
    ls = cap["losses"]
    check(all(np.isfinite(ls)) and np.mean(ls[-DEEPFM_CYCLE:])
          < np.mean(ls[:DEEPFM_CYCLE]),
          f"DeepFM losses not finite and falling over the batch cycle: {ls}")
    info = cap["capture"]
    check(info["bailouts"] == 0 and info["lowerings"] == 1
          and info["hits"] == n - 1 and info["fallback_calls"] == 0,
          f"DeepFM dp1 not one graph replayed a step: {info}")
    check(cap["launches"] == {"multi_tensor_sumsq": n,
                              "multi_tensor_adam": n},
          f"DeepFM U1/U2 launches {cap['launches']} in {n} steps")
    check(cap["program_kernels"] == {"multi_tensor_sumsq_finite": 1,
                                     "multi_tensor_adam": 1},
          f"kernels inside the graph: {cap['program_kernels']}")
    p50 = {k: float(np.percentile(r["step_ms"][DEEPFM_WARMUP:], 50))
           for k, r in (("captured", cap), ("eager", eager))}
    out = {"rows": DEEPFM_ROWS, "batch": DEEPFM_BATCH, "params": cap["params"],
           "distinct_row_share": distinct,
           "dp1": {"losses": ls, "eager_losses": eager["losses"],
                   "bitwise_eager": exact_eq, "eager_spread": spread,
                   "step_ms_p50": p50,
                   "samples_per_s": {k: DEEPFM_BATCH / v * 1e3
                                     for k, v in p50.items()},
                   "capture": info, "program_ops": cap["program_ops"],
                   "kernels_in_graph": cap["program_kernels"],
                   "launches": cap["launches"],
                   "memory_stats": cap["memory_stats"],
                   "peak_mem_gib": {"captured": cap["peak_mem_gib"],
                                    "eager": eager["peak_mem_gib"]}}}
    log(f"deepfm dp1 ({DEEPFM_ROWS} rows, batch {DEEPFM_BATCH}, "
        f"{distinct:.3f} of lookups distinct): step p50 captured "
        f"{p50['captured']:.3f} ms vs eager {p50['eager']:.3f} ms, losses "
        f"{'bitwise' if exact_eq else f'within {spread:.2e}'} eager, "
        f"{info['hits']} replays, graph kernels {cap['program_kernels']}, "
        f"memory {cap['memory_stats']}, peak {cap['peak_mem_gib']:.2f} GiB")
    # the mesh, against dp1 on the same global batches
    mb = deepfm_batches(torch, args.seed, DEEPFM_MESH_STEPS,
                        DEEPFM_BATCH * world)
    ref = deepfm_train(torch, mb, args.seed)["losses"]
    del batches, mb
    release(torch)
    res = run_ranks("deepfm_dp", world, os.path.join(args.mesh_dir, "ranks"),
                    args.seed, backend)
    for r in res:
        ex, q = r["exact"], r["int8"]
        check(loss_spread(ex["losses"], ref) <= DEEPFM_LOSS_RTOL,
              f"DeepFM dp{world} rank {r['rank']} losses {ex['losses']} vs "
              f"dp1 {ref}")
        check(ex["shards"] == world, f"tables split {ex['shards']} ways")
        rows = ex["sites"].get("embedding.rows/all_to_all/dp")
        check(rows is not None and rows["count"] == 2,
              f"the exchange's rows leg: {rows}")
        cinfo = ex["capture"]
        if backend == "gloo":
            check(cinfo["bailouts"] == 1 and cinfo["lowerings"] == 0
                  and "gloo" in cinfo["last_bailout"],
                  f"the gloo step's bailout: {cinfo}")
        else:
            check(cinfo["bailouts"] == 0 and cinfo["lowerings"] == 1
                  and cinfo["hits"] == DEEPFM_MESH_STEPS - 1,
                  f"DeepFM dp{world} not captured: {cinfo}")
            check(ex["comm_tagged"] >= 4, f"comm_tagged {ex['comm_tagged']}")
        qrows = q["sites"]["embedding.rows/all_to_all/dp"]
        share = qrows["bytes_wire"] / qrows["bytes_logical"]
        check(qrows["quantized"] == "int8" and share <= 0.27,
              f"int8 rows leg: {qrows}")
        check(abs(q["losses"][-1] - ex["losses"][-1])
              / abs(ex["losses"][-1]) < 0.1,
              f"int8 last loss {q['losses']} vs exact {ex['losses']}")
    r0 = res[0]
    out[f"dp{world}"] = {
        "backend": backend, "losses": r0["exact"]["losses"], "dp1": ref,
        "spread_vs_dp1": max(loss_spread(r["exact"]["losses"], ref)
                             for r in res),
        "capture": r0["exact"]["capture"],
        "comm_tagged": r0["exact"]["comm_tagged"],
        "step_ms_p50_rank0": float(np.percentile(r0["exact"]["step_ms"],
                                                 50)),
        "sites_rank0": r0["exact"]["sites"],
        "int8": {"losses": r0["int8"]["losses"],
                 "rows_wire_share": r0["int8"]["sites"][
                     "embedding.rows/all_to_all/dp"]["bytes_wire"]
                 / r0["int8"]["sites"]["embedding.rows/all_to_all/dp"][
                     "bytes_logical"]},
        "peak_mem_gib": [r["exact"]["peak_mem_gib"] for r in res]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"deepfm dp{world} ({MESH_LABEL[backend]}): losses "
        f"{out[f'dp{world}']['losses']} vs dp1 {ref} (spread "
        f"{out[f'dp{world}']['spread_vs_dp1']:.2e}), capture "
        f"{out[f'dp{world}']['capture']}, int8 rows wire share "
        f"{out[f'dp{world}']['int8']['rows_wire_share']:.4f}; "
        f"{out['phase_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase_elastic: a supervised data-parallel LLaMA job that loses a rank
# ---------------------------------------------------------------------------

ELASTIC_LAYERS, ELASTIC_SEQ, ELASTIC_BATCH = 1, 2048, 2
ELASTIC_STEPS, ELASTIC_COMMIT_EVERY, ELASTIC_EVENT_AFTER = 6, 2, 3
ELASTIC_DIR = os.path.join("build", "chip_smoke_elastic")
ELASTIC_MIN_FREE_GB = 24
ELASTIC_BUDGET_S = 120.0          # PT_SUPERVISOR_TIMEOUT, the pg's timeout
ELASTIC_HB_S, ELASTIC_LEASE_S = 0.25, 1.0
# the step barrier re-checks the lease roster and the drain counter after
# each slice of this many seconds: the detection's granularity
ELASTIC_BARRIER_SLICE_S = 1.0
ELASTIC_EVENT_LIMIT_S = 420.0     # both workers of one event, then killed
ELASTIC_PHASE_BUDGET_S = 150.0
# U1 a step: over dp TrainStep judges the finite flag on the raw grads
# before the sync and takes the clip's norm from the synced grads
ELASTIC_LAUNCHES = {
    2: {"flash_fwd": 2 * ELASTIC_LAYERS, "flash_bwd_dq": ELASTIC_LAYERS,
        "flash_bwd_dkv": ELASTIC_LAYERS, "multi_tensor_sumsq": 2,
        "multi_tensor_adam": 1},
    1: {"flash_fwd": 2 * ELASTIC_LAYERS, "flash_bwd_dq": ELASTIC_LAYERS,
        "flash_bwd_dkv": ELASTIC_LAYERS, "multi_tensor_sumsq": 1,
        "multi_tensor_adam": 1}}


def elastic_stream(seed):
    """The global-order stream of token sequences (S + 1 ids each), four
    shards of 16, from ``seed``."""
    from paddle_tpu_torch.io import ShardedSampleStream
    rng = np.random.RandomState(seed + 30)
    shards = [[rng.randint(0, 32000, ELASTIC_SEQ + 1).astype(np.int64)
               for _ in range(16)] for _ in range(4)]
    return ShardedSampleStream(shards, seed=seed)


def elastic_build(torch, mesh, seed):
    """LLaMA at llama_7b width cut to ELASTIC_LAYERS layers, remat
    (``LlamaConfig.recompute``), AdamW(1e-4) with a global-norm clip under
    ``DygraphShardingOptimizer`` (ZeRO-1 over dp), in a ``TrainStep``
    whose loss is the valid-token sum (``LossSum``) under bf16 autocast."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        DygraphShardingOptimizer
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import compile_train_step
    from paddle_tpu_torch.parallel.trainer import LossSum
    import torch.nn.functional as F
    cfg = mesh_config(LlamaConfig, ELASTIC_LAYERS, ELASTIC_SEQ,
                      recompute=True)
    model = LlamaForCausalLM(cfg, device=DEVICE, seed=seed, mesh=mesh)
    opt = DygraphShardingOptimizer(AdamW(
        learning_rate=1e-4, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)))

    def loss_fn(m, batch):
        with torch.autocast(DEVICE, dtype=torch.bfloat16):
            logits = m.logits(batch["input_ids"])
        labels = batch["labels"]
        return LossSum(F.cross_entropy(logits.float().flatten(0, 1),
                                       labels.flatten(), reduction="sum"),
                       (labels != -100).sum())
    return model, compile_train_step(model, loss_fn, opt, mesh=mesh)


def elastic_share(step) -> float:
    """This rank's optimizer moments over the whole model's."""
    z = step._zero
    held = sum(v.numel() for st in step._opt_state for v in st.values()
               if hasattr(v, "dim") and v.dim() > 0)
    full = sum(2 * int(np.prod(z.full_shape(k) if z is not None
                               else tuple(p.shape)))
               for k, p in enumerate(step._params))
    return held / full


def elastic_batch(torch, rows):
    ids = torch.from_numpy(np.stack(rows))
    return {"input_ids": ids[:, :-1].to(DEVICE),
            "labels": ids[:, 1:].to(DEVICE)}


def elastic_tensors(step) -> dict:
    """A one-rank step's parameters and optimizer state leaves by their
    ``supervised_state()`` names, as the device tensors themselves."""
    out = {f"params.{n}": p.detach()
           for n, p in zip(step._param_names, step._params)}
    for n, st in zip(step._param_names, step._opt_state):
        out.update({f"opt.{n}.{leaf}": v for leaf, v in st.items()
                    if hasattr(v, "dim")})
    return out


def elastic_oracle(torch, mesh_mod, snap, cursor, gen, seed, against):
    """A fresh dp1 TrainStep (other weights) loaded with the event's state
    ``snap`` (``reshard`` onto the installed one-rank mesh with every
    value given), run from step ``gen`` to ELASTIC_STEPS over the global
    samples from the event's ``cursor``: its losses, and the names of the
    tensors that are not bitwise those of ``against`` (the survivor's)."""
    model, step = elastic_build(torch, mesh_mod.get_mesh(), seed + 1)
    step.reshard(mesh_mod.get_mesh(), state=snap)
    stream = elastic_stream(seed)
    stream.load_state_dict(cursor)
    losses = []
    for _ in range(int(gen), ELASTIC_STEPS):
        rows = [stream.sample_at(stream.pos + j)
                for j in range(ELASTIC_BATCH)]
        stream.advance(ELASTIC_BATCH)
        losses.append(float(step(elastic_batch(torch, rows))))
    mine = elastic_tensors(step)
    bad = sorted(n for n, t in against.items()
                 if not torch.equal(t, mine[n]))
    del model, step, mine
    release(torch)
    return losses, bad


def elastic_worker(argv) -> int:
    """One member of the supervised job (a process of its own, so the
    crash event can SIGKILL it): ``nid root store_port c10d_port event
    seed backend``; over NCCL the parent shows it one card of its own.
    Records go to ``root/steps_<nid>.jsonl`` as they happen."""
    nid, root, port, c10d_port, event, seed, backend = (
        argv[0], argv[1], int(argv[2]), int(argv[3]), argv[4], int(argv[5]),
        argv[6])
    path = os.path.join(root, f"steps_{nid}.jsonl")

    def emit(rec):
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")

    try:
        import datetime
        import torch
        import torch.distributed as dist
        from paddle_tpu_torch.distributed import CheckpointManager
        from paddle_tpu_torch.distributed import reshard as rs
        from paddle_tpu_torch.distributed.launch.elastic import \
            ElasticManager
        from paddle_tpu_torch.distributed.store import TCPStore
        from paddle_tpu_torch.distributed.supervisor import Supervisor
        from paddle_tpu_torch.parallel import mesh as mesh_mod
        from paddle_tpu_torch.utils import native
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        if DEVICE == "cuda":
            torch.cuda.set_device(0)
        counters = mesh_mods()["counters"]
        emit({"kind": "start", "native": native.available(),
              "native_error": native.load_error()})
        store = TCPStore("127.0.0.1", port)
        c10d = dist.TCPStore("127.0.0.1", c10d_port, is_master=False,
                             timeout=datetime.timedelta(
                                 seconds=ELASTIC_BUDGET_S))
        elastic = ElasticManager(store, node_id=nid, np_range=(1, 2),
                                 heartbeat_interval=ELASTIC_HB_S,
                                 timeout=ELASTIC_LEASE_S)
        members = elastic.require_np(2, timeout=ELASTIC_BUDGET_S)

        def world(n, rank, epoch):
            return mesh_mod.elastic_mesh(
                {"dp": n}, rank, store=c10d, prefix=f"{event}/pg{epoch}",
                timeout=ELASTIC_BUDGET_S, device=DEVICE, backend=backend)

        mesh = mesh_mod.reform_world(world(2, sorted(members).index(nid), 0))
        model, step = elastic_build(torch, mesh, seed)
        params, views = step.supervised_state()
        mgr = CheckpointManager(os.path.join(root, "ckpt"), keep_last_k=1)
        sup = Supervisor(
            store=store, elastic=elastic, ckpt=mgr, params=params,
            state=views, stream=elastic_stream(seed),
            batch_size=ELASTIC_BATCH, train_step=step,
            train_mesh=lambda n: world(n, sup.rank, sup.epoch),
            ckpt_every=ELASTIC_COMMIT_EVERY,
            barrier_timeout=ELASTIC_BARRIER_SLICE_S,
            churn_probe=ELASTIC_BUDGET_S / 2)
        sup.bind(2, timeout=ELASTIC_BUDGET_S)
        emit({"kind": "bound", "t": time.time()})
        snaps = {}

        def step_fn(state, mine, s):
            n = len(s.roster)
            if s.events and s.events[-1]["epoch"] not in snaps:
                # the oracle's starting point: the state the event handed
                # the survivor (the generation the rollback read, or the
                # drained state) and the cursor it resumed from
                ev = s.events[-1]
                snaps[ev["epoch"]] = (dict(state), s.stream.state_dict(),
                                      int(ev["steps"]))
            window = [s.stream.sample_at(s.stream.pos + j)
                      for j in range(ELASTIC_BATCH * n)]
            rows = [w for r in range(n) for w in window[r::n]]
            for kern in counters.values():
                kern.launches = 0        # each step is the main path's run
            t0 = time.perf_counter()
            loss = float(step(elastic_batch(torch, rows)))
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            emit({"kind": "step", "step": s.steps_done + 1, "loss": loss,
                  "ms": ms, "n": n, "epoch": s.epoch, "t": time.time(),
                  "share": elastic_share(step),
                  "launches": {k: kern.launches
                               for k, kern in counters.items()}})
            if event == "drain" and nid == "b" \
                    and s.steps_done + 1 == ELASTIC_EVENT_AFTER:
                s.request_stop(leave=True)
            return views

        final = sup.run(step_fn, ELASTIC_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30 \
            if DEVICE == "cuda" else 0.0
        rec = {"kind": "done", "steps_done": sup.steps_done,
               "roster": sup.roster, "events": sup.events,
               "reports": rs.reshard_reports(), "peak_gib": peak,
               "commits": sup.commit_stats}
        if nid == "a":
            sup.close()
            del final, views, sup
            ev = rec["events"][-1]
            full, cur, gen = snaps[ev["epoch"]]
            live = elastic_tensors(step)
            t_or = time.perf_counter()
            rec["oracle"] = elastic_oracle(torch, mesh_mod, full, cur, gen,
                                           seed, live)
            rec["oracle_s"] = time.perf_counter() - t_or
            rec["oracle_from_step"] = gen
            mine = [r["loss"] for r in elastic_records(root, nid)
                    if r["kind"] == "step" and r["epoch"] == ev["epoch"]]
            if mine != rec["oracle"][0] or rec["oracle"][1]:
                # not bitwise: a second oracle run gives the spread
                rec["oracle2"] = elastic_oracle(torch, mesh_mod, full, cur,
                                                gen, seed, live)
            del live, model, step
            rec["b_moment_bytes"] = sum(
                int(np.prod(p.shape)) * np.dtype(p.dtype).itemsize // 2
                for k, p in params.items()
                if k.startswith("opt.") and "dp" in p.spec)
        else:
            sup.close()
        emit(rec)
        elastic.stop()
        store.stop()
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — the parent reports it and fails
        import traceback
        emit({"kind": "error", "trace": traceback.format_exc()})
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)      # skip teardown, where gloo's threads can abort


def elastic_records(root, nid):
    path = os.path.join(root, f"steps_{nid}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def elastic_start(args, event):
    """Start one fresh 6-step run of two workers that loses b: by SIGKILL
    at ``supervisor.detect`` after step 3 (``crash``) or by
    ``request_stop(leave=True)`` after step 3 (``drain``); its own master
    store, c10d store and directory. Returns the run's handles."""
    import shutil
    import datetime
    import torch.distributed as dist
    from paddle_tpu_torch.distributed.store import create_master_store
    root = os.path.abspath(os.path.join(ELASTIC_DIR, event))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    store = create_master_store()
    c10d = dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=ELASTIC_BUDGET_S))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PT_FAULTPOINT", "PT_CRASHPOINT"))}
    env.update(PT_SUPERVISOR_TIMEOUT=str(ELASTIC_BUDGET_S),
               PT_RESHARD_TIMEOUT=str(ELASTIC_BUDGET_S))
    cmd = [sys.executable, os.path.abspath(__file__)]
    run = {"event": event, "root": root, "store": store, "c10d": c10d,
           "procs": {}, "t0": time.perf_counter(), "t_wall0": time.time()}
    for i, nid in enumerate(("a", "b")):
        wenv = dict(env)
        if args.mesh_backend == "nccl":       # one card a worker
            wenv["CUDA_VISIBLE_DEVICES"] = str(
                2 * ("crash", "drain").index(event) + i)
        if event == "crash" and nid == "b":
            wenv.update(PT_FAULTPOINT="supervisor.detect",
                        PT_FAULTPOINT_MODE="crash", PT_FAULTPOINT_HITS="1",
                        PT_FAULTPOINT_SKIP=str(ELASTIC_EVENT_AFTER))
        with open(os.path.join(root, f"worker_{nid}.log"), "wb") as lf:
            run["procs"][nid] = subprocess.Popen(
                cmd + ["--elastic-worker", nid, root, str(store.port),
                       str(c10d.port), event, str(args.seed),
                       args.mesh_backend],
                env=wenv, stdout=lf, stderr=subprocess.STDOUT)
    return run


def elastic_wait(runs):
    """Wait for every worker of ``runs`` (ELASTIC_EVENT_LIMIT_S at most,
    then kill the late ones), stop the runs' stores; each run's ``wall``
    is from its start to its last worker's exit."""
    end = time.monotonic() + ELASTIC_EVENT_LIMIT_S
    try:
        while time.monotonic() < end:
            for run in runs:
                if "wall" not in run and all(
                        p.poll() is not None for p in run["procs"].values()):
                    run["wall"] = time.perf_counter() - run["t0"]
            if all("wall" in run for run in runs):
                break
            time.sleep(0.05)
    finally:
        for run in runs:
            for p in run["procs"].values():
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
            run["store"].stop()
            run.pop("c10d")
            run.setdefault("wall", time.perf_counter() - run["t0"])


def elastic_event(run):
    """The gates and numbers of one finished run (``elastic_start``);
    raises if a gate fails."""
    import signal
    event, root, procs = run["event"], run["root"], run["procs"]
    wall, t_wall0 = run["wall"], run["t_wall0"]
    rcs = {nid: p.returncode for nid, p in procs.items()}
    recs = {nid: elastic_records(root, nid) for nid in procs}

    def log_tail(nid):
        with open(os.path.join(root, f"worker_{nid}.log"), "rb") as f:
            return f.read()[-3000:].decode(errors="replace")
    errs = [f"--- {nid} ---\n{r['trace']}" for nid in recs
            for r in recs[nid] if r["kind"] == "error"]
    tails = [f"--- {nid}, last records ---\n" + "\n".join(
        json.dumps(r)[:400] for r in recs[nid][-6:]) for nid in recs]
    want_b = -signal.SIGKILL if event == "crash" else 0
    check(not errs and rcs["a"] == 0 and rcs["b"] == want_b,
          f"elastic {event}: exit codes {rcs} (b must be {want_b})\n"
          + "\n".join(errs + tails)
          + f"\n{log_tail('a')}\n{log_tail('b')}")
    for nid in recs:
        start = recs[nid][0]
        check(start["kind"] == "start" and start["native"],
              f"elastic {event}: {nid} ran the Python store fallback "
              f"(native runtime: {start.get('native_error')})")
    done = next(r for r in recs["a"] if r["kind"] == "done")
    steps_a = [r for r in recs["a"] if r["kind"] == "step"]
    steps_b = [r for r in recs["b"] if r["kind"] == "step"]
    ev = done["events"][-1]
    check(len(done["events"]) == 1 and ev["new_size"] == 1
          and ev["old_size"] == 2 and done["roster"] == ["a"]
          and done["steps_done"] == ELASTIC_STEPS,
          f"elastic {event}: events {done['events']}, roster "
          f"{done['roster']}, steps {done['steps_done']}")
    for nid, steps in (("a", steps_a), ("b", steps_b)):
        for r in steps:
            want = ELASTIC_LAUNCHES[r["n"]]
            check(r["launches"] == {**r["launches"], **want},
                  f"elastic {event}: {nid} step {r['step']} at dp"
                  f"{r['n']} launched {r['launches']}, want {want}")
            check(abs(r["share"] - 1.0 / r["n"]) < 1e-9,
                  f"elastic {event}: {nid} holds {r['share']} of the Adam "
                  f"state at dp{r['n']}")
            check(np.isfinite(r["loss"]), f"elastic {event}: loss "
                                          f"{r['loss']}")
    before = [r for r in steps_a if r["epoch"] == 0]
    after = [r for r in steps_a if r["epoch"] >= 1]
    check(len(before) == ELASTIC_EVENT_AFTER and all(
        r["n"] == 2 for r in before) and all(r["n"] == 1 for r in after)
        and [r["step"] for r in after] == list(range(
            int(ev["steps"]) + 1, ELASTIC_STEPS + 1)),
        f"elastic {event}: steps {[(r['step'], r['n']) for r in steps_a]}")
    replayed = len(before) - int(ev["steps"])
    losses, bad = done["oracle"]
    got = [r["loss"] for r in after]
    bitwise = got == losses and not bad
    spread = within = None
    if not bitwise:
        again = done["oracle2"][0]
        spread = max(abs(x - y) for x, y in zip(losses, again))
        gap = max(abs(x - y) for x, y in zip(losses, got))
        within = gap <= spread
        log(f"elastic {event}: NOT bitwise the oracle (losses {got} vs "
            f"{losses}, max gap {gap}); two oracle runs differ by {spread}: "
            f"{'within' if within else 'OUTSIDE'} that spread")
    reports = [r for r in done["reports"] if r["owner"] == "a"]
    rep = reports[-1] if reports else None
    out = {
        "b_exit": rcs["b"], "wall_s": wall, "cause": ev["cause"],
        "rung": ev["how"], "generation": ev["generation"],
        "event_steps": ev["steps"], "replayed_steps": replayed,
        "detect_latency_s": ev["detect_latency_s"],
        "downtime_s": ev["downtime_s"],
        "stall_s": max(b["t"] - a["t"] for a, b in
                       zip(steps_a, steps_a[1:])),
        "bytes_moved": ev["bytes_moved"],
        "bytes_local": rep["bytes_local"] if rep else 0,
        "bytes_from_ckpt": rep["bytes_from_ckpt"] if rep else None,
        "naive_bytes": rep["naive_bytes"] if rep else None,
        "reshard_s": rep["downtime_s"] if rep else None,
        "store_gbps": (ev["bytes_moved"] / rep["downtime_s"] / 1e9
                       if rep and ev["bytes_moved"] else None),
        "commit_s": ev["commit_wall_s"], "commit_bytes": ev["commit_bytes"],
        "commits_a": [(c["step"], c.get("wall_s"), c.get("bytes"))
                      for c in done["commits"]],
        "start_to_bound_s": {
            nid: next(r["t"] for r in recs[nid] if r["kind"] == "bound")
            - t_wall0 for nid in recs
            if any(r["kind"] == "bound" for r in recs[nid])},
        "oracle_s": done.get("oracle_s"),
        "losses": [(r["step"], r["loss"]) for r in steps_a],
        "oracle_losses": losses, "oracle_unequal_tensors": bad,
        "bitwise": bitwise, "spread": spread,
        "within_spread": within,
        "step_ms_p50": {
            "dp2": float(np.percentile([r["ms"] for r in before], 50)),
            "dp1": float(np.percentile([r["ms"] for r in after], 50))},
        "peak_gib": {"a": done["peak_gib"]},
        "launches_per_step": {
            f"dp{r['n']}": {k: r["launches"][k] for k in ELASTIC_LAUNCHES[1]}
            for r in (before[0], after[0])},
        "share": {"before": before[-1]["share"], "after": after[-1]["share"]},
    }
    check(ev["downtime_s"] < ELASTIC_BUDGET_S,
          f"elastic {event}: event took {ev['downtime_s']:.1f}s")
    if event == "drain":
        bdone = next(r for r in recs["b"] if r["kind"] == "done")
        out["peak_gib"]["b"] = bdone["peak_gib"]
        out["b_moment_bytes"] = done["b_moment_bytes"]
        check(ev["cause"] == "drain" and replayed == 0,
              f"elastic drain: cause {ev['cause']}, {replayed} replayed")
        check(ev["bytes_moved"] == done["b_moment_bytes"],
              f"elastic drain: moved {ev['bytes_moved']} bytes, b's moment "
              f"shards are {done['b_moment_bytes']}")
    else:
        out["b_died_after_step"] = steps_b[-1]["step"] if steps_b else 0
    return out, bitwise or bool(within)


def phase_elastic(torch, args):
    """The elastic tier on the card: the parent hosts the master store
    (native runtime) and the process groups' c10d store; two worker
    processes, each an ElasticManager and a Supervisor over a dp2
    TrainStep, share the card over gloo, or (``--mesh-backend nccl``)
    each hold a card of their own over NCCL (the crash fleet cards 0-1,
    the drain fleet 2-3); the crash and the drain event run at the same
    time, two fleets of two workers. Over NCCL the survivor aborts the
    old world's communicators before it re-forms the group
    (``mesh.reform_world``)."""
    from paddle_tpu_torch.utils import native
    check(native.available(), "elastic: the native host runtime did not "
                              f"load: {native.load_error()}")
    if args.mesh_backend == "nccl":
        check(torch.cuda.device_count() >= 4,
              f"the NCCL elastic form needs 4 cards, found "
              f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    out = {"card": args.card, "backend": args.mesh_backend,
           "layers": ELASTIC_LAYERS,
           "seq": ELASTIC_SEQ, "batch_per_rank": ELASTIC_BATCH,
           "steps": ELASTIC_STEPS, "commit_every": ELASTIC_COMMIT_EVERY,
           "event_after_step": ELASTIC_EVENT_AFTER,
           "lease_ttl_s": 2 * ELASTIC_HB_S + ELASTIC_LEASE_S}
    import shutil
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    os.makedirs(ELASTIC_DIR)
    free_gb = shutil.disk_usage(ELASTIC_DIR).free / 1e9
    check(free_gb >= ELASTIC_MIN_FREE_GB,
          f"elastic: {free_gb:.1f} GB free under {ELASTIC_DIR}, need "
          f"{ELASTIC_MIN_FREE_GB}")
    # the two events run at the same time, each its own fleet (stores,
    # process groups, generations): their numbers include the other's load
    runs = [elastic_start(args, event) for event in ("crash", "drain")]
    elastic_wait(runs)
    for run in runs:
        event = run["event"]
        out[event], bitwise = elastic_event(run)
        log(json.dumps({"elastic_event": {event: out[event]}}))
        check(bitwise, f"elastic {event}: the survivor's losses and state "
                       f"are neither bitwise the oracle's nor within two "
                       f"oracle runs' spread: {out[event]['losses']} vs "
                       f"{out[event]['oracle_losses']}")
    out["phase_s"] = time.perf_counter() - t0
    out["within_budget"] = out["phase_s"] <= ELASTIC_PHASE_BUDGET_S
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    log(json.dumps({"elastic": out}))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--elastic-worker"]:
        return elastic_worker(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    ap.add_argument("--mesh-backend", choices=("gloo", "nccl"),
                    default="gloo",
                    help="the mesh phase's backend: gloo, every rank on "
                         "the one card (the default), or nccl, one card a "
                         "rank (needs 4 cards)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels and run the mesh phase alone")
    ap.add_argument("--elastic-only", action="store_true",
                    help="build the kernels and run the elastic phase "
                         "alone")
    ap.add_argument("--eager-only", action="store_true",
                    help="build the kernels and run the eager phase alone")
    ap.add_argument("--nn-only", action="store_true",
                    help="build the kernels and run the nn sweep alone")
    ap.add_argument("--gpt-only", action="store_true",
                    help="build the kernels and run the GPT phase alone")
    ap.add_argument("--vision-only", action="store_true",
                    help="build the kernels and run the vision phase "
                         "(ResNet-50, CRNN, DBNet) alone")
    ap.add_argument("--bert-only", action="store_true",
                    help="build the kernels and run the BERT phase alone")
    ap.add_argument("--measure-only", action="store_true",
                    help="build the kernels and run the measurement-API "
                         "phase alone")
    ap.add_argument("--deepfm-only", action="store_true",
                    help="build the kernels and run the DeepFM phase "
                         "alone (with --elastic-only: both)")
    ap.add_argument("--static-only", action="store_true",
                    help="build the kernels and run the static/compile "
                         "tier's phases alone (to_static, the static "
                         "Program, deployment)")
    args = ap.parse_args(argv)
    # the mesh phase's ranks meet (FileStore) and leave their results here
    args.mesh_dir = os.path.join(os.path.dirname(args.out), "mesh") \
        if args.out else os.path.join("build", "chip_smoke_mesh")

    t_start = time.perf_counter()
    card_id = use_one_card() if args.mesh_backend == "gloo" else "0"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card only", file=sys.stderr)
        return 2
    from paddle_tpu_torch.inference.serving import (RequestState,
                                                    ServingEngine)
    from paddle_tpu_torch.jit import capture
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               build_hybrid_train_step)
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import fused_ce as fce
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        ragged_decode_attention as attn, ragged_decode_attention_ref)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import compile_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power(card_id)
    args.card = card
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")

    build_s = _build.build(force=True)
    _build.library()
    log(f"built {', '.join(_build.SOURCES)} -> {_build.LIB_PATH} with nvcc "
        f"(sm_90a, one process per source) in {build_s:.1f}s")
    if args.nn_only or args.gpt_only or args.measure_only or \
            args.vision_only or args.bert_only:
        import paddle_tpu_torch as P
        alone = {}
        if args.nn_only:
            alone["nn_sweep"] = phase_nn_sweep(torch, P)
        if args.gpt_only:
            alone["gpt"] = phase_gpt(torch, args, P, fa, mt)
        if args.vision_only:
            alone["vision"] = phase_vision(torch, args, P, fa, mt)
        if args.bert_only:
            alone["bert"] = phase_bert(torch, args, P, fa, mt)
        if args.measure_only:
            alone["measure"] = phase_measure(torch, args, LlamaConfig,
                                             LlamaForCausalLM, P, fa, mt)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump({"card": card, "kind": kind, "build_s": build_s,
                           **alone}, f, indent=1)
        for key, val in alone.items():
            log(json.dumps({key: val}))
        log(f"chip_smoke {' '.join(argv)} total "
            f"{time.perf_counter() - t_start:.1f}s")
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.static_only:
        import paddle_tpu_torch as P
        static_tier = phase_static(torch, args, P, fa, mt)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump({"card": card, "kind": kind, "build_s": build_s,
                           "static": static_tier}, f, indent=1)
        log(json.dumps({"static": static_tier}))
        log(f"chip_smoke --static-only total "
            f"{time.perf_counter() - t_start:.1f}s")
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.eager_only:
        eager = phase_eager(torch, args, LlamaConfig, LlamaForCausalLM,
                            build_hybrid_train_step, AdamW, fa, mt)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump({"card": card, "kind": kind, "build_s": build_s,
                           "eager": eager}, f, indent=1)
        log(json.dumps({"eager": eager}))
        log(f"chip_smoke --eager-only total "
            f"{time.perf_counter() - t_start:.1f}s")
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.elastic_only or args.deepfm_only:
        alone = {}
        if args.deepfm_only:
            alone["deepfm"] = phase_deepfm(torch, args)
            log(json.dumps({"deepfm": alone["deepfm"]}))
        if args.elastic_only:
            alone["elastic"] = phase_elastic(torch, args)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump({"card": card, "kind": kind, "build_s": build_s,
                           **alone}, f, indent=1)
        log(f"chip_smoke {' '.join(argv)} total "
            f"{time.perf_counter() - t_start:.1f}s")
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.mesh_only:
        mesh = phase_mesh(torch, args, LlamaConfig, LlamaForCausalLM,
                          build_hybrid_train_step, AdamW)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump({"card": card, "kind": kind, "build_s": build_s,
                           "mesh": mesh}, f, indent=1)
        log(json.dumps({"mesh": mesh}))
        log(f"chip_smoke --mesh-only total "
            f"{time.perf_counter() - t_start:.1f}s")
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    case_errs = phase_kernel_cases(torch, attn, ragged_decode_attention_ref)
    flash_cases = phase_flash_cases(torch, fa)
    fce_cases = phase_fce_cases(torch, fce)
    mt_cases = phase_multi_tensor_cases(torch, mt, ClipGradByGlobalNorm)
    phase_small_reference(torch, LlamaConfig, LlamaForCausalLM,
                          ServingEngine, fa)
    model, eng, reqs, specs, serving = phase_serve(
        torch, args, LlamaConfig, LlamaForCausalLM, ServingEngine,
        RequestState, attn, capture)
    agree = phase_teacher_forced(torch, model, reqs, specs)
    prefill_ms, live_lengths = phase_full_batch(
        torch, eng, model.config.vocab_size, args.seed)
    err, live, full = phase_real_caches(
        torch, eng, live_lengths, attn, ragged_decode_attention_ref)
    log(f"decode kernel at full length {eng.max_seq_len}: "
        + json.dumps(full))
    profile = {"lengths": live_lengths.tolist(), "prefill_ms": prefill_ms,
               **phase_decode_profile(torch, eng)}
    capture.set_step_capture_enabled(False)
    profile["eager"] = phase_decode_profile(torch, eng)
    capture.set_step_capture_enabled(True)
    log("decode steps of the full batch, captured vs eager: " + json.dumps(
        {k: (profile[k], profile["eager"][k]) for k in (
            "decode_step_ms_p50", "device_kernel_ms_per_step",
            "device_busy_share", "kernel_launches_per_step",
            "host_launch_calls_per_step")}))
    eng = reqs = None
    release(torch)
    t_phase = time.perf_counter()
    spec = phase_spec(torch, model, ServingEngine, RequestState, attn,
                      capture, args.seed)
    prefix = phase_prefix(torch, model, ServingEngine, RequestState, capture,
                          args.seed)
    chunked = phase_chunked(torch, model, ServingEngine, RequestState,
                            capture, args.seed)
    gateway = phase_gateway(torch, model, ServingEngine, capture, args.seed)
    serving["capture_totals"] = check_no_bailouts(capture, "serving phases")
    serving["feature_phases_s"] = time.perf_counter() - t_phase
    heads = model.config.num_attention_heads
    head_dim = model.config.hidden_size // heads
    model = None                  # free the serving model for training
    release(torch)

    phase_small_train(torch, LlamaConfig, LlamaForCausalLM,
                      build_hybrid_train_step, AdamW)
    trained = {}
    for fused in (False, True):
        tmodel, opt, step, trained[fused] = phase_train(
            torch, args, LlamaConfig, LlamaForCausalLM,
            build_hybrid_train_step, AdamW, fa, fce, mt, fused)
        vocab = tmodel.config.vocab_size
        shapes = [tuple(p.shape) for p in tmodel.parameters()]
        del tmodel, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    training, training_fused = trained[False], trained[True]
    trainstep = phase_trainstep(torch, args, LlamaConfig, LlamaForCausalLM,
                                mt, compile_train_step, GradScaler,
                                ClipGradByGlobalNorm, AdamW, capture)
    gc.collect()
    torch.cuda.empty_cache()
    eager_ts = phase_trainstep(torch, args, LlamaConfig, LlamaForCausalLM,
                               mt, compile_train_step, GradScaler,
                               ClipGradByGlobalNorm, AdamW, capture,
                               capture_on=False)
    gc.collect()
    torch.cuda.empty_cache()
    good = [i for i in range(6) if i != 3]     # the inf step aside

    def finite_losses(res):
        return [res["losses"][i] for i in good]
    trainstep["eager_losses"] = eager_ts["losses"]
    trainstep["eager_step_ms"] = eager_ts["step_ms"]
    trainstep["bitwise_eager"] = \
        finite_losses(trainstep) == finite_losses(eager_ts)
    trainstep["eager_spread"] = 0.0
    if not trainstep["bitwise_eager"]:
        again = phase_trainstep(torch, args, LlamaConfig, LlamaForCausalLM,
                                mt, compile_train_step, GradScaler,
                                ClipGradByGlobalNorm, AdamW, capture,
                                capture_on=False)
        gc.collect()
        torch.cuda.empty_cache()
        trainstep["eager_spread"] = loss_spread(finite_losses(again),
                                                finite_losses(eager_ts))
        check(loss_spread(finite_losses(trainstep), finite_losses(eager_ts))
              <= 2 * trainstep["eager_spread"],
              f"captured TrainStep losses {trainstep['losses']} vs eager "
              f"{eager_ts['losses']}: beyond two eager runs' spread")
    eager = phase_eager(torch, args, LlamaConfig, LlamaForCausalLM,
                        build_hybrid_train_step, AdamW, fa, mt)
    import paddle_tpu_torch as P
    static_tier = phase_static(torch, args, P, fa, mt)
    nn_sweep = phase_nn_sweep(torch, P)
    gpt = phase_gpt(torch, args, P, fa, mt)
    measure = phase_measure(torch, args, LlamaConfig, LlamaForCausalLM, P,
                            fa, mt)
    vision = phase_vision(torch, args, P, fa, mt)
    bert = phase_bert(torch, args, P, fa, mt)
    deepfm = phase_deepfm(torch, args)
    recompute = phase_recompute(torch, args, LlamaConfig, LlamaForCausalLM,
                                fa)
    mesh = phase_mesh(torch, args, LlamaConfig, LlamaForCausalLM,
                      build_hybrid_train_step, AdamW)
    elastic = phase_elastic(torch, args)
    flash = phase_flash_timing(torch, fa, heads, head_dim)
    log(f"flash kernels at B={TRAIN_BATCH} S={TRAIN_SEQ} H={heads} "
        f"D={head_dim} bf16 causal: " + json.dumps(flash))
    head_n = TRAIN_BATCH * TRAIN_SEQ
    fused_ce = phase_fce_timing(torch, fce, head_n, heads * head_dim, vocab)
    log(f"fused CE kernels at N={head_n} H={heads * head_dim} V={vocab} "
        f"bf16: " + json.dumps(fused_ce))
    multi = phase_multi_tensor_timing(torch, mt, shapes)
    log("multi-tensor kernels at the training model's tensors: "
        + json.dumps(multi))

    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    pallas = "paddle_tpu/ops/pallas/flash_attention.py"
    per_step = training["launches_per_step"]
    kernels = {"kernels": [{
        "name": "ragged_decode_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/decode_attention.py:37",
        "launches": serving["kernel_launches"],
        "spec_launches": spec["model"]["kernel_launches"],
        "max_abs_err": err,
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
            "mesh_launches_per_step": {
                "dp2_mp2_each_rank": mesh["dp2_mp2"]["launches_per_step"][
                    name.replace("attention_", "")],
                **{f"sep2_{mode}_by_rank": [
                    r_[name.replace("attention_", "")] for r_ in
                    mesh["sep2"][mode]["launches_per_step"]]
                   for mode in ("ring", "ulysses")},
                **pp_launches(mesh, name.replace("attention_", "")),
                "ckpt_dp_mp_each_rank": mesh["ckpt_dp_mp"][
                    "launches_per_step"][name.replace("attention_", "")]},
            "eager_launches_per_step": eager["launches_per_step"][
                name.replace("attention_", "")],
            "gpt_launches_per_step": gpt["launches_per_step"][
                name.replace("attention_", "")],
            "measure_launches_per_step": measure["launches_per_step"][
                name.replace("attention_", "")],
            "bert_launches_per_step": bert["launches_per_step"][
                name.replace("attention_", "")],
            "resnet50_launches_per_step": vision["resnet50"][
                "launches_per_step"][name.replace("attention_", "")],
            "to_static_launches_per_step": static_tier["to_static"][
                "launches_per_step"][name.replace("attention_", "")],
            "static_program_launches_per_run": static_tier["program"][
                "launches_per_run"][name.replace("attention_", "")],
            **({"deployed_llama_launches_per_run": static_tier["deploy"][
                "llama"]["k2_per_run"], "cpu_artifact_launches":
                static_tier["deploy"]["cpu_artifact"]["k2"]}
               if key == "fwd" else {}),
            "recompute_launches": {
                "recompute": recompute["launches"][
                    name.replace("attention_", "")],
                "plain": recompute["launches_plain"][
                    name.replace("attention_", "")]},
            "elastic_launches_per_step": {
                k: v[name.replace("attention_", "")] for k, v in
                elastic["crash"]["launches_per_step"].items()},
            "entry_points": "flash_attention (sdpa), flash_attention_lse "
                            "(ring attention)",
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
            "tp_launches_by_rank": [t[name] for t in
                                    mesh["tp_fused_ce"]["launches"]],
            "mesh_launches_per_step": pp_launches(mesh, name),
            "entry_points": "fused_linear_cross_entropy, "
                            "fused_linear_cross_entropy_tp (vocab shard)",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "gemm_ms": r["gemm_ms"],
            "library": "unfused head: F.cross_entropy(matmul(h, w).float())"
                       + (" forward" if key == "fwd" else
                          " autograd backward, K6 + K7 together")})
    # U1 and U2 replace no Pallas kernel: "replaces" names the XLA-fused
    # code of the JAX package they stand for; launches are the TrainStep
    # phase's run, the 8-layer training path's U2 launches beside them.
    for name, key, where, lib_name in (
            ("multi_tensor_sumsq_finite", "u1", "paddle_tpu/nn/clip.py:58",
             "torch._foreach_norm(grads): same sums, other rounding, no "
             "finite flag"),
            ("multi_tensor_adam", "u2", "paddle_tpu/optimizer/optimizer.py:81",
             "torch.optim.AdamW(fused=True).step(): same math, other "
             "rounding")):
        r = multi[key]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/multi_tensor.cu",
            "replaces": where,
            "launches": trainstep["launches"][name.replace("_finite", "")],
            "train_launches": per_step[name.replace("_finite", "")]
            * training["steps"],
            "eager_launches_per_step": eager["launches_per_step"].get(
                name.replace("_finite", ""), 0),
            "gpt_launches_per_step": gpt["launches_per_step"].get(
                name.replace("_finite", ""), 0),
            "measure_launches_per_step": measure["launches_per_step"].get(
                name.replace("_finite", ""), 0),
            **{f"{m}_launches_per_step": res["launches_per_step"].get(
                name.replace("_finite", ""), 0) for m, res in (
                    ("bert", bert), ("resnet50", vision["resnet50"]),
                    ("crnn", vision["crnn"]), ("dbnet", vision["dbnet"]))},
            "deepfm_launches": deepfm["dp1"]["launches"][
                name.replace("_finite", "")],
            "to_static_launches_per_step": static_tier["to_static"][
                "launches_per_step"].get(name.replace("_finite", ""), 0),
            "static_program_launches_per_run": static_tier["program"][
                "launches_per_run"].get(name.replace("_finite", ""), 0),
            "mesh_launches_per_step": {
                "dp2_mp2_each_rank": mesh["dp2_mp2"]["launches_per_step"][
                    name.replace("_finite", "")],
                **pp_launches(mesh, name.replace("_finite", "")),
                "ckpt_dp_mp_each_rank": mesh["ckpt_dp_mp"][
                    "launches_per_step"][name.replace("_finite", "")]},
            "elastic_launches_per_step": {
                k: v[name.replace("_finite", "")] for k, v in
                elastic["crash"]["launches_per_step"].items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": lib_name, "elements": r["elements"],
            "tensors": r["tensors"]})
    serving["teacher_forced_agreement"] = agree
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"card": card, "kind": kind, "build_s": build_s,
                       "case_max_abs_err": case_errs,
                       "flash_cases": flash_cases,
                       "fused_ce_cases": fce_cases,
                       "multi_tensor_cases": mt_cases,
                       "multi_tensor_timing": multi, "trainstep": trainstep,
                       "fused_ce_timing": fused_ce,
                       "training_fused": training_fused,
                       "live_lengths": live_lengths.tolist(),
                       "kernel_live": live, "kernel_full": full,
                       "flash_timing": flash, "serving": serving,
                       "decode_profile": profile, "training": training,
                       "spec": spec, "prefix": prefix, "chunked": chunked,
                       "gateway": gateway, "mesh": mesh,
                       "elastic": elastic, "deepfm": deepfm,
                       "eager": eager, "nn_sweep": nn_sweep, "gpt": gpt,
                       "measure": measure, "vision": vision, "bert": bert,
                       "recompute": recompute, "static": static_tier,
                       **kernels}, f, indent=1)
    log(json.dumps({"decode_profile": profile}))
    log(json.dumps({"training": training}))
    log(json.dumps({"training_fused": training_fused}))
    log(json.dumps({"trainstep": trainstep}))
    log(json.dumps({"recompute": recompute}))
    log(json.dumps({"deepfm": deepfm}))
    log(json.dumps({"eager": eager}))
    log(json.dumps({"static": static_tier}))
    log(json.dumps({"nn_sweep": nn_sweep}))
    log(json.dumps({"gpt": gpt}))
    log(json.dumps({"measure": measure}))
    log(json.dumps({"vision": vision}))
    log(json.dumps({"bert": bert}))
    log(json.dumps({"mesh": mesh}))
    log(json.dumps({"elastic": elastic}))
    log(json.dumps(kernels))
    log(json.dumps({"serving": serving}))
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f}s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
