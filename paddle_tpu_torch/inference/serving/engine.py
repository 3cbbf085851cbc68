"""ServingEngine: continuous batching over the ragged decode kernel.

Counterpart of ``paddle_tpu/inference/serving/engine.py`` without
speculative decoding, prefix sharing, chunked prefill and the gateway
(ROADMAP.md Queue 1 lists them; asking for one raises
``NotInThisSlice``). Its parts:

- the batch-slot step (``models/llama.py LlamaForCausalLM.slot_step``):
  per-slot offsets become the per-slot lengths of the ragged decode
  kernel, so every slot decodes at its own position in one
  ``[max_batch, 1]`` step;
- the paged KV pool (``kv_pool.py``) and the scheduler
  (``scheduler.py``): capacity-based admission, join/evict strictly
  between decode steps;
- typed deadlines (``utils/deadline.py``): per-request TTL ->
  RequestTimeout, bounded admission -> EngineOverloaded.

A joining request's prompt is padded on the right to the smallest
prefill bucket and prefilled alone at batch 1 into fresh caches (the logits
of its last real token picked by ``last_pos``); its KV rows are then copied
into its batch slot. Greedy decode returns the on-device argmax ``[B]``
int32, the one host sync per step; ``[B, vocab]`` logits come to the host
only on steps where a sampling slot is active.

Env knobs (read at engine construction):
- ``PT_SERVE_MAX_BATCH``   (default 8)   decode slots
- ``PT_SERVE_PAGE_SIZE``   (default 16)  tokens per KV page
- ``PT_SERVE_MAX_SEQ``     (default: model max_position_embeddings)
- ``PT_SERVE_PREFILL_BUCKETS`` comma list (default: powers of two from 8)
- ``PT_SERVE_MAX_QUEUE``   (default 8 x max_batch) bounded admission
- ``PT_SERVE_SHED_TTL``    (default 0 = off) deadline-aware shedding
- ``PT_SERVE_SPEC_K``, ``PT_SERVE_PREFIX_SHARE``, ``PT_SERVE_PREFILL_CHUNK``:
  features of a later slice; a non-off value raises NotInThisSlice.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...core.errors import NotInThisSlice
from ...distributed.chaos import faultpoint, register_fault
from ...observability import trace
from ...utils.deadline import EngineOverloaded, env_int, env_timeout
from .kv_pool import KVPagePool
from .request import Request, RequestState
from .scheduler import ContinuousBatchingScheduler

__all__ = ["ServingEngine", "SamplingUnsupported", "NotInThisSlice"]

FP_PRESSURE = register_fault(
    "engine.pressure", "every engine step's overload-ladder evaluation "
    "passes here (the admission/degradation control point)")

# overload-ladder hysteresis bands over queue_depth / max_queue: level L is
# entered at _LADDER_ENTER[L] and left below _LADDER_EXIT[L]
_LADDER_ENTER = (0.0, 0.50, 0.75, 0.90)
_LADDER_EXIT = (0.0, 0.25, 0.50, 0.75)


class SamplingUnsupported(NotImplementedError):
    """A submit() asked for sampling this engine cannot honour (a negative
    or non-finite temperature, top_p outside (0, 1], or top_p without a
    positive temperature); rejected up front, never served greedy."""

    def __init__(self, param: str, value, why: str):
        self.param = param
        self.value = value
        super().__init__(
            f"{param}={value!r} cannot be honored: {why}. Pass {param}="
            f"{'0' if param == 'temperature' else '1'} (or omit it) for "
            f"greedy decoding.")


def _normalize_buckets(vals, max_seq_len: int) -> List[int]:
    """Clamp every bucket to the cache extent, dedupe/sort, and end the
    ladder at max_seq_len so every admissible prompt has a bucket."""
    out = sorted({min(int(b), max_seq_len) for b in vals if int(b) > 0})
    if not out or out[-1] < max_seq_len:
        out.append(max_seq_len)
    return out


def _default_buckets(max_seq_len: int) -> List[int]:
    vals = []
    for tok in os.environ.get("PT_SERVE_PREFILL_BUCKETS", "").split(","):
        try:
            vals.append(int(tok))
        except ValueError:
            continue
    if not any(b > 0 for b in vals):
        vals, b = [], 8
        while b < max_seq_len:
            vals.append(b)
            b *= 2
    return _normalize_buckets(vals, max_seq_len)


def _env_on(name: str) -> bool:
    return os.environ.get(name, "0").strip().lower() not in (
        "0", "", "false", "off")


class ServingEngine:
    """Continuous-batching generation over one model's weights, on the
    model's device.

    ``submit()`` may be called from any thread; ``step()``/``run()`` are
    driven by one thread (serialised by a lock).
    """

    def __init__(self, model, max_batch: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 page_size: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 eos_token_id: Optional[int] = None,
                 default_ttl: Optional[float] = None,
                 spec_k: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_sharing: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 shed_ttl: Optional[float] = None):
        spec_k = env_int("PT_SERVE_SPEC_K", 0) if spec_k is None \
            else int(spec_k)
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k:
            raise NotInThisSlice("speculative decoding", f"spec_k={spec_k}")
        prefill_chunk = env_int("PT_SERVE_PREFILL_CHUNK", 0) \
            if prefill_chunk is None else int(prefill_chunk)
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}")
        if prefill_chunk:
            raise NotInThisSlice("chunked prefill",
                                 f"prefill_chunk={prefill_chunk}")
        if prefix_sharing is None:
            prefix_sharing = _env_on("PT_SERVE_PREFIX_SHARE")
        if prefix_sharing:
            raise NotInThisSlice("prefix sharing", "prefix_sharing=True")

        self.model = model
        cfg = model.config
        self.device = model.device
        self.max_batch = max_batch or env_int("PT_SERVE_MAX_BATCH", 8)
        self.max_seq_len = max_seq_len or env_int(
            "PT_SERVE_MAX_SEQ", cfg.max_position_embeddings)
        self.eos_token_id = eos_token_id
        self.default_ttl = default_ttl
        page = page_size or env_int("PT_SERVE_PAGE_SIZE", 16)
        pages_per_slot = -(-self.max_seq_len // page)
        self.pool = KVPagePool(self.max_batch * pages_per_slot, page)
        self.scheduler = ContinuousBatchingScheduler(self.pool, self.max_batch)
        if prefill_buckets:
            if not any(int(b) > 0 for b in prefill_buckets):
                raise ValueError(
                    f"prefill_buckets {list(prefill_buckets)!r} has no "
                    f"positive entry")
            self.buckets = _normalize_buckets(prefill_buckets,
                                              self.max_seq_len)
        else:
            self.buckets = _default_buckets(self.max_seq_len)
        self._caches = model.init_kv_caches(self.max_batch, self.max_seq_len)

        self.max_queue = env_int("PT_SERVE_MAX_QUEUE", 8 * self.max_batch) \
            if max_queue is None else int(max_queue)
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        self.shed_ttl = env_timeout("PT_SERVE_SHED_TTL", 0.0) \
            if shed_ttl is None else float(shed_ttl)
        self._pressure = 0
        self._level_steps = [0, 0, 0, 0]

        self._lock = threading.Lock()   # serialises step()/run()
        self._counters = {"prefills": 0, "decode_steps": 0,
                          "tokens_generated": 0, "rejected": 0,
                          "sampled_tokens": 0, "shed": 0}
        self._occupancy_sum = 0.0
        self._decode_time = 0.0
        self._prefill_time = 0.0

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------
    def _reject(self, exc: BaseException):
        with self._lock:
            self._counters["rejected"] += 1
        raise exc

    def submit(self, prompt_ids, max_new_tokens: int = 16,
               ttl: Optional[float] = None,
               eos_token_id: Optional[int] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None) -> Request:
        """Enqueue one request; returns the live Request handle. Raises a
        ValueError at once when the request can never fit the engine's
        cache layout, SamplingUnsupported for sampling it cannot honour,
        and EngineOverloaded when admission sheds it. ``seed`` makes a
        sampled stream reproducible (default: its rid)."""
        if temperature is not None and not (
                math.isfinite(float(temperature))
                and float(temperature) >= 0.0):
            self._reject(SamplingUnsupported(
                "temperature", temperature, "temperature must be a finite "
                "value >= 0"))
        if top_p is not None and not (
                math.isfinite(float(top_p)) and 0.0 < float(top_p) <= 1.0):
            self._reject(SamplingUnsupported(
                "top_p", top_p, "top_p must lie in (0, 1]"))
        greedy_t = temperature is None or float(temperature) == 0.0
        greedy_p = top_p is None or float(top_p) == 1.0
        if greedy_t and not greedy_p:
            self._reject(SamplingUnsupported(
                "top_p", top_p, "top_p nucleus filtering needs a positive "
                "temperature to define the sampling distribution"))
        req = Request(prompt_ids, max_new_tokens=max_new_tokens,
                      ttl=self.default_ttl if ttl is None else ttl,
                      eos_token_id=self.eos_token_id
                      if eos_token_id is None else eos_token_id,
                      temperature=None if greedy_t else float(temperature),
                      top_p=None if greedy_p else float(top_p),
                      seed=seed)
        total = req.prompt.size + req.max_new_tokens
        if total > self.max_seq_len:
            self._reject(ValueError(
                f"request needs {total} KV positions but the engine's "
                f"static layout holds max_seq_len={self.max_seq_len} — "
                f"shorten the prompt/max_new_tokens or size the engine up"))
        self._admit(req)
        self.scheduler.submit(req)
        trace.event("engine.submit", rid=req.rid,
                    prompt_len=int(req.prompt.size),
                    max_new=req.max_new_tokens)
        return req

    # ------------------------------------------------------------------
    # overload control
    # ------------------------------------------------------------------
    def _admit(self, req: Request) -> None:
        """Shed with EngineOverloaded when the queue is at max_queue, or
        (with shed_ttl on) when the projected queue wait at the measured
        token rate already exceeds the request's TTL."""
        depth = self.scheduler.queue_depth
        if depth >= self.max_queue:
            self._shed(req, depth, f"queue at max_queue={self.max_queue}")
        if self.shed_ttl <= 0:
            return
        budget = req.deadline.timeout
        if budget is None:
            budget = self.shed_ttl
        if budget is not None and budget > 0:
            wait = self._projected_wait(req.max_new_tokens)
            if wait is not None and wait > budget:
                self._shed(req, depth,
                           f"projected queue wait {wait:.3g}s exceeds the "
                           f"{budget:.3g}s deadline budget")

    def _measured_rate(self) -> Optional[float]:
        """Tokens/s measured over this engine's lifetime, None when cold."""
        gen_time = self._decode_time + self._prefill_time
        toks = self._counters["tokens_generated"]
        if gen_time <= 0 or toks <= 0:
            return None
        return toks / gen_time

    def _projected_wait(self, new_tokens: int) -> Optional[float]:
        rate = self._measured_rate()
        if rate is None:
            return None
        return (self.scheduler.backlog_tokens() + new_tokens) / rate

    def _retry_after_ms(self) -> int:
        rate = self._measured_rate()
        if rate is None:
            return 100
        inflight = self.scheduler.queue_depth + self.scheduler.active
        per_slot = self.scheduler.backlog_tokens() / max(1, inflight)
        return max(1, min(60_000, int(1000.0 * per_slot / rate)))

    def _shed(self, req: Request, depth: int, why: str) -> None:
        with self._lock:
            self._counters["rejected"] += 1
            self._counters["shed"] += 1
        retry_ms = self._retry_after_ms()
        trace.event("engine.shed", rid=req.rid, level=self._pressure,
                    queued=depth, retry_after_ms=retry_ms, reason=why)
        raise EngineOverloaded(
            f"serving request {req.rid}", req.deadline.timeout,
            detail=f"{why}; retry after {retry_ms}ms",
            retry_after_ms=retry_ms)

    def _update_pressure(self) -> None:
        """Walk the pressure ladder (queue depth over max_queue, with
        hysteresis). The optional work the JAX engine sheds at levels 1-3
        (prefix tree, speculation, chunk interleave) does not exist in this
        slice, so the level is reported and not acted on."""
        faultpoint(FP_PRESSURE)
        ratio = self.scheduler.queue_depth / float(self.max_queue)
        level = new = self._pressure
        while new < 3 and ratio >= _LADDER_ENTER[new + 1]:
            new += 1
        while new > 0 and ratio < _LADDER_EXIT[new]:
            new -= 1
        if new != level:
            trace.event("engine.pressure", level=new, prev=level,
                        queued=self.scheduler.queue_depth,
                        ratio=round(ratio, 4))
            self._pressure = new
        self._level_steps[self._pressure] += 1

    @property
    def pressure_level(self) -> int:
        """Current pressure level, 0 (healthy) .. 3."""
        return self._pressure

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: scheduler pass (evict/expire/join) ->
        prefill the joiners -> one batched decode step for every active
        slot. Returns the number of tokens produced."""
        with self._lock:
            self._update_pressure()
            joined, _ = self.scheduler.schedule()
            produced = 0
            for req in joined:
                produced += self._prefill(req)
            return produced + self._decode()

    def run(self) -> None:
        """Drive step() until no request is queued or running."""
        while not self.scheduler.idle:
            self.step()

    def generate(self, prompts: Sequence, max_new_tokens: int = 16,
                 ttl: Optional[float] = None) -> List[np.ndarray]:
        """Submit every prompt, drain, return prompt+generated arrays in
        submission order (typed errors propagate from the failing request)."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens, ttl=ttl)
                for p in prompts]
        self.run()
        return [r.result() for r in reqs]

    def _bucket_for(self, plen: int) -> int:
        for b in self.buckets:
            if b >= plen:
                return b
        return self.max_seq_len

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _prefill(self, req: Request) -> int:
        sp = trace.span("engine.prefill", rid=req.rid,
                        bucket=self._bucket_for(int(req.prompt.size)),
                        prompt_len=int(req.prompt.size)) \
            if trace.enabled() else trace.span("engine.prefill")
        with sp:
            return self._prefill_impl(req)

    def _prefill_impl(self, req: Request) -> int:
        """Run the joiner's prompt at its bucket length (batch 1, fresh zero
        caches), copy the KV rows into its slot, and take its first token
        (device argmax for greedy requests, host-side sampling otherwise)."""
        t0 = time.perf_counter()
        plen = int(req.prompt.size)
        bucket = self._bucket_for(plen)
        tok = np.zeros((1, bucket), np.int64)
        tok[0, :plen] = req.prompt
        pref = self.model.init_kv_caches(1, self.max_seq_len)
        args = (self._to_device(tok), pref,
                self._to_device(np.zeros((1,), np.int32)),
                self._to_device(np.asarray([plen - 1], np.int32)))
        if req.is_sampling:
            _, logits = self.model.slot_step(*args, return_logits=True)
            first = self._sample_row(req, logits[0].float().cpu().numpy())
            self._counters["sampled_tokens"] += 1
        else:
            first = int(self.model.slot_step(*args)[0])
        self._write_slot(pref, req.slot)
        req.cache_len = plen
        req.state = RequestState.DECODING
        if not req.append_token(first):
            req.next_token = first
        self._counters["prefills"] += 1
        self._counters["tokens_generated"] += 1
        self._prefill_time += time.perf_counter() - t0
        return 1

    @torch.inference_mode()
    def _write_slot(self, pref, slot: int) -> None:
        """Prefilled ``[1, S_max]`` KV rows -> the batch caches' row
        ``slot``, in place (engine.py:107-122 rebuilt the donated caches)."""
        for (bk, bv), (pk, pv) in zip(self._caches, pref):
            bk[slot].copy_(pk[0])
            bv[slot].copy_(pv[0])

    def _active_slots(self):
        return [(s, r) for s, r in sorted(self.scheduler.running().items())
                if r.state is RequestState.DECODING
                and r.finish_reason is None]

    def _decode(self) -> int:
        """One ``[max_batch, 1]`` decode step over every active slot.
        Inactive slots feed token 0 at offset 0 (length 1): their rows are
        garbage no other slot attends, and the next prefill overwrites
        them."""
        active = self._active_slots()
        if not active:
            return 0
        t0 = time.perf_counter()
        b = self.max_batch
        sp = trace.span("engine.decode_step",
                        step=self._counters["decode_steps"],
                        rids=[r.rid for _, r in active]) \
            if trace.enabled() else trace.span("engine.decode_step")
        with sp:
            tok = np.zeros((b, 1), np.int64)
            off = np.zeros((b,), np.int32)
            for s, r in active:
                tok[s, 0] = r.next_token
                off[s] = r.cache_len
            sampling = any(r.is_sampling for _, r in active)
            args = (self._to_device(tok), self._caches, self._to_device(off),
                    self._to_device(np.zeros((b,), np.int32)))
            if sampling:
                nxt, logits = self.model.slot_step(*args, return_logits=True)
                rows = logits.float().cpu().numpy()
            else:
                nxt = self.model.slot_step(*args)
                rows = None
            greedy = nxt.cpu().numpy()   # [B] int32, not [B, vocab] logits
            for s, r in active:
                r.cache_len += 1
                if r.is_sampling:
                    t = self._sample_row(r, rows[s])
                    self._counters["sampled_tokens"] += 1
                else:
                    t = int(greedy[s])
                if not r.append_token(t):
                    r.next_token = t
        self._counters["decode_steps"] += 1
        self._counters["tokens_generated"] += len(active)
        self._occupancy_sum += len(active) / float(b)
        self._decode_time += time.perf_counter() - t0
        return len(active)

    def _sample_row(self, req: Request, row) -> int:
        """Host-side sampling from one logits row: temperature, optional
        top_p nucleus, then one draw from the request's own Generator."""
        logits = np.asarray(row, np.float64)
        if not np.isfinite(logits).all():
            raise FloatingPointError(
                f"request {req.rid}: non-finite logits row")
        logits = logits / float(req.temperature)
        logits -= logits.max()
        probs = np.exp(logits)
        probs /= probs.sum()
        if req.top_p is not None:
            order = np.argsort(-probs, kind="stable")
            cum = np.cumsum(probs[order])
            cut = int(np.searchsorted(cum, float(req.top_p))) + 1
            keep = order[:cut]
            p = probs[keep] / probs[keep].sum()
            return int(keep[req.rng.choice(len(keep), p=p)])
        return int(req.rng.choice(len(probs), p=probs))

    # ------------------------------------------------------------------
    def info(self) -> dict:
        c = dict(self._counters)
        steps = c["decode_steps"]
        gen_time = self._decode_time + self._prefill_time
        sched = self.scheduler.info()
        return {
            "max_batch": self.max_batch,
            "max_seq_len": self.max_seq_len,
            "prefill_buckets": list(self.buckets),
            **{k: sched[k] for k in ("submitted", "admitted", "finished",
                                     "timed_out", "evicted", "active",
                                     "queued")},
            "rejected": c["rejected"] + sched["rejected"],
            "prefills": c["prefills"],
            "decode_steps": steps,
            "tokens_generated": c["tokens_generated"],
            "sampled_tokens": c["sampled_tokens"],
            "avg_occupancy": self._occupancy_sum / steps if steps else 0.0,
            "tokens_per_sec": c["tokens_generated"] / gen_time
            if gen_time else 0.0,
            "pool": self.pool.info(),
            "pressure": {
                "level": self._pressure,
                "max_queue": self.max_queue,
                "shed": c["shed"],
                **{f"level{i}_steps": n
                   for i, n in enumerate(self._level_steps)},
            },
        }
