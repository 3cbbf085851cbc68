"""ServingEngine: continuous batching over the ragged decode kernel.

Counterpart of ``paddle_tpu/inference/serving/engine.py``. Its parts:

- the batch-slot step (``models/llama.py LlamaForCausalLM.slot_step``):
  per-slot offsets become the per-slot lengths of the ragged decode
  kernel, so every slot decodes at its own position in one
  ``[max_batch, 1]`` step;
- step capture (``jit/capture.py``): every step kind the engine calls
  (the decode step, greedy and with logits, one prefill per bucket, the
  speculative verify window, the prefill window) is one CUDA graph per
  signature on the card. The engine keeps what a graph holds by address
  persistent: its KV caches, one prefill scratch per model and a small
  pool of window scratches; the step inputs are staged into persistent
  device tensors (``_Inputs``), so a step allocates nothing;
- the paged KV pool (``kv_pool.py``) and the scheduler
  (``scheduler.py``): capacity-based admission, join/evict strictly
  between decode steps;
- typed deadlines (``utils/deadline.py``): per-request TTL ->
  RequestTimeout, bounded admission -> EngineOverloaded.

A joining request's prompt is padded on the right to the smallest
prefill bucket and prefilled alone at batch 1 into the zeroed prefill
scratch (the logits of its last real token picked by ``last_pos``); its KV
rows are then copied into its batch slot. Greedy decode returns the
on-device argmax ``[B]`` int32, the one host sync per step; ``[B, vocab]``
logits come to the host only on steps where a sampling slot is active.

Speculative decoding (``spec_k > 0``): a drafter (``speculative.py``)
proposes k tokens per active slot and one ``[max_batch, k+1]`` verify call
scores every window position; each slot emits the longest draft prefix
matching the target argmax plus the bonus token (1..k+1 tokens), bitwise
the non-speculative greedy stream. Pages are reserved for the whole
lifetime including the k-token verify scratch, so a rejection is cursor
arithmetic.

Chunked prefill and prefix sharing run through the scratch path: the
request's ``[1, S_max + W]`` scratch caches are filled by ``[1, W]``
window steps, one per engine step, interleaved with the decode batch;
with prefix sharing the scratch starts from the shared chain's committed
rows, so only the tail is computed; when it completes, the rows
``[0, S_max)`` land in the slot.

Env knobs (read at engine construction):
- ``PT_SERVE_MAX_BATCH``   (default 8)   decode slots
- ``PT_SERVE_PAGE_SIZE``   (default 16)  tokens per KV page
- ``PT_SERVE_MAX_SEQ``     (default: model max_position_embeddings)
- ``PT_SERVE_PREFILL_BUCKETS`` comma list (default: powers of two from 8)
- ``PT_SERVE_SPEC_K``      (default 0)   draft tokens per verify (0 = off)
- ``PT_SERVE_DRAFTER``     (default "ngram") ngram | model
- ``PT_SERVE_PREFILL_CHUNK`` (default 0 = off) chunked prefill window
- ``PT_SERVE_PREFIX_SHARE`` (default 0 = off) radix-tree prefix sharing
- ``PT_SERVE_MAX_QUEUE``   (default 8 x max_batch) bounded admission
- ``PT_SERVE_SHED_TTL``    (default 0 = off) deadline-aware shedding

Overload control (the degradation ladder): under queue pressure the engine
sheds optional work in order: trim the prefix tree (level 1), pause
speculative decoding and return its verify-scratch pages (level 2), shrink
the chunked-prefill interleave to one window per step (level 3). Levels
are entered and left with hysteresis, every transition is stamped on the
trace ring, and the level is exported as a gauge.
"""
from __future__ import annotations

import math
import os
import threading
import time
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...distributed.chaos import faultpoint, register_fault
from ...observability import trace
from ...utils.deadline import EngineOverloaded, env_int, env_timeout
from .kv_pool import KVPagePool
from .prefix import PrefixCache
from .request import Request, RequestState
from .scheduler import ContinuousBatchingScheduler
from .speculative import build_drafter

__all__ = ["ServingEngine", "SamplingUnsupported", "serving_info"]

_ENGINES: "weakref.WeakSet[ServingEngine]" = weakref.WeakSet()

FP_PRESSURE = register_fault(
    "engine.pressure", "every engine step's overload-ladder evaluation "
    "passes here (the admission/degradation control point)")

# overload-ladder hysteresis bands over queue_depth / max_queue: level L is
# entered at _LADDER_ENTER[L] and left below _LADDER_EXIT[L]; the gap keeps
# a queue oscillating on one boundary from flapping the ladder
_LADDER_ENTER = (0.0, 0.50, 0.75, 0.90)
_LADDER_EXIT = (0.0, 0.25, 0.50, 0.75)


class SamplingUnsupported(NotImplementedError):
    """A submit() asked for sampling this engine cannot honour: a negative
    or non-finite temperature, top_p outside (0, 1], top_p without a
    positive temperature, or any sampling on a speculative engine (greedy
    acceptance is what keeps its stream exact). Rejected up front, never
    served greedy."""

    def __init__(self, param: str, value, why: str = ""):
        self.param = param
        self.value = value
        why = why or ("this engine decodes greedily (deterministic argmax "
                      "per slot) for this parameter combination")
        super().__init__(
            f"{param}={value!r} cannot be honored: {why}. Pass {param}="
            f"{'0' if param == 'temperature' else '1'} (or omit it) for "
            f"greedy decoding.")


class _KVBuffer:
    """Per-layer (k, v) caches ``[B, S, Hkv, D]`` as views of one tensor
    ``[L, 2, B, S, Hkv, D]``: a slot write, a zeroing or a page copy is
    one operation over every layer."""

    def __init__(self, model, batch: int, length: int):
        cfg = model.config
        d = cfg.hidden_size // cfg.num_attention_heads
        with torch.no_grad():
            self.all = torch.zeros(
                (cfg.num_hidden_layers, 2, batch, length,
                 cfg.num_key_value_heads, d),
                dtype=model.dtype, device=model.device)
        self.caches = [(self.all[i, 0], self.all[i, 1])
                       for i in range(cfg.num_hidden_layers)]

    def zero_(self) -> None:
        self.all.zero_()

    def write_row(self, row: int, src: "_KVBuffer") -> None:
        """Batch row ``row`` <- ``src``'s row 0, its first S positions."""
        s = self.all.shape[3]
        self.all[:, :, row].copy_(src.all[:, :, 0, :s])

    def rows(self, lo: int, hi: int) -> torch.Tensor:
        """Positions ``[lo, hi)`` of row 0, every layer: ``[L, 2, n, Hkv, D]``."""
        return self.all[:, :, 0, lo:hi]


def _prefill_scratch(model, max_seq_len: int) -> _KVBuffer:
    """The model's ``[1, S_max]`` prefill caches, one per (model, S_max),
    shared by every engine and drafter over the model: the prefill graphs
    hold its address, so it outlives any one request."""
    stash = model.__dict__.setdefault("_prefill_scratch", {})
    key = (int(max_seq_len), model.dtype, model.device)
    buf = stash.get(key)
    if buf is None:
        buf = stash[key] = _KVBuffer(model, 1, max_seq_len)
    return buf


class _Inputs:
    """Persistent device tensors for a step's host inputs, one per (name,
    shape, dtype): staging ``copy_``s into them, so the engine allocates
    no tensor a step."""

    def __init__(self, device):
        self.device = device
        self._t = {}

    def __call__(self, name: str, arr) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        key = (name, tuple(src.shape), src.dtype)
        t = self._t.get(key)
        if t is None:
            t = self._t[key] = torch.empty(src.shape, dtype=src.dtype,
                                           device=self.device)
        t.copy_(src)
        return t


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


def _wrapper_info(model, name: str) -> dict:
    """cache_info() of the model's capture wrapper for one step kind."""
    step = model.captured_step(name)
    return step.cache_info() if step is not None else {}


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
                 drafter=None, draft_model=None,
                 prefill_chunk: Optional[int] = None,
                 prefix_sharing: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 shed_ttl: Optional[float] = None):
        self.model = model
        cfg = model.config
        self.device = model.device
        self.max_batch = max_batch or env_int("PT_SERVE_MAX_BATCH", 8)
        self.max_seq_len = max_seq_len or env_int(
            "PT_SERVE_MAX_SEQ", cfg.max_position_embeddings)
        self.eos_token_id = eos_token_id
        self.default_ttl = default_ttl
        self.spec_k = env_int("PT_SERVE_SPEC_K", 0) if spec_k is None \
            else int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.spec_k and self.spec_k + 1 >= self.max_seq_len:
            raise ValueError(
                f"spec_k={self.spec_k} leaves no room for prompts in "
                f"max_seq_len={self.max_seq_len}")
        page = page_size or env_int("PT_SERVE_PAGE_SIZE", 16)
        pages_per_slot = -(-self.max_seq_len // page)
        self.pool = KVPagePool(self.max_batch * pages_per_slot, page)
        self.scheduler = ContinuousBatchingScheduler(
            self.pool, self.max_batch, reserve_extra_tokens=self.spec_k)
        self.prefill_chunk = env_int("PT_SERVE_PREFILL_CHUNK", 0) \
            if prefill_chunk is None else int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        if prefix_sharing is None:
            prefix_sharing = _env_on("PT_SERVE_PREFIX_SHARE")
        self.prefix_cache = PrefixCache(self.pool) if prefix_sharing \
            else None
        if self.prefix_cache is not None:
            # admission pressure evicts tree-only pages instead of wedging
            self.scheduler.reclaim = self.prefix_cache.evict
        # the one window both scratch paths use (chunked prompts and the
        # tails after a prefix share)
        self._window = self.prefill_chunk or page
        self._scratch_len = self.max_seq_len + self._window
        self._free_scratch: List[_KVBuffer] = []
        self._window_used = False
        if prefill_buckets:
            if not any(int(b) > 0 for b in prefill_buckets):
                raise ValueError(
                    f"prefill_buckets {list(prefill_buckets)!r} has no "
                    f"positive entry")
            self.buckets = _normalize_buckets(prefill_buckets,
                                              self.max_seq_len)
        else:
            self.buckets = _default_buckets(self.max_seq_len)
        self._kv = _KVBuffer(model, self.max_batch, self.max_seq_len)
        self._caches = self._kv.caches
        self._in = _Inputs(self.device)
        self.drafter = None
        if self.spec_k:
            self.drafter = build_drafter(
                drafter or os.environ.get("PT_SERVE_DRAFTER", "ngram"),
                self.max_batch, self.max_seq_len, draft_model=draft_model)

        self.max_queue = env_int("PT_SERVE_MAX_QUEUE", 8 * self.max_batch) \
            if max_queue is None else int(max_queue)
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        self.shed_ttl = env_timeout("PT_SERVE_SHED_TTL", 0.0) \
            if shed_ttl is None else float(shed_ttl)
        self._pressure = 0
        self._level_steps = [0, 0, 0, 0]
        self._spec_paused = False
        self._prefix_paused = False

        self._lock = threading.Lock()   # serialises step()/run()
        self._counters = {"prefills": 0, "decode_steps": 0,
                          "tokens_generated": 0, "rejected": 0,
                          "verify_steps": 0, "draft_tokens_proposed": 0,
                          "draft_tokens_accepted": 0, "sampled_tokens": 0,
                          "prefill_chunks": 0, "chunked_prefills": 0,
                          "shared_prefix_joins": 0, "prefill_pages_saved": 0,
                          "shed": 0, "pressure_trims": 0, "spec_pauses": 0,
                          "scratch_pages_returned": 0}
        # tokens-per-verify histogram: index i = slot verifies that
        # emitted i tokens (1..k+1)
        self._accept_hist = [0] * (self.spec_k + 2)
        self._occupancy_sum = 0.0
        self._decode_time = 0.0
        self._prefill_time = 0.0
        _ENGINES.add(self)

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
        cache layout, SamplingUnsupported for sampling it cannot honour
        (any sampling on a speculative engine), and EngineOverloaded when
        admission sheds it. ``seed`` makes a sampled stream reproducible
        (default: its rid)."""
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
        if self.spec_k and not (greedy_t and greedy_p):
            param, val = (("temperature", temperature) if not greedy_t
                          else ("top_p", top_p))
            self._reject(SamplingUnsupported(
                param, val, f"this engine decodes SPECULATIVELY "
                f"(spec_k={self.spec_k}) and greedy verification is what "
                f"keeps the speculative stream exact — submit to a "
                f"non-speculative engine for per-slot sampling"))
        req = Request(prompt_ids, max_new_tokens=max_new_tokens,
                      ttl=self.default_ttl if ttl is None else ttl,
                      eos_token_id=self.eos_token_id
                      if eos_token_id is None else eos_token_id,
                      temperature=None if greedy_t else float(temperature),
                      top_p=None if greedy_p else float(top_p),
                      seed=seed)
        total = req.prompt.size + req.max_new_tokens + self.spec_k
        if total > self.max_seq_len:
            spec = (f" (incl. {self.spec_k} positions of speculative "
                    f"verify scratch)" if self.spec_k else "")
            self._reject(ValueError(
                f"request needs {total} KV positions{spec} but the "
                f"engine's static layout holds max_seq_len="
                f"{self.max_seq_len} — shorten the prompt/max_new_tokens "
                f"or size the engine up"))
        # shed after the permanent rejections and before the prefix walk,
        # so a shed request never takes refs it must give back
        self._admit(req)
        if self.prefix_cache is not None and not req.is_sampling \
                and not self._prefix_paused:
            # refs on the committed chain ride the request's lifetime; the
            # scheduler reserves only the pages past the shared prefix.
            # Sampled requests take the logits-returning prefill instead.
            req.shared_pages, req.shared_kv, req.shared_len = \
                self.prefix_cache.share(req.prompt)
        self.scheduler.submit(req)
        trace.event("engine.submit", rid=req.rid,
                    prompt_len=int(req.prompt.size),
                    max_new=req.max_new_tokens)
        return req

    # ------------------------------------------------------------------
    # overload control: bounded admission + the degradation ladder
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
        # stamped before the error exists: its construction snapshots the
        # ring into the incident record
        trace.event("engine.shed", rid=req.rid, level=self._pressure,
                    queued=depth, retry_after_ms=retry_ms, reason=why)
        raise EngineOverloaded(
            f"serving request {req.rid}", req.deadline.timeout,
            detail=f"{why}; retry after {retry_ms}ms",
            retry_after_ms=retry_ms)

    def _update_pressure(self) -> None:
        """Walk the ladder (queue depth over max_queue, with hysteresis),
        each transition stamped on the trace ring."""
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
            if new > level:
                self._enter_pressure(new)
            else:
                self._exit_pressure(new)
            self._pressure = new
        self._level_steps[self._pressure] += 1

    def _enter_pressure(self, new: int) -> None:
        if new >= 1 and not self._prefix_paused:
            # level 1: trim the prefix tree; its pages serve admission
            self._prefix_paused = True
            if self.prefix_cache is not None:
                self._counters["pressure_trims"] += 1
                self.prefix_cache.evict(self.pool.total_pages)
        if new >= 2 and not self._spec_paused and self.spec_k:
            # level 2: pause speculation, hand back every verify scratch
            self._spec_paused = True
            self._counters["spec_pauses"] += 1
            freed = self.scheduler.shed_reserve_extra()
            self._counters["scratch_pages_returned"] += freed
        # level 3 carries no state: _advance_prefills reads the level

    def _exit_pressure(self, new: int) -> None:
        if new < 2 and self._spec_paused:
            self._spec_paused = False
            self.scheduler.restore_reserve_extra(self.spec_k)
        if new < 1 and self._prefix_paused:
            self._prefix_paused = False

    def _spec_ok(self) -> bool:
        """Speculate only while every decoding slot still owns its verify
        scratch (a request admitted while level 2 shed it has none)."""
        if not self.spec_k or self._spec_paused:
            return False
        return all(r.scratch_reserved
                   for r in self.scheduler.running().values()
                   if r.state is RequestState.DECODING)

    @property
    def pressure_level(self) -> int:
        """Current pressure level, 0 (healthy) .. 3."""
        return self._pressure

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: scheduler pass (evict/expire/join) ->
        prefill the joiners -> one window of every scratch prefill -> one
        batched decode (or verify) step for every active slot. Returns the
        number of tokens produced."""
        with self._lock:
            self._update_pressure()
            joined, evicted = self.scheduler.schedule()
            for req in evicted:
                self._drop_scratch(req)
                req.shared_kv = []
                if self.drafter is not None:
                    self.drafter.on_evict(req)
            produced = 0
            for req in joined:
                produced += self._begin_prefill(req)
            produced += self._advance_prefills()
            produced += self._decode_speculative() if self._spec_ok() \
                else self._decode()
            return produced

    def run(self, poll: float = 0.0) -> None:
        """Drive step() until no request is queued or running; ``poll``
        sleeps between empty iterations (submissions from other threads)."""
        while not self.scheduler.idle:
            made = self.step()
            if made == 0 and poll:
                time.sleep(poll)

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

    # ------------------------------------------------------------------
    # the scratch path: chunked prefill and prefix-shared tails
    # ------------------------------------------------------------------
    def _take_scratch(self) -> _KVBuffer:
        """A zeroed ``[1, S_max + W]`` scratch from the engine's pool (the
        window graphs hold their addresses: one per buffer ever used)."""
        buf = self._free_scratch.pop() if self._free_scratch else \
            _KVBuffer(self.model, 1, self._scratch_len)
        buf.zero_()
        return buf

    def _drop_scratch(self, req: Request) -> None:
        if req.scratch is not None:
            self._free_scratch.append(req.scratch)
            req.scratch = None

    def _begin_prefill(self, req: Request) -> int:
        """Route a joiner: shared-prefix joins and chunked prompts take the
        scratch path, everything else the single-shot bucketed prefill."""
        plen = int(req.prompt.size)
        if self.prefix_cache is not None and not req.is_sampling \
                and req.shared_len == 0 and not self._prefix_paused:
            # second walk at join time: a request submitted beside its
            # donor missed the tree at submit. The refs replace as many
            # already-reserved own pages, which go back to the pool.
            pages, kvs, slen = self.prefix_cache.share(req.prompt)
            if slen:
                req.shared_pages, req.shared_kv, req.shared_len = \
                    pages, kvs, slen
                surplus = req.pages[:len(pages)]
                req.pages = req.pages[len(pages):]
                self.pool.release(surplus)
        chunked = bool(self.prefill_chunk) and plen > self.prefill_chunk
        if req.is_sampling or not (chunked or req.shared_len):
            return self._prefill(req)
        scratch = self._take_scratch()
        ps = self.pool.page_size
        with torch.no_grad():
            for pi, page_kv in enumerate(req.shared_kv):
                scratch.rows(pi * ps, (pi + 1) * ps).copy_(page_kv)
        req.scratch = scratch
        req.prefill_pos = req.shared_len
        if req.shared_len:
            self._counters["shared_prefix_joins"] += 1
            self._counters["prefill_pages_saved"] += len(req.shared_pages)
        if plen - req.shared_len > self._window:
            self._counters["chunked_prefills"] += 1
        return 0  # the first window runs in this step's advance pass

    def _advance_prefills(self) -> int:
        produced = 0
        advanced = 0
        for _, req in sorted(self.scheduler.running().items()):
            if req.state is RequestState.PREFILL and req.scratch is not None:
                produced += self._advance_one(req)
                advanced += 1
                if self._pressure >= 3 and advanced >= 1:
                    # level 3: one window per engine step
                    break
        return produced

    def _advance_one(self, req: Request) -> int:
        """One ``[1, W]`` window of one scratch prefill: positions
        prefill_pos..prefill_pos+n land in its scratch (a window may spill
        into the W-row pad, cut off at the slot write). The last window's
        argmax at the last real token is the first generated token."""
        t0 = time.perf_counter()
        w = self._window
        plen = int(req.prompt.size)
        pos = req.prefill_pos
        n = min(w, plen - pos)
        with trace.span("engine.prefill_chunk", rid=req.rid, pos=pos,
                        tokens=n):
            tok = np.zeros((1, w), np.int64)
            tok[0, :n] = req.prompt[pos:pos + n]
            self._window_used = True
            nxt = self.model.verify_step(
                self._in("wtok", tok), req.scratch.caches,
                self._in("woff", np.asarray([pos], np.int32)))
            self._counters["prefill_chunks"] += 1
            req.prefill_pos = pos + n
            made = 0
            if req.prefill_pos >= plen:
                made = self._finish_scratch_prefill(
                    req, int(nxt[0, n - 1].cpu()))
        self._prefill_time += time.perf_counter() - t0
        return made

    def _finish_scratch_prefill(self, req: Request, first: int) -> int:
        """Scratch prefill complete: commit the prompt's full pages into the
        prefix tree, write the slot row, start decoding."""
        scratch = req.scratch
        if self.prefix_cache is not None:
            self._commit_prefix(req, scratch)
        self._kv.write_row(req.slot, scratch)
        self._drop_scratch(req)
        req.shared_kv = []
        req.cache_len = int(req.prompt.size)
        req.state = RequestState.DECODING
        if not req.append_token(first):
            req.next_token = first
        if self.drafter is not None:
            self.drafter.on_join(req)
        self._counters["prefills"] += 1
        self._counters["tokens_generated"] += 1
        return 1

    def _commit_prefix(self, req: Request, src: _KVBuffer) -> None:
        """Mark the request's own pages covering full prompt chunks as
        committed and insert the chunks into the tree (which takes its own
        refs). The KV rows of the pages the tree takes are copied out of
        ``src`` on the device in one block (one allocation, not one a
        page); each node holds a view of its page."""
        if self._prefix_paused:
            return  # ladder level 1+: don't regrow the tree just shed
        ps = self.pool.page_size
        n_full = int(req.prompt.size) // ps
        base = req.shared_len // ps
        own = req.pages[:max(0, n_full - base)]
        if own:
            self.pool.commit(own)
        block = []   # (first page copied, the copied rows)

        def kv_of_page(i):
            # the tree asks for new pages in increasing order
            if not block:
                block.append((i, src.rows(i * ps, n_full * ps).clone()))
            lo, rows = block[0]
            return rows[:, :, (i - lo) * ps:(i - lo + 1) * ps]

        with torch.no_grad():
            self.prefix_cache.insert(req.prompt, req.shared_len, own,
                                     kv_of_page)

    # ------------------------------------------------------------------
    # bucketed prefill and decode
    # ------------------------------------------------------------------
    def _prefill(self, req: Request) -> int:
        sp = trace.span("engine.prefill", rid=req.rid,
                        bucket=self._bucket_for(int(req.prompt.size)),
                        prompt_len=int(req.prompt.size)) \
            if trace.enabled() else trace.span("engine.prefill")
        with sp:
            return self._prefill_impl(req)

    def _prefill_impl(self, req: Request) -> int:
        """Run the joiner's prompt at its bucket length (batch 1, the zeroed
        prefill scratch), copy the KV rows into its slot, and take its
        first token (device argmax for greedy requests, host-side sampling
        otherwise)."""
        t0 = time.perf_counter()
        plen = int(req.prompt.size)
        bucket = self._bucket_for(plen)
        tok = np.zeros((1, bucket), np.int64)
        tok[0, :plen] = req.prompt
        pref = _prefill_scratch(self.model, self.max_seq_len)
        pref.zero_()
        args = (self._in("ptok", tok), pref.caches,
                self._in("poff", np.zeros((1,), np.int32)),
                self._in("plast", np.asarray([plen - 1], np.int32)))
        if req.is_sampling:
            _, logits = self.model.slot_step(*args, return_logits=True)
            first = self._sample_row(req, logits[0].float().cpu().numpy())
            self._counters["sampled_tokens"] += 1
        else:
            first = int(self.model.slot_step(*args).cpu()[0])
        self._kv.write_row(req.slot, pref)
        if self.prefix_cache is not None:
            # donor commit: KV rows do not depend on sampling, so sampled
            # requests donate too
            self._commit_prefix(req, pref)
        req.cache_len = plen
        req.state = RequestState.DECODING
        if not req.append_token(first):
            req.next_token = first
        if self.drafter is not None:
            self.drafter.on_join(req)
        self._counters["prefills"] += 1
        self._counters["tokens_generated"] += 1
        self._prefill_time += time.perf_counter() - t0
        return 1

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
            args = (self._in("tok", tok), self._caches, self._in("off", off),
                    self._in("last", np.zeros((b,), np.int32)))
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

    def _decode_speculative(self) -> int:
        """One drafter pass + one ``[max_batch, k+1]`` verify step: row b
        holds the slot's pending token then its k proposals at offsets
        cache_len..cache_len+k; each slot emits the longest draft prefix
        matching the targets plus the bonus target token. Rejected
        positions cost nothing to undo: the cursor does not advance past
        them and their rows lie beyond every ragged length until
        overwritten."""
        active = self._active_slots()
        if not active:
            return 0
        t0 = time.perf_counter()
        b, k = self.max_batch, self.spec_k
        traced = trace.enabled()
        rids = [r.rid for _, r in active] if traced else ()
        sp = trace.span("engine.decode_step",
                        step=self._counters["decode_steps"], rids=rids,
                        spec=True) \
            if traced else trace.span("engine.decode_step")
        with sp:
            drafts = self.drafter.propose(dict(active), k)
            tok = np.zeros((b, k + 1), np.int64)
            off = np.zeros((b,), np.int32)
            for s, r in active:
                tok[s, 0] = r.next_token
                tok[s, 1:] = drafts[s]
                off[s] = r.cache_len
            vsp = trace.span("engine.verify_step", k=k, rids=rids) \
                if traced else trace.span("engine.verify_step")
            with vsp:
                targets = self.model.verify_step(
                    self._in("vtok", tok), self._caches,
                    self._in("voff", off)).cpu().numpy()
        produced = 0
        for s, r in active:
            d = drafts[s]
            m = 0
            while m < k and int(d[m]) == int(targets[s, m]):
                m += 1
            emitted = 0
            for i in range(m + 1):
                t = int(targets[s, i])
                emitted += 1
                if r.append_token(t):
                    break
                r.next_token = t
            r.cache_len += emitted
            self.drafter.observe(r, emitted)
            self._accept_hist[emitted] += 1
            self._counters["draft_tokens_proposed"] += k
            self._counters["draft_tokens_accepted"] += m
            produced += emitted
        self._counters["decode_steps"] += 1
        self._counters["verify_steps"] += 1
        self._counters["tokens_generated"] += produced
        self._occupancy_sum += len(active) / float(b)
        self._decode_time += time.perf_counter() - t0
        return produced

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
        out = {
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
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks": c["prefill_chunks"],
            "chunked_prefills": c["chunked_prefills"],
            "shared_prefix_joins": c["shared_prefix_joins"],
            "prefill_pages_saved": c["prefill_pages_saved"],
            "pool": self.pool.info(),
            "step": _wrapper_info(self.model, "_slot_step"),
            "pressure": {
                "level": self._pressure,
                "max_queue": self.max_queue,
                "shed": c["shed"],
                "pressure_trims": c["pressure_trims"],
                "spec_pauses": c["spec_pauses"],
                "scratch_pages_returned": c["scratch_pages_returned"],
                "spec_paused": int(self._spec_paused),
                "prefix_paused": int(self._prefix_paused),
                **{f"level{i}_steps": n
                   for i, n in enumerate(self._level_steps)},
            },
        }
        if self.prefix_cache is not None:
            out["prefix"] = self.prefix_cache.info()
        if self._window_used:
            out["window"] = {"size": self._window,
                             **_wrapper_info(self.model, "_verify_step")}
        if self.spec_k:
            proposed = c["draft_tokens_proposed"]
            emitted = sum(i * n for i, n in enumerate(self._accept_hist))
            slots_verified = sum(self._accept_hist)
            out["spec"] = {
                "k": self.spec_k,
                "drafter": self.drafter.info(),
                "verify_steps": c["verify_steps"],
                "draft_steps": getattr(self.drafter, "draft_calls", 0),
                "draft_tokens_proposed": proposed,
                "draft_tokens_accepted": c["draft_tokens_accepted"],
                "acceptance_rate": c["draft_tokens_accepted"] / proposed
                if proposed else 0.0,
                "tokens_per_verify": emitted / slots_verified
                if slots_verified else 0.0,
                "tokens_per_verify_hist": list(self._accept_hist),
                "verify": _wrapper_info(self.model, "_verify_step"),
            }
        return out


def serving_info() -> List[dict]:
    """info() of every live engine (the metrics collector's source)."""
    return [e.info() for e in list(_ENGINES)]
