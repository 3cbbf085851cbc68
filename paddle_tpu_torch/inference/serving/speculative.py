"""Speculative decoding drafters for the serving engine.

Counterpart of ``paddle_tpu/inference/serving/speculative.py``. A drafter
proposes ``k`` tokens per active slot, the target scores all ``k + 1``
window positions in one verify call (``LlamaForCausalLM.verify_step``),
and the engine accepts the longest draft prefix matching the target's
argmax plus the bonus token. Greedy verification makes the drafter pure
opportunity: a wrong draft costs window slots, never correctness.

- ``NGramDrafter`` (default, ``PT_SERVE_DRAFTER=ngram``): prompt lookup.
  A per-request index maps every suffix n-gram (n <= max_n) of the
  request's prompt + output to its most recent earlier occurrence;
  ``propose()`` replays the continuation of the longest suffix match and
  falls back to repeating the last token.
- ``DraftModelDrafter`` (``PT_SERVE_DRAFTER=model``): a draft model of the
  target's family with its own KV caches over the engine's batch-slot
  layout, driven through its own captured ``[max_batch, 1]`` slot step
  (the decode kernel on the card). Proposing k tokens costs
  ``max(catch_up) + k - 1`` batched draft calls.

The draft cache stays coherent by cursor arithmetic: ``observe()`` moves
the draft cursor over positions whose K/V are known true; rejected
positions are fed again next round.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Drafter", "NGramDrafter", "DraftModelDrafter", "build_drafter"]


class Drafter:
    """Drafter contract (host side, between decode steps only).

    The engine calls ``on_join`` after a request's prefill (prompt and
    first output token already on ``req``), ``propose`` once per
    speculative step with every decoding slot, ``observe`` with the number
    of tokens the verify emitted, ``on_evict`` when the slot is released.
    Proposals are exactly ``k`` tokens per slot."""

    kind = "none"

    def on_join(self, req) -> None:
        raise NotImplementedError

    def propose(self, active: Dict[int, object], k: int) -> Dict[int, List[int]]:
        """slot -> exactly k proposed continuation tokens."""
        raise NotImplementedError

    def observe(self, req, n_accepted: int) -> None:
        """``n_accepted`` tokens were emitted for ``req`` this step (its
        ``output_tokens`` and ``cache_len`` are already advanced)."""
        raise NotImplementedError

    def on_evict(self, req) -> None:
        raise NotImplementedError

    def info(self) -> dict:
        return {"kind": self.kind}


class _NGramIndex:
    """Suffix n-gram -> most recent earlier occurrence, O(1) per token.

    ``maps[n][gram]`` is the position just past the gram; ``prev`` keeps
    the previous one for the gram that is the stream's suffix, so a suffix
    that matches only itself still finds its last earlier occurrence."""

    __slots__ = ("toks", "maps", "prev", "max_n")

    def __init__(self, toks, max_n: int):
        self.toks: List[int] = []
        self.maps = [None] + [dict() for _ in range(max_n)]
        self.prev = [None] + [dict() for _ in range(max_n)]
        self.max_n = max_n
        self.extend(toks)

    def extend(self, toks) -> None:
        for t in toks:
            self.toks.append(int(t))
            L = len(self.toks)
            for n in range(1, self.max_n + 1):
                if L < n:
                    break
                gram = tuple(self.toks[L - n:L])
                m = self.maps[n]
                old = m.get(gram)
                if old is not None:
                    self.prev[n][gram] = old
                m[gram] = L

    def propose(self, k: int) -> List[int]:
        toks = self.toks
        L = len(toks)
        for n in range(min(self.max_n, L), 0, -1):
            gram = tuple(toks[L - n:L])
            pos = self.maps[n].get(gram)
            if pos == L:                      # the suffix matched itself
                pos = self.prev[n].get(gram)
            if pos is None:
                continue
            cont = toks[pos:pos + k]
            if cont:
                while len(cont) < k:
                    cont.append(cont[-1])
                return cont
        return [toks[-1] if toks else 0] * k


class NGramDrafter(Drafter):
    """Prompt-lookup drafter: the continuation of the longest recent
    n-gram match inside the request's own prompt + output stream."""

    kind = "ngram"

    def __init__(self, max_n: int = 4):
        self.max_n = int(max_n)
        self._idx: Dict[int, _NGramIndex] = {}     # rid -> index
        self._lock = threading.Lock()
        self.draft_calls = 0    # one propose() per verify

    def on_join(self, req) -> None:
        with self._lock:
            self._idx[req.rid] = _NGramIndex(
                list(req.prompt) + list(req.output_tokens), self.max_n)

    def propose(self, active, k):
        with self._lock:
            self.draft_calls += 1
            out = {}
            for s, r in active.items():
                idx = self._idx.get(r.rid)
                if idx is None:
                    idx = _NGramIndex(
                        list(r.prompt) + list(r.output_tokens), self.max_n)
                    self._idx[r.rid] = idx
                out[s] = idx.propose(k)
            return out

    def observe(self, req, n_accepted: int) -> None:
        with self._lock:
            idx = self._idx.get(req.rid)
            if idx is not None and n_accepted > 0:
                idx.extend(req.output_tokens[-n_accepted:])

    def on_evict(self, req) -> None:
        with self._lock:
            self._idx.pop(req.rid, None)

    def info(self) -> dict:
        return {"kind": self.kind, "max_n": self.max_n,
                "draft_calls": self.draft_calls}


class DraftModelDrafter(Drafter):
    """A draft model over the engine's batch-slot layout.

    Its own KV caches ``[max_batch, S_max, ...]`` and a per-request cursor
    ``draft_len`` (cache positions holding K/V of the true stream). Each
    ``propose()`` first catches the cursor up by feeding the true tokens
    the target accepted since the last round, then rolls the draft forward
    k tokens greedily, all in batched ``[B, 1]`` calls of the draft
    model's slot step. ``draft_calls`` counts those calls and the join
    prefills."""

    kind = "model"

    def __init__(self, draft_model, max_batch: int, max_seq_len: int):
        from .engine import _Inputs, _KVBuffer
        self.model = draft_model
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        self._kv = _KVBuffer(draft_model, self.max_batch, self.max_seq_len)
        self._caches = self._kv.caches
        self._in = _Inputs(draft_model.device)
        self._draft_len: Dict[int, int] = {}       # rid -> valid positions
        self._last_k = 0                           # window of the last propose
        self.draft_calls = 0

    def on_join(self, req) -> None:
        """The engine's bucketed batch-1 prefill on the draft weights, into
        the draft's slot row. The bucket ladder is fixed (powers of two
        from 8): padding never changes the draft's cache rows."""
        from .engine import _prefill_scratch
        plen = int(req.prompt.size)
        bucket = 8
        while bucket < plen:
            bucket *= 2
        bucket = min(bucket, self.max_seq_len)
        tok = np.zeros((1, bucket), np.int64)
        tok[0, :plen] = req.prompt
        pref = _prefill_scratch(self.model, self.max_seq_len)
        pref.zero_()
        self.model.slot_step(self._in("tok", tok), pref.caches,
                             self._in("off", np.zeros((1,), np.int32)),
                             self._in("last", np.asarray([plen - 1],
                                                         np.int32)))
        self._kv.write_row(req.slot, pref)
        self._draft_len[req.rid] = plen
        self.draft_calls += 1

    def propose(self, active, k):
        b = self.max_batch
        self._last_k = int(k)
        feeds: Dict[int, List[int]] = {}
        for s, r in active.items():
            stream = list(r.prompt) + list(r.output_tokens)
            dl = self._draft_len.get(r.rid, r.cache_len)
            # true tokens not yet in the draft cache, ending at the
            # pending token (stream[cache_len], not fed anywhere yet)
            feeds[s] = [int(t) for t in stream[dl:r.cache_len + 1]]
        rounds = max(len(f) for f in feeds.values()) + k - 1
        drafts: Dict[int, List[int]] = {s: [] for s in feeds}
        last = {s: feeds[s][0] for s in feeds}
        zeros = self._in("zeros", np.zeros((b,), np.int32))
        for r_i in range(rounds):
            tok = np.zeros((b, 1), np.int64)
            off = np.zeros((b,), np.int32)
            for s, r in active.items():
                f = feeds[s]
                tok[s, 0] = f[r_i] if r_i < len(f) else last[s]
                dl = self._draft_len.get(r.rid, r.cache_len)
                off[s] = min(dl + r_i, self.max_seq_len - 1)
            nxt = self.model.slot_step(self._in("dtok", tok), self._caches,
                                       self._in("doff", off), zeros)
            self.draft_calls += 1
            out = nxt.cpu().numpy()
            for s in feeds:
                if r_i >= len(feeds[s]) - 1 and len(drafts[s]) < k:
                    drafts[s].append(int(out[s]))
                    last[s] = int(out[s])
        return drafts

    def observe(self, req, n_accepted: int) -> None:
        # valid: the true tokens fed plus the accepted proposals that were
        # fed (1..k-1; the k-th is generated last and never written)
        old = req.cache_len - n_accepted
        fed_drafts = min(max(0, n_accepted - 1), max(0, self._last_k - 1))
        self._draft_len[req.rid] = min(old + 1 + fed_drafts, req.cache_len,
                                       self.max_seq_len - 1)

    def on_evict(self, req) -> None:
        self._draft_len.pop(req.rid, None)

    def info(self) -> dict:
        cfg = self.model.config
        return {"kind": self.kind, "draft_calls": self.draft_calls,
                "draft_config": {"hidden": cfg.hidden_size,
                                 "layers": cfg.num_hidden_layers}}


def build_drafter(spec, max_batch: int, max_seq_len: int,
                  draft_model=None) -> Optional[Drafter]:
    """Resolve the engine's drafter knob: a Drafter instance passes
    through; "ngram" (default) needs nothing; "model" needs the
    ``draft_model`` the engine was given."""
    if spec is None or isinstance(spec, Drafter):
        return spec
    name = str(spec).lower()
    if name == "ngram":
        return NGramDrafter()
    if name == "model":
        if draft_model is None:
            raise ValueError(
                "drafter='model' needs a draft_model (a model of the "
                "target's family) passed to the engine")
        return DraftModelDrafter(draft_model, max_batch, max_seq_len)
    raise ValueError(f"unknown drafter {spec!r} (ngram | model | a "
                     f"Drafter instance)")
