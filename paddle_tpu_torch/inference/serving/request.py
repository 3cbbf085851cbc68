"""Request lifecycle for the continuous-batching serving engine.

Counterpart of ``paddle_tpu/inference/serving/request.py``. A request moves
QUEUED -> PREFILL -> DECODING -> {FINISHED, TIMED_OUT}. The
scheduler performs every transition between decode steps. The per-request
TTL rides ``utils.deadline.Deadline``; running out of it raises the typed
``RequestTimeout`` from ``result()``. ``wait()`` blocks a caller on another
thread (the gateway's handlers) until the request is terminal.
"""
from __future__ import annotations

import enum
import itertools
import threading
import time
from typing import List, Optional

import numpy as np

from ...utils.deadline import Deadline, RequestTimeout

__all__ = ["RequestState", "TERMINAL_STATES", "Request"]

_rid_counter = itertools.count()


class RequestState(enum.Enum):
    QUEUED = 0      # waiting for a batch slot (pages may be reserved)
    PREFILL = 1     # admitted this step; prompt being prefilled
    DECODING = 2    # occupying a slot in the decode batch
    FINISHED = 3    # hit EOS or max_new_tokens; output complete
    TIMED_OUT = 4   # TTL expired (queued or mid-decode); output partial


TERMINAL_STATES = (RequestState.FINISHED, RequestState.TIMED_OUT)


class Request:
    """One generation request: prompt in, tokens out, typed error on TTL.

    Host-side bookkeeping only; the KV cache slot belongs to the engine.
    ``token_times`` holds a perf_counter stamp per emitted token.
    """

    def __init__(self, prompt_ids, max_new_tokens: int = 16,
                 ttl: Optional[float] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_p: Optional[float] = None,
                 seed: Optional[int] = None):
        self.rid = next(_rid_counter)
        self.prompt = np.asarray(prompt_ids, dtype=np.int64).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("Request: empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("Request: max_new_tokens must be >= 1")
        self.eos_token_id = eos_token_id
        # per-slot sampling (engine-validated: None means greedy); the
        # numpy Generator is the request's own, seeded deterministically,
        # so a sampled stream is reproducible and independent of neighbours
        self.temperature = temperature
        self.top_p = top_p
        self.seed = self.rid if seed is None else int(seed)
        self._rng = None
        self.deadline = Deadline(ttl, what=f"serving request {self.rid}")
        self.state = RequestState.QUEUED
        self.output_tokens: List[int] = []
        self.finish_reason: Optional[str] = None  # "eos"|"length"|"ttl"
        self.error: Optional[BaseException] = None
        self.slot: Optional[int] = None
        self.pages: list = []           # KVPagePool pages reserved for us
        # True while the reservation covers the speculative verify scratch
        # (the ladder's shed_reserve_extra() clears it)
        self.scratch_reserved = False
        # prefix sharing (engine-owned): refs on a committed page chain
        # taken at submit, their KV rows, and the prompt positions whose
        # prefill they skip. Scratch prefill: prefill_pos positions already
        # computed into the request's [1, S_max + W] scratch caches
        self.shared_pages: list = []
        self.shared_kv: list = []
        self.shared_len = 0
        self.prefill_pos = 0
        self.scratch = None
        self.cache_len = 0              # valid KV positions in our slot
        self.next_token: Optional[int] = None   # sampled, not yet fed back
        self.submit_time = time.perf_counter()
        self.token_times: List[float] = []
        self._done = threading.Event()

    def append_token(self, tok: int) -> bool:
        """Record one emitted token; True when the request is complete
        (EOS emitted or max_new_tokens reached)."""
        self.output_tokens.append(int(tok))
        self.token_times.append(time.perf_counter())
        if self.eos_token_id is not None and int(tok) == self.eos_token_id:
            self.finish_reason = "eos"
            return True
        if len(self.output_tokens) >= self.max_new_tokens:
            self.finish_reason = "length"
            return True
        return False

    def finish(self, state: RequestState,
               error: Optional[BaseException] = None):
        """Move to a terminal ``state``; ``error`` (kept as given) is what
        ``result()`` raises. A timeout with no error gets a
        ``RequestTimeout``."""
        self.state = state
        if error is not None:
            self.error = error
        if state is RequestState.TIMED_OUT and self.error is None:
            self.error = RequestTimeout(
                f"serving request {self.rid}", self.deadline.timeout,
                detail=f"{len(self.output_tokens)} token(s) generated")
        self._done.set()

    @property
    def is_sampling(self) -> bool:
        return self.temperature is not None

    @property
    def rng(self) -> np.random.Generator:
        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)
        return self._rng

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request is terminal; False on timeout."""
        return self._done.wait(timeout)

    def result(self) -> np.ndarray:
        """prompt + generated tokens as one int64 array. Raises the typed
        error (RequestTimeout, ...) if the request did not finish cleanly."""
        if not self.done:
            raise RuntimeError(
                f"request {self.rid} still {self.state.name}; drive "
                f"engine.step() (or engine.run()) to completion first")
        if self.error is not None:
            raise self.error
        return np.concatenate(
            [self.prompt, np.asarray(self.output_tokens, np.int64)])

    def __repr__(self):
        return (f"Request(rid={self.rid}, state={self.state.name}, "
                f"prompt={self.prompt.size}, out={len(self.output_tokens)}/"
                f"{self.max_new_tokens})")
