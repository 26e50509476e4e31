"""Continuous-batching generation engine, host half (counterpart of the
JAX package's llm/engine.py).

One `step()` is the serving quantum: admit queued requests while blocks
and batch slots allow (each admission runs a bucketed prefill and yields
its first token), then run ONE decode step for every in-flight sequence
— freshly admitted requests merge into that step's decode batch, and
finished sequences retire at once, returning their blocks to the pool.
`static_batching=True` is the A/B baseline: a batch admits only while
the engine is empty and runs to completion.

Long prompts can chunk-prefill (``prefill_chunk=N``): a prompt longer
than N admits into a ``prefilling`` state and advances one N-token chunk
per step while the decode batch keeps stepping; the final chunk's logits
yield the first token.

Sampling is host numpy on the step's (vocab,) f32 logits: temperature 0
is `np.argmax` (first maximum, as `generate`'s argmax), temperature > 0
draws from a per-request seeded Generator, so a request's tokens do not
depend on its batchmates. Host syncs are batched: every prefill or chunk
launched in a step returns device logits, resolved together by one
`runtime.sync` read-back, plus one for the decode batch.

``decode_window=K`` (0, the default, disables it): when the batch is in
steady state — nothing queued or prefilling, every live row greedy — up
to K decode steps run as one window (`executor.decode_multi`: one
CUDA-graph replay on the card, the token fed back by an on-device
argmax), K rounded down to a power of two and never past any row's
remaining budget. Tokens equal the per-step path's; they arrive in
window-sized bursts, which the inter-token percentiles show.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.runtime.sync import to_host
from nnstreamer_tpu_torch.runtime.tracing import NULL_TRACER, percentile


@dataclass
class LLMRequest:
    """One generation request plus its serving state."""

    req_id: str
    prompt: np.ndarray                  # (plen,) int32, plen >= 1
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_id: Optional[int] = None
    pts: Optional[int] = None           # carried through to emissions
    # -- runtime state (engine-owned) --
    tokens: List[int] = field(default_factory=list)
    state: str = "queued"          # queued | prefilling | active | done
    finish_reason: Optional[str] = None  # eos | length
    block_table: List[int] = field(default_factory=list)
    pos: int = 0                        # next cache write position
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_last: float = 0.0
    itl_ms: List[float] = field(default_factory=list)
    _rng: Any = None

    @property
    def first_token_ms(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return (self.t_first - self.t_submit) * 1e3

    def summary(self) -> dict:
        return {
            "req_id": self.req_id,
            "state": self.state,
            "finish_reason": self.finish_reason,
            "prompt_len": int(self.prompt.shape[0]),
            "n_tokens": len(self.tokens),
            "first_token_ms": self.first_token_ms,
            "itl_p50_ms": percentile(sorted(self.itl_ms), 50)
            if self.itl_ms else None,
        }


@dataclass
class TokenEvent:
    """`step()` output: new tokens for one request (done ⇒ final)."""

    request: LLMRequest
    tokens: List[int]
    done: bool


class LLMEngine:
    """Admission + continuous-batching loop over a PagedLLMExecutor."""

    def __init__(self, model="store://transformer", *, n_heads: int = 4,
                 dtype=None, block_size: int = 16, num_blocks: int = 64,
                 max_batch: int = 8, max_len: int = 128,
                 static_batching: bool = False, prefill_chunk: int = 0,
                 paged_kernel: Optional[str] = None, shards: int = 0,
                 shard_chips=None, ring_prefill_min: int = 0,
                 decode_window: int = 0, tracer=NULL_TRACER,
                 name: str = "llm"):
        from nnstreamer_tpu_torch.backends.llm_exec import PagedLLMExecutor

        self.name = name
        self.tracer = tracer
        self.max_batch = int(max_batch)
        self.static = bool(static_batching)
        self.prefill_chunk = int(prefill_chunk)
        self.decode_window = int(decode_window)
        if self.decode_window < 0:
            raise BackendError(
                f"decode_window must be >= 0, got {self.decode_window}")
        if self.prefill_chunk < 0:
            raise BackendError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        if int(shards) > 0 and self.prefill_chunk > 0:
            raise BackendError(
                f"llm {name}: prefill_chunk and shards are exclusive — "
                f"sharded long prompts go through the sequence-parallel "
                f"ring prefill (ring_prefill_min), not chunking")
        self.executor = PagedLLMExecutor(
            model, n_heads=n_heads, dtype=dtype, block_size=block_size,
            num_blocks=num_blocks, max_len=max_len,
            paged_kernel=paged_kernel, shards=shards,
            shard_chips=shard_chips, ring_prefill_min=ring_prefill_min,
            tracer=tracer, name=name)
        self.cache = self.executor.cache
        self.queue: deque = deque()
        self.active: List[LLMRequest] = []
        self.prefilling: List[LLMRequest] = []
        self._seq = 0
        self.submitted = 0
        self.finished = 0
        self.tokens_out = 0
        self.steps = 0
        self.admission_blocked = 0
        self.decode_windows = 0
        self.window_tokens = 0
        self._first_ms: List[float] = []
        self._itl_ms: List[float] = []

    # -- submission --------------------------------------------------------
    def submit(self, prompt, *, req_id: Optional[str] = None,
               max_new_tokens: int = 32, temperature: float = 0.0,
               top_k: int = 0, seed: int = 0,
               eos_id: Optional[int] = None,
               pts: Optional[int] = None) -> LLMRequest:
        """Queue a request. Rejects (raises) only what can NEVER be
        served — a prompt + budget beyond the per-sequence table or the
        whole pool; a merely full pool queues instead."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] == 0:
            raise BackendError("llm request needs a non-empty prompt")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise BackendError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        ex = self.executor
        total = int(prompt.shape[0]) + max_new_tokens
        seq_cap = ex.max_blocks * self.cache.block_size
        if total > seq_cap:
            raise BackendError(
                f"request needs {total} token slots but max_len={ex.max_len} "
                f"caps a sequence at {seq_cap}; raise max_len/num_blocks "
                f"or shorten the request")
        if self.cache.blocks_for(total) > self.cache.allocator.total:
            raise BackendError(
                f"request needs {self.cache.blocks_for(total)} blocks but "
                f"the pool only has {self.cache.allocator.total}")
        if req_id is None:
            self._seq += 1
            req_id = f"{self.name}-{self._seq}"
        req = LLMRequest(
            req_id=req_id, prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=float(temperature), top_k=int(top_k),
            seed=int(seed), eos_id=None if eos_id is None else int(eos_id),
            pts=pts)
        req.t_submit = time.perf_counter()
        self.queue.append(req)
        self.submitted += 1
        return req

    def prewarm(self, max_prompt: Optional[int] = None) -> int:
        """Run every decode bucket (up to max_batch) and prefill bucket
        (up to `max_prompt`, default max_len) once ahead of traffic."""
        return self.executor.prewarm_buckets(
            max_batch=self.max_batch,
            max_prompt=max_prompt or self.executor.max_len,
            chunk=self.prefill_chunk)

    # -- the serving quantum ----------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active or self.prefilling)

    def step(self) -> List[TokenEvent]:
        """Admit, prefill (whole, or one chunk of a long prompt), one
        decode step, retire. Returns this step's token events."""
        self.executor.maybe_adopt()
        events: List[TokenEvent] = []
        #: (req, device logits) for every prefill completed this step
        pending: List[tuple] = []
        self._admit(pending)
        self._prefill_chunks(pending)
        self._finish_pending(pending, events)
        self._decode(events)
        self.steps += 1
        return events

    def drain(self, max_steps: int = 100000) -> List[TokenEvent]:
        """Run steps until idle (EOS / element flush path)."""
        events: List[TokenEvent] = []
        steps = 0
        while self.has_work:
            events.extend(self.step())
            steps += 1
            if steps >= max_steps:
                raise BackendError(
                    f"llm drain did not converge in {max_steps} steps "
                    f"({len(self.active)} active, {len(self.queue)} queued)")
        return events

    def _admit(self, pending: List[tuple]) -> None:
        # static A/B mode: the batch forms only from empty, no top-up
        if self.static and (self.active or self.prefilling):
            return
        alloc = self.cache.allocator
        # this step's admitted prefills join `active` only in
        # _finish_pending — count them against the cap
        while self.queue and (len(self.active) + len(self.prefilling)
                              + len(pending) < self.max_batch):
            req = self.queue[0]
            plen = int(req.prompt.shape[0])
            need = self.cache.blocks_for(plen + req.max_new_tokens)
            blocks = alloc.alloc(need, owner=req.req_id)
            if blocks is None:
                # head-of-line waits for retirements; admitting a
                # smaller later request instead would starve it
                self.admission_blocked += 1
                return
            self.queue.popleft()
            req.block_table = blocks
            if self.prefill_chunk > 0 and plen > self.prefill_chunk:
                req.state = "prefilling"
                req.pos = 0
                self.prefilling.append(req)
                continue
            req.state = "active"
            logits = self.executor.prefill(req.prompt, blocks, sync=False)
            req.pos = plen
            pending.append((req, logits))

    def _prefill_chunks(self, pending: List[tuple]) -> None:
        """Advance the oldest chunk-prefilling prompt by ONE chunk; when
        its final chunk lands, its logits join this step's pending batch
        and the request enters the decode batch."""
        if not self.prefilling:
            return
        from nnstreamer_tpu_torch.backends.llm_exec import _next_pow2

        req = self.prefilling[0]
        plen = int(req.prompt.shape[0])
        chunk = req.prompt[req.pos:req.pos + self.prefill_chunk]
        logits = self.executor.prefill_chunk(
            chunk, req.pos, req.block_table,
            bucket=_next_pow2(self.prefill_chunk, 8), sync=False)
        req.pos += int(chunk.shape[0])
        if req.pos >= plen:
            self.prefilling.pop(0)
            req.state = "active"
            pending.append((req, logits))

    def _finish_pending(self, pending: List[tuple],
                        events: List[TokenEvent]) -> None:
        """ONE read-back over every prefill the step launched, then
        sample first tokens on the host. Freshly finished requests join
        `active` and merge into this step's decode batch."""
        if not pending:
            return
        arrays = to_host([lg for _, lg in pending], self.tracer,
                         f"{self.name}:prefill_batch")
        for (req, _), lg in zip(pending, arrays):
            tok = self._sample(req, lg)
            self._record_token(req, tok)
            self.active.append(req)
            done = self._maybe_finish(req, tok)
            events.append(TokenEvent(req, [tok], done))

    def _window_len(self, live: List[LLMRequest]) -> int:
        """How many decode steps may run as one window now: 1 means the
        per-step path, >= 2 `decode_multi`. Pending admissions and
        prefills re-form the batch every step, a sampled row needs the
        host's generator every token, sharded decode stays per step, and
        a window never outruns a row's remaining budget (a row that meets
        EOS early has its later tokens discarded). Rounded down to a
        power of two so each batch bucket holds log2(window) graphs."""
        if self.decode_window < 2 or self.queue or self.prefilling:
            return 1
        if self.executor.shards:
            return 1
        if any(r.temperature > 0.0 for r in live):
            return 1
        k = min(self.decode_window,
                min(r.max_new_tokens - len(r.tokens) for r in live))
        if k < 2:
            return 1
        return 1 << (k.bit_length() - 1)

    def _decode(self, events: List[TokenEvent]) -> None:
        live = [r for r in self.active if r.state == "active"]
        if not live:
            return
        k = self._window_len(live)
        if k >= 2:
            toks = self.executor.decode_multi(
                [r.tokens[-1] for r in live],
                [r.block_table for r in live],
                [r.pos for r in live], k)
            self.decode_windows += 1
            for j in range(k):
                for i, req in enumerate(live):
                    if req.state != "active":
                        continue   # retired mid-window: discard its tail
                    req.pos += 1
                    tok = int(toks[i, j])
                    self._record_token(req, tok)
                    done = self._maybe_finish(req, tok)
                    events.append(TokenEvent(req, [tok], done))
                    self.window_tokens += 1
            return
        logits = self.executor.decode(
            [r.tokens[-1] for r in live],
            [r.block_table for r in live],
            [r.pos for r in live])
        for i, req in enumerate(live):
            req.pos += 1
            tok = self._sample(req, logits[i])
            self._record_token(req, tok)
            done = self._maybe_finish(req, tok)
            events.append(TokenEvent(req, [tok], done))

    # -- helpers -----------------------------------------------------------
    def _sample(self, req: LLMRequest, logits: np.ndarray) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        lg = logits.astype(np.float64) / req.temperature
        if req.top_k > 0 and req.top_k < lg.shape[0]:
            kth = np.partition(lg, -req.top_k)[-req.top_k]
            lg = np.where(lg < kth, -np.inf, lg)
        lg -= lg.max()
        p = np.exp(lg)
        p /= p.sum()
        if req._rng is None:
            req._rng = np.random.default_rng(req.seed)
        return int(req._rng.choice(lg.shape[0], p=p))

    def _record_token(self, req: LLMRequest, tok: int) -> None:
        now = time.perf_counter()
        if req.t_first is None:
            req.t_first = now
            self._first_ms.append(req.first_token_ms)
            if self.tracer.active:
                self.tracer.instant(
                    self.name, "first_token", t=now, req=req.req_id,
                    ms=round(req.first_token_ms, 3))
        else:
            itl = (now - req.t_last) * 1e3
            req.itl_ms.append(itl)
            self._itl_ms.append(itl)
        req.t_last = now
        req.tokens.append(tok)
        self.tokens_out += 1

    def _maybe_finish(self, req: LLMRequest, tok: int) -> bool:
        if req.eos_id is not None and tok == req.eos_id:
            req.finish_reason = "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
        else:
            return False
        req.state = "done"
        self.cache.allocator.free_blocks(req.block_table)
        req.block_table = []
        if req in self.active:
            self.active.remove(req)
        self.finished += 1
        if self.tracer.active:
            self.tracer.record_llm_request(
                self.name, req.req_id, time.perf_counter(),
                **{k: v for k, v in req.summary().items()
                   if k != "req_id"})
        return True

    def latency_ms(self) -> dict:
        """Time to first token and inter-token latency samples (ms) of
        every request so far, sorted."""
        return {"first_token": sorted(self._first_ms),
                "inter_token": sorted(self._itl_ms)}

    def stats(self) -> dict:
        lat = self.latency_ms()
        out = {
            "submitted": self.submitted,
            "finished": self.finished,
            "queued": len(self.queue),
            "active": len(self.active),
            "prefilling": len(self.prefilling),
            "tokens_out": self.tokens_out,
            "steps": self.steps,
            "admission_blocked": self.admission_blocked,
            "scheduling": "static" if self.static else "continuous",
            "prefill_chunk": self.prefill_chunk,
            "decode_window": self.decode_window,
            "decode_windows": self.decode_windows,
            "window_tokens": self.window_tokens,
            "cache": self.cache.stats(),
            "executor": self.executor.stats(),
        }
        for key, vals in (("first_token_ms", lat["first_token"]),
                          ("inter_token_ms", lat["inter_token"])):
            if vals:
                out[key] = {f"p{p}": round(percentile(vals, p), 3)
                            for p in (50, 95, 99)}
        return out
