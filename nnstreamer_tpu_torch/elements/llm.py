"""tensor_llm: continuous-batching LLM generation as a pipeline element
(counterpart of the JAX package's elements/llm.py).

One buffer in = one generation request (a 1-D int32 prompt); buffers out
= incremental token chunks per request, so downstream sees tokens as
they are produced. The element wraps `llm.engine.LLMEngine` and rides the
scheduler's timer contract (next_deadline/on_timer): process() only
*queues* a request and arms a short admission window; the engine steps
inside on_timer(). Each timer fire runs exactly one serving quantum
(admit + prefill + one decode step for the whole in-flight batch) and
yields the deadline back, so prompts arriving meanwhile are read off the
input channel *between* decode steps and merge into the next one —
continuous batching, not run-to-completion.

Per-request knobs ride `buf.meta["llm"]` (request_id, max_new_tokens,
temperature, top_k, seed, eos_id), defaulting to element properties.
Output buffers carry `meta["llm"]` with the request id, done flag and,
on the final chunk, the request's latency summary.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.graph.pipeline import (
    Element, Emission, PropDef, StreamSpec)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

#: activation dtypes the element serves in
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@register_element("tensor_llm")
class TensorLLM(Element):
    """Continuous-batching generation over a paged KV cache.

    Properties:
    - model: ``store://name[@version]`` ref (hot-swappable through the
      model store unless pinned) or a zoo name; default
      store://transformer.
    - dtype: activation dtype, float32 or bfloat16 (pools and params
      stay f32 at rest; the pools always).
    - scheduling: "continuous" (default) or "static" — the A/B baseline
      where a batch admits only from empty and runs to completion.
    - block_size / num_blocks: paged KV pool geometry (block 0 is the
      padding scratch block; capacity = (num_blocks-1) * block_size
      token slots).
    - max_batch: decode-batch slot ceiling.
    - max_len: per-sequence ceiling (prompt + generated tokens).
    - admit_window_ms: how long a serving step waits for co-arriving
      prompts before the next decode step runs.
    - stream_chunk: emit every N tokens (1 = stream each token).
    - eos_id: stop token (-1 disables); max_new_tokens: token budget.
    - paged_kernel: "pallas" (the hand-written CUDA paged-attention
      kernels, backends/paged_attn.py) or "xla" (the torch reference,
      llm/paged_model.py); "" defers to $NNS_PAGED_KERNEL, then xla. A
      kernel that cannot build or launch raises; nothing falls back.
    - prefill_chunk: prompts longer than this prefill in N-token chunks
      interleaved with decode steps (0 = whole-prompt prefill).
    - shards: tensor-parallel shard count (1/2/4/8): the executor serves
      over that many logical devices (serving/placement.visible_devices;
      ``[parallel] virtual_devices`` maps several onto one card), leased
      as one group, with head-sharded projections and KV pool slices —
      bit-identical to shards=1 by the canonical blocking. Exclusive
      with prefill_chunk and with paged_kernel=pallas.
    - ring_prefill_min: with shards>0, prompts at least this long prefill
      through ring attention over the same devices (allclose, not
      bit-equal, to the blocked path; decode stays blocked).
    - warm_start: replay the persistent bucket manifest's buckets at
      start() ([serving] compile_cache; nothing when it is off).
    - prewarm: run every decode bucket and the prefill buckets up to
      this prompt length once at start() (0 = lazily on first use).
    """

    ELEMENT_NAME = "tensor_llm"
    NUM_SINK_PADS = 1
    NUM_SRC_PADS = 1
    # timer element (decode-step wakeups): needs its own worker loop
    CHAIN_FUSABLE = False
    WANTS_HOST = True
    PROPS = {
        "model": PropDef(str, "store://transformer",
                         "store:// ref or zoo model name"),
        "n_heads": PropDef(int, 4, "attention heads (must match model)"),
        "dtype": PropDef(str, "float32",
                         "activation dtype: float32 | bfloat16"),
        "block_size": PropDef(int, 16, "KV block size in token slots"),
        "num_blocks": PropDef(int, 64,
                              "KV pool size in blocks (incl. scratch)"),
        "max_batch": PropDef(int, 8, "decode-batch slot ceiling"),
        "max_len": PropDef(int, 128,
                           "per-sequence prompt+output ceiling"),
        "max_new_tokens": PropDef(
            int, 32, "default token budget per request"),
        "temperature": PropDef(
            float, 0.0, "default sampling temperature (0 = greedy)"),
        "eos_id": PropDef(int, -1, "default stop token (-1 = disabled)"),
        "scheduling": PropDef(
            str, "continuous", "continuous | static (A/B baseline)"),
        "admit_window_ms": PropDef(
            float, 0.5, "admission window between decode steps"),
        "stream_chunk": PropDef(
            int, 1, "tokens per output buffer (1 = per-token)"),
        "paged_kernel": PropDef(
            str, "", "attention kernel: pallas | xla | '' = "
                     "$NNS_PAGED_KERNEL or xla"),
        "prefill_chunk": PropDef(
            int, 0, "chunked-prefill chunk size in tokens "
                    "(0 = whole-prompt prefill)"),
        "shards": PropDef(
            int, 0, "tensor-parallel shard count (0 = one device; 1/2/4/8 "
                    "serve over that many leased logical devices)"),
        "ring_prefill_min": PropDef(
            int, 0, "with shards>0: prompts at least this long prefill "
                    "through ring attention (0 = always the blocked "
                    "tensor-parallel path)"),
        "warm_start": PropDef(
            int, 1, "replay manifest prefill buckets at start()"),
        "prewarm": PropDef(
            int, 0, "run all decode buckets and prefill buckets up to "
                    "this prompt length at start() (0 = lazily)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.engine = None
        self._leases = None
        self._deadline: Optional[float] = None
        # per-request emission state, engine-thread only
        self._chunks: Dict[str, List[int]] = {}
        self._req_seq = 0
        self.requests_in = 0
        self.chunks_out = 0
        self.warm_compiles = 0

    # -- negotiation -------------------------------------------------------
    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0], 0)
        sched = self.props["scheduling"]
        if sched not in ("continuous", "static"):
            self.fail_negotiation(
                f"scheduling must be 'continuous' or 'static', "
                f"got {sched!r}")
        kern = self.props["paged_kernel"]
        if kern not in ("", "pallas", "xla"):
            self.fail_negotiation(
                f"paged_kernel must be 'pallas', 'xla' or '' "
                f"(env/default), got {kern!r}")
        if self.props["dtype"] not in _DTYPES:
            self.fail_negotiation(
                f"dtype must be one of {sorted(_DTYPES)}, got "
                f"{self.props['dtype']!r}")
        if int(self.props["prefill_chunk"]) < 0:
            self.fail_negotiation(
                f"prefill_chunk must be >= 0, got "
                f"{self.props['prefill_chunk']}")
        shards = int(self.props["shards"])
        if shards > 0:
            from nnstreamer_tpu_torch.serving.sharding import SUPPORTED_SHARDS

            if shards not in SUPPORTED_SHARDS:
                self.fail_negotiation(
                    f"shards must be one of {SUPPORTED_SHARDS} (canonical "
                    f"8-block serving layout), got {shards}")
            if int(self.props["prefill_chunk"]) > 0:
                self.fail_negotiation(
                    "prefill_chunk and shards are exclusive — sharded long "
                    "prompts use ring_prefill_min (sequence-parallel ring "
                    "prefill), not chunking")
            if kern == "pallas":
                self.fail_negotiation(
                    "paged_kernel=pallas runs the single-card paged "
                    "kernels; with shards>0 set paged_kernel=xla")
        elif int(self.props["ring_prefill_min"]) > 0:
            self.fail_negotiation(
                "ring_prefill_min needs shards>0 (ring prefill runs over "
                "the shard group's devices)")
        if spec.format == TensorFormat.STATIC:
            for t in spec.tensors:
                if t.dtype != DType.INT32:
                    self.fail_negotiation(
                        f"tensor_llm consumes int32 token-id prompts, "
                        f"got {t.dtype}")
        # prompts vary per request and chunks per step: both sides of
        # this element are FLEXIBLE streams
        return [TensorsSpec(tensors=(), format=TensorFormat.FLEXIBLE,
                            rate=spec.rate)]

    def start(self) -> None:
        from nnstreamer_tpu_torch.llm.engine import LLMEngine

        model = self.props["model"]
        if isinstance(model, str) and "://" not in model:
            model = f"store://{model}"
        shards = int(self.props["shards"])
        chips = None
        if shards > 0:
            # lease the group's devices under ONE owner, so fencing one
            # member is one ledger flip for the whole group
            from nnstreamer_tpu_torch.serving.placement import (
                VIRTUAL_DEVICES_HINT, ChipLeaseTable, visible_devices)

            ndev = len(visible_devices())
            if shards > ndev:
                raise BackendError(
                    f"tensor_llm {self.name}: shards={shards} needs {shards} "
                    f"devices, {ndev} visible; {VIRTUAL_DEVICES_HINT}")
            self._leases = ChipLeaseTable(range(ndev))
            chips = self._leases.lease(self.name, shards)
        self.engine = LLMEngine(
            model,
            n_heads=int(self.props["n_heads"]),
            dtype=_DTYPES[self.props["dtype"]],
            block_size=int(self.props["block_size"]),
            num_blocks=int(self.props["num_blocks"]),
            max_batch=int(self.props["max_batch"]),
            max_len=int(self.props["max_len"]),
            static_batching=self.props["scheduling"] == "static",
            prefill_chunk=int(self.props["prefill_chunk"]),
            paged_kernel=str(self.props["paged_kernel"]) or None,
            shards=shards, shard_chips=chips,
            ring_prefill_min=int(self.props["ring_prefill_min"]),
            tracer=self._tracer, name=self.name)
        if int(self.props["warm_start"]):
            self.warm_compiles = self.engine.executor.warm_start()
        if int(self.props["prewarm"]) > 0:
            self.warm_compiles += self.engine.prewarm(
                int(self.props["prewarm"]))

    def stop(self) -> None:
        if self.engine is not None:
            self.engine.executor.close()
        if self._leases is not None:
            self._leases.release(self.name)

    # -- dataflow ----------------------------------------------------------
    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        meta = buf.meta.get("llm") if isinstance(buf.meta, dict) else None
        meta = meta if isinstance(meta, dict) else {}
        prompt = np.asarray(buf.tensors[0]).reshape(-1)
        req_id = meta.get("request_id")
        if req_id is None:
            self._req_seq += 1
            req_id = f"{self.name}-{self._req_seq}"
        eos = meta.get("eos_id", int(self.props["eos_id"]))
        self.engine.submit(
            prompt,
            req_id=str(req_id),
            max_new_tokens=int(meta.get(
                "max_new_tokens", self.props["max_new_tokens"])),
            temperature=float(meta.get(
                "temperature", self.props["temperature"])),
            top_k=int(meta.get("top_k", 0)),
            seed=int(meta.get("seed", 0)),
            eos_id=None if eos is None or int(eos) < 0 else int(eos),
            pts=buf.pts)
        self.requests_in += 1
        if self._deadline is None:
            # arm the admission window: co-arriving prompts land in the
            # same first step (the scheduler reads the channel until the
            # deadline, then fires on_timer)
            self._deadline = time.perf_counter() + self._window_s()
        return []

    def _window_s(self) -> float:
        # a non-positive window would starve the input channel (an
        # always-past deadline fires timers forever without reading
        # input) — clamp to one scheduler-visible tick
        return max(0.05, float(self.props["admit_window_ms"])) * 1e-3

    def next_deadline(self) -> Optional[float]:
        return self._deadline

    def on_timer(self) -> List[Emission]:
        if self.engine is None or not self.engine.has_work:
            self._deadline = None
            return []
        events = self.engine.step()
        self._deadline = (time.perf_counter() + self._window_s()
                          if self.engine.has_work else None)
        return self._emit(events)

    def flush(self) -> List[Emission]:
        """EOS: no more requests will arrive — run the engine dry."""
        self._deadline = None
        if self.engine is None or not self.engine.has_work:
            return []
        return self._emit(self.engine.drain())

    # -- emission ----------------------------------------------------------
    def _emit(self, events) -> List[Emission]:
        chunk = max(1, int(self.props["stream_chunk"]))
        out: List[Emission] = []
        for ev in events:
            req = ev.request
            pend = self._chunks.setdefault(req.req_id, [])
            pend.extend(ev.tokens)
            if len(pend) < chunk and not ev.done:
                continue
            del self._chunks[req.req_id]
            meta = {"llm": {
                "request_id": req.req_id,
                "done": ev.done,
                "n_tokens": len(req.tokens),
            }}
            if ev.done:
                meta["llm"].update(req.summary())
            out.append((0, TensorBuffer(
                tensors=(np.asarray(pend, np.int32),),
                pts=req.pts, meta=meta)))
            self.chunks_out += 1
        return out

    # -- stats -------------------------------------------------------------
    def extra_stats(self) -> dict:
        stats = {"requests_in": self.requests_in,
                 "chunks_out": self.chunks_out,
                 "warm_compiles": self.warm_compiles}
        if self.engine is not None:
            stats.update(self.engine.stats())
        if self._leases is not None:
            stats["leases"] = self._leases.snapshot()["counts"]
        return stats
