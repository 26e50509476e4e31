"""Continuous-batching LLM serving on the port (nnstreamer_tpu_torch/llm,
tensor_llm) against the JAX package.

The gate: at temperature 0 the port's paged engine — on the torch
reference (`paged_kernel=xla`) and on the kernel path (`pallas`, whose
wrappers take the plain versions for CPU tensors) — gives the same tokens
as the JAX package's `transformer.generate`, on the same bridged params
(the params of tests/test_llm.py: vocab 61, d 32, 2 layers, 4 heads, 2 kv
heads). Around it: the transformer itself, allocator invariants,
admission under a full pool, unservable requests, EOS retirement, static
batching, a store hot swap, the element end to end, the scheduler's
timer contract, and the port's refusals (no card and no CPU request,
a shard group wider than the visible devices, a negative decode
window). A
W8A8 store version (models/quant.quantize_transformer) is served through
tensor_llm and held to the JAX package's LLMEngine on the same quantized
params; a swap from the float version to it reroutes whole prompts
through the chunk family; a bf16 run keeps its scales in f32.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.llm import LLMEngine as JaxLLMEngine
from nnstreamer_tpu.models import quant as jq
from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu_torch.backends import paged_attn
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
from nnstreamer_tpu_torch.core.errors import (
    BackendError, NegotiationError, StreamError)
from nnstreamer_tpu_torch.core.registry import PluginKind, registry
from nnstreamer_tpu_torch.elements import AppSrc, TensorLLM, TensorSink
from nnstreamer_tpu_torch.graph.pipeline import Element
from nnstreamer_tpu_torch.llm import BlockAllocator, LLMEngine
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import transformer as tt
from nnstreamer_tpu_torch.runtime.channel import TIMED_OUT, Channel
from nnstreamer_tpu_torch.serving.store import (
    get_store, parse_store_ref, reset_store)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

MAX_LEN = 64
LOGIT_TOL = 1e-5      # f32 both sides; the frameworks sum in other orders


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_params(seed=0):
    return jt.init_params(vocab=61, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, seed=seed)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's bridged copy)."""
    jp = _jax_params()
    return jp, bridge.transformer_params(
        jax.tree_util.tree_map(np.asarray, jp))


def _ref(jp, prompt, n):
    return np.asarray(jt.generate(jp, np.asarray(prompt)[None, :], n,
                                  n_heads=4, max_len=MAX_LEN))[0, len(prompt):]


def _engine(tp, **kw):
    kw = {"n_heads": 4, "block_size": 4, "num_blocks": 32, "max_batch": 4,
          "max_len": MAX_LEN, **kw}
    return LLMEngine(tp, **kw)


# -- the transformer ----------------------------------------------------------

def test_apply_seq_kv_matches_jax(params):
    jp, tp = params
    ids = np.random.default_rng(1).integers(0, 61, (2, 9)).astype(np.int32)
    jl, jk, jv = jt.apply_seq_kv(jp, ids, n_heads=4)
    tl, tk, tv = tt.apply_seq_kv(tp, torch.from_numpy(ids), n_heads=4)
    for j, t in ((jl, tl), (jk, tk), (jv, tv)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("plen", [1, 5])
def test_generate_matches_jax(params, plen):
    jp, tp = params
    prompt = np.random.default_rng(plen).integers(0, 61, plen).astype(
        np.int32)
    got = tt.generate(tp, prompt[None, :], 8, n_heads=4, max_len=MAX_LEN)
    assert np.array_equal(got[0, plen:].numpy(), _ref(jp, prompt, 8))


def test_zoo_transformer_seeds_the_store():
    reset_store()
    try:
        entry = get_store().entry("transformer")
        assert entry.current == 0
        p = entry.bundle(0).params
        assert tuple(p["embed"].shape) == (256, 64) and len(p["blocks"]) == 2
    finally:
        reset_store()


# -- block allocator ----------------------------------------------------------

def test_allocator_alloc_free_invariants():
    a = BlockAllocator(8)            # 1 scratch + 7 usable
    assert a.total == 7 and a.free == 7 and a.used == 0
    got = a.alloc(3, owner="r1")
    assert len(got) == 3 and 0 not in got        # scratch never granted
    assert a.used == 3 and a.high_water == 3
    assert a.alloc(5) is None                    # all-or-nothing
    assert a.free == 4 and a.failed_allocs == 1
    a.free_blocks(got)
    assert a.free == 7 and a.used == 0 and a.high_water == 3
    again = a.alloc(7)
    assert sorted(set(again)) == sorted(again) and len(again) == 7
    assert a.stats()["utilization"] == 1.0


@pytest.mark.parametrize("blocks", [None, [0]],
                         ids=["double-free", "scratch"])
def test_allocator_refuses_bad_frees(blocks):
    a = BlockAllocator(4)
    got = a.alloc(2)
    a.free_blocks(got)
    with pytest.raises(ValueError):
        a.free_blocks(blocks or got)


def test_allocator_rejects_degenerate_pool():
    with pytest.raises(ValueError):
        BlockAllocator(1)


# -- engine: parity, admission, retirement ------------------------------------

@pytest.mark.parametrize("kernel,chunk", [("xla", 0), ("pallas", 0),
                                          ("xla", 4), ("pallas", 4)])
def test_engine_interleaved_lengths_match_generate(params, kernel, chunk):
    """Concurrent requests of different lengths in one continuous batch,
    whole or chunked prefill, on both attention paths: each stream equals
    its own single-sequence generate(), and retirements free every
    block. On CPU tensors the kernel path runs the plain versions."""
    jp, tp = params
    launches = (paged_attn.paged_decode_attn.launches,
                paged_attn.paged_prefill_attn.launches)
    eng = _engine(tp, paged_kernel=kernel, prefill_chunk=chunk)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 61, size=n).astype(np.int32)
               for n in (1, 4, 7, 11)]
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.drain()
    for p, r in zip(prompts, reqs):
        assert np.array_equal(np.array(r.tokens), _ref(jp, p, 6)), len(p)
    assert eng.cache.allocator.used == 0
    ex = eng.stats()["executor"]
    assert ex["paged_kernel"] == kernel and ex["kernel_fallback"] == 0
    assert ex["kernel_invokes"][kernel] > 0
    assert ex["kernel_invokes"]["xla" if kernel == "pallas" else
                                "pallas"] == 0
    assert (paged_attn.paged_decode_attn.launches,
            paged_attn.paged_prefill_attn.launches) == launches


def test_staggered_admission_matches_generate(params):
    jp, tp = params
    eng = _engine(tp)
    a = eng.submit(np.array([9, 2, 40, 11], np.int32), max_new_tokens=10)
    eng.step()                       # a is prefilled and decoding
    b = eng.submit(np.array([33, 1], np.int32), max_new_tokens=5)
    eng.drain()
    assert np.array_equal(np.array(a.tokens), _ref(jp, a.prompt, 10))
    assert np.array_equal(np.array(b.tokens), _ref(jp, b.prompt, 5))


def test_admission_queues_when_pool_full(params):
    """More requests than the pool holds: latecomers queue (never crash)
    and complete as retirements free blocks."""
    jp, tp = params
    eng = _engine(tp, num_blocks=8, max_batch=8, max_len=16)
    # each needs ceil((2+6)/4) = 2 blocks of 7 usable: at most 3 resident
    reqs = [eng.submit(np.array([i + 1, i + 2], np.int32), max_new_tokens=6)
            for i in range(6)]
    eng.drain()
    assert all(r.finish_reason == "length" and len(r.tokens) == 6
               for r in reqs)
    assert eng.admission_blocked > 0
    assert eng.cache.allocator.failed_allocs > 0
    assert eng.cache.allocator.used == 0
    for r in reqs:
        assert np.array_equal(np.array(r.tokens), _ref(jp, r.prompt, 6))


@pytest.mark.parametrize("prompt,budget", [
    (np.arange(10, dtype=np.int32), 20),       # past the table
    (np.array([], np.int32), 4),               # empty prompt
    (np.array([1], np.int32), 0),              # no budget
])
def test_submit_rejects_unservable_request(params, prompt, budget):
    eng = _engine(params[1], num_blocks=8, max_batch=2, max_len=16)
    with pytest.raises(BackendError):
        eng.submit(prompt, max_new_tokens=budget)


def test_eos_retires_and_frees_blocks(params):
    """Learn a token the model emits, rerun with it as eos_id: the
    request stops AT it and returns its blocks."""
    _, tp = params
    eng = _engine(tp)
    prompt = np.array([12, 30], np.int32)
    probe = eng.submit(prompt, max_new_tokens=8)
    eng.drain()
    eos = probe.tokens[3]
    req = eng.submit(prompt, max_new_tokens=8, eos_id=eos)
    eng.drain()
    assert req.finish_reason == "eos" and req.tokens[-1] == eos
    assert len(req.tokens) == probe.tokens.index(eos) + 1
    assert eng.cache.allocator.used == 0


def test_static_batching_runs_to_completion(params):
    jp, tp = params
    eng = _engine(tp, max_batch=2, static_batching=True)
    reqs = [eng.submit(np.array([7 * (i + 1)], np.int32), max_new_tokens=4)
            for i in range(3)]
    eng.step()                       # admits exactly max_batch
    assert len(eng.active) == 2 and len(eng.queue) == 1
    eng.step()
    assert len(eng.queue) == 1       # no top-up mid-batch
    eng.drain()
    for r in reqs:
        assert np.array_equal(np.array(r.tokens), _ref(jp, r.prompt, 4))


def test_store_hot_swap_adopts_new_weights(params):
    """The executor rides the store epoch: after update(), the next step
    serves the new version's weights."""
    jp, tp = params
    jp2 = _jax_params(seed=9)
    tp2 = bridge.transformer_params(jax.tree_util.tree_map(np.asarray, jp2))
    reset_store()
    try:
        store = get_store()
        store.register("llm_swap_t", ModelBundle(fn=None, params=tp))
        eng = LLMEngine("store://llm_swap_t", n_heads=4, block_size=4,
                        num_blocks=32, max_batch=4, max_len=MAX_LEN)
        prompt = np.array([3, 44, 8], np.int32)
        r1 = eng.submit(prompt, max_new_tokens=5)
        eng.drain()
        assert np.array_equal(np.array(r1.tokens), _ref(jp, prompt, 5))
        store.register("llm_swap_t", ModelBundle(fn=None, params=tp2))
        report = store.update("llm_swap_t")
        assert report["to_version"] == 2 and report["handles"] == 1
        r2 = eng.submit(prompt, max_new_tokens=5)
        eng.drain()
        assert eng.executor.swap_count == 1
        assert eng.stats()["executor"]["store"] == "llm_swap_t@2"
        # first runs of each bucket are noted against the serving version
        assert ("decode", 1) in store.entry("llm_swap_t").buckets(1)
        assert np.array_equal(np.array(r2.tokens), _ref(jp2, prompt, 5))
    finally:
        reset_store()


def test_store_swap_refuses_other_geometry(params):
    reset_store()
    try:
        store = get_store()
        store.register("llm_geo_t", ModelBundle(fn=None, params=params[1]))
        eng = LLMEngine("store://llm_geo_t", n_heads=4, block_size=4,
                        num_blocks=32, max_batch=4, max_len=MAX_LEN)
        wider = tt.init_params(vocab=61, d_model=32, n_layers=3, n_heads=4,
                               n_kv_heads=2)
        store.register("llm_geo_t", ModelBundle(fn=None, params=wider))
        with pytest.raises(BackendError, match="geometry"):
            store.update("llm_geo_t")
        assert eng.executor.swap_count == 0
    finally:
        reset_store()


def test_store_refuses_unported_refs(params):
    reset_store()
    try:
        get_store().register("llm_ref_t", ModelBundle(fn=None,
                                                      params=params[1]))
        with pytest.raises(BackendError, match="no version alias 'prod'"):
            _engine("store://llm_ref_t@prod")
        with pytest.raises(BackendError, match="no version 7"):
            _engine("store://llm_ref_t@7")
        with pytest.raises(BackendError, match="no model named"):
            _engine("store://no_such_model")
    finally:
        reset_store()


@pytest.mark.parametrize("ref,name,version", [
    ("store://m", "m", None), ("store://m@3", "m", 3),
    ("store://m@latest", "m", None), ("store://m@prod", "m", "prod")])
def test_parse_store_ref(ref, name, version):
    r = parse_store_ref(ref)
    assert (r.name, r.version) == (name, version)


# -- refusals ----------------------------------------------------------------

def test_no_card_and_no_cpu_request_raises(params, monkeypatch):
    monkeypatch.delenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendError, match="accelerator=cpu"):
        _engine(params[1], paged_kernel="pallas")


@pytest.mark.parametrize("kw,match", [
    # one logical device here: a 2-way group names the fix
    ({"shards": 2}, "virtual_devices"),
    ({"ring_prefill_min": 64}, "needs shards"),
    ({"decode_window": -1}, "decode_window must be >= 0"),
    ({"paged_kernel": "triton"}, "paged_kernel")])
def test_engine_refuses_unported_options(params, kw, match):
    with pytest.raises(BackendError, match=match):
        _engine(params[1], **kw)


# -- the scheduler's timer contract -------------------------------------------

def test_channel_get_times_out_at_deadline():
    ch = Channel(2)
    t0 = time.perf_counter()
    assert ch.get(t0 + 0.02) == (TIMED_OUT, 0)
    assert time.perf_counter() - t0 >= 0.015
    ch.put("x")
    assert ch.get(time.perf_counter() + 5) == ("x", 0)


def test_scheduler_fires_timers_without_input():
    """A timer element's worker wakes at its deadline with no buffer in
    its channel, and on_timer emissions flow downstream."""

    class Ticker(Element):
        ELEMENT_NAME = "ticker"

        def __init__(self, **kw):
            super().__init__(**kw)
            self.deadline = None
            self.fired = threading.Event()

        def negotiate(self, in_specs):
            return [in_specs[0]]

        def process(self, pad, buf):
            self.deadline = time.perf_counter() + 0.01
            return []                    # hold the buffer until the timer

        def next_deadline(self):
            return self.deadline

        def on_timer(self):
            self.deadline = None
            self.fired.set()
            return [(0, TensorBuffer.of(np.ones(2, np.float32)))]

    spec = TensorsSpec.from_strings("2", "float32")
    src, tick, sink = AppSrc(name="s", spec=spec), Ticker(), TensorSink()
    pipe = tnns.Pipeline()
    for e in (src, tick, sink):
        pipe.add(e)
    pipe.link(src, tick)
    pipe.link(tick, sink)
    runner = tnns.PipelineRunner(pipe).start()
    try:
        src.push(np.zeros(2, np.float32))
        assert tick.fired.wait(10)       # no second buffer, no EOS yet
        src.end()
        runner.wait(30)
    finally:
        runner.stop()
    assert [b.tensors[0].tolist() for b in sink.results] == [[1.0, 1.0]]


# -- tensor_llm ---------------------------------------------------------------

def _llm_pipeline(tp, **llm_props):
    reset_store()
    get_store().register("llm_el_t", ModelBundle(fn=None, params=tp))
    src = AppSrc(name="src", spec=TensorsSpec(
        tensors=(), format=TensorFormat.FLEXIBLE))
    llm = TensorLLM(name="llm", model="store://llm_el_t", block_size=4,
                    num_blocks=32, max_batch=4, max_len=MAX_LEN,
                    **llm_props)
    sink = TensorSink(name="sink")
    pipe = tnns.Pipeline()
    for e in (src, llm, sink):
        pipe.add(e)
    pipe.link(src, llm)
    pipe.link(llm, sink)
    return pipe, src, llm, sink


@pytest.mark.parametrize("props", [
    {"paged_kernel": "xla"},
    {"paged_kernel": "pallas", "prefill_chunk": 4},
], ids=["xla", "pallas-chunked"])
def test_tensor_llm_concurrent_requests_match_generate(params, props):
    """appsrc ! tensor_llm ! tensor_sink with 4 concurrent requests:
    every request ends with exactly its budget, streamed token by token,
    equal to JAX generate()."""
    jp, tp = params
    budgets = {"r0": 3, "r1": 6, "r2": 2, "r3": 5}
    pipe, src, llm, sink = _llm_pipeline(tp, **props)
    runner = tnns.PipelineRunner(pipe).start()
    try:
        rng = np.random.default_rng(11)
        prompts = {}
        for rid, budget in budgets.items():
            p = rng.integers(0, 61, size=int(rng.integers(1, 9))) \
                .astype(np.int32)
            prompts[rid] = p
            src.push(TensorBuffer(
                tensors=(p,), pts=0,
                meta={"llm": {"request_id": rid, "max_new_tokens": budget}}))
        src.end()
        runner.wait(120)
    finally:
        runner.stop()
        reset_store()
    got, finals = {}, {}
    for b in sink.results:
        m = b.meta["llm"]
        got.setdefault(m["request_id"], []).extend(
            int(t) for t in np.asarray(b.tensors[0]))
        if m["done"]:
            finals[m["request_id"]] = m
    assert set(got) == set(budgets)
    for rid, budget in budgets.items():
        assert len(got[rid]) == budget, rid
        assert finals[rid]["finish_reason"] == "length"
        assert np.array_equal(np.array(got[rid]),
                              _ref(jp, prompts[rid], budget)), rid
    stats = llm.extra_stats()
    assert stats["finished"] == 4 and stats["cache"]["blocks_used"] == 0
    assert stats["executor"]["kernel_invokes"][props["paged_kernel"]] > 0


def test_tensor_llm_properties_registered():
    cls = registry.get(PluginKind.ELEMENT, "tensor_llm")
    assert cls is TensorLLM and tnns.TensorLLM is TensorLLM
    for prop in ("model", "n_heads", "dtype", "scheduling", "block_size",
                 "num_blocks", "max_batch", "max_len", "max_new_tokens",
                 "temperature", "eos_id", "admit_window_ms", "stream_chunk",
                 "paged_kernel", "prefill_chunk", "shards",
                 "ring_prefill_min", "warm_start", "prewarm"):
        assert prop in cls.PROPS, prop
    assert not cls.CHAIN_FUSABLE and cls.WANTS_HOST


@pytest.mark.parametrize("props,match", [
    ({"shards": 3}, "shards must be one of"),
    ({"ring_prefill_min": 8}, "needs shards"),
    ({"dtype": "float16"}, "dtype"), ({"paged_kernel": "cuda"},
                                      "paged_kernel")])
def test_tensor_llm_negotiation_refusals(params, props, match):
    pipe, *_ = _llm_pipeline(params[1], **props)
    try:
        with pytest.raises(NegotiationError, match=match):
            tnns.PipelineRunner(pipe).start()
    finally:
        reset_store()


def test_tensor_llm_prewarm_bf16_serves(params):
    """bf16 activations with prewarm: every bucket runs before traffic,
    so serving adds no first runs; tokens are produced and finite."""
    _, tp = params
    pipe, src, llm, sink = _llm_pipeline(tp, dtype="bfloat16", prewarm=16,
                                         paged_kernel="pallas",
                                         stream_chunk=4)
    runner = tnns.PipelineRunner(pipe).start()
    try:
        compiles = llm.engine.executor.compile_count
        assert compiles == llm.warm_compiles > 0
        src.push(TensorBuffer(tensors=(np.arange(1, 10, dtype=np.int32),),
                              meta={"llm": {"max_new_tokens": 6}}))
        src.end()
        runner.wait(60)
    finally:
        runner.stop()
        reset_store()
    toks = [int(t) for b in sink.results for t in np.asarray(b.tensors[0])]
    assert len(toks) == 6 and all(0 <= t < 61 for t in toks)
    assert [len(b.tensors[0]) for b in sink.results] == [4, 2]
    assert llm.engine.executor.compile_count == compiles


def test_tensor_llm_failure_surfaces(params):
    """A request the engine cannot serve fails the pipeline loudly."""
    pipe, src, llm, sink = _llm_pipeline(params[1])
    runner = tnns.PipelineRunner(pipe).start()
    try:
        src.push(TensorBuffer(tensors=(np.arange(60, dtype=np.int32),),
                              meta={"llm": {"max_new_tokens": 10}}))
        src.end()
        with pytest.raises(StreamError, match="token slots"):
            runner.wait(30)
    finally:
        runner.stop()
        reset_store()


# -- W8A8 serving --------------------------------------------------------------

@pytest.fixture(scope="module")
def qparams(params):
    """(JAX W8A8 params, the port's bridged copy) of the same model."""
    jpq = jq.quantize_transformer(params[0])
    return jpq, bridge.transformer_params(
        jax.tree_util.tree_map(np.asarray, jpq))


W8A8_PROMPTS = {"q0": np.array([5, 17, 33], np.int32),
                "q1": np.array([41, 2, 9, 60, 12, 7], np.int32)}
W8A8_NEW = 4


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_tensor_llm_w8a8_matches_jax_engine(qparams, kernel):
    """appsrc ! tensor_llm ! tensor_sink serving a W8A8 store version gives
    the tokens of the JAX package's LLMEngine on the same quantized params
    and the same paged_kernel (its Pallas kernels in interpret mode)."""
    jpq, tpq = qparams
    eng = JaxLLMEngine(dict(jpq), n_heads=4, block_size=4, num_blocks=32,
                       max_batch=4, max_len=MAX_LEN, paged_kernel=kernel)
    jreqs = {rid: eng.submit(p, max_new_tokens=W8A8_NEW)
             for rid, p in W8A8_PROMPTS.items()}
    eng.drain()
    pipe, src, llm, sink = _llm_pipeline(tpq, paged_kernel=kernel)
    runner = tnns.PipelineRunner(pipe).start()
    try:
        for rid, p in W8A8_PROMPTS.items():
            src.push(TensorBuffer(tensors=(p,), pts=0, meta={"llm": {
                "request_id": rid, "max_new_tokens": W8A8_NEW}}))
        src.end()
        runner.wait(120)
    finally:
        runner.stop()
        reset_store()
    got = {}
    for b in sink.results:
        got.setdefault(b.meta["llm"]["request_id"], []).extend(
            int(t) for t in np.asarray(b.tensors[0]))
    assert got == {rid: list(r.tokens) for rid, r in jreqs.items()}
    ex = llm.extra_stats()["executor"]
    assert ex["chunk_prefills"] == len(W8A8_PROMPTS) and ex["prefills"] == 0


def test_store_swap_to_w8a8_reroutes_prefill(params, qparams):
    """A hot swap from the float version to its W8A8 version on the torch
    reference arm: whole prompts leave `apply_seq_kv` (float-only) for the
    quant-aware chunk family, and the tokens are the W8A8 model's."""
    jpq, tpq = qparams
    reset_store()
    try:
        store = get_store()
        store.register("llm_q_t", ModelBundle(fn=None, params=params[1]))
        eng = LLMEngine("store://llm_q_t", n_heads=4, block_size=4,
                        num_blocks=32, max_batch=4, max_len=MAX_LEN)
        ex = eng.executor
        prompt = W8A8_PROMPTS["q1"]
        r1 = eng.submit(prompt, max_new_tokens=W8A8_NEW)
        eng.drain()
        assert ex._prefill_kind() == "prefill"
        assert (ex.prefills, ex.chunk_prefills) == (1, 0)
        assert np.array_equal(np.array(r1.tokens),
                              _ref(params[0], prompt, W8A8_NEW))
        store.register("llm_q_t", ModelBundle(fn=None, params=tpq))
        store.update("llm_q_t")
        r2 = eng.submit(prompt, max_new_tokens=W8A8_NEW)
        eng.drain()
        assert ex.swap_count == 1 and ex._prefill_kind() == "chunk"
        assert (ex.prefills, ex.chunk_prefills) == (1, 1)
        assert ex.params["blocks"][0]["wqkv"].dtype == torch.int8
    finally:
        reset_store()
    jeng = JaxLLMEngine(dict(jpq), n_heads=4, block_size=4, num_blocks=32,
                        max_batch=4, max_len=MAX_LEN)
    want = jeng.submit(prompt, max_new_tokens=W8A8_NEW)
    jeng.drain()
    assert list(r2.tokens) == list(want.tokens)


def test_bf16_w8a8_place_keeps_scales_f32(qparams):
    """A bf16 run places a W8A8 version with its int8 weights int8 and
    every ``*_scale`` in f32, as the JAX package keeps them; the rest of
    the floats go to bf16. It serves finite tokens."""
    eng = _engine(qparams[1], dtype=torch.bfloat16)
    p = eng.executor.params
    blocks = p["blocks"]
    assert p["head"].dtype == torch.int8 and \
        p["head_scale"].dtype == torch.float32
    for blk in blocks:
        for name in ("wqkv", "wo", "wi", "wd"):
            assert blk[name].dtype == torch.int8
            assert blk[name].stride() == (1, blk[name].shape[0])
            assert blk[f"{name}_scale"].dtype == torch.float32
        assert blk["ln1"].dtype == torch.bfloat16
    assert p["embed"].dtype == torch.bfloat16
    req = eng.submit(W8A8_PROMPTS["q0"], max_new_tokens=3)
    eng.drain()
    assert len(req.tokens) == 3 and all(0 <= t < 61 for t in req.tokens)
