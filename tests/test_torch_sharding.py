"""Sharded LLM serving on the port (nnstreamer_tpu_torch/serving/sharding,
placement, the executor's and tensor_llm's ``shards``/``ring_prefill_min``)
against the JAX package's serving/sharding.py.

The port runs its shard groups on logical CPU devices
(``[parallel] virtual_devices`` through monkeypatch, the CPU asked for);
the JAX side on the 8-device virtual CPU mesh (tests/conftest.py), on
tests/test_sharding.py's geometry. The gates:

- the canonical blocked params equal JAX's leaf for leaf;
- the port's logits at shards 1/2/4/8 are `np.array_equal` to each other
  (the fixed 8-block order) and within 1e-4 · max|logit| of JAX's sharded
  executor (f32, the frameworks sum in other orders). JAX runs at one
  width only: each JAX width is a fresh compile on the CPU mesh;
- tensor_llm with shards (with and without the ring) emits the tokens of
  the JAX package's element on the same bridged params;
- the refusals, the lease ledger and the logical-device map.
"""

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.llm_exec import (
    PagedLLMExecutor as JaxPagedLLMExecutor)
from nnstreamer_tpu.backends.xla import ModelBundle as JaxModelBundle
from nnstreamer_tpu.elements import AppSrc as JAppSrc
from nnstreamer_tpu.elements import TensorLLM as JTensorLLM
from nnstreamer_tpu.elements import TensorSink as JTensorSink
from nnstreamer_tpu.models import quant as jq
from nnstreamer_tpu.models import transformer as jt
from nnstreamer_tpu.serving import sharding as jsh
from nnstreamer_tpu.serving.store import get_store as j_get_store
from nnstreamer_tpu.serving.store import reset_store as j_reset_store
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JTensorBuffer
from nnstreamer_tpu.tensor.info import TensorFormat as JTensorFormat
from nnstreamer_tpu.tensor.info import TensorsSpec as JTensorsSpec
from nnstreamer_tpu_torch.backends.llm_exec import PagedLLMExecutor
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
from nnstreamer_tpu_torch.core.errors import (
    BackendError, ConfigError, NegotiationError)
from nnstreamer_tpu_torch.elements import AppSrc, TensorLLM, TensorSink
from nnstreamer_tpu_torch.llm import LLMEngine
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.serving import placement
from nnstreamer_tpu_torch.serving import sharding as tsh
from nnstreamer_tpu_torch.serving.store import get_store, reset_store
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorFormat, TensorsSpec

#: tests/test_sharding.py's geometry (8 heads: every shard count divides)
GEOM = dict(d_model=64, n_heads=8, n_layers=2, vocab=256)
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "8")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's bridged copy)."""
    jp = jt.init_params(**GEOM)
    return jp, bridge.transformer_params(
        jax.tree_util.tree_map(np.asarray, jp))


def _exec(tp, shards, ring_min=0, **kw):
    return PagedLLMExecutor(tp, n_heads=8, block_size=8, num_blocks=16,
                            max_len=64, shards=shards,
                            ring_prefill_min=ring_min, **kw)


def _serve(ex, prompt, steps=4):
    """Prefill, then `steps` greedy decode steps → every step's logits."""
    blocks = ex.cache.allocator.alloc(ex.cache.blocks_for(len(prompt) + steps))
    lg = ex.prefill(prompt, blocks)
    outs = [np.asarray(lg)]
    tok, pos = int(np.argmax(lg)), len(prompt)
    for _ in range(steps):
        dl = ex.decode([tok], [blocks], [pos])
        outs.append(np.asarray(dl[0]))
        tok, pos = int(np.argmax(dl[0])), pos + 1
    return outs


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 256, n).astype(np.int32)


# -- blocked weights ---------------------------------------------------------------

def test_blocked_params_match_jax_leaf_for_leaf(params):
    jp, tp = params
    want = jsh.blocked_transformer_params(jp, n_heads=8)
    got = tsh.blocked_transformer_params(tp, n_heads=8)
    jl, jdef = jax.tree_util.tree_flatten(want)
    tl, tdef = jax.tree_util.tree_flatten(got)
    assert tdef == jdef
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        assert np.array_equal(t.numpy(), np.asarray(j))


# -- the executor ----------------------------------------------------------------------

def test_logits_bit_equal_across_widths_and_close_to_jax(eight_cpu_devices,
                                                         params):
    """Blocked prefill + paged decode at shards 1/2/4/8 bit-identical
    (the numerics never see the shard count), and within LOGIT_TOL of the
    JAX package's sharded executor at shards=2."""
    jp, tp = params
    prompt = _prompt(11, 1)
    ref = None
    for n in (1, 2, 4, 8):
        ex = _exec(tp, n)
        outs = _serve(ex, prompt)
        st = ex.stats()
        ex.close()
        assert st["shards"] == n and st["shard_chips"] == list(range(n))
        assert st["shard_devices"] == ["cpu"] * n
        assert st["kernel_fallback"] == 0
        if ref is None:
            ref = outs
        for a, b in zip(outs, ref):
            assert np.array_equal(a, b)
    jex = JaxPagedLLMExecutor(dict(jp), n_heads=8, block_size=8,
                              num_blocks=16, max_len=64, shards=2)
    try:
        want = _serve(jex, prompt)
    finally:
        jex.close()
    top = max(float(np.abs(w).max()) for w in want)
    for a, w in zip(ref, want):
        np.testing.assert_allclose(a, w, rtol=0, atol=LOGIT_TOL * top)
    # and the unsharded port within float reassociation of the blocks
    ex = _exec(tp, 0)
    for a, b in zip(_serve(ex, prompt), ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL * top)
    ex.close()


def test_ring_prefill_cutover(params):
    """Prompts >= ring_prefill_min prefill through the ring (its bucket,
    counted under kernel_invokes["xla"]): logits close to the blocked
    prefill's, and the decode after it, reading the ring-written pool
    slices, close too."""
    _, tp = params
    prompt = _prompt(24, 7)
    ex_r, ex_b = _exec(tp, 2, ring_min=16), _exec(tp, 2)
    ring, blocked = _serve(ex_r, prompt, 2), _serve(ex_b, prompt, 2)
    kinds = {k[0] for k in ex_r._seen}
    st = ex_r.stats()
    assert kinds == {"ring", "decode"}
    assert {k[0] for k in ex_b._seen} == {"prefill", "decode"}
    assert st["kernel_invokes"] == {"pallas": 0, "xla": 3}
    assert st["ring_prefill_min"] == 16
    top = float(np.abs(blocked[0]).max())
    for a, b in zip(ring, blocked):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL * top)
    # a short prompt stays on the blocked path
    ex = _exec(tp, 2, ring_min=16)
    _serve(ex, _prompt(8, 2), 1)
    assert {k[0] for k in ex._seen} == {"prefill", "decode"}


def test_prewarm_covers_ring_buckets(params):
    _, tp = params
    ex = _exec(tp, 4, ring_min=16)
    n = ex.prewarm_buckets(max_batch=2, max_prompt=32)
    assert ("ring", 16, "xla") in ex._seen and ("ring", 32, "xla") in \
        ex._seen
    assert n == ex.compile_count == len(ex._seen)
    assert ex.cache.allocator.used == 0


def test_kv_pool_split_on_the_head_axis(params):
    _, tp = params
    ex = _exec(tp, 4)
    assert isinstance(ex.cache.k, list) and len(ex.cache.k) == 4
    assert all(tuple(p.shape) == (2, 16, 8, 2, 8) for p in ex.cache.k)


# -- refusals ------------------------------------------------------------------------

def test_chunked_prefill_refused(params):
    ex = _exec(params[1], 2)
    with pytest.raises(BackendError, match="ring"):
        ex.prefill_chunk(np.arange(1, 9, dtype=np.int32), 0, [1])
    with pytest.raises(BackendError, match="exclusive"):
        LLMEngine(params[1], n_heads=8, block_size=8, num_blocks=16,
                  max_len=64, shards=2, prefill_chunk=8)


def test_ring_without_shards_refused(params):
    with pytest.raises(BackendError, match="needs shards"):
        _exec(params[1], 0, ring_min=16)


def test_w8a8_refused_as_in_jax(eight_cpu_devices, params):
    jp, _ = params
    qp = jq.quantize_transformer(jp)
    with pytest.raises(Exception, match="float-only"):
        JaxPagedLLMExecutor(dict(qp), n_heads=8, block_size=8,
                            num_blocks=16, max_len=64, shards=2)
    tq = bridge.transformer_params(jax.tree_util.tree_map(np.asarray, qp))
    with pytest.raises(BackendError, match="float-only"):
        _exec(tq, 2)


def test_pallas_with_shards_raises_where_jax_counts_a_fallback(
        eight_cpu_devices, params):
    """A deliberate difference (ROADMAP Queue 3): JAX serves
    paged_kernel=pallas + shards on its XLA path and counts a
    kernel_fallback; the port refuses and names the fix."""
    jp, tp = params
    jex = JaxPagedLLMExecutor(dict(jp), n_heads=8, block_size=8,
                              num_blocks=16, max_len=64, shards=2,
                              paged_kernel="pallas")
    try:
        st = jex.stats()
        assert st["paged_kernel"] == "xla" and st["kernel_fallback"] == 1
    finally:
        jex.close()
    with pytest.raises(BackendError, match="paged_kernel=xla"):
        _exec(tp, 2, paged_kernel="pallas")


@pytest.mark.parametrize("shards", [3, 16])
def test_unsupported_widths_refused(params, shards):
    with pytest.raises(BackendError, match="supported counts"):
        _exec(params[1], shards)


def test_too_few_devices_names_virtual_devices(params, monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "0")
    with pytest.raises(BackendError, match="virtual_devices"):
        _exec(params[1], 2)


# -- placement -----------------------------------------------------------------------

def test_virtual_devices_map(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "0")
    assert placement.visible_devices() == [torch.device("cpu")]
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "4")
    assert placement.visible_devices() == [torch.device("cpu")] * 4
    assert placement.device_of(3) == torch.device("cpu")
    with pytest.raises(BackendError, match="out of range"):
        placement.device_of(4)
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "-1")
    with pytest.raises(ConfigError, match="virtual_devices"):
        placement.visible_devices()


def test_virtual_devices_off_by_default(monkeypatch):
    from nnstreamer_tpu_torch.core.config import Config

    monkeypatch.delenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES")
    monkeypatch.delenv("NNSTREAMER_TPU_TORCH_CONF", raising=False)
    assert Config(path="/nonexistent").get_int(
        "parallel", "virtual_devices", 7) == 0


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.delenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendError, match="accelerator=cpu"):
        placement.visible_devices()


def test_chip_lease_table_lease_fence_release():
    t = placement.ChipLeaseTable(range(4))
    assert t.lease("a", 2) == (0, 1)
    assert t.lease("b", 1) == (2,)
    with pytest.raises(BackendError, match="wanted 2"):
        t.lease("c", 2)
    assert t.fence("a") == (0, 1)
    assert t.snapshot()["counts"] == {"free": 1, "leased": 1, "fenced": 2}
    assert t.lease("a") == (0, 1)                 # its own fenced chips back
    assert t.chips_of("a") == (0, 1)
    assert t.release("a") == (0, 1) and t.release("b") == (2,)
    snap = t.snapshot()
    assert snap["counts"] == {"free": 4, "leased": 0, "fenced": 0}
    assert snap["fences_total"] == 2 and snap["releases_total"] == 3


# -- tensor_llm -------------------------------------------------------------------------

def _link(pipe, *els):
    for e in els:
        pipe.add(e)
    for a, b in zip(els, els[1:]):
        pipe.link(a, b)


def _run_port(tp, prompt, **props):
    reset_store()
    get_store().register("shllm_t", ModelBundle(fn=None, params=tp))
    src = AppSrc(name="src", spec=TensorsSpec(tensors=(),
                                              format=TensorFormat.FLEXIBLE))
    llm = TensorLLM(name="g", model="store://shllm_t", n_heads=8,
                    block_size=8, num_blocks=16, max_len=64, **props)
    sink = TensorSink(name="out")
    pipe = tnns.Pipeline()
    _link(pipe, src, llm, sink)
    runner = tnns.PipelineRunner(pipe).start()
    try:
        src.push(TensorBuffer(tensors=(prompt,), pts=0, meta={"llm": {
            "request_id": "r0", "max_new_tokens": 6}}))
        src.end()
        runner.wait(120)
    finally:
        runner.stop()
        reset_store()
    return [int(t) for b in sink.results for t in np.asarray(b.tensors[0])], \
        llm


def _run_jax(jp, prompt):
    j_reset_store()
    j_get_store().register("shllm_j", JaxModelBundle(fn=None, params=jp))
    src = JAppSrc(name="src", spec=JTensorsSpec(
        tensors=(), format=JTensorFormat.FLEXIBLE))
    llm = JTensorLLM(name="g", model="store://shllm_j", n_heads=8,
                     block_size=8, num_blocks=16, max_len=64)
    sink = JTensorSink(name="out")
    pipe = jnns.Pipeline()
    _link(pipe, src, llm, sink)
    runner = jnns.PipelineRunner(pipe)
    runner.start()
    try:
        src.push(JTensorBuffer(tensors=(prompt,), pts=0, meta={"llm": {
            "request_id": "r0", "max_new_tokens": 6}}))
        src.end()
        runner.wait(120)
    finally:
        runner.stop()
        j_reset_store()
    return [int(t) for b in sink.results for t in np.asarray(b.tensors[0])]


def test_tensor_llm_shards_emit_jax_tokens(eight_cpu_devices, params):
    """tensor_llm shards=2 (ring cutover at 32: this 40-token prompt takes
    it) and shards=4 emit the JAX package's element's tokens (whose
    shards=N equal its shards=0 by tests/test_sharding.py), and release
    their leases at stop."""
    jp, tp = params
    prompt = _prompt(40, 3)
    want = _run_jax(jp, prompt)
    t2, g2 = _run_port(tp, prompt, shards=2, ring_prefill_min=32)
    t4, g4 = _run_port(tp, prompt, shards=4)
    assert len(want) == 6 and t2 == want and t4 == want
    st = g2.extra_stats()
    assert st["executor"]["shards"] == 2
    assert st["executor"]["shard_devices"] == ["cpu", "cpu"]
    assert ("ring", 64, "xla") in g2.engine.executor._seen
    assert st["leases"] == {"free": 8, "leased": 0, "fenced": 0}
    assert g4.extra_stats()["leases"] == {"free": 8, "leased": 0,
                                          "fenced": 0}


@pytest.mark.parametrize("props,match", [
    ({"shards": 3}, "shards must be one of"),
    ({"shards": 2, "prefill_chunk": 8}, "exclusive"),
    ({"shards": 2, "paged_kernel": "pallas"}, "paged_kernel=xla"),
    ({"ring_prefill_min": 16}, "needs shards"),
])
def test_tensor_llm_negotiation_refusals(params, props, match):
    with pytest.raises(NegotiationError, match=match):
        _run_port(params[1], np.arange(1, 9, dtype=np.int32), **props)
