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
- the refusals, the lease ledger and the logical-device map;
- the dense path (`ShardedBackend`, `ShardedReplicaSet`, the filter's
  ``shards=``): outputs at shards 1/2/4/8 `np.array_equal` to the
  one-device model's, the same `param_specs` as JAX's for a MobileNetV2
  param tree (a conv's O axis, the classifier's input axis, what a
  width does not divide whole), group routing, a member fence fencing
  its group with Σ group invokes == frames, a store swap one epoch
  across groups with nothing run for the first time after the flip, the
  filter prop's parity and soft declines beside JAX's.
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


# -- the dense path ------------------------------------------------------------------

MBV2_ZOO = "mobilenet_v2?width=0.35&input_size=32&dtype=float32"
DENSE_DIM = 16


def _dense_bundles(seed=3):
    w = np.random.default_rng(seed).normal(
        size=(DENSE_DIM, DENSE_DIM)).astype(np.float32)
    return (JaxModelBundle(fn=lambda p, x: (x @ p["w"],), params={"w": w},
                           name="sh_mlp"),
            ModelBundle(fn=lambda p, x: (x @ p["w"],),
                        params={"w": torch.from_numpy(w.copy())},
                        name="sh_mlp"))


@pytest.fixture(scope="module")
def mbv2_pair():
    """(the JAX-layout MobileNetV2 param tree, the port's module): the
    zoo's module at width 0.35 and its tree through the bridge."""
    from nnstreamer_tpu_torch.models.zoo import build_model

    model = build_model(MBV2_ZOO).params
    return bridge.mobilenet_v2_tree(model), model


def _jax_path_of(port: str) -> str:
    """A port state-dict name → its JAX tree path."""
    parts = port.split(".")
    leaf = parts[-1]
    if parts[0] == "classifier":
        return f"classifier/{'w' if leaf == 'weight' else 'b'}"
    unit = "/".join(parts[:-1])
    return f"{unit}/conv/w" if leaf == "weight" else f"{unit}/bn/{leaf}"


@pytest.mark.parametrize("n", [2, 4, 8])
def test_param_specs_of_mobilenet_equal_jax(eight_cpu_devices, mbv2_pair,
                                           n):
    from jax.sharding import Mesh as JMesh

    from nnstreamer_tpu.parallel import mesh as jmesh
    from nnstreamer_tpu_torch.parallel import mesh as tmesh

    tree, model = mbv2_pair
    jspecs = jmesh.param_specs(
        tree, JMesh(np.array(jax.devices()[:n]), ("tp",)))
    jflat = {jmesh._path_str(p): tuple(v) for p, v in
             jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: isinstance(
                     x, jax.sharding.PartitionSpec))[0]}
    tspecs = tmesh.param_specs(
        model, tmesh.make_mesh(tmesh.MeshSpec(dp=1, tp=n),
                               placement.visible_devices()[:n]))
    assert len(tspecs) == len(jflat)
    split = 0
    for path, spec in tspecs.items():
        jspec = jflat[_jax_path_of(path)]
        jspec = jspec + (None,) * (len(spec) - len(jspec))
        if path.endswith("weight") and len(spec) == 4:
            jspec = tuple(jspec[i] for i in (3, 2, 0, 1))   # HWIO → OIHW
        elif path == "classifier.weight":
            jspec = jspec[::-1]                             # (in, out)
        assert spec == jspec, path
        split += any(a is not None for a in spec)
    assert split > 0


def test_dense_shards_bit_equal_to_one_device(eight_cpu_devices):
    """MobileNetV2 stored split at shards 1/2/4/8 gives the one-device
    model's logits bit for bit; each device holds 1/N of each split
    weight."""
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

    x = np.random.default_rng(0).uniform(-1, 1, (1, 32, 32, 3)).astype(
        np.float32)
    be = TorchBackend()
    be.open({"model": "zoo://" + MBV2_ZOO})
    ref = be.invoke((x,))[0].numpy()
    be.close()
    sizes = {}
    for n in (1, 2, 4, 8):
        b = tsh.ShardedBackend("zoo://" + MBV2_ZOO, list(range(n)),
                               name=f"d{n}")
        try:
            (out,) = b.invoke((x,))
            np.testing.assert_array_equal(out.numpy(), ref)
            sizes[n] = b.shard_bytes()
        finally:
            b.close()
    assert sum(sizes[1]) == sum(sizes[2]) == sum(sizes[8])
    assert sizes[2][1] < sizes[2][0] and max(sizes[8][1:]) < sizes[1][0] / 4


def test_dense_mlp_parity_with_jax_across_widths(eight_cpu_devices):
    jb, tb = _dense_bundles()
    x = np.linspace(-1, 1, 4 * DENSE_DIM, dtype=np.float32).reshape(
        4, DENSE_DIM)
    jrs = jsh.ShardedReplicaSet.open_sharded(jb, shards=2, groups=1,
                                             name="jd2")
    try:
        jref = np.asarray(jrs.invoke((x,))[0])
    finally:
        jrs.close()
    ref = None
    for n in (1, 2, 4, 8):
        rs = tsh.ShardedReplicaSet.open_sharded(tb, shards=n, groups=1,
                                                name=f"dp{n}")
        try:
            outs = [rs.invoke((x,)) for _ in range(3)]
        finally:
            rs.close()
        ref = np.asarray(outs[0][0]) if ref is None else ref
        for o in outs:
            np.testing.assert_array_equal(np.asarray(o[0]), ref)
    np.testing.assert_allclose(ref, jref, rtol=0, atol=1e-6)


def test_groups_compose_and_route_as_jax(eight_cpu_devices):
    jb, tb = _dense_bundles()
    x = np.ones((2, DENSE_DIM), np.float32)
    rows = []
    for mod, b in ((jsh, jb), (tsh, tb)):
        rs = mod.ShardedReplicaSet.open_sharded(b, shards=4, groups=2,
                                                name="gg")
        try:
            for _ in range(6):
                rs.invoke((x,))
            st = rs.stats()
        finally:
            rs.close()
        rows.append(([(r["group"], r["devices"], r["invokes"])
                      for r in st["replicas"]], st["group_size"],
                     st["leases"]))
    assert rows[0] == rows[1]
    assert rows[1][0][0][1] == [0, 1, 2, 3]


def test_oversubscription_is_typed():
    _, tb = _dense_bundles()
    with pytest.raises(BackendError, match="virtual_devices"):
        tsh.ShardedReplicaSet.open_sharded(tb, shards=8, groups=2,
                                           name="over")


def test_member_fence_fences_group_conserves():
    _, tb = _dense_bundles()
    x = np.ones((2, DENSE_DIM), np.float32)
    rs = tsh.ShardedReplicaSet.open_sharded(tb, shards=2, groups=4,
                                            name="fg")
    try:
        for _ in range(8):
            rs.invoke((x,))
        assert rs.group_of(5) == 2
        assert rs.group_of(9) is None and rs.fence_device(9) is False
        assert rs.fence_device(5, "drill")
        for _ in range(8):
            rs.invoke((x,))
        st = rs.stats()
    finally:
        rs.close()
    assert sum(r["invokes"] for r in st["replicas"]) == 16
    assert [r["group"] for r in st["replicas"]
            if r["state"] == "fenced"] == [2]
    assert st["leases"]["fenced"] == 2 and st["fences"] == 1


def test_group_swap_one_epoch_nothing_new_after_the_flip():
    store = get_store()
    store.register("shsw", lambda x: (x * 2.0,))
    store.register("shsw", lambda x: (x + 100.0,))
    x = np.linspace(-1, 1, 32, dtype=np.float32).reshape(2, 16)
    rs = tsh.ShardedReplicaSet.open_sharded("store://shsw", shards=2,
                                            groups=2, name="sw")
    try:
        for _ in range(4):
            (out,) = rs.invoke((x,))
        np.testing.assert_array_equal(out, x * 2.0)
        rep = rs.swap(2)
        assert rep["handles"] == 2
        counts = rs.compile_counts()
        for _ in range(4):
            (out,) = rs.invoke((x,))
        np.testing.assert_array_equal(out, x + 100.0)
        assert rs.compile_counts() == counts
        assert len(set(rs.adopted_epochs())) == 1
    finally:
        rs.close()
    pin = tsh.ShardedReplicaSet.open_sharded("store://shsw@1", shards=2,
                                             groups=1, name="pin")
    try:
        np.testing.assert_array_equal(pin.invoke((x,))[0], x * 2.0)
    finally:
        pin.close()


def _run_filter(pkg, Buffer, store, extra, frames=6):
    store.register("shf", lambda x: (x * 2.0 + 1.0,))
    pipe = pkg.parse_launch(
        f"appsrc name=src dims=16 types=float32 ! tensor_filter name=f "
        f"model=store://shf {extra} ! tensor_sink name=out")
    runner = pkg.PipelineRunner(pipe).start()
    for i in range(frames):
        pipe.get("src").push(Buffer.of(
            np.full((16,), float(i), np.float32), pts=i))
    pipe.get("src").end()
    runner.wait(60)
    runner.stop()
    return ({int(b.pts): np.asarray(b.tensors[0])
             for b in pipe.get("out").results}, pipe.get("f"))


def test_filter_shards_prop_parity_and_stats_as_jax(eight_cpu_devices):
    from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer

    base, _ = _run_filter(tnns, TensorBuffer, reset_store(), "")
    got, f = _run_filter(tnns, TensorBuffer, reset_store(),
                         "shards=2 devices=4")
    jgot, jf = _run_filter(jnns, JBuffer, j_reset_store(),
                           "shards=2 devices=4")
    for pts, ref in base.items():
        np.testing.assert_array_equal(got[pts], ref)
        np.testing.assert_array_equal(got[pts], jgot[pts])
    st, jst = f.extra_stats(), jf.extra_stats()
    for k in ("shards", "shard_groups", "replica_invokes", "leases"):
        assert st[k] == jst[k], k


def test_filter_shards_refusals_and_declines():
    with pytest.raises(NegotiationError):
        _run_filter(tnns, TensorBuffer, reset_store(), "shards=3")
    base, _ = _run_filter(tnns, TensorBuffer, reset_store(), "")
    got, f = _run_filter(tnns, TensorBuffer, reset_store(),
                         "shards=2 output=16 outputtype=float32")
    for pts, ref in base.items():
        np.testing.assert_array_equal(got[pts], ref)
    assert "shards" not in f.extra_stats()
    assert "override" in f.extra_stats()["replica_decline"]


def test_apply_plan_sets_shards_prop():
    store = reset_store()
    store.register("shf", lambda x: (x * 2.0,))
    pipe = tnns.parse_launch(
        "appsrc name=src dims=16 types=float32 ! tensor_filter name=f "
        "model=store://shf ! tensor_sink name=out")
    plan = placement.segment_plan_tp([("f", 8.0)], 8)
    assert plan.tp == [8]
    assert placement.apply_plan(pipe, plan) == 1
    assert pipe.get("f").props["shards"] == 8


def test_shard_series_round_trip_as_jax(eight_cpu_devices):
    from nnstreamer_tpu.serving.metrics import (
        metrics_snapshot as j_snapshot, render_prometheus as j_render)
    from nnstreamer_tpu_torch.serving.metrics import (
        metrics_snapshot, parse_prometheus, render_prometheus)

    _, tb = _dense_bundles()
    rs = tsh.ShardedReplicaSet.open_sharded(tb, shards=2, groups=2,
                                            name="ms")
    try:
        for _ in range(10):
            rs.invoke((np.ones((2, DENSE_DIM), np.float32),))
        st = rs.stats()
    finally:
        rs.close()
    text = render_prometheus(metrics_snapshot(replicas={"f": st}))
    assert text == j_render(j_snapshot(replicas={"f": st}))
    parsed = parse_prometheus(text)
    assert sum(parsed["nns_shard_group_invokes_total"]["samples"]
               .values()) == 10.0
