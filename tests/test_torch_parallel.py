"""The rest of the port's parallel/ (the mesh dispatcher,
BatchedQueryServer over a mesh, the GPipe pipeline, the expert-parallel
MoE layer, the dryrun and the composed dp × tp × sp forward) against the
JAX package's, on the CPU.

The port runs on 8 logical CPU devices (``[parallel] virtual_devices=8``),
JAX on its 8 virtual CPU devices (tests/conftest.py), the weights made by
JAX (or numpy) and carried across by models/bridge.py. Tolerances:

- the mesh dispatcher on the identity model: bit for bit;
- the batched server over dp 8 (MobileNetV2 width 0.35, 64², f32):
  each reply within 1e-5 of max |logit| of JAX's;
- the pipeline: within 1e-6 of max |.| (the same products, stage after
  stage);
- MoE: within 1e-5 of max |.|, a dropped token's row exactly zero in
  both and the same rows dropped;
- the composed forward: within 2e-4 of JAX's, as tests/test_parallel.py
  holds JAX's rings (each package's ring sums its online softmax in its
  own order), and each within 5e-4 of its own one-device math.
"""

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import nnstreamer_tpu as jnns
import nnstreamer_tpu_torch as tnns
from nnstreamer_tpu.backends.xla import XLABackend
from nnstreamer_tpu.edge import BatchedQueryServer as JBatched
from nnstreamer_tpu.edge import QueryServer as JQueryServer
from nnstreamer_tpu.parallel import MeshSpec as JMeshSpec
from nnstreamer_tpu.parallel import make_mesh as j_make_mesh
from nnstreamer_tpu.parallel import moe as jmoe
from nnstreamer_tpu.parallel import pipeline as jpipe
from nnstreamer_tpu.parallel.dispatch import MeshDispatcher as JDispatcher
from nnstreamer_tpu.parallel.ring_attention import \
    ring_attention as j_ring_attention
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JBuffer
from nnstreamer_tpu_torch import parallel as tpar
from nnstreamer_tpu_torch.backends import kernels
from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
from nnstreamer_tpu_torch.core.errors import StreamError
from nnstreamer_tpu_torch.edge import BatchedQueryServer, QueryServer
from nnstreamer_tpu_torch.models import bridge
from nnstreamer_tpu_torch.models import mobilenet_v2 as tm
from nnstreamer_tpu_torch.parallel import dryrun, moe, pipeline
from nnstreamer_tpu_torch.parallel.dispatch import MeshDispatcher
from nnstreamer_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

LOGIT_REL = 1e-5
PIPE_REL = 1e-6
MOE_REL = 1e-5
COMPOSED_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", "8")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    QueryServer.reset_all()
    JQueryServer.reset_all()
    torch.set_num_threads(threads)


@pytest.fixture()
def jax8(eight_cpu_devices):
    return jax.devices()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# -- the mesh dispatcher ------------------------------------------------------

def test_mesh_dispatcher_matches_jax_bit_for_bit(jax8):
    """tests/test_parallel.py's case: an 8-device dp mesh, bucket 8, 11
    frames through x @ eye(4)."""
    jd = JDispatcher(lambda p, x: x @ p["w"], {"w": jnp.eye(4)},
                     j_make_mesh(JMeshSpec(dp=8, tp=1, sp=1)), bucket=8,
                     max_delay_ms=1.0)
    td = MeshDispatcher(lambda p, x: x @ p["w"], {"w": torch.eye(4)},
                        make_mesh(MeshSpec(dp=8)), bucket=8,
                        max_delay_ms=1.0)
    try:
        frames = [np.full((4,), i, np.float32) for i in range(11)]
        want = [f.result(30) for f in [jd.submit(x) for x in frames]]
        got = [f.result(30) for f in [td.submit(x) for x in frames]]
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g[0], np.asarray(w[0]))
            np.testing.assert_array_equal(g[0], frames[i])
        assert td.buckets == jd.buckets == [8]
        st = td.stats()
        assert td.frames == 11 and td.batches >= 2
        # every batch ran on all 8 shards; rows out and back are copies
        # between logical devices, as are the params placed on 7 of them
        assert st["shard_batches"] == [td.batches] * 8
        assert st["transfers"] >= 7 + 2 * 7 * td.batches
    finally:
        jd.shutdown()
        td.shutdown()


def test_mesh_dispatcher_refuses_a_bucket_the_axis_does_not_divide():
    with pytest.raises(StreamError, match="divisible"):
        MeshDispatcher(lambda p, x: x, None, make_mesh(MeshSpec(dp=8)),
                       bucket=12)


def test_mesh_dispatcher_set_params_and_idempotent_shutdown():
    """set_params copies the new tree to every shard; later batches see
    it. shutdown() may be called again and again."""
    d = MeshDispatcher(lambda p, x: x * p, torch.tensor(2.0),
                       make_mesh(MeshSpec(dp=4)), bucket=4,
                       max_delay_ms=1.0)
    try:
        one = np.ones((3,), np.float32)
        np.testing.assert_array_equal(d.infer(one)[0], 2 * one)
        d.set_params(torch.tensor(5.0))
        np.testing.assert_array_equal(d.infer(one)[0], 5 * one)
        assert d.buckets == [4]
    finally:
        d.shutdown()
    d.shutdown()
    d.shutdown()


# -- BatchedQueryServer over a mesh -----------------------------------------------

MBV2 = "zoo://mobilenet_v2?width=0.35&input_size=64&dtype=float32"


@pytest.fixture(scope="module")
def mbv2_64():
    jb = XLABackend()._resolve(MBV2)
    np_params = jax.tree_util.tree_map(np.asarray, jb.params)
    model = bridge.load_mobilenet_v2(
        tm.MobileNetV2(0.35, dtype=torch.float32).eval(), np_params)
    tb = ModelBundle(fn=lambda m, x: m(x), params=model,
                     in_spec=TensorsSpec.of(
                         TensorInfo((1, 64, 64, 3), DType.FLOAT32)),
                     out_spec=TensorsSpec.of(
                         TensorInfo((1, 1001), DType.FLOAT32)),
                     name="mobilenet_v2_0.35_64")
    return jb, tb


def _clients(port, frames_of, nns, Buffer, n_clients=4):
    def run(cid):
        pipe = nns.parse_launch(
            f"appsrc name=src dims=3:64:64:1 types=uint8 ! "
            f"tensor_query_client port={port} timeout=60 max_in_flight=4 ! "
            f"tensor_sink name=out")
        rn = nns.PipelineRunner(pipe).start()
        for i, x in enumerate(frames_of(cid)):
            pipe.get("src").push(Buffer.of(x, pts=i))
        pipe.get("src").end()
        rn.wait(60)
        rn.stop()
        return cid, pipe.get("out").results

    with cf.ThreadPoolExecutor(n_clients) as ex:
        return dict(ex.map(run, range(n_clients)))


def test_batched_server_over_a_mesh_matches_jax(mbv2_64, jax8):
    """4 clients × 6 uint8 frames at 64² into a dp-8 server on each side
    (JAX's default mesh: 8 devices, bucket 8): every reply within 1e-5 of
    max |logit| of JAX's, in pts order; every batch ran on all 8
    shards."""
    from nnstreamer_tpu.tensor.dtypes import DType as JDType
    from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
    from nnstreamer_tpu.tensor.info import TensorsSpec as JSpec

    jb, tb = mbv2_64

    def frames_of(cid):
        rng = np.random.default_rng(300 + cid)
        return [rng.integers(0, 256, (1, 64, 64, 3), np.uint8)
                for _ in range(6)]

    jsrv = JBatched(jb, sid=61, port=0, bucket=8, max_delay_ms=5.0,
                    pre=lambda x: (x.astype(jnp.float32) - 127.5) / 127.5,
                    in_spec=JSpec.of(JInfo((1, 64, 64, 3), JDType.UINT8)))
    tsrv = BatchedQueryServer(
        tb, sid=62, port=0, bucket=8, max_delay_ms=5.0,
        mesh=make_mesh(MeshSpec(dp=8)), pre=kernels.normalize_u8,
        in_spec=TensorsSpec.of(TensorInfo((1, 64, 64, 3), DType.UINT8)))
    try:
        ours = _clients(tsrv.port, frames_of, tnns, TensorBuffer)
        theirs = _clients(jsrv.port, frames_of, jnns, JBuffer)
        for cid in range(4):
            assert [r.pts for r in ours[cid]] == list(range(6))
            assert [r.pts for r in theirs[cid]] == list(range(6))
            for r, w in zip(ours[cid], theirs[cid]):
                want = np.asarray(w.tensors[0])
                np.testing.assert_allclose(
                    np.asarray(r.tensors[0]), want, rtol=0,
                    atol=LOGIT_REL * float(np.abs(want).max()))
        st = tsrv.stats()
        assert st["frames"] == 24 and st["admitted"] == st["replied"] == 24
        assert st["shard_batches"] == [st["batches"]] * 8
        assert tsrv.dispatcher.buckets == [8]
    finally:
        tsrv.close()
        jsrv.close()


def test_batched_server_default_mesh_takes_every_logical_device(
        monkeypatch):
    """No mesh: dp is the number of logical devices where it divides the
    bucket (4 of bucket 8), else 1 (3 devices); an accelerator named
    explicitly is one device."""
    for n, dp in (("4", 4), ("3", 1)):
        monkeypatch.setenv("NNSTREAMER_TPU_TORCH_PARALLEL_VIRTUAL_DEVICES", n)
        srv = BatchedQueryServer("zoo://probe_scale", sid=63, port=0,
                                 bucket=8)
        try:
            assert srv.dispatcher.mesh.shape["dp"] == dp
            assert srv.dispatcher.buckets == sorted({dp, 8})
        finally:
            srv.close()
    srv = BatchedQueryServer("zoo://probe_scale", sid=64, port=0, bucket=8,
                             accelerator="cpu")
    try:
        assert srv.dispatcher.buckets == [1, 8]
    finally:
        srv.close()


# -- the pipeline -----------------------------------------------------------------

def _stages(n, d, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) * d ** -0.5).astype(
        np.float32), "b": (rng.standard_normal(d) * 0.1).astype(np.float32)}
        for _ in range(n)]


@pytest.mark.parametrize("n_stages,n_micro", [(8, 16), (8, 1)])
def test_pipeline_matches_jax(jax8, n_stages, n_micro):
    """(8 stages, 16 microbatches of 3 × 16) and one microbatch: the port
    against JAX's pipeline and its own serial fold."""
    stages = _stages(n_stages, 16, 10 + n_micro)
    x = _rand((n_micro, 3, 16), 20 + n_micro)
    jstage = (lambda p, a: jnp.tanh(a @ p["w"] + p["b"]))
    want = np.asarray(jax.jit(lambda s, a: jpipe.pipeline_apply(
        jstage, s, a, mesh=j_make_mesh(JMeshSpec(dp=1, pp=n_stages))))(
        jpipe.stack_stage_params(
            [jax.tree_util.tree_map(jnp.asarray, s) for s in stages]),
        jnp.asarray(x)))
    tstages = [bridge.tensor_tree(s) for s in stages]
    tstage = (lambda p, a: torch.tanh(a @ p["w"] + p["b"]))
    got = tpar.pipeline_apply(tstage, tpar.stack_stage_params(tstages),
                              torch.from_numpy(x),
                              mesh=make_mesh(MeshSpec(dp=1, pp=n_stages)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=PIPE_REL * float(np.abs(want).max()))
    serial = pipeline.reference_pipeline(tstage, tstages,
                                         torch.from_numpy(x))
    assert torch.equal(got, serial)


def test_pipeline_refusals():
    mesh = make_mesh(MeshSpec(dp=1, pp=4))
    stacked = tpar.stack_stage_params(
        [{"w": torch.eye(2)} for _ in range(4)])
    with pytest.raises(ValueError, match="at least one microbatch"):
        tpar.pipeline_apply(lambda p, a: a, stacked, torch.ones((0, 1, 2)),
                            mesh=mesh)
    with pytest.raises(ValueError, match="stages"):
        tpar.pipeline_apply(lambda p, a: a, tpar.stack_stage_params(
            [{"w": torch.eye(2)}] * 3), torch.ones((2, 1, 2)), mesh=mesh)


def test_pipeline_skips_the_bubble():
    """Stage s runs exactly the n_micro microbatches (JAX computes
    n_micro + n − 1 steps on every stage and drops the bubble's)."""
    mesh = make_mesh(MeshSpec(dp=1, pp=4))
    calls = []

    def stage(p, a):
        calls.append(int(p["i"]))
        return a + p["i"]

    stacked = tpar.stack_stage_params(
        [{"i": torch.tensor(float(i))} for i in range(4)])
    out = tpar.pipeline_apply(stage, stacked, torch.zeros((6, 1)),
                              mesh=mesh)
    assert sorted(calls) == sorted(list(range(4)) * 6)
    assert torch.equal(out, torch.full((6, 1), 6.0))


# -- MoE --------------------------------------------------------------------------

def _moe_case(jax8, capacity_factor):
    """JAX's MoE on its 8-device ep mesh and the port's on 8 logical
    devices, from JAX's params → (got, want, the port's params, x)."""
    mesh = j_make_mesh(JMeshSpec(dp=1, ep=8))
    d, h, E, T = 8, 16, 8, 64
    params = jmoe.init_moe_params(jax.random.PRNGKey(1), d, h, E)
    x = jax.random.normal(jax.random.PRNGKey(2), (T, d))
    specs = jmoe.moe_param_specs()
    placed = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
              for k, v in params.items()}
    xs = jax.device_put(x, NamedSharding(mesh, P("ep")))
    want = np.asarray(jax.jit(lambda p, a: jmoe.moe_apply(
        p, a, mesh=mesh, capacity_factor=capacity_factor))(placed, xs))
    tparams = bridge.moe_params(jax.tree_util.tree_map(np.asarray, params))
    tx = torch.from_numpy(np.array(x))
    got = tpar.moe_apply(tparams, tx, mesh=make_mesh(MeshSpec(dp=1, ep=8)),
                         capacity_factor=capacity_factor).numpy()
    return got, want, tparams, tx


def test_moe_matches_jax_with_ample_capacity(jax8):
    got, want, tparams, tx = _moe_case(jax8, 8.0)
    tol = MOE_REL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    ref = moe.reference_moe(tparams, tx).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_moe_capacity_drops_match_jax(jax8):
    """capacity_factor 1.0: the rows JAX drops are the rows the port drops
    (the port's `_route` per shard says which), exactly zero in both;
    every kept row within 1e-5 of JAX's and of the serial reference."""
    got, want, tparams, tx = _moe_case(jax8, 1.0)
    t_local, E = 8, 8
    cap = max(1, int(np.ceil(1.0 * t_local / E)))
    dropped = np.concatenate([
        ~moe._route(tx[i * t_local:(i + 1) * t_local], tparams["gate"], E,
                    cap)[2].numpy() for i in range(8)])
    assert dropped.any() and not dropped.all()
    assert (got[dropped] == 0).all() and (want[dropped] == 0).all()
    assert not (got[~dropped] == 0).all(axis=1).any()
    tol = MOE_REL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    ref = moe.reference_moe(tparams, tx).numpy()
    np.testing.assert_allclose(got[~dropped], ref[~dropped], rtol=0,
                               atol=tol)


def test_moe_refuses_experts_that_do_not_divide():
    mesh = make_mesh(MeshSpec(dp=1, ep=8))
    params = tpar.init_moe_params(torch.Generator().manual_seed(0), 4, 8, 6)
    with pytest.raises(ValueError, match="experts"):
        tpar.moe_apply(params, torch.ones((16, 4)), mesh=mesh)


def test_moe_route_counts_slots_in_integers():
    """Slots count in int64 for a bf16 input, past what bf16 holds
    exactly (256): 600 tokens on one expert get slots 0..599."""
    x = torch.ones((600, 4), dtype=torch.bfloat16)
    gate = torch.zeros((4, 2), dtype=torch.bfloat16)
    gate[:, 0] = 1
    expert, slot, keep, p = moe._route(x, gate, 2, 1000)
    assert slot.dtype == torch.int64 and (expert == 0).all()
    assert torch.equal(slot, torch.arange(600)) and keep.all()
    assert p.dtype == torch.bfloat16


# -- the dryrun and the composed forward ------------------------------------------

def test_dryrun_multichip_on_eight_cpu_devices(capsys):
    res = dryrun.dryrun_multichip(8)
    assert res["train"]["dp"] == 4 and res["train"]["tp"] == 2
    assert np.isfinite(res["train"]["loss"])
    assert res["pipeline"]["bit_for_bit"]
    assert res["ring"]["max_abs_err"] <= res["ring"]["limit"]
    assert res["composed"]["shape"] == {"dp": 2, "tp": 2, "sp": 2}
    assert "dryrun_multichip ok on 8 devices" in capsys.readouterr().out


def test_composed_dp_tp_sp_forward_matches_jax(jax8):
    """JAX's composed forward (`__graft_entry__._composed_dp_tp_sp`'s math
    and weights) on its 8-device dp 2 × tp 2 × sp 2 mesh against the
    port's on 8 logical devices."""
    from nnstreamer_tpu.parallel.ring_attention import reference_attention

    shape = dryrun.composed_shape(8)
    x, wq, wk, wv, w1, w2 = dryrun.composed_weights(shape["sp"], 8)
    mesh = j_make_mesh(JMeshSpec(**shape))
    H, Dh = 2, 8

    def fwd(x, wq, wk, wv, w1, w2, attn):
        b, s, d = x.shape
        q, k, v = ((x @ w).reshape(b, s, H, Dh) for w in (wq, wk, wv))
        return jax.nn.relu(attn(q, k, v).reshape(b, s, d) @ w1) @ w2 + x

    xs = jax.device_put(x, NamedSharding(mesh, P("dp", "sp", None)))
    w1s = jax.device_put(w1, NamedSharding(mesh, P(None, "tp")))
    w2s = jax.device_put(w2, NamedSharding(mesh, P("tp", None)))
    want = np.asarray(jax.jit(lambda x, wq, wk, wv, w1, w2: fwd(
        x, wq, wk, wv, w1, w2, lambda q, k, v: j_ring_attention(
            q, k, v, mesh=mesh, axis="sp", batch_axis="dp", causal=True,
            block_impl="xla")))(xs, wq, wk, wv, w1s, w2s))
    ref = np.asarray(fwd(jnp.asarray(x), wq, wk, wv, w1, w2,
                         lambda q, k, v: reference_attention(
                             q, k, v, causal=True)))
    got = dryrun.composed(dryrun.logical_devices(8), 8)
    assert got["shape"] == shape
    out = got["out"].numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=COMPOSED_ATOL)
    assert float(np.abs(out - ref).max()) < dryrun.COMPOSED_TOL
    assert float(np.abs(want - ref).max()) < dryrun.COMPOSED_TOL


def test_package_exports_every_name_of_jax():
    import nnstreamer_tpu.parallel as jpar

    assert set(jpar.__all__) == set(tpar.__all__)
    for name in tpar.__all__:
        assert callable(getattr(tpar, name)) or isinstance(
            getattr(tpar, name), type), name
    s = tpar.sharding_for(make_mesh(MeshSpec(dp=8)), ("dp",))
    assert s.spec == ("dp",) and s.mesh.shape["dp"] == 8
