"""The public methods and helpers the port had left to carry (ROADMAP
Queue 1 item 8, and the five names a scan of both packages added), each
held to the JAX package's result on the same inputs:

`Channel.try_put`/`closed`/`capacity`/`qsize`, `BatchCore.infer`,
`BlockAllocator.can_alloc`, `Pipeline.describe`/`spec_of_link`,
`TensorsSpec.nbytes`, `TensorBuffer.matches`, `reset_config` and
`Config.dump`, `log_error_with_trace`, `count_params`,
`FilterBackend.version_stats`/`warm_start`,
`TensorTransform.as_elementwise`, `tensor.buffer.now_ns` and
`elements.filter.np_shape`.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jn
import nnstreamer_tpu_torch as tn
from nnstreamer_tpu.backends.base import FilterBackend as JaxBackend
from nnstreamer_tpu.core import config as jconfig
from nnstreamer_tpu.core.log import log_error_with_trace as jlog_trace
from nnstreamer_tpu.elements.filter import np_shape as jnp_shape
from nnstreamer_tpu.elements.transform import TensorTransform as JaxTransform
from nnstreamer_tpu.llm.paged_cache import BlockAllocator as JaxAllocator
from nnstreamer_tpu.models import layers as jlayers
from nnstreamer_tpu.models import zoo as jzoo
from nnstreamer_tpu.parallel.dispatch import BatchCore as JaxBatchCore
from nnstreamer_tpu.runtime.channel import Channel as JaxChannel
from nnstreamer_tpu.tensor import buffer as jbuffer
from nnstreamer_tpu.tensor.info import TensorsSpec as JaxSpec
from nnstreamer_tpu_torch.backends.base import FilterBackend
from nnstreamer_tpu_torch.core import config
from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.log import log_error_with_trace
from nnstreamer_tpu_torch.elements.filter import np_shape
from nnstreamer_tpu_torch.elements.transform import TensorTransform
from nnstreamer_tpu_torch.llm.paged_cache import BlockAllocator
from nnstreamer_tpu_torch.models import layers, zoo
from nnstreamer_tpu_torch.parallel.dispatch import BatchCore
from nnstreamer_tpu_torch.runtime.channel import Channel
from nnstreamer_tpu_torch.tensor import buffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _channel_script(ch):
    """The same operations on a channel → what each returned."""
    out = [ch.capacity, ch.closed, ch.qsize()]
    out += [ch.try_put(i) for i in range(4)]        # capacity 3: 1 2 3 None
    out += [ch.qsize(), ch.full(), ch.get()[0], ch.try_put("x"),
            ch.qsize()]
    ch.close()
    out += [ch.closed, ch.try_put("late"), ch.qsize()]
    return out


def test_channel_try_put_closed_capacity_qsize_equal_jax():
    assert _channel_script(Channel(3)) == _channel_script(JaxChannel(3))


def test_batch_core_infer_equal_jax():
    frames = [np.full((2,), i, np.float32) for i in range(3)]
    core = BatchCore(lambda b, n: b * 2 + 1, buckets=(1, 2, 4),
                     max_delay_s=0.001)
    jcore = JaxBatchCore(lambda b, n: b * 2 + 1, buckets=(1, 2, 4),
                         max_delay_s=0.001)
    try:
        for f in frames:
            got, want = core.infer(f, timeout=30), jcore.infer(f, timeout=30)
            assert len(got) == len(want) == 1
            np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        assert core.stats()["frames"] == jcore.stats()["frames"] == 3
    finally:
        core.shutdown()
        jcore.shutdown()


def _alloc_script(a):
    out = [a.can_alloc(0), a.can_alloc(a.total), a.can_alloc(a.total + 1)]
    got = a.alloc(5)
    out += [a.can_alloc(a.total - 5), a.can_alloc(a.total - 4)]
    a.free_blocks(got)
    return out + [a.can_alloc(a.total)]


def test_block_allocator_can_alloc_equal_jax():
    assert _alloc_script(BlockAllocator(12)) == _alloc_script(
        JaxAllocator(12))


PIPE = ("videotestsrc name=src num-buffers=1 width=8 height=8 ! "
        "tensor_converter name=conv ! tensor_transform name=tr "
        "mode=typecast option=float32 ! tensor_sink name=out")


def test_pipeline_describe_and_spec_of_link_equal_jax():
    ours, theirs = tn.parse_launch(PIPE), jn.parse_launch(PIPE)
    with pytest.raises(PipelineError, match="not negotiated"):
        ours.spec_of_link(ours.links[0])
    ours.negotiate()
    theirs.negotiate()
    assert ours.describe() == theirs.describe()
    assert ours.describe().startswith("pipeline 'pipeline':")
    specs = [str(ours.spec_of_link(l)) for l in ours.links]
    assert specs == [str(theirs.spec_of_link(l)) for l in theirs.links]
    assert ours.spec_of_link(ours.links[-1]).tensors[0].shape == (1, 8, 8, 3)


@pytest.mark.parametrize("dims,types", [
    ("3:224:224:1", "uint8"), ("10:1,4:20", "float32,int16"),
    ("1", "float64")])
def test_tensors_spec_nbytes_equal_jax(dims, types):
    ours = TensorsSpec.from_strings(dims, types)
    assert ours.nbytes == JaxSpec.from_strings(dims, types).nbytes
    assert ours.nbytes == sum(t.nbytes for t in ours.tensors) > 0


def test_tensor_buffer_matches_equal_jax():
    spec_s, spec_t = "4:2", "float32"
    for arr in (np.zeros((2, 4), np.float32), np.zeros((2, 4), np.int32),
                np.zeros((3, 4), np.float32)):
        ours = buffer.TensorBuffer.of(torch.from_numpy(arr)).matches(
            TensorsSpec.from_strings(spec_s, spec_t))
        theirs = jbuffer.TensorBuffer.of(arr).matches(
            JaxSpec.from_strings(spec_s, spec_t))
        assert ours == theirs
    assert buffer.TensorBuffer.of(np.zeros((2, 4), np.float32)).matches(
        TensorsSpec.from_strings(spec_s, spec_t))


def test_reset_config_and_dump_equal_jax(tmp_path):
    ini = tmp_path / "conf.ini"
    ini.write_text("[filter]\nframework_priority = custom\n"
                   "[extra]\nzeta = 1\nalpha = two\n")
    try:
        ours = config.reset_config(str(ini))
        theirs = jconfig.reset_config(str(ini))
        assert config.get_config() is ours
        assert ours.get("extra", "alpha") == theirs.get("extra", "alpha") \
            == "two"
        dump, jdump = ours.dump().splitlines(), theirs.dump().splitlines()
        assert dump[0] == jdump[0] == f"# config file: {ini}"

        def section(lines, name):
            i = lines.index(f"[{name}]")
            return lines[i + 1:i + 1 + next(
                (k for k, l in enumerate(lines[i + 1:]) if l.startswith(
                    "[")), len(lines))]

        assert section(dump, "extra") == section(jdump, "extra") == [
            "alpha = two", "zeta = 1"]
        assert "framework_priority = custom" in section(dump, "filter")
        assert config.reset_config().dump().startswith(
            "# config file: (none)")
    finally:
        config.reset_config()
        jconfig.reset_config()


def test_log_error_with_trace_equal_jax(caplog):
    def caller_frame_marker(fn, logger):
        fn(logger, "failed %s", "here")

    records = []
    for fn, name in ((log_error_with_trace, "nnstreamer_tpu_torch.t"),
                     (jlog_trace, "nnstreamer_tpu.t")):
        caplog.clear()
        with caplog.at_level(logging.ERROR, logger=name):
            caller_frame_marker(fn, logging.getLogger(name))
        (rec,) = [r for r in caplog.records if r.name == name]
        msg = rec.getMessage()
        assert rec.levelno == logging.ERROR
        assert msg.startswith("failed here\nstack:\n")
        assert "caller_frame_marker" in msg
        records.append(msg.split("\n")[0])
    assert records[0] == records[1]


@pytest.mark.parametrize("name", ["transformer", "lstm", "audio_classifier"])
def test_count_params_equal_jax(name):
    theirs = jlayers.count_params(jzoo.build_model(name).params)
    assert layers.count_params(zoo.build_model(name).params) == theirs > 0


def test_count_params_of_a_module_and_a_tree_equal_jax():
    """A module counts its parameters and buffers (its BN statistics,
    which JAX keeps in its params tree): MobileNetV2 at width 0.35
    against JAX's count over its init's shapes; a tree counts the
    arrays it holds."""
    import jax

    from nnstreamer_tpu.models import mobilenet_v2 as jmbv2

    shapes = jax.eval_shape(lambda: jmbv2.init_params(width=0.35))
    model = zoo.build_model("mobilenet_v2?width=0.35&input_size=64").params
    assert isinstance(model, torch.nn.Module)
    assert layers.count_params(model) == jlayers.count_params(shapes) > 0
    tree = {"a": torch.zeros(3, 4), "b": [np.zeros(5), torch.ones(2)]}
    assert layers.count_params(tree) == jlayers.count_params(
        {"a": jnp.zeros((3, 4)), "b": [np.zeros(5), jnp.ones(2)]}) == 19


def test_filter_backend_default_hooks_equal_jax():
    class Plain(FilterBackend):
        pass

    class JaxPlain(JaxBackend):
        pass

    assert Plain().version_stats() == JaxPlain().version_stats() == {}
    assert Plain().warm_start() == JaxPlain().warm_start() == 0


@pytest.mark.parametrize("mode,option", [
    ("arithmetic", "typecast:float32,add:-127.5,div:127.5"),
    ("typecast", "float32"),
    ("transpose", "1:0:2:3")])
def test_tensor_transform_as_elementwise_equal_jax(mode, option):
    x = np.random.default_rng(0).integers(0, 256, (1, 4, 6, 3)).astype(
        np.uint8)
    ours = TensorTransform(mode=mode, option=option).as_elementwise()
    theirs = JaxTransform(mode=mode, option=option).as_elementwise()
    (got,), (want,) = ours((torch.from_numpy(x),)), theirs((jnp.asarray(x),))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_now_ns_is_jax_clock():
    a, b, c = jbuffer.now_ns(), buffer.now_ns(), jbuffer.now_ns()
    assert isinstance(b, int) and a <= b <= c


def test_np_shape_equal_jax():
    for x, jx in ((np.zeros((2, 3)), np.zeros((2, 3))),
                  ([[1, 2, 3]], [[1, 2, 3]]),
                  (torch.zeros(4, 1), jnp.zeros((4, 1))),
                  (7, 7)):
        assert tuple(np_shape(x)) == tuple(jnp_shape(jx))
