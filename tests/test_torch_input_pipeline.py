"""The port's double-buffered input staging (nnstreamer_tpu_torch/
runtime/input_pipeline.py) against tests/test_runtime.py's
TestInputPipeline, on the CPU.

The JAX test's cases run on the port: order and values, the producer
running ahead (an ordering check with events, not a time), errors at the
consumer, the push-style feeder, bad depths. Then the port's own: on the
CPU, with the CPU asked for, a batch is staged as a copy of itself; a
caller's ``put=`` is its own transfer; and (N17) a `Staged` batch — the
card's form: pinned memory, a side copy stream, an event behind the copy
— is handed over only after the consumer's stream waits on that event
and the tensor is marked as used by that stream, on the consumer's
thread (stand-in stream and tensor objects: there is no card here).
"""

import threading

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.runtime import input_pipeline as ip
from nnstreamer_tpu_torch.runtime.input_pipeline import (
    CopyStager, DeviceFeeder, Staged, prefetch_to_device)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_prefetch_yields_all_in_order():
    batches = [np.full((4,), i, np.float32) for i in range(7)]
    out = list(prefetch_to_device(iter(batches), depth=2))
    assert len(out) == 7
    for i, y in enumerate(out):
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
        np.testing.assert_array_equal(y.numpy(), batches[i])


def test_prefetch_overlaps_staging():
    """The producer runs ahead of the consumer (double buffering): with
    depth=2 the 2nd batch is staged while the consumer still holds the
    1st — shown by an event the source sets when it hands over batch 2,
    waited for before the consumer asks for more; and the producer never
    runs more than depth + 1 batches ahead of what was taken."""
    staged = []
    second = threading.Event()
    ahead = []

    def source():
        for i in range(6):
            staged.append(i)
            if i == 1:
                second.set()
            yield np.full((2,), i, np.float32)

    it = prefetch_to_device(source(), depth=2)
    first = next(it)
    assert second.wait(30), "batch 2 was not staged while batch 1 was held"
    taken = 1
    for y in it:
        taken += 1
        # staged but not yet taken: at most `depth` queued + 1 in hand
        ahead.append(len(staged) - taken)
        np.testing.assert_array_equal(y.numpy(), [taken - 1] * 2)
    assert taken == 6 and max(ahead) <= 2 + 1
    np.testing.assert_array_equal(first.numpy(), [0, 0])


def test_prefetch_propagates_source_error():
    def bad():
        yield np.zeros(2, np.float32)
        raise ValueError("sensor unplugged")

    it = prefetch_to_device(bad(), depth=1)
    next(it)
    with pytest.raises(ValueError, match="sensor unplugged"):
        for _ in it:
            pass


def test_feeder_push_pull_and_close():
    f = DeviceFeeder(depth=2)
    f.put(np.arange(3, dtype=np.float32))
    f.put(np.arange(3, dtype=np.float32) * 2)
    f.close()
    a = f.get()
    b = f.get()
    np.testing.assert_array_equal(a.numpy(), [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(b.numpy(), [0.0, 2.0, 4.0])
    assert f.get() is None and f.get() is None
    with pytest.raises(RuntimeError, match="closed"):
        f.put(np.zeros(1, np.float32))


def test_feeder_rejects_bad_depth():
    with pytest.raises(ValueError, match="depth"):
        DeviceFeeder(depth=0)
    with pytest.raises(ValueError, match="depth"):
        list(prefetch_to_device(iter([]), depth=0))


def test_cpu_put_is_a_copy_of_the_batch():
    """With the CPU asked for, staging is the identity copy: equal
    values, its own memory (the producer may reuse its array), bfloat16
    and torch inputs too."""
    import ml_dtypes

    src = np.arange(6, dtype=np.float32).reshape(2, 3)
    bf = np.arange(4, dtype=np.float32).astype(ml_dtypes.bfloat16)
    t = torch.arange(3)
    out = list(prefetch_to_device(iter([src, bf, t]), depth=1))
    src[:] = -1
    t[:] = -1
    np.testing.assert_array_equal(out[0].numpy(), np.arange(6).reshape(2, 3))
    assert out[1].dtype == torch.bfloat16
    np.testing.assert_array_equal(out[1].float().numpy(), np.arange(4))
    np.testing.assert_array_equal(out[2].numpy(), [0, 1, 2])
    assert CopyStager("cpu").stream is None


def test_caller_put_keeps_its_meaning():
    """put= is the caller's own transfer: its results are handed over as
    they are, with the device passed through."""
    calls = []

    def put(x, device):
        calls.append(device)
        return ("mine", x)

    out = list(prefetch_to_device(iter([1, 2]), depth=2, device="cpu",
                                  put=put))
    assert out == [("mine", 1), ("mine", 2)] and calls == ["cpu", "cpu"]
    f = DeviceFeeder(depth=1, put=put)
    f.put(3)
    assert f.get() == ("mine", 3)


class _Stream:
    def __init__(self, log):
        self.log = log

    def wait_event(self, ev):
        self.log.append(("wait", ev, threading.get_ident()))


class _Tensor:
    device = "cuda:0"

    def __init__(self, log, v):
        self.log, self.v = log, v

    def record_stream(self, stream):
        self.log.append(("record", stream, threading.get_ident()))


def test_staged_batches_wait_and_record_on_the_consumer(monkeypatch):
    """N17: a Staged batch (the card's form) reaches the consumer only
    after its current stream waits on the copy's event and the tensor is
    marked as used by that stream — both on the consumer's thread, for
    prefetch_to_device and DeviceFeeder alike."""
    log = []
    stream = _Stream(log)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: stream)

    def put(x, device):
        return Staged(_Tensor(log, x), ("event", x))

    me = threading.get_ident()
    for i, y in enumerate(prefetch_to_device(iter([10, 11]), depth=2,
                                             put=put)):
        assert isinstance(y, _Tensor) and y.v == 10 + i
        assert log[-2:] == [("wait", ("event", 10 + i), me),
                            ("record", stream, me)]
    log.clear()
    f = DeviceFeeder(depth=2, put=put)
    worker = threading.Thread(target=f.put, args=(12,))
    worker.start()
    worker.join()
    assert log == []                 # nothing waited on the producer side
    y = f.get()
    assert y.v == 12 and log == [("wait", ("event", 12), me),
                                 ("record", stream, me)]
    assert ip._taken(5) == 5
