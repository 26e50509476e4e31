"""The device trace's reduction: busy seconds as the union of device
records in the window, seconds by name, and idle gaps named by what the
launching thread was running."""

import pytest

from benchmark import harness


def test_summarize_busy_union_clipping_and_gaps():
    ms = 1_000_000
    dev = [(0 * ms, 2 * ms, "k1", 1),      # clipped to start at 1 ms
           (3 * ms, 5 * ms, "k2", 2),
           (4 * ms, 6 * ms, "k1", 3),      # overlaps k2: union 3-6
           (8 * ms, 9 * ms, "k3", 4),
           (20 * ms, 21 * ms, "k9", 5)]    # after the window
    host = {7: [(1 * ms, 10 * ms, "aten::linear"),
                (2 * ms, 2500_000, "aten::mm"),
                (6500_000, 7500_000, "cudaStreamSynchronize")]}
    launch = {2: 7, 4: 7, 5: 7}
    out = harness.summarize(dev, host, launch, 1 * ms, 10 * ms)
    assert out["window_s"] == pytest.approx(9e-3)
    assert out["busy_s"] == pytest.approx((1 + 3 + 1) * 1e-3)
    assert out["kernels"]["k1"] == pytest.approx(3e-3)
    assert out["launches"] == {"k1": 2, "k2": 1, "k3": 1}
    idle = dict(out["breakdown"]["idle_gaps"])
    # 2-3 ms: the midpoint, 2.5 ms, is the end of the mm: still in it
    assert idle["aten::mm"] == pytest.approx(1e-3)
    # 6-8 ms: midpoint 7 ms inside the synchronize
    assert idle["cudaStreamSynchronize"] == pytest.approx(2e-3)
    # 9-10 ms: no launch after it
    assert idle["no launch recorded after the gap"] == pytest.approx(1e-3)
    assert out["breakdown"]["device_ops"][0][0] == "k1"


def test_a_cpu_profile_reduces_with_its_window_marks(on_cpu):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = harness.DeviceTrace()
    tr.prof = profile(activities=[ProfilerActivity.CPU])
    tr.prof.start()
    with record_function(harness.MARK_START):
        pass
    torch.randn(64, 64) @ torch.randn(64, 64)
    with record_function(harness.MARK_STOP):
        pass
    tr.prof.stop()
    out = tr.reduce()
    assert out["busy_s"] == 0 and out["kernels"] == {}
    assert out["window_s"] > 0


def test_a_sub_window_that_lost_its_records_is_traced_again(monkeypatch):
    """The profiler drops device records now and then: the next
    sub-window is traced and kept; where every one lost them, the last
    comes back marked not valid and the device's readers find nothing
    to read."""
    busy = iter([0.001, 0.5])

    class Fake(harness.DeviceTrace):
        def start(self):
            pass

        def stop(self):
            pass

        def reduce(self):
            b = next(busy)
            return {"busy_s": b, "window_s": 1.0, "valid": b > 0.01}

    monkeypatch.setattr(harness, "DeviceTrace", Fake)
    import time
    summary = harness.trace_window(time.perf_counter(), 0.4, 0.05)
    assert summary["busy_s"] == 0.5
    busy = iter([0.0] * 3)
    summary = harness.trace_window(time.perf_counter(), 0.4, 0.05)
    assert not summary["valid"]
    from benchmark import readers
    assert readers.device_idle({"trace": summary}) is None


def test_coverage_counts_launches_without_device_records():
    ms = 1_000_000
    launched = [(1 * ms, 11), (2 * ms, 12), (3 * ms, 13), (4 * ms, 14),
                (999 * ms, 15)]        # within the margin of the end
    dev = [(5 * ms, 6 * ms, "k", 11), (6 * ms, 7 * ms, "k", 12),
           (7 * ms, 8 * ms, "k", 12), (8 * ms, 9 * ms, "k", 14)]
    assert harness.coverage(launched, dev, 0, 1000 * ms) == 0.75
    assert harness.coverage([], dev, 0, 1000 * ms) is None
    assert harness.coverage(launched[:2], dev, 0, 1000 * ms) == 1.0
