"""The metric arithmetic on hand-made run records: rates over the whole
window, per-layer readings from the executor's spans."""

import pytest

from benchmark import harness, readers
from benchmark.drivers.pipeline_llm import Request

import numpy as np


def _req(plen, arrivals):
    r = Request("r", np.zeros(plen, np.int32), len(arrivals))
    r.arrivals = list(arrivals)
    r.tokens = [0] * len(arrivals)
    r.done = True
    return r


def test_nearest_rank():
    v = list(range(1, 101))
    assert harness.nearest_rank(v, 95) == 95
    assert harness.nearest_rank(v, 100) == 100
    assert harness.nearest_rank([3.0], 95) == 3.0
    assert harness.nearest_rank([], 95) is None
    # 20 values: p95 is the 19th smallest
    assert harness.nearest_rank(list(range(20)), 95) == 18


def test_frames_per_s_is_the_whole_window():
    assert readers.frames_per_s({"frames_in_window": 600,
                                 "window_s": 2.0}) == 300.0


def test_output_tokens_per_s_counts_every_token_in_the_window():
    t0 = 100.0
    run = {"t0": t0, "t1": t0 + 2.0, "window_s": 2.0, "requests": [
        _req(4, [99.5, 100.0, 100.5, 101.99, 102.0]),   # 3 inside
        _req(4, [101.0, 101.5])]}                          # 2 inside
    assert readers.output_tokens_per_s(run) == 5 / 2.0


def test_device_idle_and_breakdown_shares():
    run = {"trace": {"busy_s": 0.75, "window_s": 1.0}}
    assert readers.device_idle(run) == pytest.approx(25.0)
    assert readers.device_idle({}) is None


def test_rooflines_need_a_trace():
    assert readers.paged_decode_roofline({}) is None
    assert readers.mfu_tokens({}) is None
    assert readers.mfu_frames({}) is None


_CFG = {"hidden_size": 8, "num_attention_heads": 2,
        "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
        "num_hidden_layers": 2, "vocab_size": 10}


def test_decode_roofline_and_mfu_from_the_executors_spans():
    # two decode calls of one row at contexts 4 and 5 (a 3-token
    # prompt), one prefill call of it, in the sub-window
    run = {"config": _CFG, "mix": {"element": {"block_size": 4}},
           "device": {"kind": "NVIDIA H100 80GB HBM3"},
           "trace": {"launches": {"nns_paged_decode_kernel": 4},
                     "kernels": {"nns_paged_decode_kernel": 1e-6},
                     "window_s": 3.0},
           "sub": {"decodes": [(1.5, 1, [4]), (2.5, 1, [5])],
                   "prefills": [(1.2, 0, 3)]}}
    from benchmark.cost import transformer as tcost
    f, b = tcost.sum_decode(_CFG, [4, 5], 4)
    want = 100.0 * max(f / 989e12, b / 3350e9) / 1e-6
    assert readers.paged_decode_roofline(run) == pytest.approx(want)
    flops = (tcost.token_flops(_CFG, 4) + tcost.token_flops(_CFG, 5)
             + tcost.prefill_flops(_CFG, 0, 3))
    assert readers.mfu_tokens(run) == pytest.approx(
        100.0 * flops / 3.0 / 989e12)
    # the trace holds half the launches of the two calls: half the work
    run["trace"]["launches"]["nns_paged_decode_kernel"] = 2
    assert readers.paged_decode_roofline(run) == pytest.approx(want / 2)


def test_rows_per_decode_step_is_the_spans_mean_rows():
    run = {"sub": {"decodes": [(0.1, 64, [9] * 64), (0.2, 62, [9] * 62),
                               (0.3, 63, [9] * 63)], "prefills": []}}
    assert readers.rows_per_decode_step(run) == pytest.approx(63.0)
    assert readers.rows_per_decode_step({"sub": {"decodes": [],
                                                 "prefills": []}}) is None
    assert readers.rows_per_decode_step({}) is None


def test_spread_is_the_quartile_distance_over_the_median():
    from benchmark import spread

    v = [100.0, 102.0, 98.0, 101.0, 99.0, 150.0]
    # exclusive quartiles of the six: 98.75 and 114.0; median 100.5
    assert spread.spread(v) == pytest.approx((114.0 - 98.75) / 100.5)
    assert spread.trimmed(v) == [100.0, 102.0, 98.0, 101.0, 99.0]
