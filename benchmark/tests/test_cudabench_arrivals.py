"""The seeded length generators."""

import json
import os

import numpy as np
import pytest

from benchmark import arrivals

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mix(name):
    with open(os.path.join(BENCH, "traffic", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["batch_decode.json"])
def test_same_seed_same_requests_other_seed_same_work(name):
    mix = _mix(name)
    big = 2 ** 33 + 7
    p1, o1 = arrivals.request_sizes(mix, 500, big)
    p2, o2 = arrivals.request_sizes(mix, 500, big)
    p3, o3 = arrivals.request_sizes(mix, 500, big + 1)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(o1, o2)
    assert not np.array_equal(p1, p3)
    np.testing.assert_array_equal(np.sort(p1), np.sort(p3))
    np.testing.assert_array_equal(np.sort(o1), np.sort(o3))
    for spec, v in ((mix["prompt"], p1), (mix["output"], o1)):
        assert v.min() >= spec["lo"] and v.max() <= spec["hi"]


def test_lengths_follow_their_distributions():
    rng = np.random.default_rng(0)
    v = arrivals.lengths({"dist": "lognormal", "median": 1024, "sigma": 0.6,
                          "lo": 256, "hi": 3584}, 20000, rng)
    assert abs(np.median(v) - 1024) < 40
    v = arrivals.lengths({"dist": "loguniform", "lo": 128, "hi": 1024},
                         20000, rng)
    assert abs(np.mean(np.log(v)) - (np.log(128) + np.log(1025)) / 2) < 0.05
    v = arrivals.lengths({"dist": "uniform", "lo": 256, "hi": 1024}, 20000,
                         rng)
    assert v.min() == 256 and v.max() == 1024
