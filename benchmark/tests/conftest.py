"""Shared fixtures of the benchmark's own tests. A test that needs the
card is marked `cuda` and takes the `card` fixture, which skips it where
no CUDA device is visible; nothing is decided when a module is
imported."""

import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips inside the `card` "
        "fixture where there is none)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: this test runs on the chip")
    return torch.device("cuda", 0)


@pytest.fixture
def on_cpu(monkeypatch):
    """The port on the CPU, with few threads."""
    import torch

    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield torch.device("cpu")
    torch.set_num_threads(prev)


@pytest.fixture
def repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
