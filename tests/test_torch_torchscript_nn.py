"""TorchScript (.pt) recurrent, attention and deeper models in the port
(nnstreamer_tpu_torch/modelio/torchscript.py) against the JAX package's
loader and `torch.jit.load`, on the CPU — the rest of
`tests/test_torchscript.py`'s tests that run without the reference's
model files (LSTM, GRU, the text classifier, SDPA attention causal and
full and across lengths, nn.MultiheadAttention, nn.TransformerEncoder
(both norm orders), nn.TransformerDecoder, the residual CNN), without
wall-clock bounds. Each archive runs through the port and the JAX loader
(jitted) on the same seeded inputs, f32, within 1e-5·max|y| + 1e-6, and
through `torch.jit.load` at the JAX test's tolerance; the encoder is also
`tools/model_fixtures.write_torchscript_encoder`'s (cell TX at reduced
width), its record one call a layer.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

from nnstreamer_tpu.modelio import load_model_file as jload
from nnstreamer_tpu_torch.modelio import load_model_file
from nnstreamer_tpu_torch.tools import model_fixtures as mf


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _near(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = 1e-5 * float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) <= tol


def _hold(path, *xs, rtol=1e-4, atol=1e-5, torch_xs=None):
    """The port's outputs against the JAX loader's (1e-5·max|y| + 1e-6)
    and torch.jit.load's (the JAX test's tolerance) → the port's.
    `torch_xs`: the oracle's inputs where they differ (int64 ids)."""
    b = load_model_file(path)
    got = [o.numpy() for o in b.fn(b.params,
                                   *[torch.from_numpy(x) for x in xs])]
    jb = jload(path)
    want = jax.jit(lambda p, *a: jb.fn(p, *a))(jb.params, *xs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _near(g, np.asarray(w))
    with torch.no_grad():
        ref = torch.jit.load(path)(
            *[torch.from_numpy(x) for x in (torch_xs or xs)])
    refs = ref if isinstance(ref, (tuple, list)) else (ref,)
    assert len(refs) == len(got)
    for g, r in zip(got, refs):
        np.testing.assert_allclose(g, r.numpy(), rtol=rtol, atol=atol)
    return got, b


def _script(tmp_path, model, name="m.pt"):
    path = str(tmp_path / name)
    torch.jit.save(torch.jit.script(model.eval()), path)
    return path


@pytest.mark.parametrize("bidir", [False, True])
def test_torch_scripted_lstm_matches_torch_and_jax(tmp_path, bidir):
    """nn.LSTM (torch.lstm): output and final states, two layers,
    uni- and bidirectional."""
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.rnn = tnn.LSTM(6, 5, num_layers=2, batch_first=True,
                                bidirectional=bidir)
            self.fc = tnn.Linear(5 * (2 if bidir else 1), 3)

        def forward(self, x):
            y, (h, c) = self.rnn(x)
            return self.fc(y[:, -1]), h, c

    torch.manual_seed(8)
    x = np.random.RandomState(8).randn(2, 7, 6).astype(np.float32)
    outs, _ = _hold(_script(tmp_path, Net()), x)
    assert len(outs) == 3


def test_torch_scripted_gru_matches_torch_and_jax(tmp_path):
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.rnn = tnn.GRU(4, 8, batch_first=True)

        def forward(self, x):
            y, h = self.rnn(x)
            return y, h

    torch.manual_seed(9)
    x = np.random.RandomState(9).randn(3, 5, 4).astype(np.float32)
    _hold(_script(tmp_path, Net()), x)


def test_torch_scripted_text_classifier_matches_torch_and_jax(tmp_path):
    """Embedding + LSTM + Linear over int32 token ids."""
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.emb = tnn.Embedding(50, 12)
            self.rnn = tnn.LSTM(12, 9, batch_first=True)
            self.fc = tnn.Linear(9, 4)

        def forward(self, ids):
            x = self.emb(ids)
            y, _ = self.rnn(x)
            return torch.softmax(self.fc(y[:, -1]), dim=1)

    torch.manual_seed(10)
    ids = np.random.RandomState(10).randint(0, 50, (3, 11)).astype(np.int32)
    _hold(_script(tmp_path, Net()), ids, torch_xs=[ids.astype(np.int64)])


@pytest.mark.parametrize("causal", [False, True])
def test_torch_scripted_attention_block_matches_torch_and_jax(tmp_path,
                                                              causal):
    """F.scaled_dot_product_attention in a self-attention block."""
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.qkv = tnn.Linear(32, 96)
            self.out = tnn.Linear(32, 32)
            self.causal = causal

        def forward(self, x):
            B, S, D = x.shape[0], x.shape[1], x.shape[2]
            qkv = self.qkv(x).reshape(B, S, 3, 4, 8)
            q = qkv[:, :, 0].transpose(1, 2)
            k = qkv[:, :, 1].transpose(1, 2)
            v = qkv[:, :, 2].transpose(1, 2)
            a = F.scaled_dot_product_attention(q, k, v,
                                               is_causal=self.causal)
            a = a.transpose(1, 2).reshape(B, S, D)
            return self.out(a)

    torch.manual_seed(11)
    x = np.random.RandomState(11).randn(2, 10, 32).astype(np.float32)
    _hold(_script(tmp_path, Net()), x)


def test_torch_scripted_sdpa_causal_cross_length_matches_torch_and_jax(
        tmp_path):
    """is_causal with Lq != Lk: torch's mask is ones(L, S).tril() —
    top-left aligned."""
    class Net(tnn.Module):
        def forward(self, q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    rs = np.random.RandomState(13)
    q = rs.randn(2, 4, 6, 8).astype(np.float32)
    k = rs.randn(2, 4, 10, 8).astype(np.float32)
    v = rs.randn(2, 4, 10, 8).astype(np.float32)
    _hold(_script(tmp_path, Net()), q, k, v)


def test_torch_scripted_multihead_attention_matches_torch_and_jax(
        tmp_path):
    """nn.MultiheadAttention through _native_multi_head_attention."""
    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.mha = tnn.MultiheadAttention(32, 4, batch_first=True)
            self.ln = tnn.LayerNorm(32)

        def forward(self, x):
            y, _ = self.mha(x, x, x, need_weights=False)
            return self.ln(x + y)

    torch.manual_seed(12)
    x = np.random.RandomState(12).randn(2, 9, 32).astype(np.float32)
    _hold(_script(tmp_path, Net()), x)


@pytest.mark.parametrize("norm_first,act", [(False, "gelu"),
                                            (True, "relu")])
def test_torch_scripted_transformer_encoder_matches_torch_and_jax(
        tmp_path, norm_first, act):
    """nn.TransformerEncoder through _transformer_encoder_layer_fwd, both
    norm orders and activations."""
    torch.manual_seed(13)
    layer = tnn.TransformerEncoderLayer(
        d_model=32, nhead=4, dim_feedforward=64, batch_first=True,
        activation=act, norm_first=norm_first)
    net = tnn.TransformerEncoder(layer, num_layers=2)
    path = _script(tmp_path, net, f"enc{norm_first}{act}.pt")
    x = np.random.RandomState(13).randn(2, 9, 32).astype(np.float32)
    _hold(path, x)


def test_torch_fixture_encoder_records_one_call_a_layer(tmp_path):
    """write_torchscript_encoder (cell TX's writer, 3 layers at d_model
    32): the port matches the JAX loader and torch, and its record is one
    fused layer call each (the fast path's `_transformer_encoder_layer_fwd`)
    however the code branches to reach it."""
    path = tmp_path / "enc.pt"
    mf.write_torchscript_encoder(path, d_model=32, nhead=8, dim_ff=128,
                                 layers=3, seed=1)
    x = np.random.RandomState(14).randn(1, 12, 32).astype(np.float32)
    _, b = _hold(str(path), x)
    (tape,) = b.fn.tapes.values()
    assert tape.calls == 3
    assert tape.source.count("del ") == 2


def test_torch_scripted_transformer_decoder_matches_torch_and_jax(
        tmp_path):
    """nn.TransformerDecoder (self + cross attention through SDPA, a
    two-input forward)."""
    torch.manual_seed(14)
    layer = tnn.TransformerDecoderLayer(
        d_model=32, nhead=4, dim_feedforward=64, batch_first=True)
    net = tnn.TransformerDecoder(layer, num_layers=2)
    path = _script(tmp_path, net, "dec.pt")
    tgt = np.random.RandomState(14).randn(2, 7, 32).astype(np.float32)
    mem = np.random.RandomState(15).randn(2, 9, 32).astype(np.float32)
    _hold(path, tgt, mem)


def test_torch_scripted_residual_cnn_matches_torch_and_jax(tmp_path):
    """ResNet-pattern residual blocks (conv+bn chains, a strided
    projection shortcut, an adaptive pool head)."""
    class Block(tnn.Module):
        def __init__(self, cin, cout, stride):
            super().__init__()
            self.c1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.b1 = tnn.BatchNorm2d(cout)
            self.c2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.b2 = tnn.BatchNorm2d(cout)
            self.down = (tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, stride, bias=False),
                tnn.BatchNorm2d(cout))
                if stride != 1 or cin != cout else tnn.Identity())

        def forward(self, x):
            h = torch.relu(self.b1(self.c1(x)))
            h = self.b2(self.c2(h))
            return torch.relu(h + self.down(x))

    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.stem = tnn.Conv2d(3, 8, 3, 1, 1)
            self.b1 = Block(8, 8, 1)
            self.b2 = Block(8, 16, 2)
            self.pool = tnn.AdaptiveAvgPool2d((1, 1))
            self.fc = tnn.Linear(16, 5)

        def forward(self, x):
            h = torch.relu(self.stem(x))
            h = self.b2(self.b1(h))
            return self.fc(self.pool(h).flatten(1))

    torch.manual_seed(16)
    x = np.random.RandomState(16).randn(2, 3, 16, 16).astype(np.float32)
    _hold(_script(tmp_path, Net(), "resnet.pt"), x)
