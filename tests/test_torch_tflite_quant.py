"""The fixture tool's MobileNetV2 files through the port's TFLite
lowerings, against tf.lite.Interpreter and the JAX package's lowerings,
on the CPU; and the int8-native lowering's `_int_mm` padding.

The model: MobileNetV2 0.35 at 96², the JAX package's parameter tree
from seeded numpy with random BN statistics, carried into the port's
MobileNetV2 by the weights bridge, written with BN folded by
nnstreamer_tpu_torch/tools/tflite_fixture.py as float32 and as uint8
(activation ranges from a float calibration run).

- float file: the port (f32), JAX's loader (f32) and the interpreter
  agree within 1e-3·max|logit|; the port agrees with its own zoo model
  on the same parameters within the same bound (the file folds BN, the
  zoo model does not);
- uint8 file, int8-native (`custom=dtype=int8`): the port's output equals
  JAX `lower_tflite_quant`'s bit for bit on 10 seeded frames; against the
  interpreter top-1 is equal on the same frames, and the port's largest
  difference in output LSBs is no larger than JAX's (both use an f32
  multiplier where the interpreter uses a fixed-point one); every op,
  fed the interpreter's own input tensors, within 1 LSB of the
  interpreter's output. The top-1 file keeps the JAX init's BN (unit
  scale and variance, zero mean and bias; the convs as above): with the
  random BN statistics the 1-LSB rounding differences of each op grow
  through the network to tens of LSBs (op by op they stay within 1), and
  top-1 agrees on 2 of 10 frames for the port and JAX alike. On that
  file the port equals JAX bit for bit, and its largest LSB difference
  to the interpreter is no larger than the interpreter's own output
  moves under a seeded ±1-LSB change of its input frames;
- uint8 file under the float lowering (`dtype=float32`, float outputs):
  the port against JAX within 1e-4;
- `int_mm`: M ≤ 16, K = 27, N odd (odd through the all-ones channel),
  each exact against an int64 product.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio import load_model_file
from nnstreamer_tpu_torch.modelio.tflite_quant import (
    INT_MM_ALIGN, int_mm, int_mm_weight)

WIDTH, SIZE, FRAMES = 0.35, 96, 10
REL = 1e-3


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    monkeypatch.setenv("NNSTREAMER_TPU_TORCH_FILTER_ACCELERATOR", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_params(width=WIDTH, seed=0, random_bn=True):
    """The JAX MobileNetV2 tree (shapes from eval_shape) with seeded
    He-normal convs and denses, and random BN statistics or (random_bn
    False) the JAX init's: unit scale and variance, zero mean and bias."""
    from test_torch_detection import random_params
    from nnstreamer_tpu.models import mobilenet_v2 as jm

    params = random_params(jm.init_params, seed=seed, width=width)
    if random_bn:
        return params

    def init_bn(p):
        if isinstance(p, dict):
            if set(p) == {"scale", "bias", "mean", "var"}:
                n = p["scale"].shape[0]
                return {"scale": np.ones(n, np.float32),
                        "bias": np.zeros(n, np.float32),
                        "mean": np.zeros(n, np.float32),
                        "var": np.ones(n, np.float32)}
            return {k: init_bn(v) for k, v in p.items()}
        if isinstance(p, list):
            return [init_bn(v) for v in p]
        return p

    return init_bn(params)


def port_mobilenet(params, width=WIDTH):
    from nnstreamer_tpu_torch.models import bridge
    from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2

    return bridge.load_mobilenet_v2(
        MobileNetV2(width, dtype=torch.float32).eval(), params)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from nnstreamer_tpu_torch.tools import tflite_fixture as fx

    d = tmp_path_factory.mktemp("torch_mbv2_tflite")
    params = jax_params()
    model = port_mobilenet(params)
    fx.write_mobilenet_v2(model, d / "f.tflite", input_size=SIZE)
    fx.write_mobilenet_v2(model, d / "q_rbn.tflite", quant=True,
                          input_size=SIZE, calib_frames=4)
    fx.write_mobilenet_v2(port_mobilenet(jax_params(random_bn=False)),
                          d / "q.tflite", quant=True, input_size=SIZE,
                          calib_frames=4)
    return {"f": str(d / "f.tflite"), "q": str(d / "q.tflite"),
            "q_rbn": str(d / "q_rbn.tflite"), "model": model,
            "params": params}


def frames_u8(n=FRAMES, seed=7):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 1, SIZE, SIZE, 3), np.uint8)


def _interpreter(path):
    tf = pytest.importorskip("tensorflow")
    interp = tf.lite.Interpreter(
        model_path=path, experimental_op_resolver_type=tf.lite.experimental
        .OpResolverType.BUILTIN_WITHOUT_DEFAULT_DELEGATES)
    interp.allocate_tensors()
    ind = interp.get_input_details()[0]["index"]
    outd = interp.get_output_details()[0]["index"]

    def run(x):
        interp.set_tensor(ind, x)
        interp.invoke()
        return interp.get_tensor(outd)
    return run


def _port(path, **opts):
    m = load_model_file(path, **opts)

    def run(x):
        with torch.inference_mode():
            return m.fn(m.params, torch.from_numpy(x))[0].numpy()
    return run


def _jax(path, **opts):
    import jax
    from nnstreamer_tpu.modelio import load_model_file as jload

    m = jload(path, **opts)
    fn = jax.jit(m.fn)
    return lambda x: np.asarray(fn(m.params, x)[0])


def test_torch_mobilenet_float_file_matches_interpreter_jax_and_zoo(files):
    port = _port(files["f"], compute_dtype="float32")
    jx = _jax(files["f"], compute_dtype="float32")
    interp = _interpreter(files["f"])
    for u8 in frames_u8(3):
        x = (u8.astype(np.float32) - 127.5) / 127.5
        ours = port(x)
        assert ours.shape == (1, 1001) and ours.dtype == np.float32
        with torch.inference_mode():
            zoo = files["model"](torch.from_numpy(x)).numpy()
        for other in (interp(x), jx(x), zoo):
            scale = float(np.abs(other).max())
            assert np.abs(ours - other).max() <= REL * scale
        assert ours.argmax() == zoo.argmax()


def _quant_outputs(path):
    """The port's int8-native, JAX `lower_tflite_quant`'s and the
    interpreter's uint8 outputs on the seeded frames."""
    port = _port(path, compute_dtype="int8")
    interp = _interpreter(path)
    from nnstreamer_tpu.modelio import parse_tflite as jparse
    from nnstreamer_tpu.modelio.tflite_quant import lower_tflite_quant
    import jax

    jm = lower_tflite_quant(jparse(path))
    jfn = jax.jit(jm.fn)
    out = {"port": [], "jax": [], "interp": []}
    for u8 in frames_u8():
        out["port"].append(port(u8))
        out["jax"].append(np.asarray(jfn(jm.params, u8)[0]))
        out["interp"].append(interp(u8))
    return {k: np.stack(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def quant_runs(files):
    return _quant_outputs(files["q"])


def test_torch_int8_native_matches_jax_bit_for_bit(quant_runs):
    assert quant_runs["port"].dtype == np.uint8
    assert quant_runs["port"].shape == (FRAMES, 1, 1001)
    np.testing.assert_array_equal(quant_runs["port"], quant_runs["jax"])


def test_torch_int8_native_against_interpreter(quant_runs):
    port, jx, ref = (quant_runs[k].astype(int)
                     for k in ("port", "jax", "interp"))
    np.testing.assert_array_equal(port.argmax(-1), ref.argmax(-1))
    assert np.abs(port - ref).max() <= np.abs(jx - ref).max()


def test_torch_int8_native_each_op_within_one_lsb_of_interpreter(files):
    """Each op of the random-BN uint8 file, lowered alone and fed the
    interpreter's own input tensors, within 1 LSB of the interpreter's
    output (the f32 multiplier against its fixed-point one)."""
    tf = pytest.importorskip("tensorflow")
    from nnstreamer_tpu_torch.modelio import parse_tflite
    from nnstreamer_tpu_torch.modelio.tflite_quant import lower_tflite_quant

    path = files["q_rbn"]
    interp = tf.lite.Interpreter(
        model_path=path, experimental_preserve_all_tensors=True,
        experimental_op_resolver_type=tf.lite.experimental
        .OpResolverType.BUILTIN_WITHOUT_DEFAULT_DELEGATES)
    interp.allocate_tensors()
    interp.set_tensor(interp.get_input_details()[0]["index"],
                      frames_u8(1)[0])
    interp.invoke()
    n_ops = len(parse_tflite(path).ops)
    worst = {}
    for k in range(n_ops):
        g = parse_tflite(path)
        op = g.ops[k]
        g.inputs = [i for i in op.inputs if g.tensors[i].buffer is None]
        g.outputs, g.ops = [op.outputs[0]], [op]
        m = lower_tflite_quant(g)
        with torch.inference_mode():
            ours = m.fn(m.params, *(torch.from_numpy(interp.get_tensor(i))
                                    for i in g.inputs))[0].numpy()
        ref = interp.get_tensor(op.outputs[0])
        worst[(k, op.name)] = int(np.abs(ours.astype(int)
                                         - ref.astype(int)).max())
    assert max(worst.values()) <= 1, worst


def test_torch_int8_native_random_bn_gap_within_interpreter_sensitivity(
        files):
    """On the random-BN uint8 file the port still equals JAX bit for bit,
    and its largest difference to the interpreter is no larger than the
    interpreter's own output moves when its input frames move by a
    seeded ±1 LSB: the gap that grows through this file is of the size
    the reference's own rounding produces (its top-1 flips on most frames
    under that noise too), not a fault of the lowering."""
    runs = _quant_outputs(files["q_rbn"])
    np.testing.assert_array_equal(runs["port"], runs["jax"])
    interp = _interpreter(files["q_rbn"])
    rng = np.random.default_rng(1)
    moved = np.stack([interp(np.clip(
        u8.astype(int) + rng.integers(-1, 2, u8.shape), 0, 255)
        .astype(np.uint8)) for u8 in frames_u8()]).astype(int)
    ref = runs["interp"].astype(int)
    assert (np.abs(runs["port"].astype(int) - ref).max()
            <= np.abs(moved - ref).max())


def test_torch_quant_file_float_lowering_matches_jax(files):
    u8 = frames_u8(2)
    port = _port(files["q"], compute_dtype="float32", quantize_output=False)
    jx = _jax(files["q"], compute_dtype="float32", quantize_output=False)
    for x in u8:
        np.testing.assert_allclose(port(x), jx(x), atol=1e-4, rtol=1e-4)
    # and re-quantized: the same uint8 logits
    port_q = _port(files["q"], compute_dtype="float32")
    jx_q = _jax(files["q"], compute_dtype="float32")
    for x in u8:
        np.testing.assert_array_equal(port_q(x), jx_q(x))


def test_torch_int8_dispatch(files):
    """int8 refuses a float graph; auto falls back to the float lowering
    there and picks int8-native on the quantized file."""
    with pytest.raises(BackendError, match="fully-quantized"):
        load_model_file(files["f"], compute_dtype="int8")
    auto = load_model_file(files["f"], compute_dtype="auto")
    assert auto.in_spec.tensors[0].dtype.type_name == "float32"
    q = load_model_file(files["q"], compute_dtype="auto")
    assert q.name.endswith("[int8]")
    with pytest.raises(BackendError, match="not a float dtype"):
        load_model_file(files["q"], compute_dtype="int4")


@pytest.mark.parametrize("m,k,n", [
    (1, 27, 5),            # M <= 16, K 27 (MobileNetV2's first conv), N odd
    (16, 27, 33),          # M at the rule's edge; N odd
    (17, 64, 8),           # already on the rules
    (49, 320, 1281),       # the head at 7²: N odd through the ones channel
    (3, 8, 1),
])
def test_torch_int_mm_padding_exact(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    a = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    wp = int_mm_weight(w)
    assert wp.shape[0] % INT_MM_ALIGN == 0 and wp.shape[1] % INT_MM_ALIGN == 0
    # stored (N, K): passed to _int_mm as a column-major (K, N) view
    np.testing.assert_array_equal(wp[:n, :k], w.T)
    got = int_mm(torch.from_numpy(a), torch.from_numpy(wp), n)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64))


def test_torch_int_mm_ones_channel_is_the_window_sum():
    """The all-ones output channel of the zero-point decomposition: its
    column of the product is each row's sum, exactly."""
    rng = np.random.default_rng(4)
    a = rng.integers(-128, 128, (5, 27), dtype=np.int8)
    w = np.concatenate([rng.integers(-128, 128, (27, 6), dtype=np.int8),
                        np.ones((27, 1), np.int8)], axis=1)     # N = 7
    got = int_mm(torch.from_numpy(a), torch.from_numpy(int_mm_weight(w)), 7)
    np.testing.assert_array_equal(got[:, 6].numpy(),
                                  a.astype(np.int64).sum(axis=1))
