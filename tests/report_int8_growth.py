"""How far the int8-native lowering's output drifts from tf.lite.Interpreter
through the fixture tool's MobileNetV2 (0.35 at 96², the files of
test_torch_tflite_quant.py), and how far the interpreter's own output
drifts when its input frames move by a seeded ±1 LSB. Not a test: a
report that ROADMAP's N11 cites. Prints, for the random-BN file and the
file with the JAX init's BN:

- the port's largest gap to the interpreter's tensor after each op, the
  port's int8 graph run whole on the same frames (chained);
- the port's output against the interpreter's: largest LSB gap and
  top-1 agreement on the 10 seeded frames;
- the interpreter's output under ±1-LSB input noise against its own
  output: the same two numbers.

Run from the repository root, on the CPU, with tensorflow installed:
    JAX_PLATFORMS=cpu python tests/report_int8_growth.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_tflite_quant as T  # noqa: E402
from nnstreamer_tpu_torch.modelio import parse_tflite  # noqa: E402
from nnstreamer_tpu_torch.modelio.tflite_quant import (  # noqa: E402
    lower_tflite_quant)
from nnstreamer_tpu_torch.tools import tflite_fixture as fx  # noqa: E402


def report(path: str) -> None:
    import tensorflow as tf

    interp = tf.lite.Interpreter(
        model_path=path, experimental_preserve_all_tensors=True,
        experimental_op_resolver_type=tf.lite.experimental
        .OpResolverType.BUILTIN_WITHOUT_DEFAULT_DELEGATES)
    interp.allocate_tensors()
    ind = interp.get_input_details()[0]["index"]
    g = parse_tflite(path)
    g.outputs = [op.outputs[0] for op in g.ops]
    m = lower_tflite_quant(g)
    gaps = np.zeros(len(g.ops), int)
    rng = np.random.default_rng(1)
    ref, moved, port = [], [], []
    for x in T.frames_u8():
        interp.set_tensor(ind, x)
        interp.invoke()
        refs = [interp.get_tensor(t).astype(int) for t in g.outputs]
        with torch.inference_mode():
            ours = [t.numpy().astype(int)
                    for t in m.fn(m.params, torch.from_numpy(x))]
        gaps = np.maximum(gaps, [np.abs(a - b).max()
                                 for a, b in zip(ours, refs)])
        ref.append(refs[-1])
        port.append(ours[-1])
        noisy = np.clip(x.astype(int) + rng.integers(-1, 2, x.shape), 0, 255)
        interp.set_tensor(ind, noisy.astype(np.uint8))
        interp.invoke()
        moved.append(interp.get_tensor(g.outputs[-1]).astype(int))
    ref, moved, port = map(np.stack, (ref, moved, port))
    print(f"  chained gap after each op (LSB): {gaps.tolist()}")
    for name, out in (("port", port), ("interpreter, input ±1 LSB", moved)):
        print(f"  {name} against the interpreter: largest gap "
              f"{np.abs(out - ref).max()} LSB, top-1 equal on "
              f"{int((out.argmax(-1) == ref.argmax(-1)).sum())} of "
              f"{len(ref)} frames")


def main() -> None:
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as d:
        for random_bn in (True, False):
            path = os.path.join(d, f"q_{random_bn}.tflite")
            fx.write_mobilenet_v2(
                T.port_mobilenet(T.jax_params(random_bn=random_bn)), path,
                quant=True, input_size=T.SIZE, calib_frames=4)
            print("random BN statistics" if random_bn
                  else "the JAX init's BN")
            report(path)


if __name__ == "__main__":
    main()
