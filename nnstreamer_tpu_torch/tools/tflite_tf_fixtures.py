#!/usr/bin/env python3
"""Writes the TFLite files that only TensorFlow's converter can make, for
tests and on-card checks (fixture tooling, not a feature of the system:
nothing registers it with the pipeline and the package does not export
it).

`tflite_fixture.py` writes flatbuffers itself; these four come out of
`tf.lite.TFLiteConverter`, so they need tensorflow, which the machine
with the card does not have. The files are small and committed under
`tools/data/` (`DATA`), where the card's checks read them:

- `breadth_elementwise.tflite` — ~20 elementwise / reduce / select
  builtins on a (2, 8) f32 input (`breadth_elementwise`);
- `breadth_spatial.tflite` — depth_to_space, space_to_depth,
  l2_normalize, unpack and a transpose conv on (1, 4, 4, 8) f32
  (`breadth_spatial`);
- `detect.tflite` — the TFLite_Detection_PostProcess custom op over
  (1, `DETECT_N`, 4) box encodings and (1, N, `DETECT_C` + 1) class
  scores, seeded anchors, converted from a frozen GraphDef;
- `lstm.tflite` — a keras LSTM(5) + Dense(3) softmax on (1, 8, 6) f32, a
  WHILE graph with cond/body subgraphs (weights from keras' own
  initializers under seed 0).

    python3 nnstreamer_tpu_torch/tools/tflite_tf_fixtures.py [OUT_DIR]

writes all four into OUT_DIR (default: `DATA`).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict

import numpy as np

#: where the committed files live
DATA = Path(__file__).resolve().parent / "data"
#: the detection head's anchors and classes (without background)
DETECT_N, DETECT_C = 96, 4
FILES = {"elementwise": "breadth_elementwise.tflite",
         "spatial": "breadth_spatial.tflite",
         "detect": "detect.tflite", "lstm": "lstm.tflite"}


def _convert_fn(tf, fn, sig, path: Path) -> str:
    f = tf.function(fn, input_signature=sig)
    c = tf.lite.TFLiteConverter.from_concrete_functions(
        [f.get_concrete_function()])
    path.write_bytes(c.convert())
    return str(path)


def write_breadth(out: Path) -> Dict[str, str]:
    """The two breadth models → {"elementwise": path, "spatial": path}."""
    import tensorflow as tf

    def breadth_elementwise(x):
        a = tf.exp(x) + tf.math.log(tf.abs(x) + 1.0)
        b = tf.sqrt(tf.abs(x)) * tf.math.rsqrt(tf.abs(x) + 1.0)
        c = tf.pow(x, 3.0) - tf.math.squared_difference(x, 2.0)
        d = tf.floor(x) + tf.math.ceil(x) - (-x)
        e = tf.sin(x) + tf.cos(x) + tf.nn.elu(x) + tf.nn.gelu(x)
        f = tf.where(x > 0, a, b)
        g = tf.reduce_max(c, axis=1, keepdims=True) \
            + tf.reduce_min(d, axis=1, keepdims=True)
        h = tf.reduce_prod(tf.clip_by_value(x, 0.5, 1.5), axis=1,
                           keepdims=True)
        i = tf.cast(tf.argmin(x, axis=1), tf.float32)
        j = tf.tile(g + h, [1, 8])
        k = tf.pad(e, [[0, 0], [2, 2]], mode="REFLECT")
        return f + j, k, i

    rng = np.random.default_rng(0)
    w = tf.constant(rng.normal(0, 0.3, (2, 2, 3, 8)).astype(np.float32))

    def breadth_spatial(x):
        a = tf.nn.depth_to_space(x, 2)
        b = tf.nn.space_to_depth(a, 2)
        c = tf.math.l2_normalize(b, axis=-1)
        parts = tf.unstack(c, axis=3)
        dd = tf.nn.conv2d_transpose(c, w, [1, 8, 8, 3], [1, 2, 2, 1])
        return dd, parts[0] + parts[1]

    return {
        "elementwise": _convert_fn(
            tf, breadth_elementwise, [tf.TensorSpec((2, 8), tf.float32)],
            out / FILES["elementwise"]),
        "spatial": _convert_fn(
            tf, breadth_spatial, [tf.TensorSpec((1, 4, 4, 8), tf.float32)],
            out / FILES["spatial"]),
    }


def write_detect(out: Path) -> str:
    """The TFLite_Detection_PostProcess head → its path."""
    import tensorflow as tf

    N, C = DETECT_N, DETECT_C
    gd = tf.compat.v1.GraphDef()

    def node(name, op, inputs=(), **attrs):
        n = gd.node.add()
        n.name = name
        n.op = op
        n.input.extend(inputs)
        for k, v in attrs.items():
            if isinstance(v, bool):
                n.attr[k].b = v
            elif isinstance(v, int):
                n.attr[k].i = v
            elif isinstance(v, float):
                n.attr[k].f = v
            elif isinstance(v, np.ndarray):
                n.attr[k].tensor.CopyFrom(tf.make_tensor_proto(v))
        n.attr.get_or_create("T")
        return n

    pl = node("box_encodings", "Placeholder")
    pl.attr["dtype"].type = tf.float32.as_datatype_enum
    pl.attr["shape"].shape.CopyFrom(tf.TensorShape((1, N, 4)).as_proto())
    pl2 = node("class_predictions", "Placeholder")
    pl2.attr["dtype"].type = tf.float32.as_datatype_enum
    pl2.attr["shape"].shape.CopyFrom(
        tf.TensorShape((1, N, C + 1)).as_proto())
    rng = np.random.default_rng(0)
    anch = np.concatenate([rng.uniform(0.1, 0.9, (N, 2)),
                           rng.uniform(0.1, 0.3, (N, 2))],
                          axis=1).astype(np.float32)
    cn = node("anchors", "Const", value=anch)
    cn.attr["dtype"].type = tf.float32.as_datatype_enum
    node("TFLite_Detection_PostProcess", "TFLite_Detection_PostProcess",
         ["box_encodings", "class_predictions", "anchors"],
         max_detections=10, max_classes_per_detection=1,
         nms_score_threshold=0.3, nms_iou_threshold=0.5, num_classes=C,
         y_scale=10.0, x_scale=10.0, h_scale=5.0, w_scale=5.0,
         use_regular_nms=False, detections_per_class=100)
    pb = out / "detect.pb"
    pb.write_bytes(gd.SerializeToString())
    conv = tf.compat.v1.lite.TFLiteConverter.from_frozen_graph(
        str(pb), ["box_encodings", "class_predictions"],
        ["TFLite_Detection_PostProcess", "TFLite_Detection_PostProcess:1",
         "TFLite_Detection_PostProcess:2",
         "TFLite_Detection_PostProcess:3"],
        input_shapes={"box_encodings": [1, N, 4],
                      "class_predictions": [1, N, C + 1]})
    conv.allow_custom_ops = True
    det = out / FILES["detect"]
    det.write_bytes(conv.convert())
    pb.unlink()
    return str(det)


def write_lstm(out: Path) -> str:
    """The keras LSTM's WHILE graph → its path."""
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)

    tf.keras.utils.set_random_seed(0)
    m = tf.keras.Sequential([
        tf.keras.layers.Input((8, 6), batch_size=1),
        tf.keras.layers.LSTM(5, return_sequences=False),
        tf.keras.layers.Dense(3, activation="softmax"),
    ])
    f = tf.function(lambda x: m(x),
                    input_signature=[tf.TensorSpec((1, 8, 6), tf.float32)])
    frozen = convert_variables_to_constants_v2(f.get_concrete_function())
    c2 = tf.lite.TFLiteConverter.from_concrete_functions([frozen], m)
    lstm = out / FILES["lstm"]
    lstm.write_bytes(c2.convert())
    return str(lstm)


def write_all(out: Path) -> Dict[str, str]:
    out.mkdir(parents=True, exist_ok=True)
    files = write_breadth(out)
    files["detect"] = write_detect(out)
    files["lstm"] = write_lstm(out)
    return files


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default=str(DATA))
    args = ap.parse_args(argv)
    for path in write_all(Path(args.out_dir)).values():
        print(f"{path}: {Path(path).stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
