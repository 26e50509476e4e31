"""image_labeling decoder — argmax over class scores → text label.

Reference parity: ext/nnstreamer/tensor_decoder/tensordec-imagelabel.c:
option1 = labels file (one label per line), output text/x-raw. Output
buffer: meta["label"], meta["label_index"], meta["score"], payload = utf-8
bytes of the label. The element hands `decode` host numpy (its tensors
come back through `TensorBuffer.to_host`).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from nnstreamer_tpu_torch.decoders.util import load_labels
from nnstreamer_tpu_torch.elements.decoder import DecoderSubplugin, register_decoder
from nnstreamer_tpu_torch.graph.media import TextSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec


@register_decoder("image_labeling")
class ImageLabeling(DecoderSubplugin):
    def __init__(self):
        self.labels: List[str] = []

    def init(self, props: dict) -> None:
        self.labels = load_labels(props.get("option1", ""), "image_labeling")

    def negotiate(self, in_spec: TensorsSpec) -> TextSpec:
        if in_spec.num_tensors != 1:
            raise ValueError(
                f"expects exactly one scores tensor, got {in_spec.num_tensors}")
        n_classes = in_spec.tensors[0].num_elements
        if self.labels and len(self.labels) not in (n_classes, n_classes - 1):
            raise ValueError(
                f"labels file has {len(self.labels)} entries but the scores "
                f"tensor has {n_classes} classes")
        return TextSpec(rate=in_spec.rate)

    # -- device decode (tensor_decoder device=true) ------------------------
    def device_negotiate(self, in_spec: TensorsSpec) -> TensorsSpec:
        self.negotiate(in_spec)
        return TensorsSpec.of(TensorInfo((1,), DType.INT32, name="class_index"),
                              rate=in_spec.rate)

    def device_decode(self, tensors, aux=None):
        # torch.argmax returns the first maximal index, as np.argmax does
        idx = torch.argmax(tensors[0].reshape(-1)).to(torch.int32)
        return (idx.reshape(1),)

    def decode(self, buf: TensorBuffer) -> TensorBuffer:
        scores = np.asarray(buf.tensors[0]).reshape(-1)
        idx = int(scores.argmax())
        # background-class offset when labels == classes-1 (class 0 =
        # background, as in the reference's imagenet test models)
        label_idx = idx
        if self.labels and len(self.labels) == scores.size - 1:
            label_idx = idx - 1
        label = (self.labels[label_idx]
                 if self.labels and 0 <= label_idx < len(self.labels)
                 else str(idx))
        payload = np.frombuffer(label.encode("utf-8"), np.uint8).copy()
        return buf.with_tensors((payload,)).with_meta(
            label=label, label_index=idx, score=float(scores[idx]))
