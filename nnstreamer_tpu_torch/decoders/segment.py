"""image_segment decoder — per-pixel class tensors → color-mapped video
(the JAX package's decoders/segment.py; the host decode is the same
numpy, the device decode torch).

Reference parity: ext/nnstreamer/tensor_decoder/tensordec-imagesegment.c
(660 LoC): tflite-deeplab (float per-class scores, argmax) and snpe
(index map) variants, class→color LUT overlay.

Options:
- option1 = variant: tflite-deeplab | snpe-deeplab | index (raw class map)
- option2 = number of classes for the color LUT (default 21, Pascal VOC)

Output: RGBA video at the segmentation map's own resolution; class index
map rides meta["class_map"]. ``device=true`` (tflite-deeplab only): the
argmax on the device, a uint8 (H, W) class map out.
"""

from __future__ import annotations

import numpy as np
import torch

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.elements.decoder import DecoderSubplugin, register_decoder
from nnstreamer_tpu_torch.graph.media import VideoSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.dtypes import DType
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

VARIANTS = ("tflite-deeplab", "snpe-deeplab", "index")


def _voc_palette(n: int) -> np.ndarray:
    """Pascal-VOC bit-twiddled color map (the canonical deeplab LUT)."""
    pal = np.zeros((n, 4), np.uint8)
    pal[:, 3] = 255
    for i in range(n):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i, :3] = (r, g, b)
    pal[0] = (0, 0, 0, 0)  # background transparent
    return pal


@register_decoder("image_segment")
class ImageSegment(DecoderSubplugin):
    def init(self, props: dict) -> None:
        self.variant = props.get("option1", "") or "tflite-deeplab"
        if self.variant not in VARIANTS:
            raise PipelineError(
                f"image_segment: unknown variant {self.variant!r}; "
                f"supported: {', '.join(VARIANTS)}")
        self.num_classes = int(props.get("option2", "") or 21)
        self._lut = _voc_palette(max(2, self.num_classes))

    def negotiate(self, in_spec: TensorsSpec) -> VideoSpec:
        if in_spec.num_tensors != 1:
            raise ValueError(f"expects one tensor, got {in_spec.num_tensors}")
        t = in_spec.tensors[0]
        shape = t.shape[1:] if len(t.shape) == 4 and t.shape[0] == 1 else t.shape
        if self.variant == "tflite-deeplab":
            if len(shape) != 3:
                raise ValueError(
                    f"tflite-deeplab needs (1, H, W, C) scores; got {t}")
            h, w, c = shape
            if c < 2:
                raise ValueError(f"need ≥2 classes, got {c}")
            self.num_classes = max(self.num_classes, c)
            self._lut = _voc_palette(self.num_classes)
        else:
            if len(shape) == 3 and shape[-1] == 1:
                shape = shape[:2]
            if len(shape) != 2:
                raise ValueError(
                    f"{self.variant} needs an (H, W) class-index map; got {t}")
            h, w = shape
        return VideoSpec(width=w, height=h, format="RGBA", rate=in_spec.rate)

    def decode(self, buf: TensorBuffer) -> TensorBuffer:
        t = np.asarray(buf.tensors[0])
        if t.ndim == 4 and t.shape[0] == 1:
            t = t[0]
        if self.variant == "tflite-deeplab":
            class_map = t.argmax(-1).astype(np.int32)
        else:
            if t.ndim == 3 and t.shape[-1] == 1:
                t = t[..., 0]
            class_map = t.astype(np.int32)
        clipped = np.clip(class_map, 0, len(self._lut) - 1)
        img = self._lut[clipped]
        return buf.with_tensors((img,)).with_meta(class_map=class_map)

    # -- device decode (tensor_decoder device=true) ------------------------
    def device_negotiate(self, in_spec: TensorsSpec) -> TensorsSpec:
        if self.variant != "tflite-deeplab":
            raise PipelineError(
                f"image_segment device decode supports tflite-deeplab "
                f"(scores→argmax); {self.variant!r} is already an index "
                f"map, decode it on host")
        self.negotiate(in_spec)
        t = in_spec.tensors[0]
        if t.shape[-1] > 256:
            raise PipelineError(
                f"device decode emits a uint8 class map but the model has "
                f"{t.shape[-1]} classes; use the host decoder (int32 map)")
        h, w = (t.shape[1:3] if len(t.shape) == 4 else t.shape[:2])
        return TensorsSpec.of(
            TensorInfo((h, w), DType.UINT8, name="class_map"),
            rate=in_spec.rate)

    def device_decode(self, tensors, aux=None):
        t = tensors[0]
        if t.dim() == 4:
            t = t[0]
        # class count ≤ 256 (checked at negotiation); a uint8 map is 4×
        # less D2H than the int32 host map, and the overlay LUT stays on
        # the host. torch.argmax returns the first maximal index, as
        # np.argmax does
        return (torch.argmax(t, dim=-1).to(torch.uint8),)
