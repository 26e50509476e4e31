"""pose_estimation decoder — keypoint heatmaps → skeleton overlay video
(the JAX package's decoders/pose.py; the host decode is the same numpy).

Reference parity: ext/nnstreamer/tensor_decoder/tensordec-pose.c (845
LoC): heatmap argmax keypoint decode (+ optional offset refinement),
label/limb metadata, overlay output.

Options:
- option1 = "W:H" output video size (default 640:480)
- option2 = "W:H" model input size (default heatmap grid × stride 16)
- option3 = keypoint label file (optional)
- option4 = score threshold (default 0.3)

Input: (1, h, w, K) heatmaps [+ optional (1, h, w, 2K) offsets — the
zoo://posenet output pair]. Output: RGBA overlay; decoded keypoints in
meta["keypoints"] as (K, 3) [x_px, y_px, score].
"""

from __future__ import annotations

import numpy as np
import torch

from nnstreamer_tpu_torch.decoders.font import blit_text
from nnstreamer_tpu_torch.decoders.util import load_labels, parse_wh
from nnstreamer_tpu_torch.elements.decoder import DecoderSubplugin, register_decoder
from nnstreamer_tpu_torch.graph.media import VideoSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

#: COCO-17 skeleton limb pairs (tensordec-pose.c default connection map)
LIMBS = (
    (5, 6), (5, 7), (7, 9), (6, 8), (8, 10), (5, 11), (6, 12), (11, 12),
    (11, 13), (13, 15), (12, 14), (14, 16), (0, 1), (0, 2), (1, 3), (2, 4),
)

_COLOR = np.array((64, 255, 64, 255), np.uint8)
_JOINT = np.array((255, 64, 64, 255), np.uint8)


@register_decoder("pose_estimation")
class PoseEstimation(DecoderSubplugin):
    def init(self, props: dict) -> None:
        self.out_w, self.out_h = parse_wh(props.get("option1", ""), 640, 480)
        # model input size: the pixel frame offsets are expressed in;
        # 0 = derive from the heatmap grid at output stride 16
        self.in_w, self.in_h = parse_wh(props.get("option2", ""), 0, 0)
        self.labels = load_labels(props.get("option3", ""), "pose_estimation")
        self.score_thresh = float(props.get("option4", "") or 0.3)

    def negotiate(self, in_spec: TensorsSpec) -> VideoSpec:
        if in_spec.num_tensors not in (1, 2):
            raise ValueError(
                f"expects heatmaps [+offsets], got {in_spec.num_tensors} "
                f"tensors")
        hm = in_spec.tensors[0]
        if len(hm.shape) != 4:
            raise ValueError(f"heatmap tensor must be (1, h, w, K); got {hm}")
        self._k = hm.shape[-1]
        if in_spec.num_tensors == 2:
            off = in_spec.tensors[1]
            if off.shape[-1] != 2 * self._k:
                raise ValueError(
                    f"offsets last dim {off.shape[-1]} != 2K={2 * self._k}")
        return VideoSpec(width=self.out_w, height=self.out_h, format="RGBA",
                         rate=in_spec.rate)

    # -- device decode (tensor_decoder device=true) ------------------------
    def device_negotiate(self, in_spec: TensorsSpec) -> TensorsSpec:
        self.negotiate(in_spec)   # validates, sets self._k
        from nnstreamer_tpu_torch.tensor.dtypes import DType
        from nnstreamer_tpu_torch.tensor.info import TensorInfo

        return TensorsSpec.of(
            TensorInfo((self._k, 3), DType.FLOAT32, name="keypoints"),
            rate=in_spec.rate)

    def device_aux(self):
        # the output scale is an argument of the decode, moved to the
        # device once (a CUDA-graph capture refuses a copy per frame)
        return {"scale": torch.tensor([self.out_w, self.out_h, 1.0],
                                      dtype=torch.float32)}

    def device_decode(self, tensors, aux=None):
        from nnstreamer_tpu_torch.decoders.device import pose_decode_device

        kps = pose_decode_device(
            tensors[0], tensors[1] if len(tensors) > 1 else None,
            in_h=self.in_h, in_w=self.in_w)
        # host decoder emits [x_px, y_px, score]; match it
        return (kps * aux["scale"],)

    def _keypoints(self, buf: TensorBuffer) -> np.ndarray:
        hm = np.asarray(buf.tensors[0])[0]          # (h, w, K)
        h, w, k = hm.shape
        offsets = (np.asarray(buf.tensors[1])[0]
                   if buf.num_tensors == 2 else None)
        flat = hm.reshape(-1, k)
        idx = flat.argmax(0)
        ys, xs = np.unravel_index(idx, (h, w))
        score = flat[idx, np.arange(k)]
        # map grid coords (+offset refinement) → [0,1] image space
        fy = (ys + 0.5) / h
        fx = (xs + 0.5) / w
        if offsets is not None:
            # offsets layout: [..., :K] = y-offset, [..., K:] = x-offset,
            # in MODEL-INPUT pixels (PoseNet short-range offsets). The
            # input frame is option2, or grid × stride-16 by default.
            in_h = self.in_h or h * 16
            in_w = self.in_w or w * 16
            oy = offsets[ys, xs, np.arange(k)]
            ox = offsets[ys, xs, k + np.arange(k)]
            fy = fy + oy / in_h
            fx = fx + ox / in_w
        return np.stack([fx * self.out_w, fy * self.out_h, score], axis=1)

    def decode(self, buf: TensorBuffer) -> TensorBuffer:
        kps = self._keypoints(buf)
        img = np.zeros((self.out_h, self.out_w, 4), np.uint8)
        ok = kps[:, 2] >= self.score_thresh
        for a, b in LIMBS:
            if a < len(kps) and b < len(kps) and ok[a] and ok[b]:
                self._line(img, kps[a, :2], kps[b, :2])
        for i, (x, y, s) in enumerate(kps):
            if not ok[i]:
                continue
            xi = int(np.clip(x, 1, self.out_w - 2))
            yi = int(np.clip(y, 1, self.out_h - 2))
            img[yi - 1:yi + 2, xi - 1:xi + 2] = _JOINT
            if self.labels and i < len(self.labels):
                blit_text(img, self.labels[i][:10], xi + 3, yi - 3, _JOINT)
        return buf.with_tensors((img,)).with_meta(keypoints=kps)

    def _line(self, img: np.ndarray, p0, p1) -> None:
        n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
        xs = np.clip(np.linspace(p0[0], p1[0], n + 1), 0,
                     self.out_w - 1).astype(int)
        ys = np.clip(np.linspace(p0[1], p1[1], n + 1), 0,
                     self.out_h - 1).astype(int)
        img[ys, xs] = _COLOR
