"""bounding_boxes decoder — detection tensors → RGBA overlay video (the
JAX package's decoders/boundingbox.py; the host decode is the same numpy,
so equal inputs give identical images and metadata).

Reference parity: ext/nnstreamer/tensor_decoder/tensordec-boundingbox.c
(1771 LoC): box schemes mobilenet-ssd (+priors), mobilenet-ssd-postprocess,
yolov5, ov-person-detection, mp-palm-detection (:143-158,177-184), NMS w/
IoU threshold (:125-127), label file, RGBA overlay with label text.

Options (reference property mapping):
- option1 = scheme (mode name above)
- option2 = labels file path (one per line)
- option3 = scheme config (mobilenet-ssd: "<score_thresh>:<iou_thresh>";
  priors come from models/ssd_mobilenet.generate_anchors — no sidecar
  box-priors file)
- option4 = "W:H" output video size
- option5 = "W:H" model input size (box coordinate reference frame)
- option6 = device NMS: greedy (default, exact host parity) | fast
- option7 = device=compact candidate rows K (default 100)

Output: RGBA video (boxes + labels on transparent background — the
reference draws on transparent RGBA for downstream compositing). Decoded
detections also ride `meta["boxes"]` as (N, 6) [ymin,xmin,ymax,xmax,
score,class] in output-pixel coordinates, so tests and downstream logic
need no pixel parsing.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.decoders.font import blit_text
from nnstreamer_tpu_torch.decoders.util import load_labels, parse_wh
from nnstreamer_tpu_torch.elements.decoder import DecoderSubplugin, register_decoder
from nnstreamer_tpu_torch.graph.media import VideoSpec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

SCHEMES = ("mobilenet-ssd", "mobilenet-ssd-postprocess", "yolov5",
           "ov-person-detection", "mp-palm-detection")

#: deterministic per-class overlay colors (RGBA)
_PALETTE = np.array([
    (255, 64, 64, 255), (64, 255, 64, 255), (64, 64, 255, 255),
    (255, 255, 64, 255), (255, 64, 255, 255), (64, 255, 255, 255),
    (255, 160, 0, 255), (160, 0, 255, 255),
], np.uint8)


def iou_matrix(boxes: np.ndarray) -> np.ndarray:
    """(N,4) [ymin,xmin,ymax,xmax] → (N,N) IoU."""
    area = np.maximum(0, boxes[:, 2] - boxes[:, 0]) * \
        np.maximum(0, boxes[:, 3] - boxes[:, 1])
    yx0 = np.maximum(boxes[:, None, :2], boxes[None, :, :2])
    yx1 = np.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = np.maximum(0.0, yx1 - yx0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, None] + area[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_thresh: float, max_out: int = 100) -> np.ndarray:
    """Greedy per-call NMS → kept indices (descending score)."""
    order = np.argsort(-scores)
    keep: List[int] = []
    if order.size == 0:
        return np.array([], np.int64)
    ious = iou_matrix(boxes)
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        if len(keep) >= max_out:
            break
        suppressed |= ious[i] > iou_thresh
    return np.array(keep, np.int64)


@register_decoder("bounding_boxes")
class BoundingBoxes(DecoderSubplugin):
    def init(self, props: dict) -> None:
        self.scheme = props.get("option1", "") or "mobilenet-ssd"
        if self.scheme not in SCHEMES:
            raise PipelineError(
                f"bounding_boxes: unknown scheme {self.scheme!r}; "
                f"supported: {', '.join(SCHEMES)}"
            )
        self.labels = load_labels(props.get("option2", ""), "bounding_boxes")
        cfg = props.get("option3", "")
        parts = [x for x in cfg.split(":") if x]
        self.score_thresh = float(parts[0]) if parts else 0.5
        self.iou_thresh = float(parts[1]) if len(parts) > 1 else 0.5
        self.out_w, self.out_h = parse_wh(props.get("option4", ""), 640, 480)
        self.in_w, self.in_h = parse_wh(props.get("option5", ""), 300, 300)
        # option6 = device NMS formulation: greedy (exact host parity,
        # default) | fast (YOLACT matrix form for huge candidate counts)
        self._nms_mode = props.get("option6", "") or "greedy"
        if self._nms_mode not in ("greedy", "fast"):
            raise PipelineError(
                f"bounding_boxes option6 (device NMS) must be greedy|fast, "
                f"got {self._nms_mode!r}")
        # option7 = device=compact candidate count (top-K rows shipped)
        self._compact_k = int(props.get("option7", "") or 100)
        if self._compact_k < 1:
            raise PipelineError(
                f"bounding_boxes option7 (compact top-K) must be >= 1, "
                f"got {self._compact_k}")
        self._anchors: Optional[np.ndarray] = None

    def negotiate(self, in_spec: TensorsSpec) -> VideoSpec:
        if self.scheme in ("mobilenet-ssd",):
            if in_spec.num_tensors != 2:
                raise ValueError(
                    f"scheme mobilenet-ssd expects (loc, scores) tensors, "
                    f"got {in_spec.num_tensors}")
            from nnstreamer_tpu_torch.models.ssd_mobilenet import generate_anchors

            self._anchors = generate_anchors()
            loc = in_spec.tensors[0]
            n_anchors = self._anchors.shape[0]
            if loc.num_elements % 4 or loc.num_elements // 4 != n_anchors:
                raise ValueError(
                    f"loc tensor {loc} does not hold {n_anchors} anchors ×4")
        elif self.scheme == "mobilenet-ssd-postprocess":
            # model already emits [boxes (N,4 normalized), classes, scores,
            # count] (tflite postprocess op layout)
            if in_spec.num_tensors not in (2, 4):
                raise ValueError(
                    "postprocess scheme expects (boxes, scores) or the "
                    "4-tensor tflite postprocess layout")
        elif self.scheme == "yolov5":
            if in_spec.num_tensors != 1:
                raise ValueError(
                    "yolov5 scheme expects one (1, N, 5+C) prediction tensor")
        elif self.scheme in ("ov-person-detection", "mp-palm-detection"):
            if in_spec.num_tensors != 1:
                raise ValueError(f"{self.scheme} expects one tensor")
        return VideoSpec(width=self.out_w, height=self.out_h, format="RGBA",
                         rate=in_spec.rate)

    # -- device decode (tensor_decoder device=true) ------------------------
    def device_negotiate(self, in_spec: TensorsSpec) -> TensorsSpec:
        if self.scheme != "mobilenet-ssd":
            raise PipelineError(
                f"bounding_boxes device decode supports scheme "
                f"mobilenet-ssd (raw loc+logits postprocess); "
                f"{self.scheme!r} decodes on host")
        self.negotiate(in_spec)   # validates tensors, builds anchors
        from nnstreamer_tpu_torch.tensor.dtypes import DType
        from nnstreamer_tpu_torch.tensor.info import TensorInfo

        self._top_k = 16
        return TensorsSpec.of(
            TensorInfo((self._top_k, 6), DType.FLOAT32, name="boxes"),
            rate=in_spec.rate)

    def device_aux(self):
        # the anchors and the output scale are arguments of the decode,
        # moved to the device once, never constants copied per frame (a
        # CUDA-graph capture of the decode refuses that copy)
        return {"anchors": torch.from_numpy(
            np.asarray(self._anchors, np.float32)),
            "scale": torch.tensor([self.out_h, self.out_w, self.out_h,
                                   self.out_w, 1.0, 1.0],
                                  dtype=torch.float32)}

    def _device_anchors(self, aux, device) -> torch.Tensor:
        anchors = (aux or {}).get("anchors")
        if anchors is None:
            anchors = self.device_aux()["anchors"]
        return anchors.to(device)

    def device_decode(self, tensors, aux=None):
        from nnstreamer_tpu_torch.decoders.device import ssd_decode_device

        loc, logits = tensors[0], tensors[1]
        det = ssd_decode_device(
            loc, logits, self._device_anchors(aux, loc.device),
            score_thresh=self.score_thresh, iou_thresh=self.iou_thresh,
            top_k_out=self._top_k, nms=self._nms_mode)
        # host decoder emits output-pixel coordinates; match it
        return (det * aux["scale"],)

    # -- device compaction (tensor_decoder device=compact) ------------------
    def device_compact_check(self) -> None:
        if self.scheme != "mobilenet-ssd":
            raise PipelineError(
                f"bounding_boxes device=compact supports scheme "
                f"mobilenet-ssd; {self.scheme!r} decodes on host")

    def device_compact(self, tensors, aux=None):
        """Raw (loc, logits) → (K,6) candidate rows on the device; the
        host decode() keeps its exact threshold/NMS/overlay semantics.
        K=100 (option7 overrides)."""
        from nnstreamer_tpu_torch.decoders.device import ssd_compact_device

        self.device_compact_check()
        loc = tensors[0]
        return (ssd_compact_device(loc, tensors[1],
                                   self._device_anchors(aux, loc.device),
                                   top_k_rows=self._compact_k),)

    # -- per-scheme box extraction → (N, 6) [ymin,xmin,ymax,xmax,score,cls]
    def _extract(self, buf: TensorBuffer) -> np.ndarray:
        if getattr(self, "consume_compact", False):
            det = np.asarray(buf.tensors[0], np.float32)
            if det.ndim != 2 or det.shape[1] != 6:
                raise PipelineError(
                    f"compact bounding-box tensor must be (K,6), got "
                    f"{det.shape}")
            # Truncation signal: the compact tensor ships only the top-K
            # candidates (no threshold applied on device).  If even the
            # weakest shipped row clears the score threshold, rows that
            # would also have cleared it may have been cut — host parity
            # silently breaks.  Warn once per decoder; raise option7.
            if (len(det) and det[-1, 4] >= self.score_thresh
                    and not getattr(self, "_compact_trunc_warned", False)):
                self._compact_trunc_warned = True
                get_logger("decoder.bounding_boxes").warning(
                    "device=compact top-K (option7=%d) may be truncating: "
                    "last compact row score %.3f >= threshold %.3f; "
                    "detections above threshold may be missing — raise "
                    "option7", len(det), float(det[-1, 4]),
                    self.score_thresh)
            return det
        s = self.scheme
        if s == "mobilenet-ssd":
            from nnstreamer_tpu_torch.models.ssd_mobilenet import decode_boxes

            loc = np.asarray(buf.tensors[0]).reshape(-1, 4)
            logits = np.asarray(buf.tensors[1])
            scores2d = logits.reshape(loc.shape[0], -1)
            if scores2d.min() < 0 or scores2d.max() > 1:
                scores2d = 1.0 / (1.0 + np.exp(-scores2d))  # logits → prob
            boxes = decode_boxes(loc, self._anchors)
            cls = scores2d[:, 1:].argmax(-1) + 1  # skip background 0
            score = scores2d[np.arange(len(cls)), cls]
            return np.concatenate(
                [boxes, score[:, None], cls[:, None].astype(np.float32)],
                axis=1)
        if s == "mobilenet-ssd-postprocess":
            if buf.num_tensors == 4:
                boxes = np.asarray(buf.tensors[0]).reshape(-1, 4)
                cls = np.asarray(buf.tensors[1]).reshape(-1)
                score = np.asarray(buf.tensors[2]).reshape(-1)
                n = int(np.asarray(buf.tensors[3]).reshape(-1)[0])
                boxes, cls, score = boxes[:n], cls[:n], score[:n]
            else:
                boxes = np.asarray(buf.tensors[0]).reshape(-1, 4)
                sc = np.asarray(buf.tensors[1]).reshape(len(boxes), -1)
                cls = sc.argmax(-1)
                score = sc[np.arange(len(cls)), cls]
            return np.concatenate(
                [boxes, score[:, None], cls[:, None].astype(np.float32)],
                axis=1)
        if s == "yolov5":
            p = np.asarray(buf.tensors[0]).reshape(-1,
                                                   buf.tensors[0].shape[-1])
            if len(p) == 0:  # empty frame: no detections, not an error
                return np.zeros((0, 6), np.float32)
            # [cx, cy, w, h, obj, class...] in input pixels or normalized
            xywh, obj, clsp = p[:, :4], p[:, 4], p[:, 5:]
            if xywh.max() > 2.0:  # pixel coords → normalize
                xywh = xywh / np.array(
                    [self.in_w, self.in_h, self.in_w, self.in_h], np.float32)
            cls = clsp.argmax(-1) if clsp.size else np.zeros(len(p))
            clsq = clsp[np.arange(len(p)), cls] if clsp.size else 1.0
            score = obj * clsq
            boxes = np.stack([
                xywh[:, 1] - xywh[:, 3] / 2, xywh[:, 0] - xywh[:, 2] / 2,
                xywh[:, 1] + xywh[:, 3] / 2, xywh[:, 0] + xywh[:, 2] / 2,
            ], axis=1)
            return np.concatenate(
                [boxes, np.asarray(score)[:, None],
                 np.asarray(cls)[:, None].astype(np.float32)], axis=1)
        if s == "ov-person-detection":
            # (N, 7) [image_id, label, conf, xmin, ymin, xmax, ymax]
            p = np.asarray(buf.tensors[0]).reshape(-1, 7)
            boxes = p[:, [4, 3, 6, 5]]
            return np.concatenate([boxes, p[:, 2:3], p[:, 1:2]], axis=1)
        # mp-palm-detection: (N, 18) [cx, cy, w, h, 7×kp(x,y)] w/ scores…
        p = np.asarray(buf.tensors[0]).reshape(-1, buf.tensors[0].shape[-1])
        if len(p) == 0:
            return np.zeros((0, 6), np.float32)
        cx, cy, w, h = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
        score = p[:, 4] if p.shape[1] > 4 else np.ones(len(p), np.float32)
        if np.abs(cx).max() > 2.0:
            cx, cy = cx / self.in_w, cy / self.in_h
            w, h = w / self.in_w, h / self.in_h
        boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], 1)
        return np.concatenate(
            [boxes, score[:, None], np.zeros((len(p), 1), np.float32)], axis=1)

    def decode(self, buf: TensorBuffer) -> TensorBuffer:
        det = self._extract(buf)
        det = det[det[:, 4] >= self.score_thresh]
        if len(det):
            keep = nms(det[:, :4], det[:, 4], self.iou_thresh)
            det = det[keep]
        img = np.zeros((self.out_h, self.out_w, 4), np.uint8)
        out_px = det.copy()
        for row in det:
            y0, x0, y1, x1, score, cls = row
            color = _PALETTE[int(cls) % len(_PALETTE)]
            px0 = int(np.clip(x0 * self.out_w, 0, self.out_w - 1))
            px1 = int(np.clip(x1 * self.out_w, 0, self.out_w - 1))
            py0 = int(np.clip(y0 * self.out_h, 0, self.out_h - 1))
            py1 = int(np.clip(y1 * self.out_h, 0, self.out_h - 1))
            img[py0:py1 + 1, px0] = color
            img[py0:py1 + 1, px1] = color
            img[py0, px0:px1 + 1] = color
            img[py1, px0:px1 + 1] = color
            label = (self.labels[int(cls)]
                     if 0 <= int(cls) < len(self.labels) else str(int(cls)))
            blit_text(img, label[:16], px0 + 2, py0 + 2, color)
        if len(out_px):
            out_px[:, [0, 2]] *= self.out_h
            out_px[:, [1, 3]] *= self.out_w
        return buf.with_tensors((img,)).with_meta(boxes=out_px)
