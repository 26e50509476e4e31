"""Device-side decode programs: postprocessing that stays on the card.

The JAX package's decoders/device.py in torch, on whatever device the
tensors are on: top-K select, NMS and heatmap refinement as dense tensor
ops, so only the small result (16x6 boxes, 17x3 keypoints, or 100x6
candidate rows) crosses to the host. These are XLA programs in the JAX
package, not kernels; plain torch is their counterpart.

- Top-K ties: ``lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order for ties on CUDA. Random
  weights tie often (bf16 logits, a sigmoid that saturates to 1.0 in
  f32), so `top_k` is a stable descending sort, then a slice.
- `greedy_nms_mask` keeps the exact sequential recurrence: one step per
  candidate, 2 launches each, all queued without a host sync (200
  launches for the 100 candidates of a frame).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nnstreamer_tpu_torch.models.ssd_mobilenet import decode_boxes


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of a 1-D tensor, equal
    values in index order (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(N,4) [ymin,xmin,ymax,xmax] → (N,N) IoU."""
    area = torch.clamp(boxes[:, 2] - boxes[:, 0], min=0.0) * \
        torch.clamp(boxes[:, 3] - boxes[:, 1], min=0.0)
    yx0 = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    yx1 = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = torch.clamp(yx1 - yx0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def greedy_nms_mask(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Exact greedy class-agnostic NMS over score-descending boxes (N,4)
    → keep mask (N,): box i, if still kept, suppresses every later box
    it overlaps above the threshold."""
    n = boxes.shape[0]
    idx = torch.arange(n, device=boxes.device)
    over = ((iou_matrix(boxes) > iou_thresh)
            & (idx[None, :] > idx[:, None])).to(torch.float32)
    keep = torch.ones(n, dtype=torch.float32, device=boxes.device)
    for i in range(n):
        # keep -= keep * over[i] * keep[i]: 0/1 values, exact
        keep.addcmul_(over[i] * keep[i], keep, value=-1.0)
    return keep > 0


def fast_nms_mask(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Fast NMS (YOLACT): keep a box unless any higher-scored box
    overlaps it — one dense op instead of the sequential loop."""
    n = boxes.shape[0]
    idx = torch.arange(n, device=boxes.device)
    higher = idx[None, :] < idx[:, None]          # [i, j]: j scored above i
    return ~torch.any((iou_matrix(boxes) > iou_thresh) & higher, dim=1)


def _best_class(loc, logits, sigmoid: Optional[bool]):
    """→ (boxes-ready loc (A,4) f32, class (A,), score (A,)). `sigmoid`
    None applies it only when the scores look like logits (outside
    [0, 1]), as the host decoder does."""
    loc = loc.reshape(-1, 4).to(torch.float32)
    sc = logits.reshape(loc.shape[0], -1).to(torch.float32)
    if sigmoid is None:
        is_logits = (sc.min() < 0.0) | (sc.max() > 1.0)
        sc = torch.where(is_logits, torch.sigmoid(sc), sc)
    else:
        sc = torch.sigmoid(sc)
    cls = torch.argmax(sc[:, 1:], dim=-1) + 1      # skip background 0
    score = torch.gather(sc, 1, cls[:, None])[:, 0]
    return loc, cls, score


def ssd_decode_device(loc, logits, anchors, *, score_thresh: float = 0.5,
                      iou_thresh: float = 0.5, top_k_out: int = 16,
                      pre_nms: int = 100, nms: str = "greedy") -> torch.Tensor:
    """SSD postprocess: raw loc deltas + class logits → (top_k_out, 6)
    [ymin,xmin,ymax,xmax,score,class], zero rows for missing detections.
    Sigmoid scores, background class 0 skipped, class-agnostic NMS over
    the pre_nms best candidates."""
    loc, cls, score = _best_class(loc, logits, sigmoid=True)
    boxes = decode_boxes(loc, anchors)
    k = min(pre_nms, score.shape[0])
    s_top, i_top = top_k(score, k)
    b_top = boxes[i_top]
    c_top = cls[i_top].to(torch.float32)
    s_top = torch.where(s_top >= score_thresh, s_top, torch.zeros_like(s_top))
    nms_fn = fast_nms_mask if nms == "fast" else greedy_nms_mask
    keep = nms_fn(b_top, iou_thresh)
    s_kept = torch.where(keep, s_top, torch.zeros_like(s_top))
    s_fin, i_fin = top_k(s_kept, min(top_k_out, k))
    det = torch.cat([b_top[i_fin], s_fin[:, None], c_top[i_fin][:, None]],
                    dim=1)
    return torch.where(s_fin[:, None] > 0, det, torch.zeros_like(det))


def pose_decode_device(heatmaps, offsets=None, *, in_h: int = 0,
                       in_w: int = 0) -> torch.Tensor:
    """PoseNet postprocess: heatmaps (1,h,w,K) [+ offsets (1,h,w,2K)] →
    (K, 3) [fx, fy, score] in [0,1] image space (the caller scales)."""
    hm = heatmaps[0].to(torch.float32)             # (h, w, K)
    h, w, k = hm.shape
    flat = hm.reshape(-1, k)
    idx = torch.argmax(flat, dim=0)                # (K,), first maximum
    ys, xs = idx // w, idx % w
    score = torch.gather(flat, 0, idx[None, :])[0]
    fy = (ys.to(torch.float32) + 0.5) / h
    fx = (xs.to(torch.float32) + 0.5) / w
    if offsets is not None:
        off = offsets[0].to(torch.float32)         # (h, w, 2K)
        ih = in_h or h * 16
        iw = in_w or w * 16
        kk = torch.arange(k, device=off.device)
        fy = fy + off[ys, xs, kk] / ih
        fx = fx + off[ys, xs, k + kk] / iw
    return torch.stack([fx, fy, score], dim=1)


def ssd_compact_device(loc, logits, anchors, *, top_k_rows: int = 100
                       ) -> torch.Tensor:
    """Top-K compaction (tensor_decoder device=compact): decoded boxes
    and each anchor's best class and score, only the top_k_rows rows
    (K,6) [ymin,xmin,ymax,xmax,score,class] — no threshold, no NMS; the
    host decoder applies its own to these rows."""
    loc, cls, score = _best_class(loc, logits, sigmoid=None)
    boxes = decode_boxes(loc, anchors)
    s_top, i_top = top_k(score, min(top_k_rows, score.shape[0]))
    return torch.cat([boxes[i_top], s_top[:, None],
                      cls[i_top].to(torch.float32)[:, None]], dim=1)
