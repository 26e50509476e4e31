"""Built-in TFLite custom-op lowerings (the JAX package's
modelio/tflite_custom.py in torch).

`TFLite_Detection_PostProcess` is the op the reference's flagship
query-server demo model ends in
(`gst/nnstreamer/tensor_query/README.md:46-53`; the interpreter resolves
it from its stock custom-op table, `tensor_filter_tensorflow_lite.cc`).
The lowering reproduces the kernel's fast-NMS path
(tensorflow/lite/kernels/detection_postprocess.cc, use_regular_nms=false
— the exported-model default) as dense torch ops on the inputs' device:

inputs  (box_encodings [1,N,4], class_predictions [1,N,C(+1)],
         anchors [N,4: ycenter,xcenter,h,w])
options (flexbuffer map: max_detections, num_classes, y/x/h/w_scale,
         nms_score_threshold, nms_iou_threshold, …)
outputs (boxes [1,D,4: ymin,xmin,ymax,xmax] normalized,
         classes [1,D] float 0-based (background column dropped),
         scores [1,D], num_detections [1] float)

Box decode: center/size deltas scaled by y/x/h/w_scale against the
anchor; selection: per-anchor max class score → score threshold →
descending-score greedy class-agnostic NMS (the device decoder's
`greedy_nms_mask`) → top max_detections, zero-padded. Ties in the top-K
selects keep the lower index first (`decoders.device.top_k`, as
``lax.top_k``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio.tflite import register_tflite_custom_op


@register_tflite_custom_op("TFLite_Detection_PostProcess")
def detection_postprocess(op, inputs, opts):
    from nnstreamer_tpu_torch.decoders.device import greedy_nms_mask, top_k

    if len(inputs) != 3:
        raise BackendError(
            f"TFLite_Detection_PostProcess expects (boxes, scores, "
            f"anchors), got {len(inputs)} inputs")
    boxes_enc, scores_in, anchors = inputs
    num_classes = int(opts.get("num_classes", 1))
    max_det = int(opts.get("max_detections", 10))
    score_thresh = float(opts.get("nms_score_threshold", 0.0))
    iou_thresh = float(opts.get("nms_iou_threshold", 0.5))
    y_scale = float(opts.get("y_scale", 10.0))
    x_scale = float(opts.get("x_scale", 10.0))
    h_scale = float(opts.get("h_scale", 5.0))
    w_scale = float(opts.get("w_scale", 5.0))
    if opts.get("use_regular_nms", False):
        raise BackendError(
            "TFLite_Detection_PostProcess: use_regular_nms=true "
            "(per-class NMS) is not lowered; re-export with the default "
            "fast NMS")

    d = boxes_enc.reshape(-1, 4).to(torch.float32)
    a = anchors.reshape(-1, 4).to(torch.float32)
    n = d.shape[0]
    ycenter = d[:, 0] / y_scale * a[:, 2] + a[:, 0]
    xcenter = d[:, 1] / x_scale * a[:, 3] + a[:, 1]
    half_h = 0.5 * torch.exp(d[:, 2] / h_scale) * a[:, 2]
    half_w = 0.5 * torch.exp(d[:, 3] / w_scale) * a[:, 3]
    boxes = torch.stack([ycenter - half_h, xcenter - half_w,
                         ycenter + half_h, xcenter + half_w], dim=1)

    sc = scores_in.reshape(n, -1).to(torch.float32)
    offset = sc.shape[1] - num_classes        # background column if any
    if offset not in (0, 1):
        raise BackendError(
            f"class_predictions has {sc.shape[1]} columns for "
            f"{num_classes} classes (expected num_classes or +1)")
    sc = sc[:, offset:]
    cls = torch.argmax(sc, dim=-1)
    score = torch.gather(sc, 1, cls[:, None])[:, 0]

    # candidate cap keeps NMS O(K²) with K static; the kernel sorts all
    # candidates, but anything beyond the cap cannot reach the top
    # max_det picks in practice (cap >= 10× max_det)
    k = min(n, max(100, 10 * max_det))
    s_top, i_top = top_k(score, k)
    b_top = boxes[i_top]
    c_top = cls[i_top].to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=s_top.device)
    s_top = torch.where(s_top >= score_thresh, s_top, zero)
    keep = greedy_nms_mask(b_top, iou_thresh)
    s_kept = torch.where(keep & (s_top > 0.0), s_top, zero)
    out_k = min(max_det, k)
    s_fin, i_fin = top_k(s_kept, out_k)
    valid = s_fin > 0.0
    b_fin = torch.where(valid[:, None], b_top[i_fin], zero)
    c_fin = torch.where(valid, c_top[i_fin], zero)
    s_out = torch.where(valid, s_fin, zero)
    pad = max_det - out_k
    if pad:
        b_fin = F.pad(b_fin, (0, 0, 0, pad))
        c_fin = F.pad(c_fin, (0, pad))
        s_out = F.pad(s_out, (0, pad))
    count = valid.to(torch.float32).sum()
    return (b_fin[None], c_fin[None], s_out[None], count[None])
