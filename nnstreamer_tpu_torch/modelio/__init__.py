"""Model-file ingestion. For now only the `custom=` option parser that
every filter backend shares; the file loaders (TFLite, params bundles,
...) come with model-file ingestion."""

from __future__ import annotations

from typing import Any, Dict

from nnstreamer_tpu_torch.core.errors import BackendError


def _int_opt(k: str, v: str) -> int:
    try:
        return int(v)
    except ValueError:
        raise BackendError(
            f"custom option {k}={v!r} is not an integer") from None


def parse_loader_opts(custom: str) -> Dict[str, Any]:
    """Parse the filter's `custom=` option string into loader options
    (the reference's custom property): "batch=8,dtype=float32,
    quantize_output=false". Unknown keys are ignored."""
    opts: Dict[str, Any] = {}
    for part in (custom or "").split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        v = v.strip()
        if k == "batch":
            opts["batch"] = _int_opt(k, v)
        elif k in ("dtype", "compute_dtype"):
            opts["compute_dtype"] = v
        elif k == "quantize_output":
            opts["quantize_output"] = v.lower() in ("1", "true", "yes")
        elif k == "dynamic_spatial":
            # read by the torch backend (spatial bucketing of FLEXIBLE
            # regions), not by the file loaders
            opts["dynamic_spatial"] = v.lower() in ("1", "true", "yes")
        elif k in ("inputname", "input_names"):
            opts["input_names"] = [s for s in v.split(";") if s]
        elif k in ("outputname", "output_names"):
            opts["output_names"] = [s for s in v.split(";") if s]
        elif k == "side":
            # caffe2 NetDef input spatial size (pixels per side)
            opts["side"] = _int_opt(k, v)
        elif k == "sample_rate":
            opts["sample_rate"] = _int_opt(k, v)
    return opts


__all__ = ["parse_loader_opts"]
