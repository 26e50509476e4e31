"""Model-file ingestion (the reference's "load model= files" capability,
`tensor_filter_common.c:1208` extension auto-detect +
`tensor_filter_tensorflow_lite.cc` and friends) — the JAX package's
modelio/__init__.py for the formats the port reads so far:

- `.tflite` — TFLite flatbuffer, parsed with a self-contained reader and
  lowered to torch (tflite.py; quantized uint8/int8 models dequantize →
  bf16, or run int8-native with custom=dtype=int8, tflite_quant.py).
- `.npz` — this framework's own serialized params format for zoo models
  (params_io.py), in the JAX package's layout both ways.
- `.pb` — a frozen TF GraphDef (graphdef.py; a DecodeWav entry decodes
  on the host, the bundle's `host_pre`); `inputname=`/`outputname=`
  bind its nodes.
- `.caffemodel` — a Caffe NetParameter snapshot (caffe.py).
- `"init_net.pb,predict_net.pb"` — a caffe2 NetDef pair (caffe2.py).
- `.uff` — an NVIDIA/TensorRT UFF MetaGraph (uff.py; no input shape in
  the file: the filter negotiates it from caps).
- `.dlc` — an SNPE Deep Learning Container (dlc.py).
- `.rtm` — a DeepViewRT model (rtm.py).

`.pt` (TorchScript) is recognised and refused with a `BackendError`
saying it is not ported yet (ROADMAP Queue 1, item 2).
`load_model_file(path, **opts)` dispatches on extension and returns a
`backends.torch_backend.ModelBundle`; `parse_loader_opts` parses the
filter's `custom=` string into those options.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio.params_io import load_params, save_params
from nnstreamer_tpu_torch.modelio.tflite import (
    lower_tflite, parse_tflite, register_tflite_custom_op)
import nnstreamer_tpu_torch.modelio.tflite_custom  # noqa: F401 (registers ops)

#: extensions this package recognises → default backend (.pt is refused
#: naming the roadmap item)
MODEL_EXTENSIONS = {"tflite": "torch", "npz": "torch", "pb": "torch",
                    "pt": "torch", "uff": "torch", "caffemodel": "torch",
                    "dlc": "torch", "rtm": "torch"}
#: formats recognised but not ported yet
_NOT_PORTED = ("pt",)


def model_ext(path: str) -> str:
    """The lower-case extension of a model path ("" without one): what
    picks the loader, and the filter's backend when framework= is empty."""
    return path.rsplit(".", 1)[-1].lower() if "." in path else ""


def _not_ported(what: str) -> BackendError:
    return BackendError(
        f"{what} is not ported to nnstreamer_tpu_torch yet (ROADMAP "
        f"Queue 1 item 2, model-file ingestion: torchscript); the port "
        f"loads .tflite, .npz, .pb, .caffemodel, caffe2 init,predict "
        f"pairs, .uff, .dlc and .rtm")


def load_model_file(path: str, batch: Optional[int] = None,
                    compute_dtype: Optional[str] = None,
                    quantize_output: bool = True,
                    input_names=None, output_names=None,
                    sample_rate: int = 16000, side: Optional[int] = None):
    """Load a model file into a ModelBundle (extension-dispatched)."""
    from nnstreamer_tpu_torch.backends.torch_backend import ModelBundle
    from nnstreamer_tpu_torch.tensor.dtypes import DType
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsSpec

    def mk(shapes, dtypes):
        return TensorsSpec(tensors=tuple(
            TensorInfo(shape=tuple(s), dtype=DType.from_np(d))
            for s, d in zip(shapes, dtypes)))

    if "," in path:
        # "init_net.pb,predict_net.pb" — the reference's caffe2 filter
        # model-pair syntax (tensor_filter_caffe2.cc)
        parts = [p.strip() for p in path.split(",") if p.strip()]
        if len(parts) != 2:
            raise BackendError(
                f"a comma model pair must be exactly "
                f"'init_net.pb,predict_net.pb', got {path!r}")
        for p in parts:
            if not os.path.exists(p):
                raise BackendError(f"model file {p!r} does not exist")
        if compute_dtype is not None:
            raise BackendError(
                "custom=dtype= is not consumed by caffe2 init,predict "
                "pairs (they run in the NetDef's declared dtypes); "
                "supported for .tflite and .pt")
        from nnstreamer_tpu_torch.modelio.caffe2 import lower_caffe2

        lowered = lower_caffe2(parts[0], parts[1],
                               input_names=input_names,
                               output_names=output_names, batch=batch,
                               side=side)
        return ModelBundle(
            fn=lowered.fn, params=lowered.params,
            in_spec=mk(lowered.in_shapes, lowered.in_dtypes),
            out_spec=mk(lowered.out_shapes, lowered.out_dtypes),
            name=lowered.name)

    if not os.path.exists(path):
        raise BackendError(
            f"model file {path!r} does not exist; supported formats: "
            f"{sorted(MODEL_EXTENSIONS)}")
    ext = model_ext(path)

    if ext not in ("pb", "uff") and (input_names or output_names):
        # fail loudly rather than silently ignoring a binding request
        raise BackendError(
            f"inputname/outputname bind graph nodes and apply to "
            f".pb/.uff models only (got a .{ext} file)")
    if side is not None:
        raise BackendError(
            f"custom=side= declares a caffe2 NetDef input resolution "
            f"and applies to init,predict pairs only (got {path!r})")
    if compute_dtype is not None and ext not in ("tflite", "pt"):
        # only the tflite/.pt lowerings consume a compute dtype; the
        # rest run in the graph's own dtypes (.npz archs take dtype via
        # the arch query string instead). An allowlist, so a format can't
        # silently swallow dtype= (the loader's fail-loud convention,
        # like inputname/outputname and side above).
        raise BackendError(
            f"custom=dtype= is not consumed by .{ext} models (they run "
            f"in the graph's declared dtypes; .npz archs take "
            f"?dtype=... in the arch string); supported for .tflite "
            f"and .pt")

    if ext == "tflite":
        # per-format compute default: tflite runs bf16 (tensor-core
        # native, quantized models dequantize into it); int8/native/auto
        # pick the int8-native lowering
        compute_dtype = compute_dtype or "bfloat16"
        graph = parse_tflite(path)
        if compute_dtype in ("int8", "native", "auto"):
            from nnstreamer_tpu_torch.modelio.tflite_quant import (
                lower_tflite_quant, quantized_graph_supported)
            if quantized_graph_supported(graph):
                try:
                    lowered = lower_tflite_quant(graph, batch=batch)
                except BackendError:
                    # support pre-check is necessarily approximate
                    # (e.g. per-channel weight zero points surface only
                    # during lowering); auto falls back to float
                    if compute_dtype != "auto":
                        raise
                    lowered = lower_tflite(graph, batch=batch,
                                           quantize_output=quantize_output)
            elif compute_dtype == "auto":
                lowered = lower_tflite(graph, batch=batch,
                                       quantize_output=quantize_output)
            else:
                raise BackendError(
                    f"{path!r} is not a fully-quantized graph; int8-native "
                    f"execution needs per-tensor uint8/int8 quantization "
                    f"throughout (use dtype=bfloat16)")
        else:
            lowered = lower_tflite(graph, batch=batch,
                                   compute_dtype=compute_dtype,
                                   quantize_output=quantize_output)
        return ModelBundle(
            fn=lowered.fn, params=lowered.params,
            in_spec=mk(lowered.in_shapes, lowered.in_dtypes),
            out_spec=mk(lowered.out_shapes, lowered.out_dtypes),
            name=lowered.name)

    if ext == "npz":
        from nnstreamer_tpu_torch.modelio.params_io import load_model

        return load_model(path)

    if ext == "pb":
        from nnstreamer_tpu_torch.modelio.graphdef import (
            lower_graphdef, parse_graphdef)

        lowered = lower_graphdef(
            parse_graphdef(path), input_names=input_names,
            output_names=output_names, batch=batch,
            sample_rate=sample_rate)
        wav = lowered.host_pre is not None
        return ModelBundle(
            fn=lowered.fn, params=lowered.params,
            # wav-entry graphs take raw file bytes whose length is
            # pipeline-declared (reference: input=1:16022 inputtype=int16)
            in_spec=None if wav else mk(lowered.in_shapes,
                                        lowered.in_dtypes),
            out_spec=mk(lowered.out_shapes, lowered.out_dtypes),
            name=os.path.basename(path), host_pre=lowered.host_pre)

    if ext == "uff":
        from nnstreamer_tpu_torch.modelio.uff import lower_uff, parse_uff

        lowered = lower_uff(parse_uff(path), input_names=input_names,
                            output_names=output_names)
        # UFF carries no input shape (reference: pipeline-declared
        # dims); fn takes any NHWC input, specs negotiate from caps
        return ModelBundle(fn=lowered.fn, params=lowered.params,
                           in_spec=None, out_spec=None,
                           name=os.path.basename(path))

    if ext in ("dlc", "rtm", "caffemodel"):
        if ext == "dlc":
            from nnstreamer_tpu_torch.modelio.dlc import lower_dlc, parse_dlc

            lowered = lower_dlc(parse_dlc(path), batch=batch)
        elif ext == "rtm":
            from nnstreamer_tpu_torch.modelio.rtm import lower_rtm, parse_rtm

            lowered = lower_rtm(parse_rtm(path), batch=batch)
        else:
            from nnstreamer_tpu_torch.modelio.caffe import (
                lower_caffe, parse_caffemodel)

            lowered = lower_caffe(parse_caffemodel(path), batch=batch)
        return ModelBundle(
            fn=lowered.fn, params=lowered.params,
            in_spec=mk(lowered.in_shapes, lowered.in_dtypes),
            out_spec=mk(lowered.out_shapes, lowered.out_dtypes),
            name=os.path.basename(path))

    if ext in _NOT_PORTED:
        raise _not_ported(f"the .{ext} format ({path!r})")

    raise BackendError(
        f"unsupported model file extension {ext!r} for {path!r}; "
        f"supported: {sorted(MODEL_EXTENSIONS)}")


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


__all__ = ["load_model_file", "load_params", "save_params",
           "parse_tflite", "lower_tflite", "parse_loader_opts",
           "register_tflite_custom_op", "MODEL_EXTENSIONS"]
