"""tensor_decoder — tensor→media egress via decoder subplugins.

Reference parity: gsttensor_decoder.c dispatching to
`GstTensorDecoderDef` subplugins (include/nnstreamer_plugin_api_decoder.h:39).
`device=true` runs the subplugin's device decode on the tensors where
they are and emits the compact result tensor (e.g. the label index), so
raw model outputs never cross to the host. Next to a tensor_filter it is
folded into the filter by graph/optimize.py.
"""

from __future__ import annotations

from typing import List, Sequence

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.registry import PluginKind, register_element, registry
from nnstreamer_tpu_torch.graph.pipeline import (
    Element, Emission, PropDef, StreamSpec, prop_bool)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec


class DecoderSubplugin:
    """tensor→media decoder API (GstTensorDecoderDef analog)."""

    MODE = ""

    def init(self, props: dict) -> None:
        """Receive the decoder element's option properties."""

    def negotiate(self, in_spec: TensorsSpec) -> StreamSpec:
        """Validate the tensor input and declare the output media spec."""
        raise NotImplementedError

    def decode(self, buf: TensorBuffer) -> TensorBuffer:
        """Host decode of a buffer whose tensors are numpy."""
        raise NotImplementedError

    def device_negotiate(self, in_spec: TensorsSpec) -> TensorsSpec:
        raise PipelineError(
            f"decoder mode={self.MODE} has no device decode path; drop "
            f"device=true to use the host decoder")

    def device_decode(self, tensors):
        """Tuple of tensors → tuple of tensors, on their device."""
        raise NotImplementedError


def register_decoder(mode: str):
    def deco(cls):
        cls.MODE = mode
        registry.register(PluginKind.DECODER, mode, cls)
        return cls
    return deco


@register_element("tensor_decoder")
class TensorDecoder(Element):
    ELEMENT_NAME = "tensor_decoder"
    PROPS = {
        "mode": PropDef(str, None, "decoder subplugin name"),
        "device": PropDef(prop_bool, False, "decode on the device"),
        "option1": PropDef(str, "", "image_labeling: labels file"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        import nnstreamer_tpu_torch.decoders  # noqa: F401 (registers built-ins)

        if not self.props["mode"]:
            raise PipelineError(
                f"tensor_decoder ({self.name}) requires mode=<subplugin>; "
                f"available: {registry.names(PluginKind.DECODER)}")
        self.sub: DecoderSubplugin = registry.get(
            PluginKind.DECODER, self.props["mode"])()
        self.sub.init(dict(self.props))
        # device decode emits tensors whose work may still be queued
        self.DEVICE_RESIDENT = bool(self.props["device"])

    def negotiate(self, in_specs: Sequence[StreamSpec]) -> List[StreamSpec]:
        spec = self.expect_tensors(in_specs[0])
        try:
            if self.props["device"]:
                return [self.sub.device_negotiate(spec)]
            return [self.sub.negotiate(spec)]
        except (ValueError, PipelineError) as e:
            self.fail_negotiation(
                f"decoder mode={self.props['mode']} rejected input {spec}: {e}")

    def process(self, pad: int, buf: TensorBuffer) -> List[Emission]:
        if self.props["device"]:
            return [(0, buf.with_tensors(self.sub.device_decode(buf.tensors)))]
        return [(0, self.sub.decode(buf.to_host()))]
