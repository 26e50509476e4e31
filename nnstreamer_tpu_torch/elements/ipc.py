"""ipc_sink / ipc_src — local IPC over the native shm ring, the JAX
package's elements/ipc.py on the port.

These elements move wire frames through /dev/shm (native/nt_shmring.cc)
with one memcpy per side and no socket stack — the transport between a
camera/ingest process and an inference process on the same host, where
the reference crosses process boundaries over TCP/MQTT serialization.

The payload is the standard wire frame (edge/wire.py, the JAX package's
bytes), so caps travel with every frame; ipc_src negotiates its spec
from dims/types props or from the first frame when `dims` is omitted
(blocking briefly). ipc_sink brings a frame of CUDA tensors to the host
in one counted sync, traced under the element. The native library is
built at first use (nnstreamer_tpu_torch/native).
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.log import get_logger
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.edge.wire import decode_buffer, encode_buffer
from nnstreamer_tpu_torch.graph.pipeline import (
    PropDef, SinkElement, SourceElement, StreamSpec)
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorsSpec

log = get_logger("elements.ipc")


@register_element("ipc_sink")
class IpcSink(SinkElement):
    WANTS_HOST = True
    ELEMENT_NAME = "ipc_sink"
    PROPS = {
        "ring": PropDef(str, None, "shm ring name, e.g. /nns-cam0"),
        "capacity": PropDef(int, 1 << 22, "ring bytes (default 4 MiB)"),
        "timeout_ms": PropDef(int, 10_000, "blocking-write bound"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["ring"]:
            raise PipelineError(f"ipc_sink {self.name}: ring= is required")
        self._ring = None

    def start(self) -> None:
        from nnstreamer_tpu_torch.native import ShmRing

        self._ring = ShmRing(self.props["ring"], create=True,
                             capacity=self.props["capacity"])

    def render(self, buf: TensorBuffer) -> None:
        self._ring.write(encode_buffer(buf, tracer=self._tracer,
                                       name=self.name),
                         self.props["timeout_ms"])

    def flush(self):
        if self._ring is not None:
            self._ring.close_write()
        return []

    def stop(self) -> None:
        if self._ring is not None:
            self._ring.close_write()
            self._ring.close()
            self._ring = None


@register_element("ipc_src")
class IpcSrc(SourceElement):
    ELEMENT_NAME = "ipc_src"
    PROPS = {
        "ring": PropDef(str, None, "shm ring name to open"),
        "dims": PropDef(str, "", "expected dims (else sniffed from frame 1)"),
        "types": PropDef(str, "float32"),
        "sniff_timeout": PropDef(float, 10.0, "first-frame wait, s"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["ring"]:
            raise PipelineError(f"ipc_src {self.name}: ring= is required")
        self._ring = None
        self._stop = threading.Event()
        self._sniffed: Optional[TensorBuffer] = None

    def _open(self):
        from nnstreamer_tpu_torch.native import ShmRing

        if self._ring is None:
            self._ring = ShmRing(self.props["ring"], create=False)
        return self._ring

    def output_spec(self) -> StreamSpec:
        if self.props["dims"]:
            return TensorsSpec.from_strings(self.props["dims"],
                                            self.props["types"])
        # sniff: block for the first frame, reuse it in generate()
        ring = self._open()
        deadline = self.props["sniff_timeout"]
        waited = 0.0
        while waited < deadline:
            try:
                frame = ring.read(timeout_ms=100)
            except EOFError:
                raise PipelineError(
                    f"ipc_src {self.name}: ring closed before the first "
                    f"frame; declare dims= to negotiate without sniffing"
                ) from None
            if frame is not None:
                self._sniffed, _ = decode_buffer(frame)
                return self._sniffed.spec()
            waited += 0.1
        raise PipelineError(
            f"ipc_src {self.name}: no frame arrived within {deadline}s to "
            f"sniff the stream type; declare dims=/types= instead")

    def interrupt(self) -> None:
        self._stop.set()

    def generate(self) -> Iterator[TensorBuffer]:
        ring = self._open()
        if self._sniffed is not None:
            yield self._sniffed
            self._sniffed = None
        while not self._stop.is_set():
            try:
                frame = ring.read(timeout_ms=100)
            except EOFError:
                return
            if frame is None:
                continue
            buf, _ = decode_buffer(frame)
            yield buf

    def stop(self) -> None:
        self._stop.set()
        if self._ring is not None:
            self._ring.close()
            self._ring = None
