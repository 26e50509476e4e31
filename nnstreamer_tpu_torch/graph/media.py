"""Media-domain stream specs (the video/x-raw, text/x-raw,
application/octet-stream caps analog).

Only the edges of a pipeline speak media: sources produce media buffers,
`tensor_converter` turns them into tensors, `tensor_decoder` turns tensors
back (gsttensor_converter.c per-media branches).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from fractions import Fraction
from typing import Tuple

from nnstreamer_tpu_torch.tensor.info import MediaType

#: video formats the reference converter accepts (gsttensor_converter.c
#: video branch, :1046) plus RGBA
VIDEO_FORMATS = {"RGB": 3, "BGRx": 4, "RGBA": 4, "GRAY8": 1}


@dataclass(frozen=True)
class MediaSpec:
    """Base for non-tensor stream types; negotiation passes these opaque."""

    rate: Fraction = Fraction(0, 1)

    @property
    def media(self) -> MediaType:
        raise NotImplementedError

    def with_rate(self, rate) -> "MediaSpec":
        return replace(self, rate=Fraction(rate))


@dataclass(frozen=True)
class VideoSpec(MediaSpec):
    width: int = 0
    height: int = 0
    format: str = "RGB"

    def __post_init__(self):
        if self.format not in VIDEO_FORMATS:
            raise ValueError(
                f"unsupported video format {self.format!r}; supported: "
                f"{sorted(VIDEO_FORMATS)}")

    @property
    def media(self) -> MediaType:
        return MediaType.VIDEO

    @property
    def channels(self) -> int:
        return VIDEO_FORMATS[self.format]

    @property
    def frame_shape(self) -> Tuple[int, int, int]:
        """(H, W, C) row-major."""
        return (self.height, self.width, self.channels)


@dataclass(frozen=True)
class TextSpec(MediaSpec):
    @property
    def media(self) -> MediaType:
        return MediaType.TEXT


@dataclass(frozen=True)
class OctetSpec(MediaSpec):
    @property
    def media(self) -> MediaType:
        return MediaType.OCTET
