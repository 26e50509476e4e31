"""Decoder subplugins. Importing this package registers the built-ins."""

from nnstreamer_tpu_torch.decoders import (  # noqa: F401
    boundingbox,
    direct_video,
    label,
    octet,
    pose,
    segment,
)

__all__ = ["boundingbox", "direct_video", "label", "octet", "pose", "segment"]
