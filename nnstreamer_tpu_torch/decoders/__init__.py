"""Decoder subplugins. Importing this package registers the built-ins."""

from nnstreamer_tpu_torch.decoders import boundingbox, label, pose  # noqa: F401

__all__ = ["boundingbox", "label", "pose"]
