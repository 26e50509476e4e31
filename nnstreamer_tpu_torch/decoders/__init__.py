"""Decoder subplugins. Importing this package registers the built-ins."""

from nnstreamer_tpu_torch.decoders import label  # noqa: F401

__all__ = ["label"]
