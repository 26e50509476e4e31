"""Interop formats. For now only the FlexBuffers reader that the TFLite
loader needs for custom-op options (flexbuf_read); the frame codecs and
gRPC elements come with the rest of interop."""
