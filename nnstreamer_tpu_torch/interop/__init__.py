"""Interop serialization + RPC: published formats external processes
speak (the JAX package's interop/ on the port).

The private wire codec (edge/wire.py) is for port↔port and port↔JAX
links; this package covers the reference's schema'd interop surface
(the flatbuf/flexbuf/protobuf codec pairs and gRPC):

- gst_meta       — GstTensorMetaInfo v1 header for flexible payloads
- tensors_proto  — the nnstreamer.protobuf schema with its own wire
                   encoder and decoder (JAX: tensors_pb2.py, protoc
                   output over google.protobuf)
- protobuf_codec — nnstreamer.protobuf.Tensors frames
- flatbuf_codec  — nnstreamer.fbs flatbuffers frames (flatbuf_build
                   writes, modelio/flatbuf.py reads)
- flexbuf_codec  — schema-less flexbuffers map frames (flexbuf_write
                   writes, flexbuf_read reads)
- grpc_elements  — tensor_src_grpc / tensor_sink_grpc over real gRPC
                   (grpcio imported at first use)

None imports `flatbuffers` or `google.protobuf`. Importing the codec
modules registers decoder modes "protobuf"/"flexbuf"/"flatbuf" and
converter subplugins of the same names; elements/__init__ imports them
all.
"""
