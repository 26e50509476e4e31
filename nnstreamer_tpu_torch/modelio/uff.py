"""NVIDIA UFF ``.uff`` ingestion — MetaGraph wire reader → torch.

The port of the JAX package's modelio/uff.py. The reference's TensorRT
filter consumes UFF models
(``ext/nnstreamer/tensor_filter/tensor_filter_tensorrt.cc``; golden:
``tests/nnstreamer_filter_tensorrt/runTest.sh:68`` runs ``lenet5.uff``
on MNIST digits with ``1 - x/255`` normalization, inputname=in /
outputname=out). UFF is a protobuf MetaGraph {version, descriptors,
graphs, referenced_data}; the parser (a copy) decodes it with the
dependency-free ``protowire`` reader, and the lowering runs the nodes
the outputs need, in topological order, as plain PyTorch calls.

Wire layout (field numbers of the reference's checked-in model):
  MetaGraph: 1=version 2=descriptor_version 3=descriptors 4=graphs
             5=referenced_data(KeyValuePair)
  Graph:     1=id 2=nodes
  Node:      1=id 2=inputs 3=operation 4=fields(KeyValuePair)
  KeyValuePair: 1=key 2=Data
  Data:      1=string 8=int-list(msg{1=packed varints}) 9=blob
             100=reference-string into referenced_data 101=dtype code
dtype codes: 131104=float32, 65568=int32.

Op set: Input, Const, Conv (NHWC data, HWIO weights, stored once as
OIHW), Pool (max/avg; avg divides by the whole window), FullyConnected
(NC x CK), Binary (add/sub/mul/div/max/min), Unary, Activation
(relu/tanh/sigmoid/elu), Reshape, Flatten, Softmax, Concat, MarkOutput.
Unknown ops raise with the op name at the first run (UFF carries no
input shape, so there is no probe at load).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.core.errors import BackendError
from nnstreamer_tpu_torch.modelio import protowire as pw
from nnstreamer_tpu_torch.modelio.tflite import conv_nhwc

_DTYPES = {131104: np.float32, 65568: np.int32,
           131088: np.float16, 65600: np.int64, 32784: np.int8}


@dataclass
class UffNode:
    id: str
    op: str
    inputs: List[str]
    fields: Dict[str, Any] = field(default_factory=dict)


@dataclass
class UffGraph:
    name: str
    nodes: Dict[str, UffNode]
    order: List[str]
    outputs: List[str]
    blobs: Dict[str, bytes]


def _decode_data(buf: bytes):
    d = pw.fields_dict(buf)
    if 1 in d:
        return d[1][0].decode()
    if 8 in d:                      # int list
        sub = pw.fields_dict(d[8][0]) if d[8][0] else {}
        vals = sub.get(1, [])
        if len(vals) == 1 and isinstance(vals[0], bytes):
            return [pw.to_signed64(v)
                    for v in pw.packed_varints(vals[0])]
        return [pw.to_signed64(int(v)) for v in vals]
    if 100 in d:                    # reference into referenced_data
        key = d[100][0].decode()
        return ("__ref__", key)
    if 101 in d:                    # dtype code
        return ("__dtype__", int(d[101][0]))
    if 9 in d:
        return bytes(d[9][0])
    if 2 in d:
        return pw.to_signed64(int(d[2][0]))
    if 3 in d:
        return struct.unpack("<d", int(d[3][0]).to_bytes(8, "little"))[0]
    if 4 in d:
        return bool(d[4][0])
    return None


def parse_uff(path: str) -> UffGraph:
    with open(path, "rb") as f:
        raw = f.read()
    with pw.wire_context(f"uff {path!r}", BackendError):
        return _parse_uff(raw, path)


def _parse_uff(raw: bytes, path: str) -> UffGraph:
    d = pw.fields_dict(raw)
    if 4 not in d:
        raise BackendError(f"{path!r}: no graphs in UFF MetaGraph")
    blobs: Dict[str, bytes] = {}
    for rb in d.get(5, []):
        rd = pw.fields_dict(rb)
        key = pw.first(rd, 1, b"").decode()
        val = pw.fields_dict(pw.first(rd, 2, b""))
        if 9 in val:
            blobs[key] = bytes(val[9][0])
    g = pw.fields_dict(d[4][0])
    nodes: Dict[str, UffNode] = {}
    order: List[str] = []
    outputs: List[str] = []
    for nb in g.get(2, []):
        nd = pw.fields_dict(nb)
        node = UffNode(
            id=pw.first(nd, 1, b"").decode(),
            op=pw.first(nd, 3, b"").decode(),
            inputs=[x.decode() for x in nd.get(2, [])])
        for fb in nd.get(4, []):
            fd = pw.fields_dict(fb)
            key = pw.first(fd, 1, b"").decode()
            node.fields[key] = _decode_data(pw.first(fd, 2, b""))
        nodes[node.id] = node
        order.append(node.id)
        if node.op == "MarkOutput":
            outputs.extend(node.inputs)
    return UffGraph(name=pw.first(g, 1, b"").decode(), nodes=nodes,
                    order=order, outputs=outputs, blobs=blobs)


def _const_array(node: UffNode, blobs: Dict[str, bytes]) -> np.ndarray:
    dt = np.float32
    for v in node.fields.values():
        if isinstance(v, tuple) and v[0] == "__dtype__":
            if v[1] not in _DTYPES:
                raise BackendError(
                    f"uff: const {node.id} dtype code {v[1]} unknown")
            dt = _DTYPES[v[1]]
    vals = node.fields.get("values")
    if isinstance(vals, tuple) and vals[0] == "__ref__":
        raw = blobs.get(vals[1])
        if raw is None:
            raise BackendError(
                f"uff: const {node.id} references missing data "
                f"{vals[1]!r}")
    elif isinstance(vals, bytes):
        raw = vals
    else:
        raise BackendError(f"uff: const {node.id} has no values")
    arr = np.frombuffer(raw, dt)
    shape = node.fields.get("shape")
    if isinstance(shape, list) and shape:
        arr = arr.reshape([int(s) for s in shape])
    return arr.copy()


@dataclass
class UffLowered:
    fn: Any
    params: Dict[str, Any]
    name: str


_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.true_divide, "max": torch.maximum,
           "min": torch.minimum}
_UNARY = {"neg": torch.neg, "exp": torch.exp, "log": torch.log,
          "abs": torch.abs, "sqrt": torch.sqrt}
_ACTIVATION = {"relu": torch.relu, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid, "elu": F.elu}


def lower_uff(graph: UffGraph, input_names=None, output_names=None):
    """UffGraph → fn(params, x) -> outputs.

    UFF Input nodes carry no shape (the reference declares dims in the
    pipeline: ``input=28:28:1 inputname=in``); the returned fn takes any
    NHWC input and the filter negotiates the concrete shape from
    pipeline caps by running it once. ``inputname``/``outputname`` (the
    reference's node-binding properties) validate the input binding and
    select/reorder output nodes (default: the MarkOutput set)."""
    nodes, blobs = graph.nodes, graph.blobs
    inputs = [n for n in graph.order if nodes[n].op == "Input"]
    if len(inputs) != 1:
        raise BackendError(
            f"uff: expected exactly one Input node, got {inputs}")
    if input_names and list(input_names) != inputs:
        raise BackendError(
            f"uff: inputname={list(input_names)} does not match the "
            f"graph's Input node {inputs}")
    outputs = list(graph.outputs)
    if output_names:
        missing = [o for o in output_names if o not in nodes]
        if missing:
            raise BackendError(
                f"uff: outputname nodes {missing} not in the graph")
        outputs = list(output_names)
    consts = {n: _const_array(nodes[n], blobs)
              for n in graph.order if nodes[n].op == "Const"}
    params: Dict[str, Any] = {}
    for n in graph.order:
        nd = nodes[n]
        for k, i in enumerate(nd.inputs):
            if i not in consts:
                continue
            t = torch.from_numpy(consts[i])
            if nd.op == "Conv" and k == 1:          # HWIO → OIHW
                params[i + "/oihw"] = t.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
            elif not (nd.op == "Reshape" and k == 1):
                params[i] = t

    def fn(p, x):
        # nodes serialize output-first: evaluate what the outputs need,
        # on demand (memoized), from the marked outputs back to the Input
        vals: Dict[str, Any] = {inputs[0]: x.to(torch.float32)}
        for o in outputs:
            if o in vals:
                continue
            stack = [o]
            while stack:
                name = stack[-1]
                if name in vals or name in p:
                    stack.pop()
                    continue
                nd = nodes.get(name)
                if nd is None:
                    raise BackendError(f"uff: unknown node {name!r}")
                todo = [i for i in _data_inputs(nd, consts)
                        if i not in vals and i not in p]
                if todo:
                    stack.extend(todo)
                    continue
                stack.pop()
                vals[name] = _eval_node(nd, vals, p, consts)
        return tuple(vals[o] if o in vals else p[o] for o in outputs)

    return UffLowered(fn=fn, params=params, name=graph.name or "uff")


def _data_inputs(nd: UffNode, consts) -> List[str]:
    """The inputs a node reads as tensors (a Reshape's target shape and
    conv weights are read from the constants)."""
    if nd.op == "Reshape":
        return nd.inputs[:1]
    if nd.op == "Conv" and nd.inputs[1:2] and nd.inputs[1] in consts:
        return nd.inputs[:1]
    return nd.inputs


def _eval_node(nd: UffNode, vals, p, consts):
    n, op = nd.id, nd.op

    def ev(name):
        return vals[name] if name in vals else p[name]

    if op == "Conv":
        strides = [int(s) for s in nd.fields.get("strides") or [1, 1]]
        pads = [int(v) for v in nd.fields.get("padding") or [0, 0]]
        w = p.get(nd.inputs[1] + "/oihw")
        if w is None:                               # a computed weight
            w = ev(nd.inputs[1]).permute(3, 2, 0, 1)
        return conv_nhwc(ev(nd.inputs[0]), w, None, tuple(strides), (1, 1),
                         (pads[0], pads[0], pads[1], pads[1]), 1)
    if op == "Pool":
        xin = ev(nd.inputs[0])
        k = [int(v) for v in nd.fields.get("kernel") or [2, 2]]
        s = [int(v) for v in nd.fields.get("strides") or k]
        pp = [int(v) for v in nd.fields.get("padding") or [0, 0]]
        xc = xin.permute(0, 3, 1, 2)
        flat = (pp[1], pp[1], pp[0], pp[0])
        if nd.fields.get("func", "max") == "max":
            if any(flat):
                xc = F.pad(xc, flat, value=torch.finfo(xin.dtype).min)
            y = F.max_pool2d(xc, tuple(k), tuple(s))
        else:                      # the whole window, padding included
            if any(flat):
                xc = F.pad(xc, flat)
            y = F.avg_pool2d(xc, tuple(k), tuple(s))
        return y.permute(0, 2, 3, 1)
    if op == "FullyConnected":
        return ev(nd.inputs[0]) @ ev(nd.inputs[1])       # NC x CK
    if op in ("Binary", "Unary", "Activation"):
        f = nd.fields.get("func")
        table = {"Binary": _BINARY, "Unary": _UNARY,
                 "Activation": _ACTIVATION}[op]
        if f not in table:
            raise BackendError(f"uff {op} func {f!r}")
        # NHWC channels-last: a rank-1 bias broadcasts as it is
        return table[f](*(ev(i) for i in nd.inputs[:2 if op == "Binary"
                                                    else 1]))
    if op == "Reshape":
        # the target shape is graph STRUCTURE, read from the parse-time
        # constant, never from a tensor
        if nd.inputs[1] not in consts:
            raise BackendError(f"uff Reshape {n}: non-constant shape input")
        shape = [int(v) for v in consts[nd.inputs[1]].reshape(-1)]
        return ev(nd.inputs[0]).reshape(shape)
    if op == "Flatten":
        xin = ev(nd.inputs[0])
        return xin.reshape(xin.shape[0], -1)
    if op == "Softmax":
        return torch.softmax(ev(nd.inputs[0]), dim=-1)
    if op == "Concat":
        axis = nd.fields.get("axis")
        axis = 1 if axis is None else int(
            axis[0] if isinstance(axis, list) else axis)
        return torch.cat([ev(i) for i in nd.inputs], axis)
    raise BackendError(f"uff op {op!r} ({n}) has no torch lowering")
