"""Weights carried across from the JAX package.

`jax.random` init cannot be reproduced in torch, so parity runs load the
JAX package's own parameters. The input is its MobileNetV2 param tree
with numpy leaves (``{"stem": {"conv": {"w"}, "bn": {scale, bias, mean,
var}}, "blocks": [{"expand"?, "depthwise", "project"}], "head": …,
"classifier": {"w", "b"}}``); the output is the state dict of the port's
`MobileNetV2`:

- conv weights HWIO → OIHW (depthwise (3, 3, 1, C) → (C, 1, 3, 3));
- dense (cin, cout) → (cout, cin);
- the four BN vectors as they are.

SSD-MobileNetV2 and PoseNet trees carry a MobileNetV2 tree under
"backbone" plus their own conv+BN units and bias-free head convs, mapped
the same way.

`transformer_params` carries the JAX transformer's params over as they
are: the port's transformer keeps the (in, out) dense layout, and a W8A8
tree (models/quant.quantize_transformer) keeps its int8 weights and f32
``*_scale`` columns. `lstm_params` copies the LSTM's the same way;
`audio_classifier_params` turns its conv weights WIO → (Cout, Cin, K).

The parallel paths: `moe_params` carries the JAX MoE layer's params
(plain arrays, the same layout: gate (d, E), w1 (E, d, h), w2 (E, h, d)),
`tensor_tree` any tree of arrays as it is (stacked stage params of the
pipeline, the leading stage dim kept), and `train_state_params` a JAX
`TrainState`'s params, so a sharded step starts from JAX's.

The vision and transformer bridges each have an inverse
(`mobilenet_v2_tree`, `ssd_mobilenet_tree`, `posenet_tree`,
`transformer_tree`: the port's module or params → the
JAX-layout tree with numpy leaves), so `.npz` params files
(modelio/params_io.py) move both ways between the two packages.
`JAX_TREE` and `PORT_LOADER` name them by zoo model.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def conv_bn_state(p: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """One conv+BN unit: {"conv": {"w": HWIO}, "bn": {...}} → ConvBN keys."""
    bn = p["bn"]
    return {
        f"{prefix}weight": _t(p["conv"]["w"]).permute(3, 2, 0, 1).contiguous(),
        f"{prefix}scale": _t(bn["scale"]),
        f"{prefix}bias": _t(bn["bias"]),
        f"{prefix}mean": _t(bn["mean"]),
        f"{prefix}var": _t(bn["var"]),
    }


def mobilenet_v2_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MobileNetV2 param tree (numpy leaves) → port state dict."""
    sd = conv_bn_state(params["stem"], "stem.")
    for i, blk in enumerate(params["blocks"]):
        for part in ("expand", "depthwise", "project"):
            if part in blk:
                sd.update(conv_bn_state(blk[part], f"blocks.{i}.{part}."))
    sd.update(conv_bn_state(params["head"], "head."))
    sd["classifier.weight"] = _t(params["classifier"]["w"]).t().contiguous()
    sd["classifier.bias"] = _t(params["classifier"]["b"])
    return sd


def load_mobilenet_v2(model: torch.nn.Module, params: Dict[str, Any]) -> torch.nn.Module:
    """Load the JAX param tree into the port's MobileNetV2 (strict: every
    key must match both ways)."""
    model.load_state_dict(mobilenet_v2_state_dict(params), strict=True)
    return model


def _conv(p: Dict[str, Any]) -> torch.Tensor:
    """A bias-free conv {"w": HWIO} → OIHW."""
    return _t(p["w"]).permute(3, 2, 0, 1).contiguous()


def _prefixed(sd: Dict[str, torch.Tensor], prefix: str):
    return {prefix + k: v for k, v in sd.items()}


def ssd_mobilenet_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SSD-MobileNetV2 tree ({"backbone", "extras": [{"squeeze",
    "conv"}], "loc_heads": [{"w"}], "cls_heads": [{"w"}]}) → port state
    dict."""
    sd = _prefixed(mobilenet_v2_state_dict(params["backbone"]), "backbone.")
    for i, ex in enumerate(params["extras"]):
        sd.update(conv_bn_state(ex["squeeze"], f"extras.{i}.squeeze."))
        sd.update(conv_bn_state(ex["conv"], f"extras.{i}.conv."))
    for kind in ("loc_heads", "cls_heads"):
        for i, p in enumerate(params[kind]):
            sd[f"{kind}.{i}.weight"] = _conv(p)
    return sd


def load_ssd_mobilenet(model: torch.nn.Module,
                       params: Dict[str, Any]) -> torch.nn.Module:
    model.load_state_dict(ssd_mobilenet_state_dict(params), strict=True)
    return model


def posenet_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX PoseNet tree ({"backbone", "proj", "heatmap": {"w"},
    "offset": {"w"}}) → port state dict."""
    sd = _prefixed(mobilenet_v2_state_dict(params["backbone"]), "backbone.")
    sd.update(conv_bn_state(params["proj"], "proj."))
    sd["heatmap.weight"] = _conv(params["heatmap"])
    sd["offset.weight"] = _conv(params["offset"])
    return sd


def load_posenet(model: torch.nn.Module,
                 params: Dict[str, Any]) -> torch.nn.Module:
    model.load_state_dict(posenet_state_dict(params), strict=True)
    return model


def _leaf(a) -> torch.Tensor:
    """int8 stays int8 (a W8A8 weight); everything else becomes f32."""
    a = np.asarray(a)
    if a.dtype == np.int8:
        return torch.from_numpy(np.array(a, dtype=np.int8))
    return _t(a)


def transformer_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """JAX transformer params (numpy leaves) → the port's params dict.

    The port keeps the JAX layout — dense weights (in, out), used as
    ``x @ w`` — so this is a plain copy of embed, every block key (ln1,
    wqkv, wo, ln2, wi, wd and, for a W8A8 tree, their ``*_scale``), ln_f,
    head and head_scale, with no transpose: int8 weights stay int8, the
    rest is f32."""
    out = {k: _leaf(params[k]) for k in ("embed", "ln_f", "head",
                                         "head_scale") if k in params}
    out["blocks"] = [{k: _leaf(v) for k, v in blk.items()}
                     for blk in params["blocks"]]
    return out


def lstm_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX LSTM params ({"wx": (d_in, 4h), "wh": (h, 4h), "b": (4h,)}) →
    the port's: the same keys and layout, f32 (the port's cell computes
    ``x @ wx`` as JAX does, so nothing is transposed per call)."""
    return {k: _t(params[k]) for k in ("wx", "wh", "b")}


def audio_classifier_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """JAX audio classifier params → the port's: each block's conv weight
    WIO (K, Cin, Cout) → (Cout, Cin, K), once; biases and the dense head
    (C, num_classes) as they are."""
    return {"blocks": [{"w": _t(b["w"]).permute(2, 1, 0).contiguous(),
                        "b": _t(b["b"])} for b in params["blocks"]],
            "head_w": _t(params["head_w"]), "head_b": _t(params["head_b"])}


def tensor_tree(tree) -> Any:
    """A (nested) dict/list/tuple of arrays → the same tree of tensors
    (`_leaf`: int8 stays int8, the rest f32)."""
    if isinstance(tree, dict):
        return {k: tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensor_tree(v) for v in tree)
    return _leaf(tree)


def moe_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MoE params ({"gate", "w1", "w2"}, parallel/moe.init_moe_params)
    → the port's, the same keys and layout, f32."""
    return {k: _t(params[k]) for k in ("gate", "w1", "w2")}


def train_state_params(state, to_port=tensor_tree):
    """A JAX `TrainState`'s params (its ``params`` tree, leaves read as
    numpy) → the port's params by `to_port` (e.g.
    `mobilenet_v2_state_dict`; by default the tree as tensors)."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(host(v) for v in node)
        return np.asarray(node)

    return to_port(host(state.params))


# -- the inverses: port → JAX-layout numpy trees ------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy().copy()


def conv_bn_tree(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    """ConvBN keys → {"conv": {"w": HWIO}, "bn": {...}} (inverse of
    `conv_bn_state`)."""
    return {"conv": {"w": _np(sd[f"{prefix}weight"].permute(2, 3, 1, 0))},
            "bn": {k: _np(sd[f"{prefix}{k}"])
                   for k in ("scale", "bias", "mean", "var")}}


def _mobilenet_v2_tree_sd(sd: Dict[str, torch.Tensor],
                          prefix: str = "") -> Dict[str, Any]:
    tree: Dict[str, Any] = {"stem": conv_bn_tree(sd, f"{prefix}stem."),
                            "blocks": []}
    i = 0
    while f"{prefix}blocks.{i}.depthwise.weight" in sd:
        blk = {}
        for part in ("expand", "depthwise", "project"):
            if f"{prefix}blocks.{i}.{part}.weight" in sd:
                blk[part] = conv_bn_tree(sd, f"{prefix}blocks.{i}.{part}.")
        tree["blocks"].append(blk)
        i += 1
    tree["head"] = conv_bn_tree(sd, f"{prefix}head.")
    if f"{prefix}classifier.weight" in sd:
        tree["classifier"] = {
            "w": _np(sd[f"{prefix}classifier.weight"].t()),
            "b": _np(sd[f"{prefix}classifier.bias"])}
    return tree


def mobilenet_v2_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The port's MobileNetV2 → the JAX param tree (numpy leaves)."""
    return _mobilenet_v2_tree_sd(model.state_dict())


def _conv_tree(sd, key: str) -> Dict[str, np.ndarray]:
    return {"w": _np(sd[key].permute(2, 3, 1, 0))}


def ssd_mobilenet_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The port's SSD-MobileNetV2 → the JAX tree."""
    sd = model.state_dict()
    tree = {"backbone": _mobilenet_v2_tree_sd(sd, "backbone."),
            "extras": [], "loc_heads": [], "cls_heads": []}
    i = 0
    while f"extras.{i}.squeeze.weight" in sd:
        tree["extras"].append({
            "squeeze": conv_bn_tree(sd, f"extras.{i}.squeeze."),
            "conv": conv_bn_tree(sd, f"extras.{i}.conv.")})
        i += 1
    for kind in ("loc_heads", "cls_heads"):
        i = 0
        while f"{kind}.{i}.weight" in sd:
            tree[kind].append(_conv_tree(sd, f"{kind}.{i}.weight"))
            i += 1
    return tree


def posenet_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The port's PoseNet → the JAX tree."""
    sd = model.state_dict()
    return {"backbone": _mobilenet_v2_tree_sd(sd, "backbone."),
            "proj": conv_bn_tree(sd, "proj."),
            "heatmap": _conv_tree(sd, "heatmap.weight"),
            "offset": _conv_tree(sd, "offset.weight")}


def transformer_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's transformer params → the JAX tree (the same keys and
    layout; numpy leaves)."""
    out = {k: _np(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: _np(v) for k, v in blk.items()}
                     for blk in params["blocks"]]
    return out


#: zoo model → (port params → JAX tree)
JAX_TREE = {"mobilenet_v2": mobilenet_v2_tree,
            "ssd_mobilenet": ssd_mobilenet_tree,
            "posenet": posenet_tree,
            "transformer": transformer_tree}
#: zoo model → (the zoo bundle's params, a JAX tree) → params to run
PORT_LOADER = {"mobilenet_v2": load_mobilenet_v2,
               "ssd_mobilenet": load_ssd_mobilenet,
               "posenet": load_posenet,
               "transformer": lambda _params, tree: transformer_params(tree)}
