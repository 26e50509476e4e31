"""gst-launch-style pipeline description parser.

Grammar:

  pipeline   := chain (whitespace chain)*
  chain      := node ('!' node)*
  node       := element | ref
  element    := NAME (prop)*
  prop       := KEY '=' VALUE        (VALUE may be "quoted with spaces")
  ref        := NAME '.' [PAD]       (links to/from a named element; PAD
                                      picks the pad — 'sink_0', 'src_1',
                                      or a bare index — else the next free
                                      pad: mux/demux branches)

Example:

  videotestsrc num-buffers=10 ! tensor_converter ! tensor_sink name=out

  appsrc name=a ! mux.sink_0  appsrc name=b ! mux.sink_1
  tensor_mux name=mux ! tensor_sink

Element names resolve through the port's ELEMENT registry.
"""

from __future__ import annotations

import re
import shlex
from typing import Dict, List, Optional

from nnstreamer_tpu_torch.core.errors import PipelineError
from nnstreamer_tpu_torch.core.registry import PluginKind, registry
from nnstreamer_tpu_torch.graph.pipeline import Element, Pipeline

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_\-]*$")


def parse_launch(description: str, name: str = "pipeline") -> Pipeline:
    """Build a Pipeline from a description string. Importing the port's
    elements is implicit, so built-in element names are always there."""
    import nnstreamer_tpu_torch.elements  # noqa: F401  (registers built-ins)

    tokens = _tokenize(description)
    if not tokens:
        raise PipelineError("empty pipeline description")
    pipe = Pipeline(name)
    chains = _split_chains(tokens)
    # pass 1: instantiate every element so refs may point forward
    for chain in chains:
        for node in chain:
            if node["kind"] == "element":
                node["instance"] = _instantiate(node)
                pipe.add(node["instance"])
    # pass 2: link chain by chain
    for chain in chains:
        prev: Optional[Element] = None
        prev_pad: Optional[int] = None
        for node in chain:
            cur = (node["instance"] if node["kind"] == "element"
                   else pipe.get(node["name"]))
            if prev is not None:
                pipe.link(prev, cur, src_pad=prev_pad,
                          dst_pad=_ref_pad(node, "sink"))
            prev = cur
            prev_pad = _ref_pad(node, "src")
    return pipe


def _ref_pad(node: Dict, direction: str) -> Optional[int]:
    """The explicit pad of a ref node on the side it is used from:
    'sink_N'/'src_N' name their side, a bare N fits either; None = the
    next free pad."""
    pad = node.get("pad") if node["kind"] == "ref" else None
    if not pad:
        return None
    if pad.isdigit():
        return int(pad)
    prefix, _, idx = pad.rpartition("_")
    if prefix in ("sink", "src") and idx.isdigit():
        return int(idx) if prefix == direction else None
    raise PipelineError(
        f"bad pad reference {node['name']}.{pad}: expected sink_<n>, "
        f"src_<n> or a bare pad index")


def _tokenize(description: str) -> List[str]:
    try:
        lex = shlex.shlex(description, posix=True)
        lex.whitespace_split = True
        lex.commenters = "#"
        return list(lex)
    except ValueError as e:
        raise PipelineError(f"cannot tokenize pipeline description: {e}") from e


def _split_chains(tokens: List[str]) -> List[List[Dict]]:
    """Group tokens into chains of element/ref nodes."""
    chains: List[List[Dict]] = []
    current: List[Dict] = []
    node: Optional[Dict] = None
    expect_node = True  # right after '!' or at a chain boundary

    def finish_node():
        nonlocal node
        if node is not None:
            current.append(node)
            node = None

    def finish_chain():
        nonlocal current
        finish_node()
        if current:
            chains.append(current)
            current = []

    for tok in tokens:
        if tok == "!":
            if node is None and not current:
                raise PipelineError("pipeline description starts with '!'")
            finish_node()
            expect_node = True
            continue
        if "=" in tok and not expect_node and node is not None:
            key, _, value = tok.partition("=")
            if not key:
                raise PipelineError(f"malformed property token {tok!r}")
            if node["kind"] != "element":
                raise PipelineError(
                    f"property {tok!r} follows reference {node['name']!r}.; "
                    f"properties belong on the element's own declaration")
            if key == "name":
                node["name"] = value
            else:
                node["props"][key] = value
            continue
        if not expect_node:  # whitespace-separated chains
            finish_chain()
        name, dot, pad = tok.partition(".")
        if dot and _NAME_RE.match(name) and (
                not pad or _NAME_RE.match(pad) or pad.isdigit()):
            finish_node()
            node = {"kind": "ref", "name": name, "pad": pad or None}
        elif _NAME_RE.match(tok):
            finish_node()
            node = {"kind": "element", "type": tok, "name": None, "props": {}}
        else:
            raise PipelineError(
                f"unexpected token {tok!r} in pipeline description (element "
                f"names match [A-Za-z_][A-Za-z0-9_-]*; properties are "
                f"key=value; links are '!')")
        expect_node = False
    finish_chain()
    return chains


def _instantiate(node: Dict) -> Element:
    cls = registry.get(PluginKind.ELEMENT, node["type"])
    try:
        return cls(name=node["name"], **node["props"])
    except PipelineError:
        raise
    except (TypeError, ValueError) as e:
        raise PipelineError(
            f"cannot construct element {node['type']!r}: {e}") from e
