"""Runtime element-contract introspection (the JAX package's
analysis/contract.py on the port's elements).

The single source of truth the NNL001 rule checks *statically* and docs
render *dynamically*: for a registered Element class, which contract
flags does it actually carry? Tests cross-check it against the
scheduler's own `_chain_eligible` logic so the lint rule, the docs and
the runtime can never disagree about what a class declares.

This module imports the graph layer (it introspects live classes) —
keep it OUT of the linter's import path; `analysis.core`/`analysis
.rules` stay stdlib-only.
"""

from __future__ import annotations

from typing import Dict


def element_contract(cls) -> Dict[str, object]:
    """Declared contract flags for an Element class.

    ``timer`` mirrors the scheduler's check (scheduler.py
    `_chain_eligible`): an element is a timer element iff it overrides
    `next_deadline` or `on_timer` relative to the Element base.
    """
    from nnstreamer_tpu_torch.graph.pipeline import DYNAMIC, Element

    has_timer = (cls.next_deadline is not Element.next_deadline
                 or cls.on_timer is not Element.on_timer)

    def _pads(v) -> str:
        return "dynamic" if v == DYNAMIC else str(v)

    return {
        "chain_fusable": bool(getattr(cls, "CHAIN_FUSABLE", False)),
        "device_resident": bool(getattr(cls, "DEVICE_RESIDENT", False)),
        "timer": has_timer,
        "sink_pads": _pads(getattr(cls, "NUM_SINK_PADS", 1)),
        "src_pads": _pads(getattr(cls, "NUM_SRC_PADS", 1)),
    }


def contract_badges(cls) -> str:
    """Compact human rendering for the docs table, e.g.
    ``fusable · device-resident · timer · pads 1→dynamic``."""
    c = element_contract(cls)
    badges = []
    if c["chain_fusable"]:
        badges.append("fusable")
    if c["device_resident"]:
        badges.append("device-resident")
    if c["timer"]:
        badges.append("timer")
    badges.append(f"pads {c['sink_pads']}→{c['src_pads']}")
    return " · ".join(badges)
