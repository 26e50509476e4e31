"""nnlint — project-specific static analysis of the port (the JAX
package's analysis/ with the rules that named jax in their torch form,
ROADMAP N42).

    python -m nnstreamer_tpu_torch lint                # human, exit 0/1
    python -m nnstreamer_tpu_torch lint --json         # machine output
    python -m nnstreamer_tpu_torch lint --list-rules   # the catalog

`lint_report(paths)` is the in-process API (the tier-1 gate test uses
it). The analysis core is stdlib-only — this package never imports torch
or the code it scans; `contract` (runtime introspection for docs) is
imported lazily for the same reason.
"""

from __future__ import annotations

from nnstreamer_tpu_torch.analysis.core import (
    SCHEMA_VERSION, Finding, Module, Project, Report, Rule,
    build_project, load_baseline, project_from_sources, run_rules,
    write_baseline)
from nnstreamer_tpu_torch.analysis.rules import ALL_RULES, iter_rules

__all__ = [
    "SCHEMA_VERSION", "Finding", "Module", "Project", "Report", "Rule",
    "ALL_RULES", "build_project", "element_contract", "iter_rules",
    "lint_report", "load_baseline", "project_from_sources", "run_rules",
    "write_baseline",
]


def lint_report(paths=("nnstreamer_tpu_torch",), root=None,
                baseline_path=None, rules=None) -> Report:
    """One-call lint: build the project, run the rules, apply the
    baseline.  `Report.clean` is the gate bit."""
    project = build_project(paths, root=root)
    baseline = load_baseline(baseline_path) if baseline_path else []
    return run_rules(project, iter_rules(rules), baseline)


def element_contract(cls):
    """Lazy re-export (contract.py imports the graph layer)."""
    from nnstreamer_tpu_torch.analysis.contract import element_contract as ec
    return ec(cls)
