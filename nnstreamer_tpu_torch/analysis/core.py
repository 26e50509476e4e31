"""nnlint core — rule runner, suppressions, baseline, output (the JAX
package's analysis/core.py on the port, the same code).

The runtime's correctness rests on conventions the compiler never
checks: timer elements must implement the `next_deadline`/`on_timer`
pair, contract flags must match element shape, every host sync must
route through `runtime/sync.device_sync`, no thread may block while
holding a lock, bodies captured into CUDA graphs must stay pure,
spawn-imported modules must not touch the card at import, and error
classes must pickle across the worker pool. The reference framework
inherits these guarantees from GStreamer's core; this substrate is
homegrown threads + PyTorch, so each convention is one refactor away
from a silent race. This package encodes them as AST rules so the gap
shows up in review, not in production.

Mechanics:

- **Rules** subclass :class:`Rule` and yield ``(node, message)`` pairs
  from ``check(module, project)``; cross-module rules read the whole
  :class:`Project` index (capture purity follows imports, spawn safety
  walks the worker's import closure).
- **Suppressions**: ``# nnlint: disable=NNL003`` (comma list, or
  ``all``) on the finding's line waives it — for *deliberate*
  exceptions, each with a one-line justification in the same comment.
- **Baseline**: a committed JSON of finding fingerprints grandfathers
  pre-existing debt so the gate can be red-line-only. The port's
  baseline (`analysis/nnlint_baseline.json`) is empty and the tier-1
  gate test keeps it that way: new findings are fixed or
  inline-suppressed, never baselined.

Dependency-free (stdlib ast only) so the gate runs anywhere the code
parses — no torch import, no package import of the code under analysis.
"""

from __future__ import annotations

import ast
import hashlib
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

#: suppression comment grammar: `# nnlint: disable=NNL001[,NNL002]` or
#: `# nnlint: disable=all`; anything after the rule list is the
#: human justification and is ignored by the parser
_DISABLE_RE = re.compile(r"#\s*nnlint:\s*disable=([A-Za-z0-9_,]+|all)")

#: JSON report schema version (tests pin it)
SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str              # posix-relative path as scanned
    line: int
    col: int
    message: str
    suppressed: bool = False

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity for baseline matching: a finding
        keeps its fingerprint when unrelated edits shift it down the
        file, and changes it when the offending code itself changes."""
        blob = f"{self.rule}|{self.path}|{self.message}"
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "fingerprint": self.fingerprint,
                "suppressed": self.suppressed}

    def __str__(self):
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclass
class Module:
    """One parsed source file plus the per-line suppression table."""

    path: str                        # posix relative path
    src: str
    tree: ast.AST
    lines: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.lines:
            self.lines = self.src.splitlines()

    def disabled_rules(self, lineno: int) -> set:
        if not 1 <= lineno <= len(self.lines):
            return set()
        m = _DISABLE_RE.search(self.lines[lineno - 1])
        if not m:
            return set()
        spec = m.group(1)
        if spec == "all":
            return {"all"}
        return {r.strip().upper() for r in spec.split(",") if r.strip()}


class Project:
    """Index of every scanned module, for cross-module rules.

    Keyed by posix relative path; `by_dotted` resolves a package module
    name (``nnstreamer_tpu_torch.runtime.sync``) back to its scanned file,
    so the capture-purity rule can follow ``from X import f`` and the
    spawn-safety rule can walk the worker's import closure without
    importing anything.
    """

    def __init__(self, modules: Dict[str, Module]):
        self.modules = modules
        self._dotted: Dict[str, str] = {}
        for path in modules:
            p = path[:-3] if path.endswith(".py") else path
            if p.endswith("/__init__"):
                p = p[: -len("/__init__")]
            self._dotted[p.replace("/", ".")] = path

    def by_dotted(self, dotted: str) -> Optional[Module]:
        path = self._dotted.get(dotted)
        return self.modules.get(path) if path else None

    def __iter__(self) -> Iterator[Module]:
        return iter(self.modules.values())


class Rule:
    """One lint rule. Subclasses set `rule_id`/`title`/`rationale` and
    implement `check()` yielding ``(node_or_lineno, message)``."""

    rule_id: str = "NNL000"
    title: str = ""
    rationale: str = ""

    def check(self, module: Module,
              project: Project) -> Iterable[Tuple[object, str]]:
        raise NotImplementedError

    def run(self, module: Module, project: Project) -> List[Finding]:
        out = []
        for node, msg in self.check(module, project):
            line = getattr(node, "lineno", node if isinstance(node, int) else 0)
            col = getattr(node, "col_offset", 0)
            disabled = module.disabled_rules(line)
            suppressed = "all" in disabled or self.rule_id in disabled
            out.append(Finding(self.rule_id, module.path, line, col,
                               msg, suppressed=suppressed))
        return out


# -- baseline ----------------------------------------------------------------

def load_baseline(path) -> List[str]:
    """Fingerprint multiset from a baseline file; [] when absent."""
    p = Path(path)
    if not p.exists():
        return []
    data = json.loads(p.read_text() or "{}")
    return list(data.get("findings", []))


def write_baseline(path, findings: Iterable[Finding]) -> int:
    fps = sorted(f.fingerprint for f in findings if not f.suppressed)
    Path(path).write_text(json.dumps(
        {"version": SCHEMA_VERSION, "findings": fps}, indent=2) + "\n")
    return len(fps)


def apply_baseline(findings: List[Finding],
                   baseline: List[str]) -> Tuple[List[Finding], int]:
    """Split findings against the baseline multiset: returns
    (unbaselined findings, number grandfathered). Duplicate
    fingerprints consume one baseline entry each."""
    budget: Dict[str, int] = {}
    for fp in baseline:
        budget[fp] = budget.get(fp, 0) + 1
    fresh: List[Finding] = []
    matched = 0
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
            matched += 1
        else:
            fresh.append(f)
    return fresh, matched


# -- running -----------------------------------------------------------------

def _iter_py_files(paths: Iterable[str], root: Path) -> Iterator[Path]:
    for p in paths:
        pp = Path(p)
        if not pp.is_absolute():
            pp = root / pp
        if pp.is_dir():
            yield from sorted(pp.rglob("*.py"))
        elif pp.suffix == ".py":
            yield pp


def build_project(paths: Iterable[str], root=None) -> Project:
    """Parse every .py under `paths` (files or dirs) into a Project.
    Generated protobuf modules and caches are skipped; a file that does
    not parse becomes a synthetic parse-error module handled by the
    runner (syntax gate)."""
    root = Path(root or ".").resolve()
    modules: Dict[str, Module] = {}
    for f in _iter_py_files(paths, root):
        if "_pb2" in f.name or "__pycache__" in f.parts:
            continue
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = f.as_posix()
        src = f.read_text()
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            tree = ast.Module(body=[], type_ignores=[])
            mod = Module(rel, src, tree)
            mod.parse_error = (e.lineno or 0, e.msg)  # type: ignore
            modules[rel] = mod
            continue
        modules[rel] = Module(rel, src, tree)
    return Project(modules)


def project_from_sources(sources: Dict[str, str]) -> Project:
    """In-memory project for tests/fixtures: {relpath: source}."""
    modules = {}
    for rel, src in sources.items():
        modules[rel] = Module(rel, src, ast.parse(src, filename=rel))
    return Project(modules)


@dataclass
class Report:
    """Outcome of one lint run over a project."""

    findings: List[Finding]          # unbaselined, unsuppressed
    suppressed: List[Finding]
    baselined: int
    files: int
    rules: List[str]

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        counts: Dict[str, int] = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "version": SCHEMA_VERSION,
            "clean": self.clean,
            "files": self.files,
            "rules": self.rules,
            "counts": counts,
            "baselined": self.baselined,
            "suppressed": [f.to_json() for f in self.suppressed],
            "findings": [f.to_json() for f in self.findings],
        }


def run_rules(project: Project, rules: Iterable[Rule],
              baseline: Optional[List[str]] = None) -> Report:
    rules = list(rules)
    all_findings: List[Finding] = []
    for module in project:
        err = getattr(module, "parse_error", None)
        if err is not None:
            all_findings.append(Finding(
                "NNL000", module.path, err[0], 0,
                f"syntax error: {err[1]}"))
            continue
        for rule in rules:
            all_findings.extend(rule.run(module, project))
    all_findings.sort(key=lambda f: (f.path, f.line, f.rule))
    active = [f for f in all_findings if not f.suppressed]
    suppressed = [f for f in all_findings if f.suppressed]
    fresh, matched = apply_baseline(active, baseline or [])
    return Report(findings=fresh, suppressed=suppressed,
                  baselined=matched, files=len(project.modules),
                  rules=[r.rule_id for r in rules])


# -- AST helpers shared by rules --------------------------------------------

def dotted(node: ast.AST) -> str:
    """Dotted name of an expression: `torch.cuda.synchronize` →
    "torch.cuda.synchronize"; non-name parts render as empty heads
    (``x[0].get`` → ".get") so suffix checks still work."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{dotted(node.value)}.{node.attr}"
    if isinstance(node, ast.Call):
        return dotted(node.func)
    return ""


def const_value(node: ast.AST):
    """Literal value of a class-body assignment RHS, with the graph
    module's DYNAMIC marker folded to its value (-1). Returns None for
    anything non-literal."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name) and node.id == "DYNAMIC":
        return -1
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) \
            and isinstance(node.operand, ast.Constant):
        return -node.operand.value
    return None


def walk_no_functions(stmts) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function/class
    bodies — the lock-discipline walker (code in a nested def does not
    run under the enclosing `with`)."""
    skip = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
            ast.ClassDef)
    stack = [s for s in stmts if not isinstance(s, skip)]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(c for c in ast.iter_child_nodes(node)
                     if not isinstance(c, skip))
