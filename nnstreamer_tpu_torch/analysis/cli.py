"""`python -m nnstreamer_tpu_torch lint` — the nnlint command line (the
JAX package's analysis/cli.py on the port).

Exit codes: 0 clean, 1 findings, 2 usage/internal error (pytest-style).
The default baseline is the port's own file beside this module
(`nnlint_baseline.json`, kept empty).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from nnstreamer_tpu_torch.analysis.core import (
    build_project, load_baseline, run_rules, write_baseline)
from nnstreamer_tpu_torch.analysis.rules import ALL_RULES, iter_rules

DEFAULT_BASELINE = Path(__file__).resolve().with_name("nnlint_baseline.json")


def _repo_root() -> Path:
    """Nearest ancestor holding the package dir — so `lint` works from
    any cwd inside the repo; from outside a checkout, fall back to the
    imported package's own location (scan what you're running)."""
    here = Path.cwd().resolve()
    for cand in (here, *here.parents):
        if (cand / "nnstreamer_tpu_torch" / "__init__.py").exists():
            return cand
    return Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch lint",
        description="project-specific static analysis of the port")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: nnstreamer_tpu_torch)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="baseline file (default: the port's own, "
                         "analysis/nnlint_baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline "
                         "and exit 0 (policy: keep it empty — fix or "
                         "inline-suppress instead)")
    ap.add_argument("--rules", default=None, metavar="IDS",
                    help="comma list of rule ids to run (default all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.rule_id}  {r.title}")
            print(f"    {r.rationale}")
        return 0

    try:
        rules = iter_rules(args.rules.split(",") if args.rules else None)
    except ValueError as e:
        print(f"nnlint: {e}", file=sys.stderr)
        return 2

    root = _repo_root()
    baseline_path = Path(args.baseline) if args.baseline \
        else DEFAULT_BASELINE
    project = build_project(args.paths or ["nnstreamer_tpu_torch"],
                            root=root)
    if not project.modules:
        print("nnlint: no python files found under "
              f"{args.paths or ['nnstreamer_tpu_torch']}", file=sys.stderr)
        return 2

    if args.write_baseline:
        report = run_rules(project, rules, baseline=None)
        n = write_baseline(baseline_path, report.findings)
        print(f"nnlint: wrote {n} fingerprint(s) to {baseline_path}")
        return 0

    report = run_rules(project, rules,
                       baseline=load_baseline(baseline_path))
    if args.json:
        print(json.dumps(report.to_json(), indent=2))
        return 0 if report.clean else 1

    for f in report.findings:
        print(f)
    tail = (f"nnlint: {len(report.findings)} finding(s) in "
            f"{report.files} file(s)")
    extras = []
    if report.baselined:
        extras.append(f"{report.baselined} baselined")
    if report.suppressed:
        extras.append(f"{len(report.suppressed)} suppressed inline")
    if extras:
        tail += f" ({', '.join(extras)})"
    print(tail, file=sys.stderr if report.clean else sys.stdout)
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
