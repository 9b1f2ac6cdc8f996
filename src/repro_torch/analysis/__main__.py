"""CLI: ``python -m repro_torch.analysis src/repro_torch [--json] [--rules MIR,DET201]``.

Exit status 0 when no finding survives suppressions, 1 otherwise (a
zero-findings gate), 2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import run_analysis


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Mirror-sync, determinism, and hygiene auditor "
                    "(see repro_torch.analysis for the rule catalogue).")
    parser.add_argument("paths", nargs="+",
                        help="files or directories to analyze")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings as a JSON array")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids or prefixes "
                             "(e.g. MIR,DET203) — default: all rules")
    args = parser.parse_args(argv)

    rules = [r.strip() for r in args.rules.split(",") if r.strip()] \
        if args.rules else None
    findings = run_analysis(args.paths, rules=rules)

    if args.as_json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
        print(f"repro_torch.analysis: {len(findings)} finding(s)",
              file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
