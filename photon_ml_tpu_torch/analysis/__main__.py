"""photon-lint for the port: run every static-analysis pass over the tree.

The counterpart of ``tools/photon_lint.py``: the reference's rule ids
(``res-*``, ``tel-*``, ``trace-*``, ``lock-*``, ``obs-metric-catalog``,
``res-fault-coverage``) over ``photon_ml_tpu_torch/`` and the port's root
scripts (``chip_smoke.py``, ``port_tree_report.py``), one ``path:line
rule-id message`` line per finding.

Usage::

    python -m photon_ml_tpu_torch.analysis [root]
        [--rules res-sleep,trace-clock]   # subset by rule id
        [--json]                          # machine-readable report
        [--list-rules]                    # rule catalog, one id per line

Exit codes: 0 = clean, 1 = findings (fix or suppress with a justified
``# photon-lint: disable=<rule-id> -- <reason>``), 2 = the lint failed
(unknown rule id, unparseable source, crash) — nothing is known about the
tree.
"""

from __future__ import annotations

import argparse
import sys

from photon_ml_tpu_torch.analysis import engine


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("root", nargs="?", default=".",
                        help="repo root to scan (default: .)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids (default: all)")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable JSON report")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    try:
        if args.list_rules:
            for rid, r in sorted(engine.all_rules().items()):
                print(f"{rid:24s} [{r.scope}] {r.summary}")
            return 0
        rule_ids = (None if args.rules is None
                    else [s.strip() for s in args.rules.split(",")
                          if s.strip()])
        report = engine.run(args.root, rule_ids=rule_ids)
    except Exception as e:
        print(f"photon-lint: internal error: {e!r}", file=sys.stderr)
        return 2
    if args.json:
        print(report.to_json())
    else:
        for f in report.findings:
            print(f.render())
        if report.findings:
            print(f"{len(report.findings)} finding(s) "
                  f"({len(report.suppressed)} suppressed with "
                  f"justification)")
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
