"""Benchmark regression gate: compare two results.json files.

The analog of the reference's benchstat PR-comparison workflow
(.github/workflows/benchmark.yml): given a current and a baseline results
file (benchmarks/run_all.py format), fail when any shared config regresses
by more than the tolerance.

Usage:
    python benchmarks/check_regression.py CURRENT BASELINE \
        [--tolerance 0.20] [--configs substr ...]

Exit status 1 lists every regressed config.  Configs present in only one
file are reported but do not fail the gate (new benchmarks are allowed).
Backends must match — comparing runs on two different devices is
meaningless and is rejected.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def load(path: str) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("current")
    ap.add_argument("baseline")
    ap.add_argument("--tolerance", type=float, default=0.20,
                    help="max allowed fractional slowdown (default 0.20)")
    ap.add_argument("--configs", nargs="*", default=[],
                    help="only compare configs containing these substrings")
    args = ap.parse_args(argv)

    cur = load(args.current)
    base = load(args.baseline)
    if cur.get("backend") != base.get("backend"):
        print(f"error: backend mismatch: current={cur.get('backend')} "
              f"baseline={base.get('backend')} — same-machine runs only",
              file=sys.stderr)
        return 2

    def wanted(name: str) -> bool:
        return not args.configs or any(c in name for c in args.configs)

    cur_r = {k: v for k, v in cur["results"].items() if wanted(k)}
    base_r = {k: v for k, v in base["results"].items() if wanted(k)}
    shared = sorted(set(cur_r) & set(base_r))
    regressions = []
    for k in shared:
        ratio = cur_r[k] / base_r[k] if base_r[k] else float("inf")
        flag = ""
        if ratio < 1.0 - args.tolerance:
            regressions.append((k, base_r[k], cur_r[k], ratio))
            flag = "  << REGRESSION"
        print(f"{k}: {base_r[k]:.1f} -> {cur_r[k]:.1f} Msamples/s "
              f"({(ratio - 1) * 100:+.1f}%){flag}")
    for k in sorted(set(cur_r) - set(base_r)):
        print(f"{k}: (new) {cur_r[k]:.1f} Msamples/s")
    for k in sorted(set(base_r) - set(cur_r)):
        print(f"{k}: (missing from current run; baseline {base_r[k]:.1f})")

    if not shared:
        print("error: no shared configs to compare", file=sys.stderr)
        return 2
    if regressions:
        print(f"\nFAIL: {len(regressions)} config(s) regressed more than "
              f"{args.tolerance * 100:.0f}%", file=sys.stderr)
        return 1
    print(f"\nOK: no config regressed more than {args.tolerance * 100:.0f}% "
          f"({len(shared)} compared)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
