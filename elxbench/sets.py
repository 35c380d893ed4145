"""Sets of runs of one cell, one process a run, one run at a time, and the
spread of each metric: what a cell's bounds are set from.

Usage, from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 elxbench/sets.py --workload <cell> --seeds 11 12 13 14 15 16 \
        --sets 2 --seconds 40 [--trace 0] [--out FILE]

Every set runs the same seeds in order. Each run's last stdout line (or
its failure, with the end of its stderr) goes to ``--out`` as one JSON
line. Then, for each set and metric, the values, the median and the
spread: the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from elxbench.stats import spread  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--timeout", type=int, default=1200)
    ap.add_argument("--out")
    args = ap.parse_args()
    rows, bad = [], 0
    for k in range(args.sets):
        for seed in args.seeds:
            cmd = [sys.executable, str(HERE / "run.py"), "--workload",
                   args.workload, "--seed", str(seed), "--seconds",
                   str(args.seconds), "--trace", str(args.trace)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout)
            row = {"workload": args.workload, "set": k, "seed": seed,
                   "trace": args.trace, "rc": proc.returncode}
            try:
                row["result"] = json.loads(proc.stdout.strip().splitlines()[-1])
            except (IndexError, json.JSONDecodeError):
                row["stderr"] = proc.stderr[-3000:]
            if proc.returncode or not row.get("result", {}).get("correct"):
                bad += 1
                row["stderr"] = proc.stderr[-3000:]
            row["stdout_head"] = proc.stdout.strip().splitlines()[:6]
            print(json.dumps(row), flush=True)
            rows.append(row)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    for k in range(args.sets):
        got = [r["result"] for r in rows if r["set"] == k and "result" in r]
        for name in sorted({m for g in got for m in g["metrics"]}):
            vals = [g["metrics"][name]["value"] for g in got
                    if name in g["metrics"]]
            line = {"set": k, "metric": name, "values": vals,
                    "median": statistics.median(vals)}
            if len(vals) >= 2:
                line["spread"] = spread(vals)
            print(json.dumps(line))
    print(json.dumps({"workload": args.workload, "runs": len(rows),
                      "not_correct_or_failed": bad}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
