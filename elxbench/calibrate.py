"""The readings that a cell's limits are set from: the program's numbers
over many seeds, and the control's (the plain reference in the program's
place, one precision below the traffic's) over a few.

Usage, from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 elxbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 --seconds 3 [--control-precision P] \
        [--out FILE]

Each seed is one run of the cell (run.py's set-up, a short window at the
cell's own load, the judge), all in this process. One JSON line a run
(side, seed, the numbers compared), then the lower reading (the largest
that the program gave) and the upper reading (the smallest that the
control gave) of each number. ``--control-precision`` puts the reference
at another of its precisions in the program's place (a fault to read the
limit against) instead of the configuration's control. The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from elxbench import cells, run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-precision")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    control = (args.control_precision
               or cell.config["control"][cell.traffic["dtype"]])
    lines, worst = [], {}
    for side, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            solver = (run.control_solver(cell, control)
                      if side == "control" else None)
            read: dict = {}
            res = run.run(cell, seed, args.seconds, False, dev, solver=solver,
                          log=lambda s: None, readings=read)
            line = {"workload": cell.name, "side": side, "seed": seed,
                    "precision": (control if side == "control"
                                  else cell.traffic["dtype"]),
                    "attempted": res["attempted"], "failed": res["failed"],
                    "correct": res["correct"], "checks": read}
            print(json.dumps(line), flush=True)
            lines.append(line)
            for k, v in line["checks"].items():
                pick = max if side == "program" else min
                key = (side, k)
                worst[key] = v if key not in worst else pick(worst[key], v)
            del res
            torch.cuda.empty_cache()
    summary = {f"{'lower' if s == 'program' else 'upper'}.{k}": v
               for (s, k), v in sorted(worst.items())}
    print(json.dumps({"workload": cell.name, "readings": summary}))
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
