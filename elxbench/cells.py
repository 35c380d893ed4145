"""Find a cell's pieces by name.

Each piece is a file of its own under the benchmark's directory, found by
the name that ``BENCHMARK.json`` gives it:

- ``workloads/<cell>.json``: the cell: its configuration, its traffic mix,
  the chips it needs and the limits of its correctness numbers;
- ``configs/<config>.json``: the configuration: the public entry of the
  port that a call runs, the precisions its source states (a cell runs in
  one of them), the accuracy it promises, the precision of its control;
- ``traffic/<traffic>.json``: the traffic mix: dtype, n, nrhs and the
  number of distinct problems the window cycles through;
- ``reference/<config>.py``: the plain reference: the inputs from the seed
  and the solve in plain PyTorch at a stated precision;
- ``work/<config>.py``: the nominal operations and bytes of one call;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

A later cell, configuration or per-layer metric is a new file; no file
here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, NamedTuple

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Cell(NamedTuple):
    name: str
    chips: int
    limits: Dict[str, float]
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    reference: ModuleType
    work: ModuleType


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, label: str) -> ModuleType:
    """The Python file at ``path`` as a module, not entered in sys.modules
    (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "elxbench_" + re.sub(r"\W", "_", label), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic, reference and
    work count, read from the files under ``root``."""
    w = load_json(root / "workloads" / f"{_checked(name)}.json")
    cfg, trf = _checked(w["config"]), _checked(w["traffic"])
    config = load_json(root / "configs" / f"{cfg}.json")
    traffic = load_json(root / "traffic" / f"{trf}.json")
    if traffic["dtype"] not in config["precisions"]:
        raise ValueError(f"{cfg} states no {traffic['dtype']} routine")
    return Cell(
        name=name, chips=int(w["chips"]), limits=dict(w["limits"]),
        config_name=cfg, config=config, traffic_name=trf, traffic=traffic,
        reference=load_module(root / "reference" / f"{cfg}.py",
                              f"reference.{cfg}"),
        work=load_module(root / "work" / f"{cfg}.py", f"work.{cfg}"))


def readers(root: Path = HERE) -> Dict[str, ModuleType]:
    """Every per-layer metric's reader, by the metric's name (the file's
    name without ``.py``)."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        out[_checked(path.name[:-3])] = load_module(path, f"metric.{path.name}")
    return out
