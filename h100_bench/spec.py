"""Where the benchmark's parts are found by name.

`BENCHMARK.json` (the root of the checkout) lists the cells and the
metrics. Each configuration is `configs/<name>.json`, each traffic mix
`traffic/<name>.json`, the frozen operation count of each cell
`flops/<workload>.json`, and each metric a reader `metrics/<name>.py` with
a function `read(run)` that returns a number or None. A cell or a metric
is added by adding files and entries; nothing here names one.
"""

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   + ", ".join(w["name"] for w in bench["workloads"]))


def _file(kind: str, name: str, suffix: str) -> Path:
    if not NAME.fullmatch(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return HERE / kind / f"{name}{suffix}"


def config(name: str) -> dict:
    return _json(_file("configs", name, ".json"))


def traffic(name: str) -> dict:
    return _json(_file("traffic", name, ".json"))


def flops(workload_name: str) -> dict:
    return _json(_file("flops", workload_name, ".json"))


def reader(metric: str):
    """The `read` function of `metrics/<metric>.py`."""
    path = _file("metrics", metric, ".py")
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload_name: str, traced: bool) -> list:
    """The metric entries a run of the cell reports: its end-to-end ones,
    or with tracing its per-layer ones. An entry without `workloads`
    belongs to every cell."""
    entries = bench["per_layer" if traced else "end_to_end"]
    return [m for m in entries
            if workload_name in m.get("workloads", [workload_name])]
