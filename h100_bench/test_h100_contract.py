"""BENCHMARK.json against the benchmark's contract: names, units and
lengths; every cell's configuration, traffic, operation count and metric
readers found by name; every per-layer metric moving one end-to-end
metric that its cells report; no file of the harness importing JAX or
the JAX package, and the reference importing nothing of the program."""

import ast
import json
import re
from pathlib import Path

import pytest

from h100_bench import spec

BENCH = spec.benchmark()
HERE = spec.HERE
ONE_LINE = re.compile(r"[^\n\t]{1,200}")
FORBIDDEN = {"jax", "jaxlib", "flax", "dformer_tpu"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert ONE_LINE.fullmatch(word)
        assert not word.startswith("/") and ".." not in word


def test_names_and_units():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            assert spec.NAME.fullmatch(entry["name"]), entry["name"]
            names.append((key, entry["name"]))
    for key in ("configs", "workloads"):
        assert len({n for k, n in names if k == key}) == len(BENCH[key])
    metrics = [n for k, n in names if k in ("end_to_end", "per_layer")]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert spec.NAME.fullmatch(w["config"])
        assert spec.NAME.fullmatch(w["traffic"])
        assert ONE_LINE.fullmatch(w["why"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert ONE_LINE.fullmatch(c["why"]) and ONE_LINE.fullmatch(
            c["source"])
        assert len(c["reduced"]) <= 16


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert ONE_LINE.fullmatch(m["layer"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_resolve(w):
    configs = {c["name"]: c for c in BENCH["configs"]}
    c = configs[w["config"]]
    assert Path(spec.ROOT / c["file"]) == HERE / "configs" / \
        f"{c['name']}.json"
    cfg = spec.config(w["config"])
    assert cfg["reduced"] == c["reduced"] == []
    tr = spec.traffic(w["traffic"])
    assert (HERE / "cells" / f"{tr['kind']}.py").exists()
    assert spec.flops(w["name"])["per_image"] > 0
    for m in spec.metrics_of(BENCH, w["name"], False) \
            + spec.metrics_of(BENCH, w["name"], True):
        assert callable(spec.reader(m["name"]))


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in spec.metrics_of(BENCH, w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        assert spec.metrics_of(BENCH, w["name"], True), w["name"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell]), \
                (m["name"], cell)


def test_tail_gates_serving_only():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["serve_p95_ms"]["workloads"] == ["large_serve_bs32"]
    tail = [m for m in BENCH["per_layer"] if m["name"] == "label_p95_ms.trav"]
    assert tail and tail[0]["moves"] == "serve_img_per_s"
    assert tail[0]["workloads"] == ["trav_label_bs32"]


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    for path in HERE.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        found = set(_imports(path))
        assert "dformer_torch" not in found, path
        assert found <= {"contextlib", "math", "numpy", "torch",
                         "statistics", "dataclasses", "typing",
                         "h100_bench"}, (path, found)


def test_top_level_name_compare():
    """The run's own check compares whole top-level names: the port's
    package name begins with the JAX package's prefix and must pass."""
    from h100_bench.run import FORBIDDEN as RUN_FORBIDDEN

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "dformer_torch".split(".")[0] not in FORBIDDEN
    assert "dformer_tpu.models".split(".")[0] in FORBIDDEN
