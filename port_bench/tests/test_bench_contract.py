"""BENCHMARK.json against the benchmark's contract, and every cell against
the files it is found by."""

import json
import os
import re

import pytest

from harness import common

B = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in B["end_to_end"]}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert 1 <= len(B["command"]) <= 32 and all(_line(w) for w in B["command"])
    for p in B["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in B[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_units_better_sources():
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])


def test_configs_found_and_used():
    used = {w["config"] for w in B["workloads"]}
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for c in B["configs"]:
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(B["paths"][0] + "/")
        cfg = common.load_json(os.path.join(common.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["precision"]["compute_dtype"] == "float32"


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(w):
    assert w["chips"] in (1, 4) and _line(w["why"])
    tr = common.traffic(w["traffic"])
    assert os.path.exists(os.path.join(common.BENCH_DIR, "harness", "entries",
                                       f"{tr['entry']}.py"))
    limits = common.load_json(os.path.join(common.BENCH_DIR, "limits", f"{w['name']}.json"))
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    assert common.config(w["config"])["name"] == w["config"]


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


def _reports(cell: str, metric: str) -> bool:
    m = E2E[metric]
    return "workloads" not in m or cell in m["workloads"]


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_e2e_and_a_layer(w):
    n = w["name"]
    assert _reports(n, "setup_s")
    assert any(_reports(n, k) for k in E2E if k != "setup_s")
    assert any(n in m.get("workloads", [n]) for m in B["per_layer"])


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_what_its_cells_report(m):
    assert m["moves"] in E2E
    for cell in m["workloads"]:
        assert _reports(cell, m["moves"])
    assert os.path.exists(os.path.join(common.BENCH_DIR, "metrics", f"{m['name']}.py"))


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in B["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_the_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_result_line_puts_the_compared_numbers_last():
    line = common.result_line(True, 3, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                              {"platform": "gpu"}, [{"name": "x", "value": 0.1,
                                                     "limit": 0.2, "ok": True}])
    d = json.loads(line)
    assert list(d)[-1] == "compared" and d["compared"]["x"] == {"value": 0.1, "limit": 0.2}
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(d)


def test_nearest_rank():
    vals = list(range(1, 101))
    assert common.nearest_rank(vals, 0.9) == 90
    assert common.nearest_rank([5.0], 0.9) == 5.0
    assert common.nearest_rank([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 0.9) == 10
