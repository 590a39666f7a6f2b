"""BENCHMARK.json against the benchmark's contract, the files it names,
and what the benchmark's modules may import."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PB = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# modules that make inputs, the reference or the yardstick: nothing of
# the program either
PLAIN = {"gen.py", "reference.py", "walread.py", "yardstick.py"}


@pytest.fixture(scope="module")
def man():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    assert 1 <= len(man["command"]) <= 32
    for word in man["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word
    assert (ROOT / man["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check(man):
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(man):
    seen = set()
    for entry in man["configs"] + man["workloads"] + man["end_to_end"] \
            + man["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in seen
        seen.add(entry["name"])
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert "\n" not in entry[key] and "\t" not in entry[key]
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs(man):
    used = {w["config"] for w in man["workloads"]}
    files = set()
    for c in man["configs"]:
        assert c["name"] in used
        assert c["source"].startswith("https://")
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert (PB / "drivers" / f"{cfg['driver']}.py").is_file()
        assert len(c["reduced"]) <= 16
        assert set(c["reduced"]) == set(cfg["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key)
            assert key in cfg and key in cfg["source_values"]
        assert cfg["guarantees"]


def test_workloads(man):
    configs = {c["name"] for c in man["configs"]}
    pairs = set()
    four = 0
    for w in man["workloads"]:
        assert w["config"] in configs
        assert NAME.match(w["traffic"])
        assert (PB / "mixes" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
    assert 1 <= len(man["workloads"]) <= 24
    assert four <= max(1, len(man["workloads"]) // 4)


def test_end_to_end(man):
    cells = {w["name"] for w in man["workloads"]}
    names = [m["name"] for m in man["end_to_end"]]
    assert "setup_s" in names
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        got = [m["name"] for m in man["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert "setup_s" in got and len(got) >= 2, cell


def test_per_layer_metrics_have_readers_and_move_a_reported_metric(man):
    cells = {w["name"] for w in man["workloads"]}
    layers = {}
    for m in man["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        e2e = next(e for e in man["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e.get("workloads", cells), (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:
        assert any(cell in m["workloads"] for m in man["per_layer"]), cell


def test_mixes_are_data():
    for path in (PB / "mixes").iterdir():
        assert path.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv")
        if path.suffix == ".json":
            json.loads(path.read_text())


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        names = set(_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if path.name in PLAIN:
            assert "repro_torch" not in names, path


def test_import_scan_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.core\nfrom jax import numpy\n")
    assert set(_imports(p)) == {"repro_torch", "jax"}
    assert not {"repro_torch"} & FORBIDDEN
