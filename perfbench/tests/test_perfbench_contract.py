"""The benchmark's definition: names, files, imports and the frozen counts.

    python -m pytest perfbench/tests
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pita_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _imports(path):
    """Top-level names of every module a file imports, in any scope."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in list((HERE / "reference").glob("*.py")) + list((HERE / "frozen").glob("*.py")):
        assert "pita_torch" not in _imports(path), path


def test_loading_the_harness_and_reference_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import harness, port, checks, controls\n"
            "from perfbench.reference import egnn, sampler, train\n"
            "for d in ('sample', 'train'):\n"
            "    harness.load_module(harness.HERE / 'drivers' / (d + '.py'), 'd_' + d)\n"
            "import pita_torch.configs.registry, pita_torch.sampler.integrator\n"
            "F = %r\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & F))\n" % (str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"


def test_names_units_and_limits_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"], c
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_every_cell_reports_setup_a_rate_and_a_layer_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        has = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in has} and len(has) >= 2, w["name"]
        layer = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer, w["name"]
        for m in layer:  # a per-layer metric's cells report the metric it moves
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]]), (m, w)


def test_every_name_finds_its_files():
    assert BENCH["paths"] == ["perfbench"]
    for c in BENCH["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("perfbench/")
        assert json.loads(f.read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        tr = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "drivers" / f"{tr['driver']}.py").is_file()
        assert w["chips"] == 1
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_frozen_counts_give_the_recorded_readings():
    from perfbench.frozen import bounds as Bd

    ops = Bd.k4_f32_ops(64, 64, 55, 32)
    assert ops == pytest.approx(2.842e10, rel=1e-3)
    assert Bd.k4_f32_bound(64, 64, 55, 32)[0] == pytest.approx(0.1723, abs=5e-5)
    E = 256 * 55 * 54
    assert E * 8 * 32 * 32 + 2 * 256 * 55 * 10 * 32 * 32 == pytest.approx(6.517e9, rel=1e-3)
    assert Bd.k3_bound(256, 55, 32, Bd.PEAK_3XTF32)[0] == pytest.approx(0.0395, abs=5e-5)
    assert E * 4 * 32 * 32 + 256 * 55 * 10 * 32 * 32 == pytest.approx(3.258e9, rel=1e-3)
    assert Bd.k2_bound(256, 55, 32, Bd.PEAK_3XTF32)[0] == pytest.approx(0.0197, abs=5e-5)
    # the bf16 K2 and K3 at 2,048 chains: SFU-bound at 0.1425 ms (PERF.md's kernel table)
    assert Bd.k3_bound(2048, 55, 32, Bd.PEAK_BF16) == (pytest.approx(0.1425, abs=5e-5),
                                                        "operations")
    assert Bd.k2_bound(2048, 55, 32, Bd.PEAK_BF16)[0] == pytest.approx(0.1425, abs=5e-5)
