"""Nothing a run loads is JAX, flax or the JAX package (top-level module
names compared whole: ``epnn_tpu_torch`` begins with ``epnn_tpu``), the
reference loads nothing of the port, and ``BENCHMARK.json`` keeps to the
contract's names, units and layout."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
MODULES = sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE)
                 for f in fs if f.endswith(".py"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", MODULES,
                         ids=[os.path.relpath(p, HERE) for p in MODULES])
def test_no_jax_in_the_sources(path):
    assert not set(_imports(path)) & set(run.FORBIDDEN)


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh process holds after
    ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of a small cell on the CPU, the window and the check
    included."""
    names = _loaded(
        "from portbench import run\nfrom portbench.tests import small\n"
        "r = run.run_cell(small.spec(small.MD, 40), 5, "
        "0.5, True, 'cpu')\nassert r['correct'], r['checks']")
    assert not names & set(run.FORBIDDEN)
    assert "epnn_tpu_torch" in names


def test_the_reference_loads_nothing_of_the_port():
    names = _loaded("import portbench.reference.epnn64, portbench.compare")
    assert not names & (set(run.FORBIDDEN) | {"epnn_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "epnn_tpu_torch_x", types.ModuleType(
        "epnn_tpu_torch_x"))
    assert "epnn_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("x"))
    assert "flax" in run.forbidden_modules()


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_and_units():
    b = _bench()
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[k]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [r for c in b["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in b[k]]
        assert len(got) == len(set(got)), k


def test_benchmark_layout():
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric; every per-layer metric has a reader; every
    configuration is used and its file lies under the paths."""
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert any(w["config"] == c["name"] for w in b["workloads"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
    for w in b["workloads"]:
        spec = run.load_cell(w["name"])
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2, w
        assert spec["per_layer"], w
        for m in spec["per_layer"]:
            assert m["moves"] in e2e
            assert callable(run.reader(m["name"]).read)
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536
