"""What a run imports: never JAX or the JAX package (top-level names compared
whole); and nothing of the program in the yardstick's own modules."""

import ast
import json
import subprocess
import sys
import textwrap

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

YARDSTICK = ["reference.py", "world.py", "compare.py", "work.py", "gauge.py",
             "host_reads.py", "trace.py", "blocks.py"]
# every plain reference, found by glob: none may import the program
YARDSTICK += sorted(str(p.relative_to(ROOT / "benchmark"))
                    for p in (ROOT / "benchmark" / "references").glob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    mods = imported(ROOT / "benchmark" / name)
    assert not mods & {"dpgo_ros_tpu_torch", "dpgo_ros_tpu", "jax", "jaxlib", "flax"}


def test_no_module_anywhere_in_the_benchmark_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not imported(path) & {"dpgo_ros_tpu", "jax", "jaxlib", "flax"}, path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dpgo_ros_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxish", object())
    assert not {"dpgo_ros_tpu_torch_fake", "jaxish"} & set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "dpgo_ros_tpu.fake", object())
    assert "dpgo_ros_tpu.fake" in harness.forbidden_modules()


def test_a_run_loads_no_jax_module():
    code = textwrap.dedent("""
        import json, sys
        from benchmark import harness
        from benchmark.tests.conftest import small_run
        m = harness.load_json(harness.ROOT / "BENCHMARK.json")
        out = small_run(m, "dpgo_demo.warm")
        print(json.dumps({"loaded": harness.forbidden_modules(), "correct": out["correct"]}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and res["correct"] is True


def test_a_module_a_metric_reader_loads_is_caught(manifest, monkeypatch):
    from benchmark.tests.conftest import small_run

    def reader(name):
        def read(run):
            monkeypatch.setitem(sys.modules, "jax", object())
            return None
        return read

    monkeypatch.setattr(harness, "reader", reader)
    with pytest.raises(harness.ForbiddenImport):
        small_run(manifest, "dpgo_demo.warm")
