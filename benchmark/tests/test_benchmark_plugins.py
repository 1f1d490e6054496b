"""A runner and a plain reference join the benchmark as files: in a copy of
the benchmark, new files and new manifest entries alone bring a cell
through the asynchronous engine (``ASAPPEngine``, its plain version on the
CPU), judged by a reference of its own; and every runner's traced work
counts the kernel calls it records."""

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT, cells, small

PROBE_RUNNER = textwrap.dedent('''
    """A probe runner: ASAPP ticks from the initialized state, as the CLI's
    async mode runs them, then rounding."""
    import contextlib

    SOURCES = ("TICK_SOURCE",)
    RECORDS_SCHEDULE = False
    STEP = "dpgo_ros_tpu_torch.ops.fused_asapp:asapp_tick_fused"


    def solve(eng, st, spans):
        from dpgo_ros_tpu_torch.ops import quadratic
        from dpgo_ros_tpu_torch.parallel.asapp import ASAPPEngine

        aeng = ASAPPEngine(eng.problem, eng.config)
        with spans("run"):
            ast, info = aeng.run(st.X, num_ticks=aeng.config.max_iteration_number,
                                 tol=aeng.config.asapp_tolerance)
            cost = float(quadratic.cost(ast.X, eng.problem.edges))
        return ast, info["ticks"], cost, 0, None


    def finalize(eng, st):
        from dpgo_ros_tpu_torch.ops import rounding

        T = rounding.anchor_to_first_pose(rounding.round_solution(st.X))
        return T.cpu().numpy(), st


    @contextlib.contextmanager
    def captured(calls):
        yield


    def work(g, r, calls):
        return {}, {}
''')

# the same runner with its answer altered where it is produced
FAULTY_RUNNER = PROBE_RUNNER + textwrap.dedent('''

    _finalize = finalize


    def finalize(eng, st):
        T, st = _finalize(eng, st)
        T[len(T) // 2:, :, 3] += 0.05
        return T, st
''')

PROBE_REFERENCE = textwrap.dedent('''
    """A probe reference: the rounding of the final state alone."""
    from benchmark.reference import lifting_matrix, rounded  # noqa: F401

    NUMBERS = ("rounding",)
    EXACT = ()
''')


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def add(root, rel, text):
    path = root / rel
    assert not path.exists(), rel  # new files only
    path.write_text(text)


def test_a_runner_and_a_reference_join_as_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "dpgo_ros_tpu_torch").symlink_to(ROOT / "dpgo_ros_tpu_torch")
    before = digests(tmp_path / "benchmark")

    demo = json.loads((ROOT / "benchmark" / "configs" / "dpgo_demo.json").read_text())
    config = dict(demo, name="asapp_probe", reference="probe",
                  solver=dict(demo["solver"], asynchronous=True, asynchronous_rate=100.0,
                              RGD_stepsize=0.2, max_delayed_iterations=3,
                              max_iteration_number=60))
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "warm.json").read_text())
    add(tmp_path, "benchmark/runners/probe_asapp.py", PROBE_RUNNER)
    add(tmp_path, "benchmark/runners/probe_asapp_faulty.py", FAULTY_RUNNER)
    add(tmp_path, "benchmark/references/probe.py", PROBE_REFERENCE)
    add(tmp_path, "benchmark/configs/asapp_probe.json", json.dumps(config))
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(manifest["configs"][0], name="asapp_probe",
                                    file="benchmark/configs/asapp_probe.json"))
    cells = []
    for runner in ("probe_asapp", "probe_asapp_faulty"):
        add(tmp_path, f"benchmark/traffic/{runner}.json",
            json.dumps(dict(traffic, runner=runner, warmup=1, kept_states=2)))
        add(tmp_path, f"benchmark/limits/asapp_probe.{runner}.json",
            json.dumps({"rounding": 0.0015}))
        cells.append(f"asapp_probe.{runner}")
        manifest["workloads"].append(dict(manifest["workloads"][0], name=cells[-1],
                                          config="asapp_probe", traffic=runner))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    code = textwrap.dedent("""
        import json, sys
        from benchmark import harness
        m = harness.load_json(harness.ROOT / "BENCHMARK.json")
        out = {c: harness.run_cell(m, c, 2**31 + 21, 0.3, False, device="cpu",
                                   world_override={"n": 100}, log=lambda s: None)
               for c in sys.argv[1:]}
        print(json.dumps({"bench": str(harness.BENCH), "out": out}))
    """)
    r = subprocess.run([sys.executable, "-c", code, *cells], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["bench"] == str(tmp_path / "benchmark")  # the copy's harness ran
    sound, faulty = (res["out"][c] for c in cells)
    assert sound["correct"] is True and sound["failed"] == 0, sound["checks"]
    assert set(sound["checks"]) == {"rounding"} and sound["attempted"] >= 1
    assert faulty["correct"] is False and faulty["failed"] >= 1, faulty["checks"]
    assert faulty["checks"]["rounding"]["value"] >= 0.05
    after = digests(tmp_path / "benchmark")
    assert {k: after.get(k) for k in before} == before  # no file of the copy was edited


@pytest.mark.parametrize("cell", cells())
def test_a_runner_counts_the_kernel_calls_it_records(manifest, cell):
    c = harness.Cell.load(manifest, cell, False)
    world, solver = small(cell)
    c.config = dict(c.config, world=dict(c.config["world"], **world),
                    solver=dict(c.config["solver"], **solver))
    cpu = torch.device("cpu")
    traffic = harness.Traffic(c, 2**31 + 3, cpu, harness.Spans(cpu))
    calls = []
    with c.runner.captured(calls):
        rec = traffic.request(0)
    g = traffic.graphs[rec["graph"]]
    work, launches = harness.traced_work(c.runner, traffic.graphs, traffic.prog.r,
                                         [(g, calls), (g, calls)])
    own, n = c.runner.work(g, traffic.prog.r, calls)
    assert calls and n and all(v == len(calls) for v in n.values())
    assert set(work) == set(own) and set(launches) == set(n)  # the cell's runner's keys alone
    for k, v in own.items():  # each request counted once
        assert work[k] == 2 * v and v > 0
    assert launches == {k: 2 * v for k, v in n.items()}
    assert (rec["sched"] is not None) == c.runner.RECORDS_SCHEDULE
    assert sum(v for k, v in own.items() if k.endswith("_tcg")) == rec["tcg"]
