"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re

from benchmark import harness
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def load():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_sizes():
    m = load()
    assert set(m) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/")
                                              and ".." not in p for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(TEXT.match(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check with 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    m = load()
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
    metrics = m["end_to_end"] + m["per_layer"]
    names += [x["name"] for x in metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in m["configs"])) == len(m["configs"])
    assert len(set(w["name"] for w in m["workloads"])) == len(m["workloads"])
    assert len(set(x["name"] for x in metrics)) == len(metrics)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        # no width is cut; a stand-in world is listed as a change from the source
        assert set(c["reduced"]) <= {"world"} and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1 and TEXT.match(w["why"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in m["configs"]} == {w["config"] for w in m["workloads"]}
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{x['name']}.py").is_file()


def test_metrics_and_cells():
    m = load()
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    reports = {c: {x["name"] for x in m["end_to_end"] if c in x.get("workloads", cells)}
               for c in cells}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        assert TEXT.match(x["layer"]) and x["moves"] in e2e
        assert set(x["workloads"]) <= cells
        assert all(x["moves"] in reports[c] for c in x["workloads"])
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert any(c in x["workloads"] for x in m["per_layer"])


def test_configs_state_their_settings():
    m = load()
    for c in m["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
        assert cfg["solver"]["dtype"] == "float32"
        assert cfg["world"]["n"] == 2500


def test_limits_are_positive_and_named():
    m = load()
    cfgs = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in m["configs"]}
    for w in m["workloads"]:
        lim = json.loads((ROOT / "benchmark" / "limits" / f"{w['name']}.json").read_text())
        plain = harness.reference_of(cfgs[w["config"]])
        known, exact = set(plain.NUMBERS), set(plain.EXACT)  # exact: counts
        assert lim and set(lim) <= known | exact
        assert all(v > 0 for k, v in lim.items() if k in known)
        assert all(v == 0 for k, v in lim.items() if k in exact)
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        if harness.runner(traffic["runner"]).RECORDS_SCHEDULE:
            assert "schedule" in lim  # a cell whose runner records it holds its loop to the rule
