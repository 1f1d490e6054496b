"""The port's measurement scripts (``dpgo_ros_tpu_torch/scripts/``) on the
CPU, cut to small worlds: each refuses to start without a card unless
``--device cpu`` is passed; with it, each prints exactly one JSON line on
stdout that names the card (here the CPU, with no power limit), launches
no kernel (CPU tensors run the plain versions) and holds its records; each
refuses an ``--out`` that names one of the repository's root records and
leaves that file as it was. ``bench``'s run is ``tests/test_torch_bench.py``'s.
"""

import importlib
import json
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

# script: (small CPU arguments, the root record its JAX counterpart writes)
RUNS = {
    "golden_solves": (["tinyGrid3D"], "golden_optima.json"),
    "record_ate": (["--world", "tinyGrid3D", "--gnc_world", "tinyGrid3D",
                    "--outlier_ratio", "0.5", "--dtype", "float64"], "ATE_r02.json"),
    "run_baselines": (["1"], "baseline_results.json"),
    "bench_scale_hbm": (["--sizes", "256:2:k1", "--k_solves", "2"], "HBM_SCALE_r05.json"),
    "bench_scale": (["--sizes", "256:3", "--iters", "2", "--k_chain", "2"],
                    "baseline_results.json"),
    "bench_asapp": (["--world", "tinyGrid3D", "--ticks", "1,2", "--reps", "1"],
                    "baseline_results.json"),
    "bench_spmd_stretch": (["--world", "tinyGrid3D", "--m1_strides", "1,2", "--m1_iters",
                            "2", "--m8_strides", "1,2", "--m8_iters", "2"],
                           "SPMD_STRETCH_r05.json"),
    "record_staircase": ([], "STAIRCASE_r04.json"),
}


def _script(name: str):
    return importlib.import_module(f"dpgo_ros_tpu_torch.scripts.{name}")


def _launches(obj) -> list:
    """Every ``launches`` / ``*_launches`` dict nested in ``obj``."""
    if isinstance(obj, dict):
        own = [v for k, v in obj.items()
               if (k == "launches" or k.endswith("_launches")) and isinstance(v, dict)]
        return own + [d for v in obj.values() for d in _launches(v)]
    if isinstance(obj, list):
        return [d for v in obj for d in _launches(v)]
    return []


@pytest.mark.parametrize("name", list(RUNS))
def test_script_runs_on_the_cpu(name, capsys):
    args, _ = RUNS[name]
    out = _script(name).main(args + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(out))
    cards = [out["card"]] if "card" in out else [v["card"] for v in out.values()]
    assert cards and all(c["name"] == "cpu" and c["power_limit"] is None for c in cards)
    counts = _launches(out)  # the certified solves run no kernel: fp64, plain
    assert counts or name in ("golden_solves", "record_staircase")
    assert all(set(d.values()) == {0} for d in counts)
    if name == "golden_solves":
        assert out["tinyGrid3D"]["certified"] and out["tinyGrid3D"]["rank"] == 5
    if name == "record_staircase":
        assert out["ok"] and out["rows"][0]["ranks_tried"][0] == 3
    if name == "record_ate":
        gnc = out["tinyGrid3D_8robot_gnc_schedule_independence"]
        assert gnc["round_robin"]["outliers"]["planted"] == 1
        assert "distributed_ate_vs_ground_truth" in out["tinyGrid3D_5robot_vs_centralized"]
    if name == "bench_scale_hbm":
        row = out["rows"][0]
        assert row["k4_tcg_per_solve"] > 0 and row["k1_tcg_per_solve"] > 0


@pytest.mark.parametrize("name", list(RUNS))
def test_script_refuses_without_a_card_and_root_records(name):
    args, record = RUNS[name]
    main = _script(name).main
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            main(args)
    path = REPO / record
    before = path.read_bytes()
    with pytest.raises(SystemExit) as e:
        main(args + ["--device", "cpu", "--out", str(path)])
    assert e.value.code == 2
    assert path.read_bytes() == before
