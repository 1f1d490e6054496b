"""The kernel layer (``ops/kernels.py``): the one operand-check guard of
K1, K2, K3, K4 and K7, the build names the benchmark reads through
``fused_rtr``, and the module's import boundary.

1. Each kernel's full operand checks run on its first call and again only
   when what they read changed: a long-lived operand written in place or
   replaced by a new tensor, or a per-call operand of a new layout (a
   non-contiguous X, which the checks then refuse). The engine's per-row
   mask and schedule views hit. A bad operand raises on its first call. A
   tensor made in inference mode keeps no version, so such calls are
   checked every time. On the CPU: K1–K4 through their wrappers (given
   windows), K7 through ``nesterov.checked``, the card path's checks.
2. ``fused_rtr.build_all`` and ``fused_rtr.*_SOURCE`` are the kernel
   module's own objects; the kernel module imports nothing of the package.
3. (``cuda``) On the card K1–K4 take κ_eff/τ_eff from
   ``Windows.effective_weights``: once per weight set.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_asapp, fused_rtr, hbm_rtr, kernels, nesterov
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.utils import profiling
from dpgo_ros_tpu_torch.utils.config import AgentConfig

QUICK = RTRParams(max_iterations=1, max_tcg_iterations=3)
KERNELS = ["k1", "k2", "k3", "k4", "k7"]
# each kernel's full check, counted by the tests
FULL_CHECK = {"k1": (kernels, "checked_operands"), "k2": (fused_rtr, "_check_run"),
              "k3": (fused_asapp, "_check"), "k4": (kernels, "checked_operands"),
              "k7": (nesterov, "check_operands")}


def _engine(device="cpu", dtype=torch.float64):
    data, _, _ = generate_world("sphere", n=120, num_robots=3, seed=1)
    prob = LiftedProblem.from_data(data, r=5, dtype=dtype, device=device)
    name = "float64" if dtype == torch.float64 else "float32"
    eng = RBCDEngine(prob, AgentConfig(num_robots=3, dtype=name))
    return eng, eng.initialize(ylift=np.eye(5, 3)).X


def _case(kernel, device="cpu", dtype=torch.float64):
    """(run, ops): ``run(ops)`` calls ``kernel`` once as the engine does
    (its mask or schedule row a view taken afresh), on ``ops["X"]`` and the
    long-lived operand ``ops["held"]`` (P⁻¹; K7's mask bank); ``ops["weight"]``
    the edges' weights."""
    eng, X = _engine(device, dtype)
    e, w = eng.problem.edges, eng._windows
    ops = {"X": X, "held": eng._solver_cache(e), "weight": e.weight}
    if kernel == "k1":
        run = lambda o: fused_rtr.rtr_solve_fused(o["X"], eng._masks[0], o["held"], e,
                                                  QUICK, windows=w, row=0)
    elif kernel == "k2":
        run = lambda o: fused_rtr.rtr_run_fused(
            o["X"], eng._bank, eng._row_sched[1], o["held"], e, QUICK, adj=eng._adjf,
            rel0=eng._rel_zero, it0=0, last_wu=0, gnc_pending=False, cost0=0.0,
            it_cap=1, tol=0.0, gnc=False, inner=1, inner_tol=None,
            offsets=eng._offsets, windows=eng._row_windows)
    elif kernel == "k3":
        hist = X.expand(3, *X.shape).contiguous()
        delays = torch.zeros(3, dtype=torch.int32, device=X.device)
        run = lambda o: fused_asapp.asapp_tick_fused(
            o["X"], hist, eng._onehot, o["held"], e, delays, 0.1, 1, True,
            eng._offsets, windows=w)
    elif kernel == "k4":
        run = lambda o: hbm_rtr.rtr_solve_hbm(o["X"], 0, o["held"], e, QUICK, w)
    else:
        X32 = X.float()
        Z, X_prev, V = (X32 + s for s in (0.01, 0.02, 0.03))
        beta = torch.tensor([0.3])
        ops = {"X": X32, "held": eng._onehot.float()}
        run = lambda o: nesterov.checked(Z, o["X"], X_prev, V, o["held"][1], beta)
    return run, ops


def _counted(monkeypatch, kernel):
    module, name = FULL_CHECK[kernel]
    real, calls = getattr(module, name), []
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return lambda: len(calls)


@pytest.mark.parametrize("kernel", KERNELS)
def test_full_checks_run_once_per_operand_set(monkeypatch, kernel):
    run, ops = _case(kernel)
    checks = _counted(monkeypatch, kernel)
    for _ in range(3):
        run(ops)
    assert checks() == 1
    ops["held"].mul_(1.0)  # a write in place: its version moves
    run(ops), run(ops)
    assert checks() == 2
    ops["held"] = ops["held"].clone()  # a new tensor
    run(ops), run(ops)
    assert checks() == 3
    good = ops["X"]
    ops["X"] = good.transpose(1, 2).contiguous().transpose(1, 2)  # a new layout
    with pytest.raises(ValueError, match="X is not contiguous"):
        run(ops)
    assert checks() == 4
    ops["X"] = good
    run(ops)
    assert checks() == 4


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_bad_operand_raises_on_its_first_call(monkeypatch, kernel):
    run, ops = _case(kernel)
    good = ops["held"]
    wrong = torch.float32 if good.dtype == torch.float64 else torch.float64
    ops["held"] = good.to(wrong)
    with pytest.raises(TypeError, match="expected"):
        run(ops)
    ops["held"] = good
    checks = _counted(monkeypatch, kernel)
    run(ops), run(ops)
    assert checks() == 1


@pytest.mark.parametrize("kernel", KERNELS)
def test_operands_made_in_inference_mode_are_checked_every_call(monkeypatch, kernel):
    run, ops = _case(kernel)
    checks = _counted(monkeypatch, kernel)
    with torch.inference_mode():
        ops["held"] = ops["held"].clone()
        out = [run(ops) for _ in range(3)]
    assert checks() == 3
    if kernel != "k7":
        assert all(torch.equal(o[0], out[0][0]) for o in out)


def test_fused_rtr_reexports_the_kernel_modules_build_and_sources():
    """The benchmark's set-up reads ``build_all`` and the ``*_SOURCE``
    constants from ``fused_rtr``: they are the kernel module's."""
    assert fused_rtr.build_all is kernels.build_all
    assert fused_rtr.SOURCE is kernels.BLOCK_SOURCE
    for name in ("RUN_SOURCE", "TICK_SOURCE", "WINDOW_SOURCE", "PEAK_SOURCE",
                 "EXTRAP_SOURCE"):
        assert getattr(fused_rtr, name) is getattr(kernels, name)
    assert set(kernels.ALL_SOURCES) == {getattr(fused_rtr, n) for n in (
        "SOURCE", "RUN_SOURCE", "TICK_SOURCE", "WINDOW_SOURCE", "PEAK_SOURCE",
        "EXTRAP_SOURCE")}


def test_kernel_module_imports_nothing_of_the_package():
    tree = ast.parse(Path(kernels.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.startswith("dpgo_ros_tpu")], names


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4"])
def test_window_kernels_take_effective_weights_once_per_weight_set(kernel):
    """On the card each window kernel takes κ_eff/τ_eff from its windows:
    ``k4.weights`` + 1 on the first launch and after the weights change in
    place, not across launches with the same weights; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: pytest --noconftest -m cuda)")
    run, ops = _case(kernel, device="cuda", dtype=torch.float32)
    count = lambda: profiling.counters().get("k4.weights", 0)
    launches = profiling.launches()[kernel]
    before = count()
    run(ops), run(ops)
    assert count() == before + 1
    ops["weight"].mul_(1.0)
    run(ops), run(ops)
    assert count() == before + 2
    torch.cuda.synchronize()
    assert profiling.launches()[kernel] == launches + 4
