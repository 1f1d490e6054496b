"""The bank rows' windows that K2 solves on, and the cluster's slices.

1. ``prepare_row_windows``: per bank row (one robot, or a Parallel colour
   class), the plain windowed solve in fp64 equals the full-width masked
   solve under the row's mask (the same function, the same TR and tCG
   counts; X and f − f0 to 1e-9), on a banded and an irregular world.
2. The cluster of one launch: its size follows the largest window, and
   every row's slices cover its window's poses in order, balanced by work.
3. ``rtr_run_fused``'s window operands: none, the wrong number of rows,
   another world's windows, windows on another device or of another dtype,
   or blocks that are not the bank rows raise; the fused runner passes the
   windows of its rule's bank rows, and robot rows share the engine's
   (K4's) windows.
The CUDA kernels themselves run only on the card (``python3 chip_smoke.py``;
the ``cuda``-marked case here skips without one).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dpgo_ros_tpu_torch.io.synthetic import add_random_loop_closures, generate_world
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr, quadratic, stiefel
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.utils.config import AgentConfig, UpdateRule
from torch_parity import rel_err, world

DEMO = RTRParams(max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5)


def _problem(name, dtype=torch.float64, device="cpu"):
    """A 300-pose 6-robot sphere (robots adjacent along the band only),
    banded or with 12 loop closures between random pose pairs, and a noisy
    state of it."""
    data, gt, _ = generate_world("sphere", n=300, num_robots=6, seed=3)
    if name == "irregular":
        data = add_random_loop_closures(data, gt, 12, seed=7)
    prob = LiftedProblem.from_data(data, r=5, dtype=dtype, device=device)
    rng = np.random.default_rng(11)
    Yl, _ = np.linalg.qr(rng.standard_normal((5, 3)))
    X = np.einsum("rd,ndk->nrk", Yl, gt)
    V = rng.standard_normal(X.shape)
    V[..., :-1] *= 0.05
    V[..., -1] *= 0.5
    X = stiefel.retract_polar_ns(torch.as_tensor(X, dtype=dtype),
                                 torch.as_tensor(V, dtype=dtype))
    return prob, X.to(device)


def _engine(prob, rule):
    return RBCDEngine(prob, AgentConfig(num_robots=prob.num_robots, update_rule=rule,
                                        dtype="float64" if prob.dtype == torch.float64
                                        else "float32"))


@pytest.mark.parametrize("name", ["banded", "irregular"])
@pytest.mark.parametrize("rule", [UpdateRule.ROUND_ROBIN, UpdateRule.PARALLEL])
def test_row_window_solve_equals_full_width_fp64(name, rule):
    prob, X = _problem(name)
    eng = _engine(prob, rule)
    w = eng._row_windows
    bank, _ = eng.mask_bank_and_schedule(1)
    assert w.num_rows == bank.shape[0]
    if rule == UpdateRule.PARALLEL:
        assert w.num_rows == eng.num_colors and any(len(r) > 1 for r in w.rows)
    Pinv = quadratic.precond_inverse(quadratic.precond_blocks(prob.edges, prob.n))
    for row in range(w.num_rows):
        mask = bank[row]
        X_w, s_w = hbm_rtr.rtr_solve_hbm_ref(X, row, Pinv, prob.edges, DEMO, w)
        X_f, res = rtr_solve(X, prob.edges, mask.reshape(-1, 1, 1), Pinv, DEMO)
        X_f = torch.where(mask[:, None, None] > 0, X_f, X)
        assert int(s_w[4]) == res.iterations and int(s_w[5]) == res.tcg_iterations
        assert float(s_w[1] - s_w[0]) == pytest.approx(
            float(res.f_opt - res.f_init), rel=1e-9)
        assert rel_err(X_w.numpy(), X_f.numpy()) < 1e-9
        assert torch.equal(X_w[mask == 0], X[mask == 0])


def test_row_windows_hold_their_blocks():
    prob, _ = _problem("irregular")
    w = hbm_rtr.prepare_row_windows(prob, [(0, 2), (1,)])
    bounds = np.concatenate([prob.offsets, [prob.n]])
    poses, *_ = w.window(0)
    blk = list(range(bounds[0], bounds[1])) + list(range(bounds[2], bounds[3]))
    assert poses.tolist()[: len(blk)] == blk and w.num_poses[0] == len(blk)
    assert w.rows == ((0, 2), (1,)) and w.row_robots.tolist() == [0, 2, 1]
    assert w.meta[:, 3].tolist() == [0, 2, 3]
    with pytest.raises(ValueError):
        hbm_rtr.prepare_row_windows(prob, [(2, 0)])


@pytest.mark.parametrize("max_poses, size", [(1, 2), (256, 2), (600, 3),
                                             (3573, 14), (10 ** 6, 16)])
def test_cluster_size_follows_the_largest_window(max_poses, size):
    assert hbm_rtr.cluster_size(max_poses) == size


def test_slices_cover_every_window_balanced_by_work():
    prob, _ = _problem("irregular")
    w = hbm_rtr.prepare_windows(prob)
    part = w.part.numpy()
    assert part.shape == (w.num_rows, w.cluster + 1)
    for row in range(w.num_rows):
        nw = int(w.pose_off[row + 1] - w.pose_off[row])
        assert part[row, 0] == 0 and part[row, -1] == nw
        assert (np.diff(part[row]) >= 0).all()
        pull = w.window(row)[4].numpy()
        ew = int(w.edge_off[row + 1] - w.edge_off[row])
        work = (pull < 2 * ew).sum(1) + float(hbm_rtr.POSE_WORK)
        per = [work[a:b].sum() for a, b in zip(part[row][:-1], part[row][1:])]
        assert max(per) <= work.sum() / w.cluster + work.max()
    assert w.slice_max == int(np.diff(part, axis=1).max())
    cut = hbm_rtr.partition(np.array([1.0, 1, 1, 1, 4]), 2)
    assert cut.tolist() == [0, 4, 5]


def _run_operands():
    prob, X = _problem("banded", torch.float32)
    eng = _engine(prob, UpdateRule.ROUND_ROBIN)
    bank, sched = eng.mask_bank_and_schedule(4)
    kw = dict(adj=eng._adjf, rel0=torch.full((6,), float("inf")), it0=0,
              last_wu=0, gnc_pending=False, cost0=1.0, it_cap=4, tol=0.0,
              gnc=False, inner=1, inner_tol=None, offsets=eng._offsets)
    args = [X, bank, sched, eng._solver_cache(prob.edges), prob.edges, DEMO]
    return prob, eng, args, kw


@pytest.mark.parametrize("bad", ["missing", "rows", "other_world", "device", "dtype",
                                 "blocks"])
def test_run_wrapper_rejects_bad_windows(bad):
    prob, eng, args, kw = _run_operands()
    w = eng._row_windows
    err = ValueError
    if bad == "missing":  # the windows are a required operand, on every device
        with pytest.raises(TypeError):
            fused_rtr.rtr_run_fused(*args, **kw)
    elif bad == "rows":
        w = hbm_rtr.prepare_row_windows(prob, [(0,), (1,)])
    elif bad == "other_world":
        data, _ = world("grid3d4")
        other = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
        w = hbm_rtr.prepare_row_windows(other, [(0,), (1,), (0, 1)] * 2)
    elif bad == "device":
        w = dataclasses.replace(w, part=w.part.to("meta"))
    elif bad == "dtype":
        w, err = dataclasses.replace(w, pull=w.pull.long()), TypeError
    else:
        w = hbm_rtr.prepare_row_windows(prob, [(0, 1), (2,), (3,), (4,), (5,), (1,)])
        assert w.num_poses.tolist() != eng._row_windows.num_poses.tolist()
    if bad != "missing":
        with pytest.raises(err):
            fused_rtr.rtr_run_fused(*args, windows=w, **kw)
    stats = fused_rtr.rtr_run_fused(*args, windows=eng._row_windows, **kw)[2]
    assert int(stats[fused_rtr.RUN_STEPS]) == 4


@pytest.mark.parametrize("rule", [UpdateRule.ROUND_ROBIN, UpdateRule.UNIFORM])
def test_robot_rows_share_the_engines_windows(rule):
    """A robot bank row's window is the robot's: K2 and K4 share one table."""
    prob, _ = _problem("banded")
    eng = _engine(prob, rule)
    assert eng._row_windows is eng._windows
    assert eng._windows.rows == tuple((k,) for k in range(prob.num_robots))


@pytest.mark.parametrize("rule", [UpdateRule.UNIFORM, UpdateRule.PARALLEL])
def test_fused_runner_passes_its_bank_rows_windows(monkeypatch, rule):
    prob, _ = _problem("banded")
    eng = _engine(prob, rule)
    seen = []
    real = fused_rtr.rtr_run_fused
    monkeypatch.setattr(fused_rtr, "rtr_run_fused",
                        lambda *a, **k: seen.append(k["windows"]) or real(*a, **k))
    eng.make_fused_run(3)(eng.initialize(ylift=np.eye(5, 3)))
    (w,) = seen
    bank, _ = eng.mask_bank_and_schedule(3)
    assert w is eng._row_windows and w.num_rows == bank.shape[0]
    assert w.num_poses.tolist() == (bank > 0).sum(1).tolist()


@pytest.mark.cuda
def test_cluster_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 chip_smoke.py)")
    prob, X = _problem("banded", torch.float32, device="cuda")
    eng = _engine(prob, UpdateRule.PARALLEL)
    bank, sched = eng.mask_bank_and_schedule(4)
    kw = dict(adj=eng._adjf, rel0=torch.full((6,), float("inf"), device="cuda"),
              cost0=quadratic.cost(X, prob.edges).reshape(1), offsets=eng._offsets,
              it0=0, last_wu=0, gnc_pending=False, it_cap=4, tol=0.0, gnc=False,
              inner=1, inner_tol=None, record=False, rgd_stepsize=0.0)
    args = (X, bank, sched, eng._solver_cache(prob.edges), prob.edges, DEMO)
    X_k, _, s_k = fused_rtr.rtr_run_fused(*args, windows=eng._row_windows, **kw)
    X_k2, _, s_k2 = fused_rtr.rtr_run_fused(*args, windows=eng._row_windows, **kw)
    X_p, _, s_p = fused_rtr.rtr_run_fused_ref(*args, **kw)
    assert torch.equal(X_k, X_k2) and torch.equal(s_k, s_k2)
    assert int(s_k[1]) == int(s_p[1]) == 4 and int(s_k[3]) == int(s_p[3])
    assert rel_err(X_k.cpu(), X_p.cpu()) < 1e-4
