"""Port parity: the large-world block solve (K4) and its engine route.

1. ``prepare_windows``: each robot's window holds exactly the edges with an
   endpoint in its block, in global order, its separators are their far
   endpoints, and each block pose's local pull row is its global row,
   renumbered (banded, lattice and irregular graphs).
2. The port's ``rtr_solve_hbm`` on CPU tensors (its plain version) in fp32
   against the JAX Pallas kernel in interpret mode, with the tolerances of
   tests/test_hbm_rtr.py (window sums reorder fp32 adds): the same TR and
   tCG counts, gn rel ≤ 1e-3, X ≤ 1e-3 of max |X|, f − f0 rel ≤ 1e-3 (f is
   a local cost in both packages, over different windows, so only its
   change compares).
3. The windowed plain solve against JAX ``rtr_solve`` full-width under the
   block mask in fp64: X to 1e-9 and the same counts.
4. The engine's windowed RoundRobin route against the JAX fp64 XLA engine
   (full-width solves): X, cost and rel-change histories to 1e-7, and the
   final state's cost against JAX's ``quadratic.cost`` of its X to 1e-9;
   L2 and GNC-TLS.
5. Routing: which entry point each rule and mode takes.
6. The wrapper's operand checks, and K4 in the build.
The CUDA kernel itself runs only on the card (``python3 chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models import local_solvers as j_ls
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import fused_rtr as j_fused
from dpgo_ros_tpu.ops import hbm_rtr as j_hbm
from dpgo_ros_tpu.ops import quadratic as j_quad
from dpgo_ros_tpu.parallel.rbcd import RBCDEngine as JaxEngine
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)
from dpgo_ros_tpu_torch.io.synthetic import add_random_loop_closures, generate_world
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr, kernels, quadratic, stiefel
from dpgo_ros_tpu_torch.parallel import rbcd
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.utils import profiling
from torch_parity import port_config, rel_err, world

DEMO = dict(max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5)


def _world(name):
    """(data, ground truth) of a named world; "irregular" is sphere256 with
    40 loop closures between random pose pairs."""
    if name == "irregular":
        data, gt = world("sphere256")
        return add_random_loop_closures(data, gt, 40, seed=7), gt
    return world(name)


def _on_manifold_state(gt, seed, dtype=torch.float64):
    """Lifted ground truth moved by a random ambient step and retracted, so
    the block solves make real progress."""
    rng = np.random.default_rng(seed)
    Yl, _ = np.linalg.qr(rng.standard_normal((5, gt.shape[1])))
    X = np.einsum("rd,ndk->nrk", Yl, gt)
    V = rng.standard_normal(X.shape)
    V[..., :-1] *= 0.05
    V[..., -1] *= 0.5
    return stiefel.retract_polar_ns(
        torch.as_tensor(X, dtype=dtype), torch.as_tensor(V, dtype=dtype))


# ------------------------------------------------------------ 1. windows


@pytest.mark.parametrize("name", ["sphere256", "grid3d4", "irregular"])
def test_windows_hold_exactly_the_incident_edges(name):
    data, _ = _world(name)
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    w = hbm_rtr.prepare_windows(tp)
    he = tp.host_edges
    src, dst, E = he.src.tolist(), he.dst.tolist(), len(he.src)
    bounds = np.concatenate([tp.offsets, [tp.n]]).tolist()
    assert w.offsets.tolist() == bounds and w.num_robots == tp.num_robots
    for k in range(tp.num_robots):
        a, b = bounds[k], bounds[k + 1]
        inb = lambda i: a <= i < b
        want = [e for e in range(E) if inb(src[e]) or inb(dst[e])]
        seps = sorted({i for e in want for i in (src[e], dst[e]) if not inb(i)})
        poses, eids, lsrc, ldst, pull = (t.tolist() for t in w.window(k))
        assert eids == want
        assert poses == list(range(a, b)) + seps
        assert [poses[i] for i in lsrc] == [src[e] for e in want]
        assert [poses[i] for i in ldst] == [dst[e] for e in want]
        El = len(want)
        to_global = lambda j: want[j] if j < El else E + want[j - El]
        for li in range(b - a):
            row = [to_global(j) for j in pull[li] if j != 2 * El]
            grow = [j for j in he.pull[a + li].tolist() if j != 2 * E]
            assert row == grow, (k, li)
    assert w.max_poses == max(np.diff(w.pose_off))
    assert w.max_edges == max(np.diff(w.edge_off))


# ------------------------------------------------- 2. vs the Pallas kernel


@pytest.fixture(scope="module")
def k4_world():
    """The JAX package's own K4 fixture (tests/test_hbm_rtr.py): the 1,200-
    pose 5-robot synthetic sphere, Odometry init, fp32."""
    data, _, _ = generate_world("sphere", n=1200, num_robots=5, seed=0)
    jp = JaxProblem.from_data(data, r=5, dtype=jnp.float32)
    cfg = AgentConfig(
        num_robots=5, update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.ODOMETRY, RTR_gradnorm_tol=0.5,
        dtype="float32", use_fused_kernel=True,
    )
    je = JaxEngine(jp, cfg)
    st = je.initialize()
    e = je._edges(st.weights)
    Pinv = je._precond_inv(e)
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
    return jp, je, st, e, Pinv, tp, hbm_rtr.prepare_windows(tp)


@pytest.mark.parametrize("robot", [0, 2])
def test_plain_version_matches_pallas_interpret(k4_world, robot):
    jp, je, st, e, Pinv, tp, windows = k4_world
    kg = je._kg
    assert kg.E_loop == 0
    o, nk = kg.offsets[robot], kg.num_poses[robot]
    Xt, sj = j_hbm.rtr_solve_hbm(
        j_fused.to_t(st.X, kg.n_pad), jnp.asarray(o, jnp.int32),
        jnp.asarray(nk, jnp.int32), j_fused.pinv_to_t(Pinv, kg.n_pad),
        kg.weight_rows(e, e.weight), kg, je.rtr_params, interpret=True,
    )
    X_j = np.asarray(j_fused.from_t(Xt, jp.n, 5, 4))
    sj = np.asarray(sj)[0]
    X = torch.as_tensor(np.array(st.X))
    launches = profiling.launches()["k4"]
    X_t, s_t = hbm_rtr.rtr_solve_hbm(
        X, robot, torch.as_tensor(np.array(Pinv)), tp.edges,
        RTRParams(**DEMO), windows,
    )
    assert profiling.launches()["k4"] == launches  # CPU tensors: plain version
    s_t = s_t.numpy()
    assert s_t.shape == (hbm_rtr.STATS_LEN,)
    assert int(s_t[4]) == int(sj[4]) and int(s_t[5]) == int(sj[5])
    assert s_t[3] == pytest.approx(float(sj[3]), rel=1e-3)
    assert (s_t[1] - s_t[0]) == pytest.approx(float(sj[1] - sj[0]), rel=1e-3)
    assert s_t[hbm_rtr.S_MOVED] == pytest.approx(float(sj[6]), rel=1e-3)
    assert rel_err(X_t.numpy(), X_j) < 1e-3
    out = np.ones(jp.n, bool)
    out[o:o + nk] = False
    assert torch.equal(X_t[out], X[out])  # only the block moved


# ------------------------------------------------- 3. vs XLA, fp64


@pytest.mark.parametrize("name", ["sphere256", "irregular"])
def test_windowed_plain_solve_matches_jax_full_width_fp64(name):
    data, gt = _world(name)
    jp = JaxProblem.from_data(data, r=5, dtype=jnp.float64)
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    windows = hbm_rtr.prepare_windows(tp)
    X = _on_manifold_state(gt, seed=21)
    Pinv = quadratic.precond_inverse(quadratic.precond_blocks(tp.edges, tp.n))
    for robot in range(tp.num_robots):
        mask = tp.block_mask(robot).numpy()
        X_j, res = j_ls.rtr_solve(
            jnp.asarray(X.numpy()), jp.edges, jnp.asarray(mask),
            jnp.asarray(Pinv.numpy()), j_ls.RTRParams(**DEMO),
        )
        X_j = np.where(mask > 0, np.asarray(X_j), X.numpy())
        X_t, s_t = hbm_rtr.rtr_solve_hbm_ref(
            X, robot, Pinv, tp.edges, RTRParams(**DEMO), windows)
        # JAX reports no tCG count: the port's full-width solve (held to JAX
        # by tests/test_torch_fused_rtr.py) gives it
        _, res_t = rtr_solve(X, tp.edges, tp.block_mask(robot), Pinv,
                             RTRParams(**DEMO))
        assert int(s_t[4]) == int(res.iterations) == res_t.iterations == 3
        assert int(s_t[5]) == res_t.tcg_iterations
        assert float(s_t[1] - s_t[0]) == pytest.approx(
            float(res.f_opt - res.f_init), rel=1e-9)
        assert rel_err(X_t.numpy(), X_j) < 1e-9


# ------------------------------------------------- 4. the engine route


def _engine_cfg(gnc: bool):
    kw = dict(
        num_robots=3, update_rule=UpdateRule.ROUND_ROBIN,
        local_initialization_method=InitMethod.CHORDAL, RTR_gradnorm_tol=0.5,
        dtype="float64",
    )
    if gnc:  # rounds at 9 and 18; stop two steps after the last
        kw.update(robust_cost_type=RobustCostType.GNC_TLS,
                  robust_opt_num_weight_updates=2,
                  robust_opt_inner_iters_per_robot=3,
                  relative_change_tolerance=0.1)
    else:
        kw.update(relative_change_tolerance=0.0)
    return AgentConfig(**kw)


@pytest.mark.parametrize("cost", ["L2", "GNC_TLS"])
def test_engine_route_matches_jax_fp64(monkeypatch, cost):
    gnc = cost == "GNC_TLS"
    if gnc:
        data, _, _ = generate_world("sphere", n=256, num_robots=3, seed=0,
                                    outlier_ratio=0.2)
    else:
        data, _ = world("sphere256")
    cfg, cap = _engine_cfg(gnc), 20 if gnc else 12
    jp = JaxProblem.from_data(data, r=5, dtype=jnp.float64)
    je = JaxEngine(jp, cfg)
    js, jinfo = je.run(je.initialize(), max_iters=cap)

    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    te = RBCDEngine(tp, port_config(cfg))
    calls = []
    real = hbm_rtr.rtr_solve_hbm
    monkeypatch.setattr(hbm_rtr, "rtr_solve_hbm",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    ts, tinfo = te.run(te.initialize(ylift=np.asarray(je.Ylift)), max_iters=cap)
    assert tinfo["iterations"] == jinfo["iterations"] == cap
    assert calls == [i % 3 for i in range(tinfo["iterations"])]
    jh, th = jinfo["history"], tinfo["history"]
    assert th["event"] == jh["event"] and len(th["event"]) == (2 if gnc else 0)
    # the history's costs are the ones the steps carry by f − f0
    assert rel_err(th["cost"], jh["cost"]) < 1e-7
    assert rel_err(th["rel_change"], jh["rel_change"]) < 1e-7
    assert rel_err(np.stack(th["rel_change_robots"]),
                   np.stack(jh["rel_change_robots"])) < 1e-7
    assert rel_err(ts.X.numpy(), np.asarray(js.X)) < 1e-7
    assert np.max(np.abs(ts.weights.numpy() - np.asarray(js.weights))) < 1e-7
    jcost = j_quad.cost(jnp.asarray(ts.X.numpy()),
                        je._edges(jnp.asarray(ts.weights.numpy())))
    assert float(ts.cost) == pytest.approx(float(jcost), rel=1e-9)
    assert tinfo["final_cost"] == float(ts.cost)
    assert th["cost"][-1] == pytest.approx(float(jcost), rel=1e-9)
    assert float(ts.cost) == pytest.approx(float(js.cost), rel=1e-7)


# ------------------------------------------------- 5. routing


@pytest.fixture(scope="module")
def sphere_cpu():
    data, _ = world("sphere256")
    return LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("case", ["RoundRobin", "Parallel", "RoundRobin/full-width",
                                  "fused", "async-init"])
def test_routing(sphere_cpu, monkeypatch, case):
    """RoundRobin solves each block on its window (K4) and Parallel on its
    colour's window (K1, the colour windows); with
    ``SEQUENTIAL_ON_WINDOWS`` off RoundRobin runs K1 on the robots'
    windows; --mode fused is K2, on the same robot windows. The robots'
    windows are built on the first solve or fused run that needs them, so
    an engine that needs none (Parallel, the one the async mode builds for
    ``initialize``) never builds them."""
    if case == "RoundRobin/full-width":
        monkeypatch.setattr(rbcd, "SEQUENTIAL_ON_WINDOWS", False)
    calls = []
    for mod, fn in [(hbm_rtr, "rtr_solve_hbm"), (fused_rtr, "rtr_solve_fused"),
                    (fused_rtr, "rtr_run_fused"), (hbm_rtr, "prepare_windows")]:
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _f=fn, _r=real, **k:
                            calls.append(_f) or _r(*a, **k))
    rule = UpdateRule.PARALLEL if case == "Parallel" else UpdateRule.ROUND_ROBIN
    cfg = port_config(AgentConfig(num_robots=3, update_rule=rule,
                                  relative_change_tolerance=0.0,
                                  asynchronous=case == "async-init",
                                  RTR_gradnorm_tol=0.5, dtype="float64"))
    eng = RBCDEngine(sphere_cpu, cfg)
    st = eng.initialize(ylift=np.eye(5, 3))
    if case == "async-init":
        assert calls == []
        return
    if case == "fused":
        eng.make_fused_run(3)(st)
        assert calls == ["prepare_windows", "rtr_run_fused"]
        return
    eng.run(st, max_iters=3)
    if case == "RoundRobin":
        assert calls == ["prepare_windows"] + ["rtr_solve_hbm"] * 3
    elif case == "Parallel":
        assert calls == ["rtr_solve_fused"] * 3
    else:
        assert calls == ["prepare_windows"] + ["rtr_solve_fused"] * 3


# ------------------------------------------------- 6. wrapper and build


BAD_OPERANDS = ["dtype", "device", "pinv_shape", "robot_range", "robot_negative",
                "robot_bool", "other_world"]
QUICK = RTRParams(max_iterations=1, max_tcg_iterations=2, gradnorm_tol=0.5)


@pytest.mark.parametrize("bad", BAD_OPERANDS + [f"warm-{b}" for b in BAD_OPERANDS])
def test_wrapper_rejects_operands_the_kernel_cannot_take(sphere_cpu, bad):
    """Each operand error raises on the call that has it; the warm cases
    make a good call on the same windows first, so that the bad call meets
    the row's launch record (robot_bool: the record of robot 1 == True)."""
    warm, bad = bad.startswith("warm-"), bad.removeprefix("warm-")
    tp = sphere_cpu
    windows = hbm_rtr.prepare_windows(tp)
    X = _on_manifold_state(world("sphere256")[1], seed=3)
    Pinv = torch.eye(4, dtype=torch.float64).expand(tp.n, 4, 4).contiguous()
    good = (X, 1 if bad == "robot_bool" else 0, Pinv, tp.edges, QUICK, windows)
    robot, err = 0, ValueError
    if bad == "dtype":
        X, err = X.float(), TypeError
    elif bad == "device":
        X = X.to("meta")
    elif bad == "pinv_shape":
        Pinv = Pinv[:, :3, :3]
    elif bad == "robot_range":
        robot = tp.num_robots
    elif bad == "robot_negative":
        robot = -1
    elif bad == "robot_bool":
        robot, err = True, TypeError
    else:
        data, gt = world("grid3d4")
        other = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
        windows = hbm_rtr.prepare_windows(other)
        good = (_on_manifold_state(gt, seed=3), 0,
                torch.eye(4, dtype=torch.float64).expand(other.n, 4, 4).contiguous(),
                other.edges, QUICK, windows)
    if warm:
        hbm_rtr.rtr_solve_hbm(*good)
        assert good[1] in windows.records
    with pytest.raises(err):
        hbm_rtr.rtr_solve_hbm(X, robot, Pinv, tp.edges, QUICK, windows)


def test_one_launch_record_per_windows_and_row(sphere_cpu, monkeypatch):
    """``k4.records`` goes up once per row over repeated calls, and again
    for new windows of the same problem; the full operand checks run on a
    row's first call and again only when what they read changed (another
    Pinv, Pinv changed in place, other params, other weights), once."""
    tp = sphere_cpu
    X = _on_manifold_state(world("sphere256")[1], seed=3)
    Pinv = torch.eye(4, dtype=torch.float64).expand(tp.n, 4, 4).contiguous()
    checks = []
    real = kernels.checked_operands
    monkeypatch.setattr(kernels, "checked_operands",
                        lambda *a: checks.append(a[0]) or real(*a))
    count = lambda: profiling.counters().get("k4.records", 0)
    solve = lambda w, robot=0, P=Pinv, params=QUICK, e=tp.edges: hbm_rtr.rtr_solve_hbm(
        X, robot, P, e, params, w)
    w, before = hbm_rtr.prepare_windows(tp), count()
    for _ in range(3):
        for robot in (0, 1):
            solve(w, robot)
    assert count() == before + 2 and sorted(w.records) == [0, 1]
    assert len(checks) == 2
    solve(hbm_rtr.prepare_windows(tp))
    assert count() == before + 3 and len(checks) == 3
    P2 = Pinv.clone()
    e2 = dataclasses.replace(tp.edges, weight=tp.edges.weight.clone())
    for change in (lambda: solve(w, P=P2), lambda: (P2.mul_(1.0), solve(w, P=P2)),
                   lambda: solve(w, params=RTRParams(max_iterations=1, max_tcg_iterations=3)),
                   lambda: solve(w, e=e2)):
        n = len(checks)
        change()
        assert len(checks) == n + 1
    solve(w, e=e2)
    solve(w, np.int64(0), e=e2)  # a row that is not an int is checked every call
    assert len(checks) == n + 2 and count() == before + 3


def test_operands_made_in_inference_mode_are_checked_every_call(sphere_cpu, monkeypatch):
    """A tensor made in inference mode keeps no version, so the guard
    cannot hold it: such calls run the full checks every time, and still
    solve."""
    tp = sphere_cpu
    X = _on_manifold_state(world("sphere256")[1], seed=3)
    checks = []
    real = kernels.checked_operands
    monkeypatch.setattr(kernels, "checked_operands",
                        lambda *a: checks.append(a[0]) or real(*a))
    w = hbm_rtr.prepare_windows(tp)
    with torch.inference_mode():
        Pinv = torch.eye(4, dtype=torch.float64).expand(tp.n, 4, 4).contiguous()
        out = [hbm_rtr.rtr_solve_hbm(X, 0, Pinv, tp.edges, QUICK, w) for _ in range(3)]
    assert len(checks) == 3 and list(w.records) == [0]
    assert all(torch.equal(o[0], out[0][0]) for o in out)


@pytest.mark.parametrize("change", ["new_tensor", "weight_in_place", "mask_in_place"])
def test_effective_weights_once_per_weight_set(sphere_cpu, change):
    """``Windows.effective_weights`` equals ``edges.effective_weights()``,
    recomputes (``k4.weights`` + 1) after a new weights tensor or an
    in-place change to the weights or the mask, and not across calls with
    the same tensors."""
    tp = sphere_cpu
    w = hbm_rtr.prepare_windows(tp)
    e = dataclasses.replace(tp.edges, weight=tp.edges.weight.clone(),
                            mask=tp.edges.mask.clone())
    count = lambda: profiling.counters().get("k4.weights", 0)

    def same(edges, recomputed):
        n = count()
        kw, tw = w.effective_weights(edges)
        want = edges.effective_weights()
        assert torch.equal(kw, want[0]) and torch.equal(tw, want[1])
        assert count() == n + recomputed
        return kw

    kw = same(e, 1)
    assert same(e, 0) is kw and same(dataclasses.replace(e), 0) is kw
    if change == "new_tensor":
        e = dataclasses.replace(e, weight=e.weight * 0.5)
    elif change == "weight_in_place":
        e.weight[::2] = 0.25
    else:
        e.mask[::3] = 0.0
    assert same(e, 1) is not kw
    same(e, 0)


def test_build_all_lists_k4_and_a_failing_build_raises(tmp_path, monkeypatch):
    """build_all() compiles K4 with the other kernels; an nvcc that fails
    raises and names the source; nothing falls back."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        kernels.build_all()
    for src in ("rtr_block.cu", "rtr_run.cu", "asapp_tick.cu", "rtr_window.cu"):
        assert src in str(err.value)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 chip_smoke.py)")
    data, gt = _world("irregular")
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cuda")
    windows = hbm_rtr.prepare_windows(tp)
    X = _on_manifold_state(gt, seed=4, dtype=torch.float32).cuda()
    Pinv = quadratic.precond_inverse(quadratic.precond_blocks(tp.edges, tp.n)).contiguous()
    for robot in range(tp.num_robots):
        launches = profiling.launches()["k4"]
        X_k, s_k = hbm_rtr.rtr_solve_hbm(X, robot, Pinv, tp.edges, RTRParams(**DEMO), windows)
        assert profiling.launches()["k4"] == launches + 1
        X_p, s_p = hbm_rtr.rtr_solve_hbm_ref(X, robot, Pinv, tp.edges, RTRParams(**DEMO), windows)
        assert int(s_k[4]) == int(s_p[4]) and int(s_k[5]) == int(s_p[5])
        assert float(s_k[1] - s_k[0]) == pytest.approx(float(s_p[1] - s_p[0]), rel=1e-4)
        assert rel_err(X_k.cpu(), X_p.cpu()) < 1e-4
        out = tp.block_mask(robot)[:, 0, 0] == 0
        assert torch.equal(X_k[out], X[out])

