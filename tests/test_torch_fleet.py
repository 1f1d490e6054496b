"""The fleet protocol simulation: the port's agents and controller against
the JAX package's on the same data (fp64, CPU).

1. Fleets (RoundRobin, Uniform, acceleration with restarts, GNC_TLS with
   planted outliers, a lossy transport, a robot killed mid-solve,
   asynchronous RGD agents): the JAX ``DistributedController`` and the
   port's run the same world and config, with the port leader's YLift set
   to JAX's draw before the first tick. Every published message is
   recorded (sender, class, fields): the traces are identical (integers,
   flags and enums equal, floats within 1e-9 relative), and so are ticks,
   iterations, ``messages_sent``, ``bytes_received``, the active set and
   ``gnc_statistics``; final trajectories and weights agree to 1e-9
   relative. Each synchronous RTR solve of the port goes through
   ``hbm_rtr.rtr_solve_hbm`` (K4's wrapper; its plain version here).
2. A second round warm-started from the first, and the fleet checkpoint:
   the files of ``save_checkpoint`` load to the same arrays and json as
   JAX's, and each package restores the other's.
3. K4's agent window (``hbm_rtr.prepare_local_window``): the plain
   version on it equals ``rtr_solve`` on the whole local problem (fp64,
   the same TR and tCG counts, X within 1e-12), with separator edges
   masked as for unknown slots.
4. ``utils/hostmath.py`` and ``parallel/comm.py`` against their JAX twins
   on seeded inputs (equal bits; the same drops and byte counts).
5. The CLI's ``--mode fleet`` summary equals the JAX CLI's on a small
   world (fp32, CPU) but for the wall time; float64 on the card is refused
   at construction.
"""

import dataclasses
import enum
import json

import jax
import numpy as np
import pytest
import torch

from dpgo_ros_tpu import cli as jax_cli
from dpgo_ros_tpu.io.synthetic import generate_world
from dpgo_ros_tpu.models import local_solvers as j_ls
from dpgo_ros_tpu.ops import quadratic as j_quadratic
from dpgo_ros_tpu.ops import stiefel as j_stiefel
from dpgo_ros_tpu.parallel import comm as j_comm
from dpgo_ros_tpu.parallel.controller import DistributedController as JaxController
from dpgo_ros_tpu.utils import hostmath as j_hostmath
from dpgo_ros_tpu.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    UpdateRule,
)
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu_torch.ops import hbm_rtr
from dpgo_ros_tpu_torch.parallel import agent_node
from dpgo_ros_tpu_torch.parallel import comm
from dpgo_ros_tpu_torch.parallel.controller import DistributedController
from dpgo_ros_tpu_torch.utils import hostmath
from torch_parity import port_config, rel_err

TOL = 1e-9


def _jax_ylift(cfg) -> np.ndarray:
    """The JAX leader's lifting matrix (``PRNGKey(seed)``)."""
    return np.asarray(j_stiefel.random_lifting_matrix(
        jax.random.PRNGKey(cfg.seed), cfg.relaxation_rank, cfg.dimension))


def _record(ctl) -> list:
    """Every message ``ctl``'s transport publishes, in order."""
    out = []
    publish = ctl.transport.publish

    def recorded(sender, msg):
        out.append((sender, msg))
        publish(sender, msg)

    ctl.transport.publish = recorded
    return out


def _same(a, b, where="") -> None:
    """a (port) equals b (JAX): dataclasses field by field, integers,
    flags and enums exactly, floats within TOL of b's largest entry."""
    if dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(b):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, where
        if b.dtype.kind == "f":
            assert rel_err(a, b) <= TOL, (where, rel_err(a, b))
        else:
            assert np.array_equal(a, b), where
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(b, enum.Enum):
        assert int(a) == int(b), where
    elif isinstance(b, float):
        assert rel_err([a], [b]) <= TOL, (where, a, b)
    else:
        assert a == b, (where, a, b)


def _cfg(R, **kw):
    base = dict(num_robots=R, update_rule=UpdateRule.ROUND_ROBIN,
                local_initialization_method=InitMethod.ODOMETRY,
                relative_change_tolerance=0.05, max_iteration_number=60,
                RTR_gradnorm_tol=0.5, dtype="float64", seed=3)
    base.update(kw)
    return AgentConfig(**base)


def _gnc_cfg(R):
    return _cfg(R, robust_cost_type=RobustCostType.GNC_TLS,
                GNC_use_probability=False, GNC_barc=3.0,
                robust_opt_num_weight_updates=3,
                robust_opt_inner_iters_per_robot=3, robust_opt_num_resets=1,
                weight_convergence_threshold=0.4)


def _kill_after_first_solve(ctl, robot: int) -> None:
    """``robot`` crashes on the tick after its first solve (the JAX
    package's dead-robot test)."""
    agent, tr = ctl.agents[robot], ctl.transport
    run = agent.runOnce

    def run_or_die():
        if robot not in tr.dead and agent.solved_iterations >= 1:
            tr.kill_robot(robot)
            return
        run()

    agent.runOnce = run_or_die


# name: (world kwargs, config, transport (kind, kwargs) or None, hook)
FLEETS = {
    "roundrobin": (dict(n=200, num_robots=2), _cfg(2), None, None),
    "uniform": (dict(n=240, num_robots=3),
                _cfg(3, update_rule=UpdateRule.UNIFORM), None, None),
    "acceleration": (dict(n=200, num_robots=2),
                     _cfg(2, acceleration=True, restart_interval=3,
                          local_initialization_method=InitMethod.CHORDAL),
                     None, None),
    "gnc": (dict(n=240, num_robots=3, outlier_ratio=0.2), _gnc_cfg(3), None, None),
    "lossy": (dict(n=200, num_robots=2), _cfg(2, timeout_threshold=10.0),
              ("lossy", dict(drop_prob=0.2, delay_ticks=1, seed=3)), None),
    "killed": (dict(n=240, num_robots=3),
               _cfg(3, enable_recovery=True, timeout_threshold=8.0,
                    relative_change_tolerance=0.3),
               ("lossy", {}), lambda ctl: _kill_after_first_solve(ctl, 2)),
    "async": (dict(n=200, num_robots=2),
              _cfg(2, asynchronous=True, RGD_stepsize=0.2,
                   local_initialization_method=InitMethod.CHORDAL,
                   relative_change_tolerance=0.1), None, None),
}


def _fleets(name):
    """(JAX controller, port controller, their message traces) of a FLEETS
    entry, ready to run."""
    wkw, cfg, tr, hook = FLEETS[name]
    data, _, _ = generate_world("sphere", seed=5, **wkw)
    R = data.num_robots
    jt = tt = None
    if tr is not None:
        jt = j_comm.LossyTransport(R, **tr[1])
        tt = comm.LossyTransport(R, **tr[1])
    jc = JaxController(data, cfg, transport=jt)
    tc = DistributedController(data, port_config(cfg), transport=tt, device="cpu")
    tc.agents[0].Ylift = _jax_ylift(cfg)
    if hook is not None:
        hook(jc)
        hook(tc)
    return jc, tc, _record(jc), _record(tc)


def _same_results(jc, tc, jres, tres) -> None:
    for key in ("ticks", "terminated", "iterations", "messages_sent",
                "bytes_received", "active_robots"):
        assert tres[key] == jres[key], (key, tres[key], jres[key])
    assert tres["trajectories"].keys() == jres["trajectories"].keys()
    for k, T in jres["trajectories"].items():
        assert rel_err(tres["trajectories"][k], T) <= TOL, k
    for k, w in jres["weights"].items():
        if w is None:
            assert tres["weights"][k] is None
        else:
            assert rel_err(tres["weights"][k], w) <= TOL, k
    assert tc.gnc_statistics(tres) == jc.gnc_statistics(jres)


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_matches_jax(name, monkeypatch):
    jc, tc, jtrace, ttrace = _fleets(name)
    solves = []
    solve = hbm_rtr.rtr_solve_hbm
    monkeypatch.setattr(hbm_rtr, "rtr_solve_hbm",
                        lambda *a: solves.append(a[1]) or solve(*a))
    jres = jc.run(max_ticks=3000)
    tres = tc.run(max_ticks=3000)
    assert len(ttrace) == len(jtrace)
    for i, ((ts, tm), (js, jm)) in enumerate(zip(ttrace, jtrace)):
        assert ts == js, i
        _same(tm, jm, f"message {i} {type(jm).__name__}")
    _same_results(jc, tc, jres, tres)
    iterations = sum(tres["iterations"].values())
    if name == "async":  # RGD agents: no K4
        assert not solves and iterations > 0
    elif name == "acceleration":  # a second solve where a step restarts
        assert len(solves) > iterations
    else:
        assert len(solves) == iterations
    kinds = {type(m).__name__ for _, m in jtrace}
    if name == "gnc":  # weight rounds replicate owned weights and freezes
        w = [m for _, m in jtrace if type(m).__name__ == "MeasurementWeights"]
        assert w and any(m.fixed.any() for m in w)
        assert jc.gnc_statistics(jres)["rejected"] > 0
    if name == "killed":
        assert 2 not in tres["active_robots"] and all(tres["terminated"][:2])
        assert {"Command"} <= kinds


def test_warm_start_and_checkpoint_match_jax(tmp_path):
    """A second round from the first's caches, then the checkpoint files:
    equal contents, and each package restores the other's."""
    jc, tc, jtrace, ttrace = _fleets("roundrobin")
    rounds = []
    for r in range(2):
        jres, tres = jc.run(max_ticks=3000), tc.run(max_ticks=3000)
        _same_results(jc, tc, jres, tres)
        rounds.append(sum(tres["iterations"].values()))
        jc.start_new_round()
        tc.start_new_round()
        tc.agents[0].Ylift = _jax_ylift(jc.config)  # round 2 draws again
    assert len(ttrace) == len(jtrace)
    assert rounds[1] <= rounds[0] and tc.agents[0].instance == 2
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    jc.save_checkpoint(jp, meta={"ticks": 1})
    tc.save_checkpoint(tp, meta={"ticks": 1})
    with np.load(f"{jp}/fleet_caches.npz") as zj, np.load(f"{tp}/fleet_caches.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files) and zj.files
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype and rel_err(zt[k], zj[k]) <= TOL, k
    assert json.load(open(f"{tp}/fleet_meta.json")) == json.load(open(f"{jp}/fleet_meta.json"))
    data = tc.data
    for ctl, path, Ctl in ((tc, jp, DistributedController), (jc, tp, JaxController)):
        kw = dict(device="cpu") if Ctl is DistributedController else {}
        fresh = Ctl(data, ctl.config if Ctl is JaxController else tc.config, **kw)
        fresh.restore_checkpoint(path)
        for a, b in zip(fresh.agents, ctl.agents):
            assert rel_err(a.cached_trajectory, b.cached_trajectory) <= TOL
            assert a.cached_weights == b.cached_weights


def test_local_window_matches_rtr_solve():
    """K4's window of an agent's local problem, mid-round with a third of
    the separator slots still unknown (their edges masked): the plain
    version equals ``rtr_solve`` on the whole local problem, and JAX's."""
    _, tc, _, _ = _fleets("uniform")
    a = tc.agents[1]
    while a.solved_iterations < 2:  # mid-round
        tc.run(max_ticks=1)
    assert a.edges is not None and not a.terminated
    a._slot_known[::3] = False
    a._edge_mask_cache = None
    emask = a._edge_mask()
    assert 0 < emask.sum() < emask.size
    e, P = a._local_problem(a.weights, emask)
    w = a.windows
    ntot = a.X.shape[0]
    assert w.num_rows == 1 and w.max_poses == ntot and int(w.num_poses[0]) == a.n_local
    assert torch.equal(w.poses.long(), torch.arange(ntot))
    assert torch.equal(w.edges.long(), torch.arange(e.num_edges))
    X = torch.as_tensor(a.X)
    params = RTRParams(max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5)
    Xk, sk = hbm_rtr.rtr_solve_hbm(X, 0, P, e, params, w)
    Xr, res = rtr_solve(X, e, a._own_mask, P, params)
    assert (int(sk[4]), int(sk[5])) == (res.iterations, res.tcg_iterations)
    assert res.tcg_iterations > 0
    own = a._own_mask[:, 0, 0] > 0
    assert float((Xk[own] - Xr[own]).abs().max()) <= 1e-12 * float(Xr.abs().max())
    assert torch.equal(Xk[~own], X[~own])
    assert abs(float(sk[1]) - float(res.f_opt)) <= 1e-12 * float(res.f_init)
    # the same solve in JAX (XLA, the agent's own rtr_solve)
    he = a.host_edges
    je = j_quadratic.EdgeSet(
        src=jax.numpy.asarray(he.src), dst=jax.numpy.asarray(he.dst),
        R=jax.numpy.asarray(he.R), t=jax.numpy.asarray(he.t),
        kappa=jax.numpy.asarray(he.kappa), tau=jax.numpy.asarray(he.tau),
        weight=jax.numpy.asarray(a.weights), mask=jax.numpy.asarray(emask),
        is_loop=jax.numpy.asarray(he.is_loop))
    jP = j_quadratic.precond_inverse(j_quadratic.precond_blocks(je, ntot))
    jX, jres = j_ls.rtr_solve(jax.numpy.asarray(a.X), je,
                              jax.numpy.asarray(a._own_np, np.float64), jP,
                              j_ls.RTRParams(max_iterations=3, max_tcg_iterations=50,
                                             gradnorm_tol=0.5))
    assert int(jres.iterations) == res.iterations
    assert rel_err(Xk[own].numpy(), np.asarray(jX)[own.numpy()]) <= 1e-9


def _seeded(seed):
    rng = np.random.default_rng(seed)
    T = np.concatenate([j_hostmath.project_to_so_np(rng.standard_normal((40, 3, 3))),
                        rng.standard_normal((40, 3, 1))], -1)
    Y, _ = np.linalg.qr(rng.standard_normal((5, 3)))
    return rng, T, Y


@pytest.mark.parametrize("fn", [
    "project_to_so_np", "se_compose_np", "se_inverse_np", "odometry_chain_np",
    "lift_trajectory_np", "round_via_lifting_np", "anchor_to_first_pose_np",
    "measurement_residuals_np", "gnc_tls_weights_np", "gnc_round_params_np",
])
def test_hostmath_matches_jax(fn):
    rng, T, Y = _seeded(11)
    X = j_hostmath.lift_trajectory_np(T, Y) + 0.01 * rng.standard_normal((40, 5, 4))
    src, dst = rng.integers(0, 40, 60), rng.integers(0, 40, 60)
    r = np.abs(rng.standard_normal(60)) * 4
    cases = {
        "project_to_so_np": [(rng.standard_normal((7, 3, 3)),)],
        "se_compose_np": [(T[:20], T[20:])],
        "se_inverse_np": [(T,)],
        "odometry_chain_np": [(T[:-1],), (T[:-1], T[0])],
        "lift_trajectory_np": [(T, Y)],
        "round_via_lifting_np": [(X, Y)],
        "anchor_to_first_pose_np": [(T,), (T, T[3])],
        "measurement_residuals_np": [(T, src, dst, rng.standard_normal((60, 3, 3)),
                                      rng.standard_normal((60, 3)), np.full(60, 4.0),
                                      np.full(60, 2.0))],
        "gnc_tls_weights_np": [(r, 0.7, 3.0), (r, 1e-5, 3.0)],
        "gnc_round_params_np": [
            (k, dataclasses.replace(AgentConfig(), GNC_schedule=s, GNC_barc=3.0), 0.2,
             r, (rng.random(60) > 0.3).astype(float))
            for k in (0, 2) for s in ("adaptive", "geometric", "reference", "mu")],
    }
    for args in cases[fn]:
        ours, theirs = getattr(hostmath, fn)(*args), getattr(j_hostmath, fn)(*args)
        assert np.array_equal(np.asarray(ours), np.asarray(theirs)), fn


def test_comm_matches_jax():
    """The same seeded drops and delays, queues and byte counts, for the
    same published messages; every message class has JAX's fields."""
    for name in ("Command", "PublicPoses", "RelativeMeasurementList",
                 "MeasurementWeights", "LiftingMatrix", "Anchor", "StatusMsg"):
        assert ([f.name for f in dataclasses.fields(getattr(comm, name))]
                == [f.name for f in dataclasses.fields(getattr(j_comm, name))])
    rng = np.random.default_rng(2)

    def msgs(mod):
        from dpgo_ros_tpu_torch import types as tt
        from dpgo_ros_tpu import types as jt
        t = tt if mod is comm else jt
        return [
            mod.Command(t.CommandType.UPDATE, 0, 0, 1, 3, (0, 1)),
            mod.PublicPoses(1, 0, 0, 4, False, np.arange(5), np.ones((5, 5, 4))),
            mod.MeasurementWeights(0, 0, *(np.arange(3),) * 4, np.ones(3), np.zeros(3, bool)),
            mod.LiftingMatrix(0, np.ones((5, 3))),
            mod.Anchor(0, np.ones((5, 4))),
            mod.StatusMsg(t.AgentStatus(robot_id=2)),
        ]

    order = rng.integers(0, 6, 200)
    senders = rng.integers(0, 3, 200)
    for kw in (dict(drop_prob=0.2, delay_ticks=1, seed=3),
               dict(drop_prob=0.5, seed=9, partitioned=[(0, 2)])):
        ours, theirs = comm.LossyTransport(3, **kw), j_comm.LossyTransport(3, **kw)
        mo, mt = msgs(comm), msgs(j_comm)
        got = {0: [], 1: [], 2: []}, {0: [], 1: [], 2: []}
        for i, (k, s) in enumerate(zip(order, senders)):
            ours.publish(int(s), mo[k])
            theirs.publish(int(s), mt[k])
            if i % 7 == 0:
                ours.tick()
                theirs.tick()
                for tr, g in zip((ours, theirs), got):
                    for rb in range(3):
                        g[rb] += [type(m).__name__ for m in tr.poll(rb)]
        assert got[0] == got[1] and any(got[0].values())
        assert ours.messages_sent == theirs.messages_sent
        assert dict(ours.bytes_delivered) == dict(theirs.bytes_delivered)
    for a, b in zip(msgs(comm), msgs(j_comm)):
        assert comm._msg_bytes(a) == j_comm._msg_bytes(b)


SMALL_FLEET = ["--synthetic", "sphere", "--synthetic_n", "300", "--num_robots", "3",
               "--mode", "fleet", "--update_rule", "RoundRobin",
               "--RTR_gradnorm_tol", "0.5", "--relative_change_tolerance", "0.1"]


def test_cli_fleet_summary_matches_jax(capsys, monkeypatch, tmp_path):
    """``--mode fleet`` through both CLIs (fp32, CPU), the port's YLift
    draw replaced by JAX's: the same summary but for the wall time; with
    ``--log_directory`` each agent writes the reference's telemetry CSV."""
    Y = _jax_ylift(AgentConfig())
    monkeypatch.setattr(agent_node.stiefel, "random_lifting_matrix",
                        lambda gen, r, d, dtype: torch.tensor(Y, dtype=dtype))
    assert jax_cli.main(SMALL_FLEET + ["--platform", "cpu"]) == 0
    jsum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tsum, extras = cli.run(SMALL_FLEET + ["--device", "cpu", "--log_directory",
                                          str(tmp_path)])
    tsum = json.loads(json.dumps(tsum))  # int robot ids become strings
    jsum.pop("wall_time_sec"), tsum.pop("wall_time_sec")
    assert tsum == jsum
    assert extras["initial_cost"] is None and all(extras["terminated"])
    assert np.isfinite(extras["ate_vs_ground_truth"])
    from dpgo_ros_tpu.utils.telemetry import HEADER

    for k in range(3):
        (log,) = (tmp_path / f"agent{k}").glob("dpgo_log_*.csv")
        lines = log.read_text().splitlines()
        assert lines[0] == HEADER
        rows = [line for line in lines[1:] if line.count(",") == 8]  # not events
        assert len(rows) == tsum["iterations"][str(k)]


def test_float64_on_the_card_is_refused():
    data, _, _ = generate_world("sphere", n=60, num_robots=2, seed=0)
    cfg = port_config(_cfg(2))
    with pytest.raises(ValueError, match="float32 only"):
        DistributedController(data, cfg, device="cuda")
    with pytest.raises(ValueError, match="float32 only"):
        agent_node.PGOAgentNode(0, cfg, comm.PerfectTransport(2),
                                agent_node.DatasetServer(data), device="cuda")
    import inspect

    assert inspect.signature(DistributedController).parameters["device"].default == "cuda"
