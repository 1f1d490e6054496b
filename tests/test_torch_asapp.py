"""Port parity: the asynchronous ASAPP mode against the JAX package.

The plain tick (the CPU path of ``fused_asapp.asapp_tick_fused``) and the
port's ``ASAPPEngine`` are held to the JAX engine on small synthetic worlds
(sphere 256 with 3 robots, grid3d 4×4×4 with 2 robots):

* one tick against the XLA tick ``_tick_impl`` in fp64 (X, ring buffer and
  per-robot movement to 1e-9 relative), over K, steps per tick and the
  preconditioner;
* five chained ticks against the Pallas tick kernel in interpret mode, fp32
  (the JAX package's own tolerances: X ≤ 2e-4 of max |X|, movement rtol
  2e-3);
* whole runs with the stop tolerance and the stepsize decay, fed the JAX
  delay stream (``jax.random.split`` / ``randint`` from ``PRNGKey(seed)``,
  as ``dpgo_ros_tpu/parallel/asapp.py`` draws it): the same stop tick,
  ``converged`` flag, rel-change history and final cost (fp64).

The port's own delay generator is a ``torch.Generator``; its stream is
checked for chunk invariance. The CLI's async mode runs on CPU at n = 256.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import quadratic as j_quad
from dpgo_ros_tpu.parallel.asapp import ASAPPEngine as JaxASAPP
from dpgo_ros_tpu.parallel.asapp import ASAPPState as JaxState
from dpgo_ros_tpu.utils.config import AgentConfig
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_asapp, quadratic
from dpgo_ros_tpu_torch.parallel.asapp import ASAPPEngine, ASAPPState
from dpgo_ros_tpu_torch.utils import profiling
from torch_parity import noisy_lifted_gt, port_config, rel_err, world

TOL64 = 1e-9
SEED = 11


def _cfg(robots, K=2, steps=1, precond=True, dtype="float64", seed=SEED, **kw):
    return AgentConfig(
        num_robots=robots, asynchronous=True, RGD_stepsize=0.2,
        asynchronous_rate=100.0 * steps, RGD_use_preconditioner=precond,
        max_delayed_iterations=K, dtype=dtype, seed=seed, **kw,
    )


def _problems(name, dtype):
    data, gt = world(name)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    return (JaxProblem.from_data(data, r=5, dtype=jdt),
            LiftedProblem.from_data(data, r=5, dtype=tdt, device="cpu"), gt)


def _manifold_state(gt, seed, noise=0.05):
    """A lifted state near the ground truth with exactly orthonormal
    rotation blocks (polar factor by SVD), like the solver's iterates."""
    X = noisy_lifted_gt(gt, 5, seed=seed, noise=noise)
    U, _, Vt = np.linalg.svd(X[..., :-1], full_matrices=False)
    X[..., :-1] = U @ Vt
    return X


def jax_delays(seed, ticks, R, K):
    """The JAX engine's delay stream from PRNGKey(seed): per tick
    ``key, sub = split(key); randint(sub, (R,), 0, K+1)``."""
    def body(key, _):
        key, sub = jax.random.split(key)
        return key, jax.random.randint(sub, (R,), 0, K + 1)

    _, rows = jax.lax.scan(body, jax.random.PRNGKey(seed), None, length=ticks)
    return np.asarray(rows, np.int32)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


# ------------------------------------------------------------ one tick


@pytest.mark.parametrize("name", ["sphere256", "grid3d4"])
@pytest.mark.parametrize("K", [0, 2])
@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("precond", [True, False])
def test_plain_tick_matches_jax_xla_tick_fp64(name, K, steps, precond):
    jp, tp, gt = _problems(name, "float64")
    R = tp.num_robots
    cfg = _cfg(R, K=K, steps=steps, precond=precond)
    jeng, teng = JaxASAPP(jp, cfg), ASAPPEngine(tp, port_config(cfg))
    assert teng.steps_per_tick == jeng.steps_per_tick == steps
    X = _manifold_state(gt, seed=1)
    H = np.stack([_manifold_state(gt, seed=2 + j) for j in range(K + 1)])
    key = jax.random.PRNGKey(7)
    jst = JaxState(X=jnp.asarray(X), hist=jnp.asarray(H),
                   tick=jnp.asarray(3, jnp.int32), key=key,
                   rel_change=jnp.full((R,), jnp.inf, jnp.float64))
    jout = jeng._tick(jst)
    delays = np.asarray(jax.random.randint(jax.random.split(key)[1], (R,), 0, K + 1))
    tst = teng.init_state(_t(X))._replace(hist=_t(H), tick=3)
    tout = teng.tick(tst, torch.tensor(delays, dtype=torch.int32))
    assert tout.tick == int(jout.tick) == 4
    assert rel_err(tout.X.numpy(), jout.X) < TOL64
    assert rel_err(tout.hist.numpy(), jout.hist) < TOL64
    assert rel_err(tout.rel_change.numpy(), jout.rel_change) < TOL64
    assert float(tout.rel_change.min()) > 0  # every robot moved


@pytest.mark.parametrize("name", ["sphere256", "grid3d4"])
def test_plain_ticks_match_jax_pallas_kernel_fp32(name):
    """Five chained ticks: the plain tick (fp32) against the JAX Pallas tick
    kernel in interpret mode, fed the same delays; 2 steps per tick, K=2."""
    jp, tp, gt = _problems(name, "float32")
    R = tp.num_robots
    cfg = _cfg(R, K=2, steps=2, dtype="float32")
    jeng = JaxASAPP(jp, dataclasses.replace(cfg, use_fused_kernel=True))
    assert jeng._use_fused
    teng = ASAPPEngine(tp, port_config(cfg))
    X0 = _manifold_state(gt, seed=3).astype(np.float32)
    jst = jeng.make_fused_run()(jeng.init_state(jnp.asarray(X0)),
                                jnp.asarray(5, jnp.int32))
    tst = teng.make_fused_run()(teng.init_state(_t(X0, torch.float32)), 5,
                                delays=jax_delays(SEED, 5, R, 2))
    assert tst.tick == int(jst.tick) == 5
    scale = float(np.max(np.abs(np.asarray(jst.X))))
    assert float(np.max(np.abs(tst.X.numpy() - np.asarray(jst.X)))) < 2e-4 * scale
    assert float(np.max(np.abs(tst.hist.numpy() - np.asarray(jst.hist)))) < 2e-4 * scale
    np.testing.assert_allclose(tst.rel_change.numpy(), np.asarray(jst.rel_change),
                               rtol=2e-3, atol=1e-5)


# ------------------------------------------------------------ runs


@pytest.mark.parametrize("name,tol", [("sphere256", 2e-2), ("grid3d4", 5e-3)])
def test_run_stops_at_the_jax_tick(name, tol):
    """tol > 0: the same stop tick, converged flag, rel-change history, X
    and ring buffer as the JAX run, with the JAX delay stream; the port's
    chunks differ from JAX's, and its stop (tested on the device, one host
    read per chunk) falls inside one of them. JAX's key is the one of
    exactly the ticks run; the port's own generator rewinds the same way
    (tests/test_torch_tick_windows.py)."""
    jp, tp, gt = _problems(name, "float64")
    R = tp.num_robots
    cfg = _cfg(R, K=3)
    jeng, teng = JaxASAPP(jp, cfg), ASAPPEngine(tp, port_config(cfg))
    X0 = _manifold_state(gt, seed=4, noise=0.1)
    N = 300
    jst, jinfo = jeng.run(jnp.asarray(X0), num_ticks=N, chunk=100, tol=tol, record=True)
    tst, tinfo = teng.run(_t(X0), num_ticks=N, chunk=37, tol=tol, record=True,
                          delays=jax_delays(SEED, N, R, 3))
    assert jinfo["converged"] and 0 < jinfo["ticks"] < N
    assert tinfo["converged"] == jinfo["converged"]
    assert tinfo["ticks"] == tinfo["ticks_this_run"] == jinfo["ticks"]
    assert tinfo["rel_hist"].shape == (jinfo["ticks"], R)
    assert rel_err(tinfo["rel_hist"], jinfo["rel_hist"]) < 1e-8
    assert rel_err(tst.hist.numpy(), jst.hist) < 1e-8
    assert rel_err(tst.X.numpy(), jst.X) < 1e-8
    assert tinfo["ticks"] % 37, "the port's stop falls inside a chunk"
    key = jax.random.PRNGKey(SEED)
    for _ in range(jinfo["ticks"]):
        key, _ = jax.random.split(key)
    assert np.array_equal(np.asarray(jst.key), np.asarray(key))
    assert tinfo["costs"][0] == pytest.approx(jinfo["costs"][0], rel=1e-12)


@pytest.mark.parametrize("name", ["sphere256", "grid3d4"])
def test_stepsize_decay_matches_jax(name):
    jp, tp, gt = _problems(name, "float64")
    R = tp.num_robots
    cfg = _cfg(R, K=1, asapp_stepsize_decay_ticks=5)
    jeng, teng = JaxASAPP(jp, cfg), ASAPPEngine(tp, port_config(cfg))
    for t in (0, 1, 5, 12, 200):
        assert teng.stepsize_at(t) == pytest.approx(
            float(jeng._stepsize_at(jnp.asarray(t))), rel=1e-15)
    assert teng.stepsize_at(5) == pytest.approx(0.1, rel=1e-15)  # halves at T0
    X0 = _manifold_state(gt, seed=5, noise=0.1)
    jst, _ = jeng.run(jnp.asarray(X0), num_ticks=12, chunk=12)
    tst, _ = teng.run(_t(X0), num_ticks=12, chunk=12, delays=jax_delays(SEED, 12, R, 1))
    assert rel_err(tst.X.numpy(), jst.X) < TOL64


@pytest.mark.parametrize("name", ["sphere256", "grid3d4"])
def test_engine_run_matches_jax_final_cost(name):
    """The async demo's knobs (K=3, stepsize 0.2, preconditioned, one step
    per tick, tol 1e-3) from one state with the JAX delay stream: JAX's
    ticks, converged flag and final cost; continuing from a returned state
    equals one run."""
    jp, tp, gt = _problems(name, "float64")
    R = tp.num_robots
    cfg = _cfg(R, K=3)
    jeng, teng = JaxASAPP(jp, cfg), ASAPPEngine(tp, port_config(cfg))
    X0 = _manifold_state(gt, seed=6, noise=0.1)
    N = 120
    table = jax_delays(SEED, N, R, 3)
    jst, jinfo = jeng.run(jnp.asarray(X0), num_ticks=N, chunk=N, tol=1e-3)
    tst, tinfo = teng.run(_t(X0), num_ticks=N, chunk=50, tol=1e-3, delays=table)
    assert (tinfo["ticks"], tinfo["converged"]) == (jinfo["ticks"], jinfo["converged"])
    f_j = float(j_quad.cost(jst.X, jp.edges))
    assert float(quadratic.cost(tst.X, tp.edges)) == pytest.approx(f_j, rel=1e-6)
    assert tinfo["costs"][-1] == pytest.approx(f_j, rel=1e-6)
    half, _ = teng.run(_t(X0), num_ticks=N // 2, chunk=N, tol=1e-3, delays=table)
    rest, rinfo = teng.run(num_ticks=N, chunk=N, tol=1e-3, state=half, delays=table)
    assert rinfo["ticks_this_run"] == tinfo["ticks"] - half.tick
    assert torch.equal(rest.X, tst.X)


def test_torch_delay_stream_is_chunk_invariant():
    """The port's own generator: the same ticks whatever the chunking, and
    a continued run picks the stream up where the first call left it."""
    _, tp, gt = _problems("grid3d4", "float64")
    teng = ASAPPEngine(tp, port_config(_cfg(2, K=3)))
    X0 = _t(_manifold_state(gt, seed=8))
    a, _ = teng.run(X0, num_ticks=30, chunk=30)
    b, _ = teng.run(X0, num_ticks=30, chunk=7)
    c, _ = teng.run(X0, num_ticks=11, chunk=30)
    c, _ = teng.run(num_ticks=30, chunk=30, state=c)
    assert torch.equal(a.X, b.X) and torch.equal(a.X, c.X)
    assert torch.equal(a.rng, b.rng) and torch.equal(a.rng, c.rng)
    d, _ = ASAPPEngine(tp, port_config(_cfg(2, K=3, seed=SEED + 1))).run(X0, num_ticks=30)
    assert not torch.equal(a.X, d.X)  # the seed drives the stream


def test_stop_rewinds_the_generator_to_the_ticks_run():
    _, tp, gt = _problems("grid3d4", "float64")
    teng = ASAPPEngine(tp, port_config(_cfg(2, K=3)))
    X0 = _t(_manifold_state(gt, seed=9, noise=0.1))
    st, info = teng.run(X0, num_ticks=400, chunk=400, tol=5e-3)
    assert info["converged"] and info["ticks"] < 400
    gen = torch.Generator().manual_seed(SEED)
    torch.randint(0, 4, (info["ticks"], 2), generator=gen)
    assert torch.equal(st.rng, gen.get_state())
    assert info["rel_change"] == st.rel_change.tolist()


def test_tick_operands_are_checked():
    _, tp, gt = _problems("grid3d4", "float64")
    teng = ASAPPEngine(tp, port_config(_cfg(2)))
    st = teng.init_state(_t(_manifold_state(gt, seed=10)))
    ok = (st.X, st.hist, teng._masks, teng._Pinv, tp.edges,
          torch.zeros(2, dtype=torch.int32), 0.1, 1, True, teng._offsets)
    fused_asapp.asapp_tick_fused(*ok)
    bad = list(ok)
    bad[5] = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError):
        fused_asapp.asapp_tick_fused(*bad)
    bad = list(ok)
    bad[1] = st.hist[:, :-1]
    with pytest.raises(ValueError):
        fused_asapp.asapp_tick_fused(*bad)


# ------------------------------------------------------------ CLI

SPHERE256 = ["--synthetic", "sphere", "--synthetic_n", "256", "--device", "cpu"]


@pytest.mark.parametrize("argv", [
    ["--demo", "asapp_demo"],
    ["--mode", "async", "--num_robots", "3", "--RGD_stepsize", "0.2",
     "--asynchronous_rate", "200", "--max_iteration_number", "40",
     "--asapp_tolerance", "0"],
    ["--asynchronous", "true", "--num_robots", "3", "--RGD_stepsize", "1e-5",
     "--asynchronous_rate", "100", "--max_iteration_number", "40",
     "--RGD_use_preconditioner", "false", "--asapp_stepsize_decay_ticks", "20"],
], ids=["asapp_demo", "mode_async", "asynchronous_flag"])
def test_cli_async_prints_jax_summary_keys(argv, tmp_path, capsys):
    logs = tmp_path / "logs"
    assert cli.main(SPHERE256 + argv + ["--log_directory", str(logs),
                                        "--output", str(tmp_path / "sol")]) == 0
    out, err = capsys.readouterr()
    summary = json.loads(out.strip().splitlines()[-1])
    assert list(summary) == ["mode", "ticks", "steps_per_tick", "converged",
                             "final_cost", "wall_time_sec"]
    assert summary["mode"] == "async"
    timing = json.loads(err.split("timing_sec ", 1)[1].splitlines()[0])
    assert set(timing) == {"init", "solve", "rounding", "export", "ticks", "counters"}
    assert timing["ticks"] == summary["ticks"]
    if "--demo" in argv:
        assert summary["steps_per_tick"] == 1 and summary["converged"]
        assert summary["ticks"] < 1000
    else:
        assert summary["ticks"] == 40 and not summary["converged"]
        assert summary["steps_per_tick"] == (2 if "200" in argv else 1)
    assert np.isfinite(summary["final_cost"])
    assert (tmp_path / "sol_global.g2o").stat().st_size > 0
    assert any(logs.rglob("*.csv"))


def test_cli_asapp_demo_extras():
    summary, extras = cli.run(SPHERE256 + ["--demo", "asapp_demo",
                                           "--max_iteration_number", "60"])
    assert summary["final_cost"] < extras["initial_cost"]
    assert extras["costs"][0] == pytest.approx(extras["initial_cost"], rel=1e-6)
    assert np.isfinite(extras["ate_vs_ground_truth"])
    a = cli.build_parser().parse_args(["--demo", "asapp_demo",
                                       "--max_delayed_iterations", "5"])
    cli.apply_demo(a, cli.build_parser())
    assert (a.max_delayed_iterations, a.num_robots, a.RGD_stepsize,
            a.asynchronous_rate, a.local_initialization_method) == (
        5, 5, 0.2, 100.0, "Chordal")


# ------------------------------------------------------------ card


@pytest.mark.cuda
def test_tick_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 chip_smoke.py)")
    data, gt = world("sphere256")
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cuda")
    teng = ASAPPEngine(tp, port_config(_cfg(3, K=2, steps=2, dtype="float32")))
    st = teng.init_state(torch.as_tensor(_manifold_state(gt, seed=12),
                                         dtype=torch.float32, device="cuda"))
    st = st._replace(hist=torch.stack([st.X, st.X.flip(0), st.X.roll(7, 0)]))
    delays = torch.tensor([0, 1, 2], dtype=torch.int32, device="cuda")
    args = (st.X, st.hist, teng._masks, teng._Pinv, tp.edges, delays, 0.2, 2,
            True, teng._offsets)
    launches = profiling.launches()["k3"]
    X_k, m_k = fused_asapp.asapp_tick_fused(*args, windows=teng._windows)
    assert profiling.launches()["k3"] == launches + 1
    X_p, m_p = fused_asapp.asapp_tick_fused_ref(*args)
    assert rel_err(X_k.cpu(), X_p.cpu()) < 1e-4
    assert rel_err(m_k.cpu(), m_p.cpu()) < 1e-3
