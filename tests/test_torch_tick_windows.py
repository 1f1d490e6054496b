"""K3 on the robots' windows and the async runner's device-side stop.

On the card K3 ticks each robot as one thread-block cluster on its window
(``hbm_rtr.prepare_windows``: its block fresh from X, its separators from
its stale ring slot, the edges that touch the block). Its windowed plain
version is ``fused_asapp.asapp_tick_window_ref``; the runner's stop test
stays on the device (a ``live`` flag K3 reads, the ring write, the recorded
row and a tick counter predicated on it; one host read per chunk). Held
here:

1. fp64: one windowed plain tick against the JAX XLA tick (``_tick_impl``)
   and against the port's full-width plain tick, K = 3, 1 and 2 steps, with
   and without the preconditioner (X and movement to 1e-9).
2. fp32: three chained windowed plain ticks against the JAX Pallas tick in
   interpret mode (its lane-windowed kernel), 1 and 2 steps, K = 3, with the
   JAX package's tolerances (X ≤ 2e-4 of max |X|, movement rtol 2e-3).
3. A run whose stop falls mid-chunk is a run of exactly the ticks it ran
   (X, ring buffer, generator, movement and its history bit for bit), for
   chunks that end before, at and after the stop; the wrapper's ``live``
   flag and window checks.
The CUDA kernel itself runs only on the card (``python3 chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.parallel.asapp import ASAPPEngine as JaxASAPP
from dpgo_ros_tpu.parallel.asapp import ASAPPState as JaxState
from dpgo_ros_tpu.utils.config import AgentConfig
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_asapp, hbm_rtr
from dpgo_ros_tpu_torch.parallel.asapp import ASAPPEngine
from torch_parity import noisy_lifted_gt, port_config, rel_err, world

SEED = 11
K = 3


def _cfg(robots, steps=1, precond=True, dtype="float64", **kw):
    return AgentConfig(
        num_robots=robots, asynchronous=True, RGD_stepsize=0.2 if precond else 1e-5,
        asynchronous_rate=100.0 * steps, RGD_use_preconditioner=precond,
        max_delayed_iterations=K, dtype=dtype, seed=SEED, **kw,
    )


def _manifold_state(gt, seed, noise=0.05):
    """A lifted state near the ground truth with orthonormal rotation
    blocks (polar factor by SVD)."""
    X = noisy_lifted_gt(gt, 5, seed=seed, noise=noise)
    U, _, Vt = np.linalg.svd(X[..., :-1], full_matrices=False)
    X[..., :-1] = U @ Vt
    return X


def _engines(name, dtype, **kw):
    data, gt = world(name)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    tp = LiftedProblem.from_data(data, r=5, dtype=tdt, device="cpu")
    jp = JaxProblem.from_data(data, r=5, dtype=jdt)
    cfg = _cfg(tp.num_robots, dtype=dtype, **kw)
    return jp, tp, gt, cfg, tdt


def _window_tick(teng, X, H, delays, tick=0):
    return fused_asapp.asapp_tick_window_ref(
        X, H, teng._Pinv, teng.problem.edges, delays, teng.stepsize_at(tick),
        teng.steps_per_tick, teng.rgd.use_preconditioner, teng._windows)


# ------------------------------------------------------------ 1. fp64


@pytest.mark.parametrize("name", ["sphere256", "grid3d4"])
@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("precond", [True, False])
def test_window_tick_matches_jax_xla_tick_fp64(name, steps, precond):
    jp, tp, gt, cfg, tdt = _engines(name, "float64", steps=steps, precond=precond)
    jeng, teng = JaxASAPP(jp, cfg), ASAPPEngine(tp, port_config(cfg))
    R = tp.num_robots
    X = _manifold_state(gt, seed=1)
    H = np.stack([_manifold_state(gt, seed=2 + j) for j in range(K + 1)])
    key = jax.random.PRNGKey(7)
    jst = JaxState(X=jnp.asarray(X), hist=jnp.asarray(H), tick=jnp.asarray(3, jnp.int32),
                   key=key, rel_change=jnp.full((R,), jnp.inf, jnp.float64))
    jout = jeng._tick(jst)
    delays = torch.tensor(np.asarray(
        jax.random.randint(jax.random.split(key)[1], (R,), 0, K + 1)), dtype=torch.int32)
    Xt, Ht = torch.as_tensor(X), torch.as_tensor(H)
    X_w, m_w = _window_tick(teng, Xt, Ht, delays, tick=3)
    assert rel_err(X_w.numpy(), jout.X) < 1e-9
    assert rel_err(m_w.numpy(), jout.rel_change) < 1e-9
    assert float(m_w.min()) > 0  # every robot moved
    X_f, m_f = fused_asapp.asapp_tick_fused_ref(
        Xt, Ht, teng._masks, teng._Pinv, tp.edges, delays, teng.stepsize_at(3),
        steps, precond, teng._offsets)
    assert rel_err(X_w.numpy(), X_f.numpy()) < 1e-12
    assert rel_err(m_w.numpy(), m_f.numpy()) < 1e-12


# ------------------------------------------------------------ 2. fp32


def _jax_delays(ticks, R):
    """The JAX engine's delay stream from PRNGKey(SEED)."""
    key, rows = jax.random.PRNGKey(SEED), []
    for _ in range(ticks):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.randint(sub, (R,), 0, K + 1)))
    return torch.tensor(np.stack(rows), dtype=torch.int32)


@pytest.mark.parametrize("steps", [1, 2])
def test_window_ticks_match_jax_pallas_kernel_fp32(steps):
    jp, tp, gt, cfg, tdt = _engines("sphere256", "float32", steps=steps)
    jeng = JaxASAPP(jp, dataclasses.replace(cfg, use_fused_kernel=True))
    assert jeng._use_fused
    teng = ASAPPEngine(tp, port_config(cfg))
    T = 3
    X0 = _manifold_state(gt, seed=3).astype(np.float32)
    jst = jeng.make_fused_run()(jeng.init_state(jnp.asarray(X0)), jnp.asarray(T, jnp.int32))
    X = torch.as_tensor(X0)
    H = X.unsqueeze(0).repeat(K + 1, 1, 1, 1)
    table = _jax_delays(T, tp.num_robots)
    for t in range(T):
        X_new, moved = _window_tick(teng, X, H, table[t], tick=t)
        H[t % (K + 1)] = X
        X = X_new
    scale = float(np.max(np.abs(np.asarray(jst.X))))
    assert float(np.max(np.abs(X.numpy() - np.asarray(jst.X)))) < 2e-4 * scale
    assert float(np.max(np.abs(H.numpy() - np.asarray(jst.hist)))) < 2e-4 * scale
    np.testing.assert_allclose(moved.numpy(), np.asarray(jst.rel_change), rtol=2e-3,
                               atol=1e-5)


# ------------------------------------------------------------ 3. the stop


@pytest.fixture(scope="module")
def grid():
    _, tp, gt, cfg, _ = _engines("grid3d4", "float64")
    teng = ASAPPEngine(tp, port_config(cfg))
    return teng, torch.as_tensor(_manifold_state(gt, seed=9, noise=0.1))


@pytest.mark.parametrize("chunk", [5, 7, 400])
def test_stop_mid_chunk_is_a_run_of_the_ticks_it_ran(grid, chunk):
    teng, X0 = grid
    st, info = teng.run(X0, num_ticks=400, chunk=chunk, tol=5e-3, record=True)
    ran = info["ticks"]
    assert info["converged"] and 0 < ran < 400
    if chunk != 5:
        assert ran % chunk, "the stop must fall inside a chunk"
    ref, rinfo = teng.run(X0, num_ticks=ran, chunk=400, record=True)
    assert torch.equal(st.X, ref.X) and torch.equal(st.hist, ref.hist)
    assert torch.equal(st.rng, ref.rng)
    assert torch.equal(st.rel_change, ref.rel_change)
    assert np.array_equal(info["rel_hist"], rinfo["rel_hist"])
    assert info["rel_hist"].shape == (ran, 2)
    assert np.all(info["rel_hist"][-1] < 5e-3) and not np.all(info["rel_hist"][-2] < 5e-3)


def test_stopped_tick_returns_x_and_the_movement_it_was_given(grid):
    teng, X0 = grid
    st = teng.init_state(X0)
    rel = torch.tensor([0.25, 0.5], dtype=torch.float64)
    args = (st.X, st.hist, teng._masks, teng._Pinv, teng.problem.edges,
            torch.zeros(2, dtype=torch.int32), 0.2, 1, True, teng._offsets)
    kw = dict(windows=teng._windows, rel=rel)
    X1, m1 = fused_asapp.asapp_tick_fused(*args, live=torch.tensor(0, dtype=torch.int32), **kw)
    assert torch.equal(X1, st.X) and torch.equal(m1, rel)
    X2, m2 = fused_asapp.asapp_tick_fused(*args, live=torch.tensor(1, dtype=torch.int32), **kw)
    X3, m3 = fused_asapp.asapp_tick_fused(*args)
    assert torch.equal(X2, X3) and torch.equal(m2, m3) and not torch.equal(X2, st.X)


@pytest.mark.parametrize("bad", ["no-windows", "colour-rows", "other-world", "live-alone",
                                 "live-dtype", "rel-shape"])
def test_tick_wrapper_checks_windows_and_stop_flag(grid, bad):
    teng, X0 = grid
    st = teng.init_state(X0)
    args = (st.X, st.hist, teng._masks, teng._Pinv, teng.problem.edges,
            torch.zeros(2, dtype=torch.int32), 0.2, 1, True, teng._offsets)
    kw, err = dict(windows=teng._windows), ValueError
    if bad == "no-windows":
        # the CPU path needs none; the card's wrapper always checks them
        with pytest.raises(ValueError, match="windows="):
            fused_asapp._check_windows(st.X, teng._masks, teng.problem.edges, None)
        return
    if bad == "colour-rows":
        kw["windows"] = hbm_rtr.prepare_row_windows(teng.problem, [(0, 1)])
    elif bad == "other-world":
        data, _ = world("sphere256")
        kw["windows"] = hbm_rtr.prepare_windows(
            LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu"))
    elif bad == "live-alone":
        kw["live"] = torch.tensor(1, dtype=torch.int32)
    elif bad == "live-dtype":
        kw.update(live=torch.tensor(1), rel=torch.zeros(2, dtype=torch.float64))
        err = TypeError
    else:
        kw.update(live=torch.tensor(1, dtype=torch.int32),
                  rel=torch.zeros(3, dtype=torch.float64))
        err = TypeError
    with pytest.raises(err):
        fused_asapp.asapp_tick_fused(*args, **kw)
