"""K1 on windows: the block solve of a mask's window against the JAX package.

On the card K1 solves the window of its mask's block (a robot, a Parallel
colour class, all robots: ``hbm_rtr.prepare_row_windows`` /
``prepare_mask_window``) and adds the cost of the world's edges outside the
window, so that its f0 and f stay the world's. Its windowed plain version
is ``hbm_rtr.rtr_solve_window_ref``. Held here:

1. fp64: the windowed plain solve against JAX's ``rtr_solve`` full-width
   under the same mask: X, f0, f, gn0 and gn to 1e-9 and the same TR count;
   the tCG count and the per-robot moved / updated of the port's
   full-width K1 plain version (``rtr_solve_fused_ref``, held to JAX by
   tests/test_torch_fused_rtr.py). Cases: the colour classes of a
   500-pose 5-robot sphere (the dpgo_demo world's layout at a fifth of its
   size), those of a 300-pose 4-robot SE(2) ring, and the sphere's
   all-ones mask.
2. fp32: the same windowed plain solve against the JAX Pallas K1
   (``rtr_solve_fused``) in interpret mode, with the tolerances of
   tests/test_torch_fused_rtr.py: the Pallas kernel is fp32 with bf16-split
   products, so 1e-9 holds only against the fp64 solve of 1.
3. The mask's window and the wrapper's window checks; the Parallel engine
   hands K1 its colour windows.
The CUDA kernel itself runs only on the card (``python3 chip_smoke.py``;
the ``cuda``-marked case skips without one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import se2_world
from dpgo_ros_tpu.models import local_solvers as j_ls
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import fused_rtr as j_fused
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr, quadratic, stiefel
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.utils import profiling
from dpgo_ros_tpu_torch.utils.config import AgentConfig, UpdateRule
from torch_parity import rel_err, world

DEMO = dict(max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5)
TOL64 = 1e-9


def _data(name):
    if name == "sphere500":
        return generate_world("sphere", n=500, num_robots=5, seed=1)[:2]
    if name == "se2-ring":
        return se2_world(300, 4, seed=3)
    return world(name)


def _on_manifold(gt, seed, dtype):
    """The ground truth lifted and moved by a random ambient step, retracted:
    a state on the manifold, as the solver's iterates are (off it, the
    full-width solve's retraction would move every pose, η = 0 or not)."""
    rng = np.random.default_rng(seed)
    Yl, _ = np.linalg.qr(rng.standard_normal((5, gt.shape[1])))
    X = np.einsum("rd,ndk->nrk", Yl, gt)
    V = rng.standard_normal(X.shape)
    V[..., :-1] *= 0.05
    V[..., -1] *= 0.5
    return stiefel.retract_polar_ns(torch.as_tensor(X, dtype=dtype),
                                    torch.as_tensor(V, dtype=dtype))


def _setup(name, dtype):
    """(port problem, JAX problem, the Parallel engine's colour windows and
    masks, a state on the manifold near the ground truth, P⁻¹) in
    ``dtype``."""
    data, gt = _data(name)
    tdt, jdt = (torch.float64, jnp.float64) if dtype == "float64" else (torch.float32,
                                                                         jnp.float32)
    tp = LiftedProblem.from_data(data, r=5, dtype=tdt, device="cpu")
    jp = JaxProblem.from_data(data, r=5, dtype=jdt)
    eng = RBCDEngine(tp, AgentConfig(num_robots=tp.num_robots, dtype=dtype,
                                     update_rule=UpdateRule.PARALLEL))
    X = _on_manifold(gt, 31, tdt)
    Pinv = quadratic.precond_inverse(quadratic.precond_blocks(tp.edges, tp.n))
    return tp, jp, eng, X, Pinv


def _cases(name, tp, eng):
    """(label, mask (n,), windows, row): every colour class, and on the
    sphere the all-ones mask."""
    out = [(f"color{c}", eng._color_masks[c, :, 0, 0], eng._row_windows, c)
           for c in range(eng.num_colors)]
    if name == "sphere500":
        ones = torch.ones(tp.n, dtype=tp.dtype)
        out.append(("all", ones, hbm_rtr.prepare_mask_window(tp, ones), 0))
    return out


@pytest.mark.parametrize("name", ["sphere500", "se2-ring"])
def test_window_solve_with_world_cost_matches_jax_fp64(name):
    tp, jp, eng, X, Pinv = _setup(name, "float64")
    assert any(len(r) > 1 for r in eng._row_windows.rows)  # real colour unions
    for label, mask, w, row in _cases(name, tp, eng):
        m3 = mask.reshape(-1, 1, 1)
        X_j, res = j_ls.rtr_solve(jnp.asarray(X.numpy()), jp.edges, jnp.asarray(m3.numpy()),
                                  jnp.asarray(Pinv.numpy()), j_ls.RTRParams(**DEMO))
        X_j = np.where(m3.numpy() > 0, np.asarray(X_j), X.numpy())
        X_w, s_w = hbm_rtr.rtr_solve_window_ref(X, row, Pinv, tp.edges, RTRParams(**DEMO), w)
        _, s_f = fused_rtr.rtr_solve_fused_ref(X, mask, Pinv, tp.edges, RTRParams(**DEMO),
                                               w.offsets)
        R = tp.num_robots
        assert s_w.shape == s_f.shape == (6 + 2 * R,), label
        assert int(s_w[4]) == int(res.iterations) == int(s_f[4]), label
        assert int(s_w[5]) == int(s_f[5]), label
        for i, v in enumerate((res.f_init, res.f_opt, res.gradnorm_init, res.gradnorm_opt)):
            assert float(s_w[i]) == pytest.approx(float(v), rel=TOL64), (label, i)
        assert rel_err(X_w.numpy(), X_j) < TOL64, label
        np.testing.assert_allclose(s_w[6:6 + R].numpy(), s_f[6:6 + R].numpy(), rtol=TOL64)
        assert torch.equal(s_w[6 + R:], s_f[6 + R:]), label
        assert torch.equal(X_w[mask == 0], X[mask == 0]), label  # only the block moves


@pytest.mark.parametrize("which", ["color1", "all"])
def test_window_solve_matches_pallas_interpret_fp32(which):
    tp, jp, eng, X, Pinv = _setup("sphere256", "float32")
    if which == "all":
        mask = torch.ones(tp.n)
        w, row = hbm_rtr.prepare_mask_window(tp, mask), 0
    else:
        mask, w, row = eng._color_masks[1, :, 0, 0], eng._row_windows, 1
        assert len(w.rows[row]) == 2
    m3 = mask.numpy().reshape(-1, 1, 1)
    e = jp.edges
    kg = j_fused.build_kernel_graph(jp)
    Xt_j, s_j = j_fused.rtr_solve_fused(
        j_fused.to_t(jnp.asarray(X.numpy()), kg.n_pad),
        j_fused.mask_to_row(jnp.asarray(m3), kg.n_pad),
        j_fused.pinv_to_t(jnp.asarray(Pinv.numpy()), kg.n_pad),
        kg.weight_rows(e, e.weight), kg, j_ls.RTRParams(**DEMO), interpret=True,
    )
    X_j = np.where(m3 > 0, np.asarray(j_fused.from_t(Xt_j, jp.n, 5, 4)), X.numpy())
    s_j = np.asarray(s_j)[0]
    X_t, s_t = hbm_rtr.rtr_solve_window_ref(X, row, Pinv, tp.edges, RTRParams(**DEMO), w)
    s_t = s_t.numpy()
    R = tp.num_robots
    assert s_t[0] == pytest.approx(float(s_j[0]), rel=1e-4)
    assert s_t[1] == pytest.approx(float(s_j[1]), rel=1e-3)
    assert s_t[2] == pytest.approx(float(s_j[2]), rel=1e-3)
    assert int(s_t[4]) == int(s_j[4])
    assert rel_err(X_t.numpy(), X_j) < 1e-3
    moved_j = s_j[j_fused._S_MOVED:j_fused._S_MOVED + R]
    upd_j = s_j[j_fused._S_UPD:j_fused._S_UPD + R]
    np.testing.assert_array_equal(s_t[6 + R:], upd_j)
    np.testing.assert_allclose(s_t[6:6 + R], moved_j, rtol=1e-3, atol=1e-6)


# ------------------------------------------------------------ 3. checks


@pytest.fixture(scope="module")
def sphere():
    tp, _, eng, X, Pinv = _setup("sphere500", "float64")
    return tp, eng, X, Pinv


def test_mask_window_is_the_one_row_of_its_robots(sphere):
    tp, eng, _, _ = sphere
    ones = np.ones(tp.n)
    w = hbm_rtr.prepare_mask_window(tp, ones)
    assert w.rows == (tuple(range(tp.num_robots)),)
    assert int(w.num_poses[0]) == tp.n == w.max_poses  # no separators
    assert w.max_edges == tp.edges.num_edges
    c = eng._row_windows
    w1 = hbm_rtr.prepare_mask_window(tp, eng._color_masks[1])
    assert w1.rows == (c.rows[1],)
    for a, b in zip(w1.window(0), c.window(1)):
        assert torch.equal(a, b)
    assert torch.equal(w1.robots_of(0), c.robots_of(1))


@pytest.mark.parametrize("bad", ["half-robot", "not-01", "empty", "shape"])
def test_mask_window_rejects_masks_k1_does_not_solve(sphere, bad):
    tp = sphere[0]
    m = np.zeros(tp.n)
    if bad == "half-robot":
        m[: int(tp.num_poses[0]) // 2] = 1.0
    elif bad == "not-01":
        m[: int(tp.num_poses[0])] = 0.5
    elif bad == "shape":
        m = np.ones(tp.n + 1)
    with pytest.raises(ValueError):
        hbm_rtr.prepare_mask_window(tp, m)


def test_wrapper_with_windows_runs_the_plain_version_on_cpu(sphere):
    tp, eng, X, Pinv = sphere
    mask, w = eng._color_masks[0], eng._row_windows
    launches = profiling.launches()["k1"]
    X_k, s_k = fused_rtr.rtr_solve_fused(X, mask, Pinv, tp.edges, RTRParams(**DEMO),
                                         windows=w, row=0)
    assert profiling.launches()["k1"] == launches
    X_p, s_p = fused_rtr.rtr_solve_fused_ref(X, mask, Pinv, tp.edges, RTRParams(**DEMO),
                                             w.offsets)
    assert torch.equal(X_k, X_p) and torch.equal(s_k, s_p)


@pytest.mark.parametrize("bad", ["other-row", "not-01", "row-range", "row-bool",
                                 "other-world", "offsets-shape", "offsets-values",
                                 "no-windows", "no-row"])
def test_wrapper_rejects_a_mask_that_is_not_the_rows_block(sphere, bad):
    tp, eng, X, Pinv = sphere
    mask = eng._color_masks[0].reshape(-1).clone()
    w, row, offs, err = eng._row_windows, 0, None, ValueError
    if bad == "other-row":
        row = 1
    elif bad == "not-01":
        mask[mask > 0] = 0.5
    elif bad == "row-range":
        row = w.num_rows
    elif bad == "row-bool":
        row, err = True, TypeError
    elif bad == "other-world":
        w = RBCDEngine(LiftedProblem.from_data(world("sphere256")[0], r=5,
                                               dtype=torch.float64, device="cpu"),
                       AgentConfig(num_robots=3, update_rule=UpdateRule.PARALLEL,
                                   dtype="float64"))._row_windows
    elif bad == "offsets-shape":
        offs = torch.tensor([0, tp.n], dtype=torch.int32)
    elif bad == "offsets-values":
        offs = w.offsets.clone()
        offs[1] += 1
    elif bad == "no-windows":
        w = None
    else:
        row = None
    if bad in ("no-windows", "no-row"):
        # the CPU path needs no windows; the card's always checks them
        m, *_ = fused_rtr._checked_operands("t", X, mask, Pinv, tp.edges, RTRParams(**DEMO),
                                            eng._offsets, X.dtype)
        with pytest.raises(err, match="windows= and row="):
            fused_rtr._check_window(X, m, tp.edges, eng._offsets, w, row)
        return
    with pytest.raises(err):
        fused_rtr.rtr_solve_fused(X, mask, Pinv, tp.edges, RTRParams(**DEMO), offs,
                                  windows=w, row=row)


def test_parallel_engine_hands_k1_its_colour_windows(monkeypatch):
    tp, _, eng, _, _ = _setup("sphere500", "float64")
    seen = []
    real = fused_rtr.rtr_solve_fused

    def spy(*a, windows=None, row=None, **k):
        seen.append((windows, row))
        return real(*a, windows=windows, row=row, **k)

    monkeypatch.setattr(fused_rtr, "rtr_solve_fused", spy)
    _, info = eng.run(eng.initialize(ylift=np.eye(5, 3)), max_iters=4)
    assert info["iterations"] == 4
    assert [r for _, r in seen] == eng.update_schedule(4).tolist() == [0, 1, 0, 1]
    assert all(w is eng._row_windows for w, _ in seen)


@pytest.mark.cuda
def test_kernel_on_colour_windows_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 chip_smoke.py)")
    data, gt = _data("sphere500")
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cuda")
    eng = RBCDEngine(tp, AgentConfig(num_robots=5, dtype="float32",
                                     update_rule=UpdateRule.PARALLEL))
    X = _on_manifold(gt, 32, torch.float32).cuda()
    Pinv = eng._solver_cache(tp.edges)
    for c in range(eng.num_colors):
        mask = eng._color_masks[c]
        with pytest.raises(ValueError):
            fused_rtr.rtr_solve_fused(X, mask, Pinv, tp.edges, RTRParams(**DEMO))
        X_k, s_k = fused_rtr.rtr_solve_fused(X, mask, Pinv, tp.edges, RTRParams(**DEMO),
                                             windows=eng._row_windows, row=c)
        X_p, s_p = fused_rtr.rtr_solve_fused_ref(X, mask, Pinv, tp.edges, RTRParams(**DEMO),
                                                 eng._offsets)
        X_p = torch.where(mask > 0, X_p, X)
        assert int(s_k[4]) == int(s_p[4])
        assert float(s_k[1]) == pytest.approx(float(s_p[1]), rel=1e-4)
        assert rel_err(X_k.cpu(), X_p.cpu()) < 1e-4
