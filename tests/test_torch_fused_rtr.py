"""Port parity: the RTR block solve (K1) against the JAX package.

1. The port's ``rtr_solve_fused`` on CPU tensors (its plain version) in
   fp32 against the JAX Pallas kernel in interpret mode, with the
   tolerances of tests/test_fused_rtr.py::test_fused_single_solve_matches_xla.
2. The port's ``rtr_solve`` against JAX ``rtr_solve`` in fp64: the same TR
   iteration count and X to rel 1e-8.
The CUDA kernel itself runs only on the card (``python3 chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models import local_solvers as j_ls
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import fused_rtr as j_fused
from dpgo_ros_tpu.ops import quadratic as j_quad
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr, quadratic, stiefel
from dpgo_ros_tpu_torch.utils import profiling
from torch_parity import noisy_lifted_gt, random_state, rel_err, world

DEMO = dict(max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5)


def _masks(prob, which):
    rof = np.asarray(prob.robot_of_pose)
    sel = (rof == 0) if which == "robot0" else np.isin(rof, (0, 2))
    return sel.astype(np.float64)[:, None, None]


def _offsets(prob):
    return torch.tensor(
        np.concatenate([prob.offsets, [prob.n]]), dtype=torch.int32
    )


@pytest.mark.parametrize(
    "name,which", [("sphere256", "robot0"), ("sphere256", "robots0+2"),
                   ("grid3d4", "robot0")],
)
def test_fused_cpu_matches_pallas_interpret(name, which):
    data, gt = world(name)
    jp = JaxProblem.from_data(data, r=5, dtype=jnp.float32)
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
    X = noisy_lifted_gt(gt, 5, seed=11).astype(np.float32)
    mask = _masks(jp, which).astype(np.float32)
    e = jp.edges
    Pinv = np.array(j_quad.precond_inverse(j_quad.precond_blocks(e, jp.n)))
    kg = j_fused.build_kernel_graph(jp)
    Xt_j, s_j = j_fused.rtr_solve_fused(
        j_fused.to_t(jnp.asarray(X), kg.n_pad),
        j_fused.mask_to_row(jnp.asarray(mask), kg.n_pad),
        j_fused.pinv_to_t(jnp.asarray(Pinv), kg.n_pad),
        kg.weight_rows(e, e.weight), kg, j_ls.RTRParams(**DEMO),
        interpret=True,
    )
    X_j = np.where(mask > 0, np.asarray(j_fused.from_t(Xt_j, jp.n, 5, 4)), X)
    s_j = np.asarray(s_j)[0]

    launches = profiling.launches()["k1"]
    X_t, s_t = fused_rtr.rtr_solve_fused(
        torch.as_tensor(X), torch.as_tensor(mask), torch.as_tensor(Pinv),
        tp.edges, RTRParams(**DEMO), offsets=_offsets(tp),
    )
    assert profiling.launches()["k1"] == launches  # CPU tensors: plain version
    X_t = np.where(mask > 0, X_t.numpy(), X)
    s_t = s_t.numpy()
    R = tp.num_robots
    assert s_t.shape == (6 + 2 * R,)
    assert s_t[0] == pytest.approx(float(s_j[0]), rel=1e-4)
    assert s_t[1] == pytest.approx(float(s_j[1]), rel=1e-3)
    assert s_t[2] == pytest.approx(float(s_j[2]), rel=1e-3)
    assert int(s_t[4]) == int(s_j[4])
    assert rel_err(X_t, X_j) < 1e-3
    moved_j = s_j[j_fused._S_MOVED:j_fused._S_MOVED + R]
    upd_j = s_j[j_fused._S_UPD:j_fused._S_UPD + R]
    np.testing.assert_array_equal(s_t[6 + R:], upd_j)
    np.testing.assert_allclose(s_t[6:6 + R], moved_j, rtol=1e-3, atol=1e-6)
    assert (s_t[6:6 + R][upd_j == 0] == 0).all()


@pytest.mark.parametrize(
    "state,params",
    [("near", DEMO), ("random", DEMO),
     ("near", dict(max_iterations=8, max_tcg_iterations=30, gradnorm_tol=1e-3))],
)
def test_rtr_solve_matches_jax_fp64(state, params):
    data, gt = world("sphere256")
    jp = JaxProblem.from_data(data, r=5, dtype=jnp.float64)
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    if state == "near":
        X = noisy_lifted_gt(gt, 5, seed=12)
    else:
        X = random_state(jp.n, 5, 3, seed=13, p_scale=3.0)
    mask = _masks(jp, "robot0")
    Pinv = np.array(j_quad.precond_inverse(j_quad.precond_blocks(jp.edges, jp.n)))
    X_j, res_j = j_ls.rtr_solve(
        jnp.asarray(X), jp.edges, jnp.asarray(mask), jnp.asarray(Pinv),
        j_ls.RTRParams(**params),
    )
    X_t, res_t = rtr_solve(
        torch.as_tensor(X), tp.edges, torch.as_tensor(mask),
        torch.as_tensor(Pinv), RTRParams(**params),
    )
    assert res_t.iterations == int(res_j.iterations)
    assert rel_err(X_t.numpy(), X_j) < 1e-8
    for a, b in [(res_t.f_init, res_j.f_init), (res_t.f_opt, res_j.f_opt),
                 (res_t.gradnorm_opt, res_j.gradnorm_opt)]:
        assert float(a) == pytest.approx(float(b), rel=1e-8)


def test_plain_version_stats_layout():
    data, gt = world("grid3d4")
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    X = torch.as_tensor(noisy_lifted_gt(gt, 5, seed=14))
    mask = torch.as_tensor(_masks(tp, "robot0"))
    Pinv = quadratic.precond_inverse(quadratic.precond_blocks(tp.edges, tp.n))
    X_f, s_f = fused_rtr.rtr_solve_fused_ref(
        X, mask, Pinv, tp.edges, RTRParams(**DEMO), offsets=_offsets(tp)
    )
    X_r, res = rtr_solve(X, tp.edges, mask, Pinv, RTRParams(**DEMO))
    assert torch.equal(X_f, X_r)
    assert s_f[fused_rtr.S_ITERS] == res.iterations
    assert s_f[fused_rtr.S_TCG] == res.tcg_iterations >= res.iterations
    assert s_f[fused_rtr.S_F] == res.f_opt
    moved = torch.sqrt(((X_r - X)[: tp.num_poses[0]] ** 2).sum())
    assert float(s_f[fused_rtr.S_MOVED]) == pytest.approx(float(moved), rel=1e-12)
    assert s_f[fused_rtr.S_MOVED + 1] == 0
    assert s_f[fused_rtr.S_MOVED + 2:].tolist() == [1.0, 0.0]


@pytest.mark.parametrize("bad", ["strided", "rank9", "offsets_dtype", "pinv_shape"])
def test_wrapper_rejects_operands_the_kernel_cannot_take(bad):
    data, gt = world("grid3d4")
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cpu")
    X = torch.as_tensor(noisy_lifted_gt(gt, 5, seed=15), dtype=torch.float32)
    mask = torch.as_tensor(_masks(tp, "robot0"), dtype=torch.float32)
    Pinv = torch.eye(4).expand(tp.n, 4, 4).contiguous()
    offs = _offsets(tp)
    err = ValueError
    if bad == "strided":
        X = X.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "rank9":
        X = torch.zeros((tp.n, 9, 4))
    elif bad == "offsets_dtype":
        offs, err = offs.long(), TypeError
    else:
        Pinv = Pinv[:, :3, :3]
    with pytest.raises(err):
        fused_rtr.rtr_solve_fused(X, mask, Pinv, tp.edges, RTRParams(**DEMO), offs)


def test_build_failure_raises(tmp_path, monkeypatch):
    """A kernel that does not compile raises; nothing falls back."""
    src = tmp_path / "broken.cu"
    src.write_text("this is not CUDA\n")
    monkeypatch.setattr(fused_rtr, "SOURCE", src)
    monkeypatch.setattr(fused_rtr, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fused_rtr, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fused_rtr.build()


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 chip_smoke.py)")
    data, gt = world("sphere256")
    tp = LiftedProblem.from_data(data, r=5, dtype=torch.float32, device="cuda")
    X = torch.as_tensor(noisy_lifted_gt(gt, 5, seed=16), dtype=torch.float32,
                        device="cuda")
    # on the manifold, as the solver's iterates: the kernel retracts the
    # window only, the plain version every pose
    X = stiefel.retract_polar_ns(X, torch.zeros_like(X))
    mask = torch.as_tensor(_masks(tp, "robot0"), dtype=torch.float32, device="cuda")
    Pinv = quadratic.precond_inverse(quadratic.precond_blocks(tp.edges, tp.n)).contiguous()
    offs = _offsets(tp).cuda()
    launches = profiling.launches()["k1"]
    X_k, s_k = fused_rtr.rtr_solve_fused(X, mask, Pinv, tp.edges, RTRParams(**DEMO), offs,
                                         windows=hbm_rtr.prepare_windows(tp), row=0)
    assert profiling.launches()["k1"] == launches + 1
    X_p, s_p = fused_rtr.rtr_solve_fused_ref(X, mask, Pinv, tp.edges, RTRParams(**DEMO), offs)
    X_p = torch.where(mask > 0, X_p, X)
    assert int(s_k[4]) == int(s_p[4])
    assert float(s_k[1]) == pytest.approx(float(s_p[1]), rel=1e-4)
    assert rel_err(X_k.cpu(), X_p.cpu()) < 1e-4
