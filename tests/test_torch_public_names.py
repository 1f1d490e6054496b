"""Port parity: the public functions the port lacked until now, against
the JAX package on the same seeded numpy inputs (fp64, to 1e-12).

``LiftedProblem``'s bookkeeping (``counts_by_type``, ``num_measurements``,
``host_edges``, ``pose_block``, ``global_trajectory``,
``separator_mask``), ``rounding.round_via_lifting``,
``quadratic.precond_solve``, ``stiefel.retract_qr`` and
``lie.rotation_geodesic_distance``. The JAX package's TPU operand layouts
(``fused_rtr.KernelGraph`` and the rest) stay unported by design
(ROADMAP.md).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import lie as j_lie
from dpgo_ros_tpu.ops import quadratic as j_quad
from dpgo_ros_tpu.ops import rounding as j_rounding
from dpgo_ros_tpu.ops import stiefel as j_stiefel
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import lie, quadratic, rounding, stiefel
from torch_parity import random_state

TOL = 1e-12


@pytest.fixture(scope="module")
def problems():
    data, _, _ = generate_world("sphere", n=300, num_robots=3, seed=2, outlier_ratio=0.1)
    return (data, JaxProblem.from_data(data, r=5, dtype=jnp.float64),
            LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu"))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * max(1.0, np.max(np.abs(b)))


def test_problem_bookkeeping_matches_jax(problems):
    data, jp, tp = problems
    assert tp.counts_by_type() == jp.counts_by_type() and sum(tp.counts_by_type()) > 0
    assert tp.num_measurements() == jp.num_measurements() == len(data.measurements)
    for f in ("src", "dst", "R", "t", "kappa", "tau", "weight", "mask", "is_loop", "pull"):
        np.testing.assert_array_equal(getattr(tp.host_edges, f),
                                      np.asarray(getattr(jp.host_edges, f)), err_msg=f)
    X = random_state(tp.n, 5, 3, seed=4)
    for k in range(tp.num_robots):
        blk = tp.pose_block(torch.as_tensor(X), k)
        assert blk.shape[0] == int(tp.num_poses[k])
        np.testing.assert_array_equal(blk.numpy(), np.asarray(jp.pose_block(jnp.asarray(X), k)))
    np.testing.assert_array_equal(tp.global_trajectory(data), jp.global_trajectory(data))
    assert tp.global_trajectory(data).shape == (tp.n, 3, 4)
    no_guess = type(data)(measurements=data.measurements, num_poses=data.num_poses, d=3)
    assert tp.global_trajectory(no_guess) is None is jp.global_trajectory(no_guess)
    sep = tp.separator_mask()
    assert sep.dtype == torch.float64 and sep.device == tp.device
    np.testing.assert_array_equal(sep.numpy(), np.asarray(jp.separator_mask()))
    assert 0 < float(sep.sum()) < tp.n


def test_round_via_lifting_matches_jax():
    rng = np.random.default_rng(5)
    X = random_state(50, 5, 3, seed=6)
    Ylift, _ = np.linalg.qr(rng.standard_normal((5, 3)))
    _close(rounding.round_via_lifting(torch.as_tensor(X), torch.as_tensor(Ylift)).numpy(),
           j_rounding.round_via_lifting(jnp.asarray(X), jnp.asarray(Ylift)))


def test_round_via_lifting_recovers_lifted_poses():
    rng = np.random.default_rng(7)
    T = np.asarray(j_rounding.round_via_lifting(
        jnp.asarray(random_state(20, 3, 3, seed=8)), jnp.eye(3)))
    Ylift, _ = np.linalg.qr(rng.standard_normal((5, 3)))
    X = np.einsum("rd,ndk->nrk", Ylift, T)
    _close(rounding.round_via_lifting(torch.as_tensor(X), torch.as_tensor(Ylift)).numpy(), T)


def test_precond_solve_matches_jax(problems):
    _, jp, tp = problems
    P = np.array(j_quad.precond_blocks(jp.edges, jp.n))
    V = np.random.default_rng(9).standard_normal((tp.n, 5, 4))
    out = quadratic.precond_solve(torch.as_tensor(P), torch.as_tensor(V)).numpy()
    _close(out, j_quad.precond_solve(jnp.asarray(P), jnp.asarray(V)))
    Pinv = quadratic.precond_inverse(torch.as_tensor(P))
    _close(quadratic.precond_apply(Pinv, torch.as_tensor(V)).numpy(), out, 1e-10)


@pytest.mark.parametrize("d", [2, 3])
def test_retract_qr_matches_jax(d):
    X = random_state(40, 5, d, seed=10)
    V = 0.3 * np.random.default_rng(11).standard_normal(X.shape)
    out = stiefel.retract_qr(torch.as_tensor(X), torch.as_tensor(V))
    _close(out.numpy(), j_stiefel.retract_qr(jnp.asarray(X), jnp.asarray(V)))
    Y = out[..., :d]
    _close((Y.transpose(-1, -2) @ Y).numpy(), np.broadcast_to(np.eye(d), (40, d, d)))


@pytest.mark.parametrize("d", [2, 3])
def test_rotation_geodesic_distance_matches_jax(d):
    Ra = random_state(60, d, d, seed=12)[..., :d]
    Rb = random_state(60, d, d, seed=13)[..., :d]
    for R in (Ra, Rb):  # proper rotations
        R[np.linalg.det(R) < 0, :, 0] *= -1
    out = lie.rotation_geodesic_distance(torch.as_tensor(Ra), torch.as_tensor(Rb))
    _close(out.numpy(), j_lie.rotation_geodesic_distance(jnp.asarray(Ra), jnp.asarray(Rb)))
    _close(lie.rotation_geodesic_distance(torch.as_tensor(Ra), torch.as_tensor(Ra)).numpy(),
           np.zeros(60), 1e-6)
