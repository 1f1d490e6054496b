"""Port parity: dpgo_ros_tpu_torch ops against the JAX package in fp64.

Same numpy inputs go through both; the JAX side is deterministic XLA CPU
math (conftest enables x64). Tolerance: rel 1e-9 of the reference's max
magnitude — both sides are fp64 and differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import chordal as j_chordal
from dpgo_ros_tpu.ops import lie as j_lie
from dpgo_ros_tpu.ops import quadratic as j_quad
from dpgo_ros_tpu.ops import rounding as j_round
from dpgo_ros_tpu.ops import stiefel as j_stiefel
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import chordal, lie, quadratic, rounding, stiefel
from torch_parity import WORLDS, noisy_lifted_gt, random_state, rel_err, world

TOL = 1e-9
T64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=T64)


@pytest.fixture(scope="module", params=sorted(WORLDS))
def problems(request):
    data, gt = world(request.param)
    return (
        JaxProblem.from_data(data, r=5, dtype=jnp.float64),
        LiftedProblem.from_data(data, r=5, dtype=T64, device="cpu"),
        gt,
    )


def _random_se3(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    Q[np.linalg.det(Q) < 0, :, 0] *= -1
    return np.concatenate([Q, rng.standard_normal((n, 3, 1))], axis=-1)


def test_pull_index_matches_jax(problems):
    jp, tp, _ = problems
    np.testing.assert_array_equal(tp.edges.pull.numpy(), np.asarray(jp.edges.pull))
    src, dst = np.asarray(jp.edges.src), np.asarray(jp.edges.dst)
    pull = quadratic.build_pull_index(src, dst, jp.n)
    np.testing.assert_array_equal(pull, j_quad.build_pull_index(src, dst, jp.n))
    # the zero row is 2E, the only row the kernel and pull_sum append
    assert pull.max() == 2 * len(src)


@pytest.mark.parametrize("op", ["compose", "inverse", "project", "odometry"])
def test_lie(op):
    A, B = _random_se3(40, 1), _random_se3(40, 2)
    if op == "compose":
        ref, got = j_lie.se_compose(A, B), lie.se_compose(_t(A), _t(B))
    elif op == "inverse":
        ref, got = j_lie.se_inverse(A), lie.se_inverse(_t(A))
    elif op == "project":
        M = np.random.default_rng(3).standard_normal((40, 3, 3))
        ref, got = j_lie.project_to_so(M), lie.project_to_so(_t(M))
    else:
        ref, got = j_lie.odometry_chain(jnp.asarray(A)), lie.odometry_chain(_t(A))
    assert got.shape == tuple(ref.shape)
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("op", ["proj", "retract_ns", "lift", "inner"])
def test_stiefel(op):
    X = random_state(50, 5, 3, seed=4)
    V = 0.3 * np.random.default_rng(5).standard_normal(X.shape)
    if op == "proj":
        ref, got = j_stiefel.proj_tangent(X, V), stiefel.proj_tangent(_t(X), _t(V))
    elif op == "retract_ns":
        ref = j_stiefel.retract_polar_ns(jnp.asarray(X), jnp.asarray(V))
        got = stiefel.retract_polar_ns(_t(X), _t(V))
    elif op == "lift":
        T, Yl = _random_se3(50, 6), X[0, :, :3]
        ref, got = j_stiefel.lift_trajectory(T, Yl), stiefel.lift_trajectory(_t(T), _t(Yl))
    else:
        ref = j_stiefel.tangent_norm(jnp.asarray(V))
        got = stiefel.tangent_norm(_t(V))
        assert rel_err(stiefel.inner(_t(X), _t(V)), j_stiefel.inner(X, V)) < TOL
    assert rel_err(got, ref) < TOL


def test_random_stiefel_is_on_manifold():
    gen = torch.Generator().manual_seed(0)
    Y = stiefel.random_stiefel(gen, 7, 5, 3, dtype=T64)
    G = Y.transpose(-1, -2) @ Y
    assert torch.allclose(G, torch.eye(3, dtype=T64).expand(7, 3, 3), atol=1e-12)
    Yl = stiefel.random_lifting_matrix(torch.Generator().manual_seed(3), 5, 3)
    assert torch.allclose(Yl.T @ Yl, torch.eye(3, dtype=T64), atol=1e-12)
    again = stiefel.random_lifting_matrix(torch.Generator().manual_seed(3), 5, 3)
    assert torch.equal(Yl, again)


@pytest.mark.parametrize(
    "op", ["cost", "egrad", "apply_Q", "rgrad", "rhess_vp",
           "precond_blocks", "precond_inverse", "precond_apply"],
)
def test_quadratic(problems, op):
    jp, tp, _ = problems
    je, te = jp.edges, tp.edges
    X = random_state(jp.n, 5, 3, seed=7)
    V = np.random.default_rng(8).standard_normal(X.shape)
    jX, jV, tX, tV = jnp.asarray(X), jnp.asarray(V), _t(X), _t(V)
    if op == "cost":
        ref, got = j_quad.cost(jX, je), quadratic.cost(tX, te)
    elif op == "egrad":
        ref, got = j_quad.egrad(jX, je), quadratic.egrad(tX, te)
    elif op == "apply_Q":
        ref, got = j_quad.apply_Q(jV, je), quadratic.apply_Q(tV, te)
    elif op == "rgrad":
        ref, got = j_quad.rgrad(jX, je), quadratic.rgrad(tX, te)
    elif op == "rhess_vp":
        ref, got = j_quad.rhess_vp(jX, jV, je), quadratic.rhess_vp(tX, tV, te)
    else:
        jP = j_quad.precond_blocks(je, jp.n)
        tP = quadratic.precond_blocks(te, tp.n)
        if op == "precond_blocks":
            ref, got = jP, tP
        elif op == "precond_inverse":
            ref, got = j_quad.precond_inverse(jP), quadratic.precond_inverse(tP)
        else:
            ref = j_quad.precond_apply(j_quad.precond_inverse(jP), jV)
            got = quadratic.precond_apply(quadratic.precond_inverse(tP), tV)
    assert got.shape == tuple(np.shape(ref))
    assert rel_err(got, ref) < TOL


def test_chordal_initialization(problems):
    jp, tp, _ = problems
    ref = j_chordal.chordal_initialization(jp.edges, jp.n)
    got = chordal.chordal_initialization(tp.edges, tp.n)
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("op", ["round_anchor", "anchor", "umeyama", "ate"])
def test_rounding(problems, op):
    jp, _, gt = problems
    X = noisy_lifted_gt(gt, 5, seed=9, noise=0.02)
    est = _random_se3(gt.shape[0], 10)
    if op == "round_anchor":
        # rounding is defined up to the sign gauge of U_d; anchoring fixes it
        ref = j_round.anchor_to_first_pose(j_round.round_solution(jnp.asarray(X)))
        got = rounding.anchor_to_first_pose(rounding.round_solution(_t(X)))
    elif op == "anchor":
        ref = j_round.anchor_to_first_pose(jnp.asarray(est), jnp.asarray(gt[3]))
        got = rounding.anchor_to_first_pose(_t(est), _t(gt[3]))
    elif op == "umeyama":
        ref = j_round.align_umeyama(jnp.asarray(est), jnp.asarray(gt))
        got = rounding.align_umeyama(_t(est), _t(gt))
    else:
        ref = j_round.ate_translation(jnp.asarray(est), jnp.asarray(gt))
        got = rounding.ate_translation(_t(est), _t(gt))
    assert rel_err(got, ref) < TOL
