"""Port parity: the dual certificate (ops/certificate.py), the Riemannian
staircase (models/certified.py) and the CLI's ``--certify`` and
``--acceleration`` against the JAX package, fp64 on the CPU.

Each certificate function takes the same X in both packages: Λ, S·V and
the criticality residual within 1e-12 relative, the sparse S entry by
entry within 1e-12 of its largest entry, the Lanczos minimum eigenvalue
within 1e-6·max(1, |λ_max|) (the JAX package's own bound,
tests/test_certificate.py). ``certify`` gives the same verdict on a
converged point (certified), a random point (fails fast on criticality,
the same residual) and a suboptimal critical point (negative min eig, the
same escape direction up to sign). The staircase takes JAX's YLift or
initial point and reaches the same rank, verdict and cost (rel 1e-8).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as sla
import torch

from dpgo_ros_tpu import cli as jax_cli
from dpgo_ros_tpu.models import certified as j_certified
from dpgo_ros_tpu.models.problem import LiftedProblem as JaxProblem
from dpgo_ros_tpu.ops import certificate as j_cert
from dpgo_ros_tpu.ops import stiefel as j_stiefel
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.models import certified
from dpgo_ros_tpu_torch.models.local_solvers import RTRParams
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import certificate, stiefel
from torch_parity import noisy_lifted_gt, random_state, rel_err, world

TOL = 1e-12


@pytest.fixture(scope="module")
def grid():
    data, gt = world("grid3d4")
    return data, gt, {r: (JaxProblem.from_data(data, r=r, dtype=jnp.float64),
                          LiftedProblem.from_data(data, r=r, dtype=torch.float64,
                                                  device="cpu"))
                      for r in (3, 5)}


@pytest.fixture(scope="module")
def converged(grid):
    """The port's staircase optimum of the grid world (rank 5, certified)."""
    data, _, _ = grid
    res = certified.certified_solve(data, device="cpu")
    assert res.certified and res.rank == 5
    return res.X


@pytest.fixture(scope="module")
def suboptimal(grid):
    """A rank-3 critical point of the grid world from a random start: a
    suboptimal one, where S has strong negative curvature."""
    _, _, probs = grid
    tp = probs[3][1]
    X0 = torch.tensor(random_state(tp.n, 3, 3, seed=0, p_scale=2.0))
    X, _ = certified._tight_rtr(X0, tp.edges, RTRParams(
        max_iterations=100, max_tcg_iterations=200, gradnorm_tol=1e-6), 10)
    return X


def _both(X):
    return jnp.asarray(X.numpy()), X


def _lam_max(S) -> float:
    return float(sla.eigsh(S, k=1, which="LA", return_eigenvectors=False)[0])


@pytest.mark.parametrize("point", ["noisy", "random"])
def test_certificate_functions_match_jax(grid, point):
    data, gt, probs = grid
    jp, tp = probs[5]
    X = torch.tensor(noisy_lifted_gt(gt, 5, seed=3) if point == "noisy"
                     else random_state(tp.n, 5, 3, seed=4))
    jX, tX = _both(X)
    jL, tL = j_cert.lambda_blocks(jX, jp.edges), certificate.lambda_blocks(tX, tp.edges)
    assert rel_err(tL.numpy(), jL) < TOL
    rng = np.random.default_rng(5)
    for rv in (1, 5):
        V = rng.standard_normal((tp.n, rv, 4))
        assert rel_err(certificate.s_matvec(torch.tensor(V), tX, tL, tp.edges).numpy(),
                       j_cert.s_matvec(jnp.asarray(V), jX, jL, jp.edges)) < TOL
    assert certificate.crit_residual(tX, tL, tp.edges) == pytest.approx(
        j_cert.crit_residual(jX, jL, jp.edges), rel=TOL)
    assert certificate._q_scale(tp.edges, tp.n) == pytest.approx(
        j_cert._q_scale(jp.edges, jp.n), rel=TOL)
    St, Sj = certificate.s_sparse(tX, tL, tp.edges), j_cert.s_sparse(jX, jL, jp.edges)
    assert St.shape == Sj.shape
    assert abs(St - Sj).max() <= TOL * abs(Sj).max()
    lam_max = _lam_max(Sj)
    vj, _ = j_cert.min_eig_lanczos(jX, jL, jp.edges)
    for host_sparse in (True, False):
        vt, vecs = certificate.min_eig_lanczos(tX, tL, tp.edges, host_sparse=host_sparse)
        assert abs(vt[0] - vj[0]) <= 1e-6 * max(1.0, abs(lam_max))
        v = vecs[:, 0]
        assert abs(v @ (St @ v) - vt[0]) <= 1e-6 * max(1.0, abs(lam_max))


def test_certify_converged_point(grid, converged):
    _, _, probs = grid
    jp, tp = probs[5]
    jX, tX = _both(converged)
    cj, ct = j_cert.certify(jX, jp.edges), certificate.certify(tX, tp.edges)
    assert ct.is_global and cj.is_global
    assert abs(ct.crit_residual - cj.crit_residual) <= TOL
    lam_max = _lam_max(certificate.s_sparse(tX, certificate.lambda_blocks(tX, tp.edges),
                                            tp.edges))
    assert abs(ct.min_eig - cj.min_eig) <= 1e-6 * max(1.0, lam_max)
    assert ct.scale == pytest.approx(cj.scale, rel=TOL)
    assert ct.margin_verified and ct.min_eig_check is None
    assert float(stiefel.check_on_manifold(tX)) < 1e-12


def test_certify_rejects_noncritical_point(grid):
    _, _, probs = grid
    jp, tp = probs[5]
    jX, tX = _both(torch.tensor(random_state(tp.n, 5, 3, seed=6, p_scale=2.0)))
    cj, ct = j_cert.certify(jX, jp.edges), certificate.certify(tX, tp.edges)
    assert not ct.is_global and not cj.is_global
    assert ct.eigvec is None and cj.eigvec is None  # failed fast
    assert ct.crit_residual > 1e-3
    assert ct.crit_residual == pytest.approx(cj.crit_residual, rel=TOL)
    with pytest.raises(ValueError):
        certificate.escape_direction(tX, ct)


def test_certify_suboptimal_critical_point(grid, suboptimal):
    _, _, probs = grid
    jp, tp = probs[3]
    jX, tX = _both(suboptimal)
    cj, ct = j_cert.certify(jX, jp.edges), certificate.certify(tX, tp.edges)
    assert not ct.is_global and not cj.is_global
    assert ct.crit_residual <= 1e-5 and cj.crit_residual <= 1e-5
    assert ct.min_eig < -1.0
    lam_max = _lam_max(certificate.s_sparse(tX, certificate.lambda_blocks(tX, tp.edges),
                                            tp.edges))
    assert abs(ct.min_eig - cj.min_eig) <= 1e-6 * max(1.0, lam_max)
    Xp_t, dt = certificate.escape_direction(tX, ct)
    Xp_j, dj = j_cert.escape_direction(jX, cj)
    assert Xp_t.shape == (tp.n, 4, 4)
    assert rel_err(Xp_t.numpy(), Xp_j) == 0.0
    dt, dj = dt.numpy(), np.asarray(dj)
    sign = np.sign(np.sum(dt * dj))
    assert np.max(np.abs(sign * dt - dj)) <= 1e-4 * np.max(np.abs(dj))


def test_retract_polar_matches_jax(grid):
    _, _, probs = grid
    X = random_state(probs[5][1].n, 5, 3, seed=8)
    V = 0.3 * np.random.default_rng(9).standard_normal(X.shape)
    out = stiefel.retract_polar(torch.tensor(X), torch.tensor(V))
    assert rel_err(out.numpy(), j_stiefel.retract_polar(jnp.asarray(X), jnp.asarray(V))) < TOL
    assert float(stiefel.check_on_manifold(out)) < 1e-12


@pytest.mark.parametrize("init", ["chordal", "random"])
def test_certified_solve_matches_jax(grid, init):
    """The staircase from JAX's start: chordal lifted through JAX's
    YLift (certified at the first rung, rank 5), and a random rank-3 point
    (JAX's draw), whose certificate fails and whose escape reaches the
    optimum one rank up."""
    data, _, _ = grid
    if init == "chordal":
        jres = j_certified.certified_solve(data)
        ylift = j_stiefel.random_lifting_matrix(jax.random.PRNGKey(0), 5, 3, jnp.float64)
        tres = certified.certified_solve(data, device="cpu", ylift=np.asarray(ylift))
    else:
        key = jax.random.PRNGKey(1)
        n = int(np.sum(data.num_poses))
        X0 = jnp.concatenate([
            j_stiefel.random_stiefel(key, n, 3, 3, jnp.float64),
            2.0 * jax.random.normal(jax.random.fold_in(key, 1), (n, 3, 1), jnp.float64),
        ], axis=-1)
        jres = j_certified.certified_solve(data, r0=3, init="random", init_seed=1)
        tres = certified.certified_solve(data, r0=3, device="cpu", X0=np.asarray(X0))
    assert tres.certified and jres.certified
    assert tres.rank == jres.rank
    assert tres.ranks_tried == jres.ranks_tried
    assert tres.cost == pytest.approx(jres.cost, rel=1e-8)
    assert tres.refined_cost == pytest.approx(jres.refined_cost, rel=1e-8)
    if init == "random":
        assert tres.ranks_tried == (3, 4)


CLI_CASES = {
    # dpgo_demo's tolerances: stops short of criticality, not certified
    "demo-fused": ["--demo", "dpgo_demo", "--synthetic", "sphere", "--synthetic_n", "256",
                   "--mode", "fused"],
    # solved tight: certified
    "tight-engine": ["--synthetic", "grid3d", "--synthetic_n", "64", "--num_robots", "2",
                     "--update_rule", "RoundRobin", "--relative_change_tolerance", "1e-7",
                     "--RTR_gradnorm_tol", "1e-9", "--max_iteration_number", "400"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_acceleration_and_certify_match_jax(case, capsys):
    argv = CLI_CASES[case] + ["--acceleration", "true", "--certify", "--dtype", "float64"]
    assert jax_cli.main(argv + ["--platform", "cpu"]) == 0
    jsum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tsum, extras = cli.run(argv + ["--device", "cpu"])
    assert tsum["iterations"] == jsum["iterations"]
    assert tsum["final_cost"] == pytest.approx(jsum["final_cost"], rel=1e-9)
    tc, jc = tsum["certificate"], jsum["certificate"]
    assert tc["certified_global"] == jc["certified_global"] == (case == "tight-engine")
    assert tc["scale"] == pytest.approx(jc["scale"], rel=TOL)
    assert extras["restarts"] >= 0
