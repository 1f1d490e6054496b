"""The accelerated step's extrapolation (K7, ``ops/nesterov.py``).

1. The plain version ``extrapolate_ref`` is, bit for bit, the composition
   written out here as the engine wrote it inline (the select of X_acc,
   ``proj_tangent``, ``retract_polar_ns``, the select of V, an (n, 1, 1)
   mask, β a float), in fp32 and fp64, for the fixed β (a one-element
   tensor in the wrapper's call) and the θ-sequence's β, robot and colour
   masks, d = 2 and 3: the engine's CPU numbers, and its parity with the
   JAX package, do not move.
2. The wrapper: CPU tensors through the plain version with no launch
   counted; the operand checks; the source in the build; the counter.
3. The engine's accelerated update calls the wrapper once a step.
The CUDA kernel itself runs only on the card (the ``cuda``-marked test
here, and ``python3 chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import kernels, nesterov, stiefel
from dpgo_ros_tpu_torch.parallel.rbcd import RBCDEngine
from dpgo_ros_tpu_torch.utils import profiling
from dpgo_ros_tpu_torch.utils.config import AgentConfig, InitMethod, UpdateRule

BETA = 0.3  # dpgo_accel_demo's fixed acceleration_beta


def _near(X, g, scale):
    """A point of the manifold near X: X retracted along a random tangent
    vector of norm ~``scale`` a pose."""
    D = torch.randn(X.shape, generator=g, dtype=X.dtype)
    return stiefel.retract_polar_ns(X, scale * stiefel.proj_tangent(X, D))


def _operands(n=2500, r=5, d=3, dtype=torch.float64, mask_kind="robot",
              beta_kind="fixed", seed=0):
    """(Z, X, X_prev, V, mask (n,), β as the engine passes it, β as the old
    composition took it): a state on the manifold, Z, X_prev and V near
    it, the mask of one robot's contiguous block (a fifth of the poses) or
    of a colour (two robots' blocks)."""
    g = torch.Generator().manual_seed(seed)
    X = stiefel.join(stiefel.random_stiefel(g, n, r, d, dtype=dtype),
                     torch.randn((n, r), generator=g, dtype=dtype)).contiguous()
    Z, X_prev, V = (_near(X, g, s).contiguous() for s in (0.05, 0.1, 0.2))
    mask = torch.zeros(n, dtype=dtype)
    blocks = [1] if mask_kind == "robot" else [0, 2]
    for k in blocks:
        mask[k * n // 5:(k + 1) * n // 5] = 1.0
    if beta_kind == "fixed":
        beta, old_beta = torch.tensor([BETA], dtype=dtype), BETA
    else:
        theta = torch.tensor(2.3, dtype=dtype)
        theta_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * theta ** 2))
        beta = old_beta = (theta - 1.0) / theta_new
    return Z, X, X_prev, V, mask, beta, old_beta


def _old_composition(Z, X, X_prev, V, mask, beta):
    """The extrapolation as the engine wrote it inline, its mask (n, 1, 1)."""
    mask = mask[:, None, None]
    X_acc = torch.where(mask > 0, Z, X)
    Vk = stiefel.retract_polar_ns(
        X_acc, beta * stiefel.proj_tangent(X_acc, mask * (X_acc - X_prev))
    )
    return X_acc, torch.where(mask > 0, Vk, V)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("mask_kind", ["robot", "colour"])
@pytest.mark.parametrize("beta_kind", ["fixed", "theta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "fp64"])
def test_plain_version_is_the_old_composition_bit_for_bit(dtype, beta_kind, mask_kind, d):
    Z, X, X_prev, V, mask, beta, old_beta = _operands(
        n=250, d=d, dtype=dtype, mask_kind=mask_kind, beta_kind=beta_kind)
    X_acc, V_new = nesterov.extrapolate_ref(Z, X, X_prev, V, mask, beta)
    X_old, V_old = _old_composition(Z, X, X_prev, V, mask, old_beta)
    assert torch.equal(X_acc, X_old) and torch.equal(V_new, V_old)
    inside = mask > 0
    assert torch.equal(X_acc[inside], Z[inside]) and torch.equal(X_acc[~inside], X[~inside])
    assert torch.equal(V_new[~inside], V[~inside])
    assert not torch.equal(V_new[inside], V[inside])
    # the block's new V lies on the manifold: 20 Newton–Schulz steps converged
    assert float(stiefel.check_on_manifold(V_new[inside])) < (
        1e-5 if dtype == torch.float32 else 1e-12)


@pytest.mark.parametrize("beta_kind", ["fixed", "float"])
def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch(beta_kind):
    Z, X, X_prev, V, mask, beta, old_beta = _operands(n=250, dtype=torch.float32)
    if beta_kind == "float":
        beta = old_beta
    before = profiling.launches()["k7"]
    out = nesterov.extrapolate(Z, X, X_prev, V, mask, beta)
    assert profiling.launches()["k7"] == before
    ref = nesterov.extrapolate_ref(Z, X, X_prev, V, mask, beta)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    # CPU tensors of any layout and rank: the plain version takes them
    wide = _operands(n=20, r=10, dtype=torch.float64)
    wide = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in wide[:4]] + list(wide[4:6])
    out = nesterov.extrapolate(*wide)
    assert all(torch.equal(a, b) for a, b in zip(out, nesterov.extrapolate_ref(*wide)))


BAD = ["dtype", "mask_dtype", "beta_dtype", "shape", "mask_shape", "beta_numel",
       "contiguous", "mask_contiguous", "device", "rank", "d", "beta_float", "no_poses"]


@pytest.mark.parametrize("bad", BAD)
def test_checks_reject_operands_the_kernel_cannot_take(bad):
    """Each operand error raises in the kernel's checks, called on CPU
    tensors as the card's path calls them; the good operands pass."""
    ops = list(_operands(n=100, dtype=torch.float32)[:6])
    nesterov.check_operands("extrapolate", *ops)
    err = ValueError
    if bad == "dtype":
        ops[0], err = ops[0].double(), TypeError
    elif bad == "mask_dtype":
        ops[4], err = ops[4].double(), TypeError
    elif bad == "beta_dtype":
        ops[5], err = ops[5].double(), TypeError
    elif bad == "shape":
        ops[3] = ops[3][:-1]
    elif bad == "mask_shape":
        ops[4] = ops[4][:, None]
    elif bad == "beta_numel":
        ops[5] = torch.tensor([BETA, BETA])
    elif bad == "contiguous":
        ops[2] = ops[2].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "mask_contiguous":
        ops[4] = torch.stack([ops[4], ops[4]], 1)[:, 0]
    elif bad == "device":
        ops[1] = ops[1].to("meta")
    elif bad == "rank":
        ops[:4] = [torch.zeros(100, kernels.MAX_RANK + 1, 4) for _ in range(4)]
    elif bad == "d":
        ops[:4] = [torch.zeros(100, 5, 5) for _ in range(4)]
    elif bad == "beta_float":
        ops[5], err = BETA, TypeError
    else:
        ops[:5] = [t[:0] for t in ops[:5]]
    with pytest.raises(err):
        nesterov.check_operands("extrapolate", *ops)


def test_wrapper_refuses_a_device_it_has_no_kernel_for():
    ops = [t.to("meta") for t in _operands(n=100, dtype=torch.float32)[:6]]
    with pytest.raises(ValueError, match="unsupported device"):
        nesterov.extrapolate(*ops)


def test_build_all_lists_k7(tmp_path, monkeypatch):
    """build_all() compiles K7 with the other kernels; a failing nvcc names
    the source and raises."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        kernels.build_all()
    assert "nesterov_extrapolate.cu" in str(err.value)
    assert kernels.EXTRAP_SOURCE in kernels.ALL_SOURCES
    assert "int dpgo_nesterov_extrapolate(" in kernels.EXTRAP_SOURCE.read_text()


def test_launches_count_k7():
    assert "k7" in profiling.KERNELS
    before = profiling.launches()
    assert set(before) == set(profiling.KERNELS)
    profiling.count("k7.launches", 2)
    try:
        assert profiling.launches()["k7"] == before["k7"] + 2
    finally:
        profiling.set_counters({"k7.launches": before["k7"]})


@pytest.mark.parametrize("case", ["fixed", "theta", "parallel"])
def test_engine_extrapolates_through_the_wrapper(monkeypatch, case):
    """Every accelerated update calls ``nesterov.extrapolate`` once, with
    the update's (n,) mask row and β as a tensor: the engine's fixed
    (1,) β, or the θ-sequence's."""
    data, _, _ = generate_world("sphere", n=120, num_robots=3, seed=1)
    prob = LiftedProblem.from_data(data, r=5, dtype=torch.float64, device="cpu")
    kw = dict(acceleration_beta=None) if case == "theta" else {}
    if case == "parallel":
        kw["update_rule"] = UpdateRule.PARALLEL
    eng = RBCDEngine(prob, AgentConfig(
        num_robots=3, acceleration=True, relative_change_tolerance=0.0,
        max_iteration_number=6, local_initialization_method=InitMethod.CHORDAL,
        dtype="float64", **kw))
    seen = []
    real = nesterov.extrapolate
    monkeypatch.setattr(nesterov, "extrapolate",
                        lambda *a: seen.append(a) or real(*a))
    _, info = eng.run(eng.initialize())
    assert len(seen) == info["iterations"] == 6
    for i, (_, _, _, _, mask, beta) in enumerate(seen):
        rows = eng._color_masks if case == "parallel" else eng._masks
        sched = eng.update_schedule(6)
        assert torch.equal(mask, rows[int(sched[i])].reshape(-1))
        assert isinstance(beta, torch.Tensor) and beta.numel() == 1
        if case != "theta":
            assert beta is eng._fixed_beta
            assert float(beta) == eng.config.acceleration_beta


@pytest.mark.cuda
@pytest.mark.parametrize("beta_kind", ["fixed", "theta"])
def test_kernel_matches_plain_version_on_card(monkeypatch, beta_kind):
    """K7 against its plain version on the same CUDA tensors at the main
    path's shapes (2,500 poses, r = 5, d = 3, one robot's 500-pose block).
    X_acc is a select, so bit-equal. V_new within 1e-5 abs: the kernel sums
    each small product (YᵀW, Y·sym, ZnᵀZn, Zn·(3I − ZnᵀZn), ‖A‖²) in
    another order, with FMA, than the batched GEMMs and reductions of the
    plain version; the 20 Newton–Schulz steps contract toward the same
    polar factor, so those fp32 roundings (~1e-7) do not grow. One launch
    a call; the operand checks once per layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 chip_smoke.py)")
    ops = [t.cuda() for t in _operands(dtype=torch.float32, beta_kind=beta_kind)[:6]]
    checks = []
    real = nesterov.check_operands
    monkeypatch.setattr(nesterov, "_kept", {})
    monkeypatch.setattr(nesterov, "check_operands",
                        lambda *a: checks.append(a[0]) or real(*a))
    before = profiling.launches()["k7"]
    X_acc, V_new = nesterov.extrapolate(*ops)
    X_acc2, V_new2 = nesterov.extrapolate(*ops)
    torch.cuda.synchronize()
    assert profiling.launches()["k7"] == before + 2 and len(checks) == 1
    X_ref, V_ref = nesterov.extrapolate_ref(*ops)
    assert torch.equal(X_acc, X_ref) and torch.equal(X_acc2, X_acc)
    assert torch.equal(V_new2, V_new)
    outside = ops[4] == 0
    assert torch.equal(V_new[outside], ops[3][outside])
    err = float((V_new - V_ref).abs().max())
    assert np.isfinite(err) and err <= 1e-5, err
