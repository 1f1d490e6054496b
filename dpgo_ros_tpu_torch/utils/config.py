"""Framework configuration — parity with the reference's parameter surface.

Every knob in the reference launch template (``launch/PGOAgent.launch:9-50``,
parsed at ``src/PGOAgentROSNode.cpp:28-245``) has an equivalent here, with the
same defaults. Derived parameters (GNC barc from a χ² quantile, the GNC
iteration budget) are computed in ``resolve()`` exactly as the reference does
(``PGOAgentROSNode.cpp:196-232``).

Copy of ``dpgo_ros_tpu/utils/config.py`` for the PyTorch port.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class UpdateRule(enum.Enum):
    """Block-selection rule for synchronous RBCD (reference
    ``PGOAgentROSParameters::UpdateRule``, ``PGOAgentROS.h:35-38``) plus the
    TPU-native PARALLEL generalization (all blocks update simultaneously
    against last-iteration separators — ASAPP with delay 0, SURVEY.md §2.4)."""

    UNIFORM = "Uniform"
    ROUND_ROBIN = "RoundRobin"
    PARALLEL = "Parallel"


class InitMethod(enum.Enum):
    """``localInitializationMethod`` (reference ``PGOAgentROSNode.cpp:104-117``)."""

    ODOMETRY = "Odometry"
    CHORDAL = "Chordal"
    GNC_TLS = "GNC_TLS"


class RobustCostType(enum.Enum):
    """``RobustCostParameters::Type`` (reference ``PGOAgentROSNode.cpp:174-211``)."""

    L2 = "L2"
    L1 = "L1"
    HUBER = "Huber"
    TLS = "TLS"
    GM = "GM"
    GNC_TLS = "GNC_TLS"


class SolverMethod(enum.Enum):
    RTR = "RTR"
    RGD = "RGD"


def chi2_quantile_3dof(quantile: float) -> float:
    """Inverse CDF of χ²(3) via bisection on the regularized lower incomplete
    gamma function — replaces the reference's boost::math quantile call
    (``RobustCost::computeErrorThresholdAtQuantile(quantile, 3)``,
    ``PGOAgentROSNode.cpp:196-209``)."""
    # P(3/2, x/2) = quantile; closed-form CDF for 3 dof:
    # F(x) = erf(sqrt(x/2)) - sqrt(2/pi) * sqrt(x) * exp(-x/2)
    def cdf(x: float) -> float:
        return math.erf(math.sqrt(x / 2.0)) - math.sqrt(
            2.0 / math.pi
        ) * math.sqrt(x) * math.exp(-x / 2.0)

    lo, hi = 0.0, 200.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < quantile:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@dataclasses.dataclass
class AgentConfig:
    """Full parameter set (defaults = reference ``launch/PGOAgent.launch:9-50``)."""

    # problem
    num_robots: int = 1
    dimension: int = 3
    relaxation_rank: int = 5

    # mode
    asynchronous: bool = False
    asynchronous_rate: float = 10.0

    # local solver
    solver: Optional[SolverMethod] = None  # None → RTR if sync, RGD if async
    RGD_stepsize: float = 1e-3
    RGD_use_preconditioner: bool = True
    RTR_iterations: int = 3
    RTR_tCG_iterations: int = 50
    RTR_gradnorm_tol: float = 1e-2

    # initialization
    local_initialization_method: InitMethod = InitMethod.ODOMETRY
    multirobot_initialization: bool = True

    # schedule
    update_rule: UpdateRule = UpdateRule.UNIFORM
    acceleration: bool = False
    restart_interval: int = 50
    # guard accelerated steps with a cost-decrease check (adaptive restart)
    acceleration_safeguard: bool = True
    # extrapolation coefficient for the auxiliary sequence; None = Nesterov
    # theta-sequence. Default 0.3 — tuned on 5-robot sphere2500, where it
    # cuts iterations-to-converge ~245 → ~120 (the reference reports
    # 240 → 150 for its accelerated mode, README.md:44).
    acceleration_beta: Optional[float] = 0.3

    # robust cost
    robust_cost_type: RobustCostType = RobustCostType.L2
    GNC_use_probability: bool = True
    GNC_quantile: float = 0.9
    GNC_barc: float = 5.0
    GNC_mu_step: float = 2.0
    GNC_init_mu: float = 1e-5
    # μ-schedule. "reference": μ_k = init_mu · mu_step^k (the reference's
    # parameterization — with its demo budget of 3-4 updates the TLS weights
    # mathematically cannot binarize: w_mid ≈ √μ·barc/r stays ≪1, leaving
    # every loop closure undecided). "geometric": μ interpolates
    # GNC_mu_start → GNC_mu_end across the scheduled updates. "adaptive"
    # (default): residual-scale-aware annealing — the hard-rejection cutoff
    # shrinks geometrically from the current loop-residual P90 down to
    # ~barc by the last round (see models/robust.py::mu_for_round).
    GNC_schedule: str = "adaptive"
    GNC_mu_start: float = 0.05
    GNC_mu_end: float = 1e3
    robust_opt_num_weight_updates: int = 4
    robust_opt_num_resets: int = 0
    robust_opt_min_convergence_ratio: float = 0.0
    robust_opt_inner_iters_per_robot: int = 10
    # Convergence-gated GNC weight rounds (TPU-build extension; None =
    # reference fixed-cadence semantics). When set, a weight round fires as
    # soon as EVERY robot's rel-change has fallen below this tolerance —
    # i.e. each graduated subproblem is solved to (approximate) convergence
    # before reweighting, which is what GNC theory assumes and what makes
    # the accept/reject split schedule-independent: residuals at the weight
    # round are evaluated at the weighted optimum, which does not depend on
    # the block-update order. The fixed inner-iteration cadence remains as
    # a budget cap (fires anyway after inner_iters x num_robots updates
    # since the last round).
    robust_opt_inner_tol: Optional[float] = None
    robust_init_min_inliers: int = 5
    # At TERMINATE, classify still-undecided GNC weights by the final
    # residual against barc instead of rejecting them wholesale. With the
    # reference demo budget (3 weight updates × mu_step 2 from mu=1e-5) the
    # TLS weights cannot binarize — w_mid ≈ √mu · barc/r — so the reference's
    # "reject undecided" rule would reject every loop closure; thresholding
    # the final residuals recovers the intended inlier/outlier split.
    gnc_finalize_by_residual: bool = True

    # termination
    max_iteration_number: int = 1000
    relative_change_tolerance: float = 0.1
    # "block_frobenius" (DPGO-calibrated) or "max_pose"
    relative_change_metric: str = "block_frobenius"

    # coordination-layer extensions (reference PGOAgentROS.h:33-119)
    publish_iterate: bool = False
    visualize_loop_closures: bool = False
    complete_reset: bool = False
    enable_recovery: bool = False
    synchronize_measurements: bool = True
    max_distributed_init_steps: int = 30
    inter_update_sleep_time: float = 0.0
    weight_convergence_threshold: float = -1.0
    # reference default 3 (``PGOAgentROS.h:74-86``): a robot may execute its
    # scheduled update with neighbor separators up to 3 iterations stale
    max_delayed_iterations: int = 3
    timeout_threshold: float = 15.0

    # logging
    log_directory: Optional[str] = None
    verbose: bool = False

    # framework extras (TPU build)
    dtype: str = "float64"  # "float32" on TPU
    seed: int = 42
    # ASAPP stepsize decay time-constant T0 (ticks): stepsize_t =
    # RGD_stepsize * T0/(T0+t). 0 disables (reference constant-rate
    # behavior). Kills the bounded-staleness noise ball on ill-conditioned
    # graphs (parking-garage) — see parallel/asapp.py.
    asapp_stepsize_decay_ticks: int = 0
    # async-mode termination: per-robot block-Frobenius movement PER TICK.
    # This is a different scale from the sync rel-change tolerance (one tick
    # = one RGD step vs one full block trust-region solve), so it gets its
    # own knob: 0.2-scale sync tolerances fire on the very first async tick.
    # 1e-3 reproduces the recorded torus3D/sphere baselines; parking-garage
    # (tiny optimum) wants 1e-4 (scripts/run_baselines.py §4).
    asapp_tolerance: float = 1e-3
    # single-Pallas-kernel RTR block solve (ops/fused_rtr.py): None = auto
    # (enabled on a TPU backend with fp32 + RTR); False forces the XLA path;
    # True forces the kernel (interpreter mode off-TPU — tests only)
    use_fused_kernel: Optional[bool] = None
    # SPMD mesh program: solver steps executed INSIDE one kernel launch per
    # mesh slot between separator all_gathers (parallel/spmd.py). S > 1 =
    # each device runs S color-scheduled block updates against
    # stretch-start separators — exactly the bounded-staleness semantics of
    # the reference's maxDelayedIterations / ASAPP modes
    # (``include/dpgo_ros/PGOAgentROS.h:62-63``), amortizing per-launch
    # overhead S-fold. 1 = the per-step program (exact colored RBCD).
    # Requires the fused kernel; silently 1 on the XLA fallback path.
    spmd_steps_per_launch: int = 1
    # Stretch step rule: None = trust-region block solves on the in-kernel
    # schedule (EXACT when the mesh has one slot — no staleness; measured
    # to diverge from cold inits on multi-slot meshes, where simultaneous
    # full block solves against stale separators are a Jacobi overshoot);
    # a float = preconditioned Riemannian-gradient ticks of that stepsize
    # (the ASAPP update rule — staleness-robust, the multi-slot default
    # choice; reference ``launch/asapp_demo.launch`` stepsize 0.2).
    spmd_stretch_rgd_stepsize: Optional[float] = None
    # Exchange ONLY separator poses between mesh slots (the reference's
    # core bandwidth idea — ``msg/PublicPoses.msg`` carries nothing else):
    # non-separator lanes of other slots are mathematically irrelevant to
    # a masked block solve (every owned edge touches own block +
    # separators only) and are filled with inert template poses. Cuts the
    # per-step exchange from full blocks to the separator set (~12x on
    # sphere2500). None = auto (on for non-robust runs); GNC runs
    # exchange full blocks — their weight rounds evaluate a GLOBAL
    # rounding (SVD over all lanes) that stale template lanes would
    # corrupt.
    spmd_separator_only: Optional[bool] = None

    def resolve(self) -> "AgentConfig":
        """Apply the reference's derived-parameter rules
        (``PGOAgentROSNode.cpp:82-93, 196-232``):

        * solver: RTR for synchronous mode, RGD for asynchronous;
        * GNC barc from the χ²(3) quantile when GNC_use_probability;
        * max iteration budget for GNC runs:
          (numWeightUpdates + 1) * innerIters * numRobots − 2.
        """
        cfg = dataclasses.replace(self)
        if cfg.solver is None:
            cfg.solver = (
                SolverMethod.RGD if cfg.asynchronous else SolverMethod.RTR
            )
        if (
            cfg.robust_cost_type == RobustCostType.GNC_TLS
            and cfg.GNC_use_probability
        ):
            cfg.GNC_barc = math.sqrt(chi2_quantile_3dof(cfg.GNC_quantile))
        if cfg.robust_cost_type == RobustCostType.GNC_TLS:
            inner = cfg.robust_opt_inner_iters_per_robot * cfg.num_robots
            cfg.max_iteration_number = (
                (cfg.robust_opt_num_weight_updates + 1) * inner - 2
            )
        return cfg
