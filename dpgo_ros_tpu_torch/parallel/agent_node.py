"""Per-robot distributed-PGO agent: the coordination FSM.

Port of ``dpgo_ros_tpu/parallel/agent_node.py``; capability parity with
the reference's ``dpgo_ros::PGOAgentROS`` (``src/PGOAgentROS.cpp``,
SURVEY.md §1-L5): an event-driven agent that owns ONE robot's pose block,
communicates only through the message protocol of
:mod:`dpgo_ros_tpu_torch.parallel.comm`, and implements

* pose-graph acquisition from a front-end service (REQUEST_POSE_GRAPH,
  ``requestPoseGraph`` :246-261),
* inter-robot measurement synchronization (``publishPublicMeasurements``
  :692-719),
* distributed initialization with global-frame alignment and a leader
  barrier (``tryInitialize`` :322-366, INITIALIZE round :1091-1158),
* synchronous RBCD with UPDATE tokens, bounded-staleness gating
  (:136-149) and Nesterov auxiliary-pose exchange (:662-690),
* GNC weight-update rounds with lower-ID-owner weight replication
  (:721-754, :1315-1353),
* termination, timeout detection, active-robot management and recovery
  (:1515-1575, :1191-1209, :506-515),
* per-iteration CSV telemetry with the reference schema (:853-907).

The protocol state is numpy on the host: message handlers index it per
message, so no handler launches device work. Device tensors exist only
inside a solve. Each agent's local problem is its own poses [0, n_k) then
its neighbours' separator slots [n_k, n_k + S), which is exactly the
layout of K4's window (``ops/hbm_rtr.py``): every synchronous RTR solve is
one K4 launch on the window :func:`hbm_rtr.prepare_local_window` builds
with the problem (on the CPU, K4's plain version, which is ``rtr_solve`` on
the whole local problem). The asynchronous agents, and ``solver = RGD``,
run ``local_solvers.rgd_solve`` as plain PyTorch on the agent's device.
X (or V) goes to the device once per solve and the result comes back once.

This event-driven mode exists for protocol/capability parity and fault
simulation; the high-throughput paths are the engine and the fused runner
(:mod:`dpgo_ros_tpu_torch.parallel.rbcd`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dpgo_ros_tpu_torch.models.local_solvers import RGDParams, RTRParams, rgd_solve
from dpgo_ros_tpu_torch.models.problem import HostEdges
from dpgo_ros_tpu_torch.ops import chordal as chordal_ops
from dpgo_ros_tpu_torch.ops import hbm_rtr, quadratic, stiefel
from dpgo_ros_tpu_torch.ops.quadratic import build_pull_index
from dpgo_ros_tpu_torch.parallel.comm import (
    Anchor,
    Command,
    LiftingMatrix,
    MeasurementWeights,
    PublicPoses,
    RelativeMeasurementList,
    StatusMsg,
    Transport,
    _msg_bytes,
)
from dpgo_ros_tpu_torch.types import (
    AgentState,
    AgentStatus,
    CommandType,
    EdgeType,
    MeasurementBatch,
    PoseGraphData,
)
from dpgo_ros_tpu_torch.utils import hostmath
from dpgo_ros_tpu_torch.utils.config import (
    AgentConfig,
    InitMethod,
    RobustCostType,
    SolverMethod,
    UpdateRule,
)
from dpgo_ros_tpu_torch.utils.telemetry import IterationLogger


class DatasetServer:
    """The fake SLAM front-end: serves per-robot pose graphs on request —
    the ``request_pose_graph`` service of the reference dataset publisher
    (``src/PGODatasetPublisherNode.cpp:46-72``)."""

    def __init__(self, data: PoseGraphData):
        self.data = data

    def request_pose_graph(self, robot_id: int) -> Tuple[MeasurementBatch, int]:
        m = self.data.robot_measurements(robot_id)
        return m, int(self.data.num_poses[robot_id])


def check_device(device, dtype: str) -> torch.device:
    """The agents' device; on the card every RTR solve is the float32 K4
    kernel, and there is no plain solve there, so float64 is refused."""
    device = torch.device(device)
    if device.type == "cuda" and dtype != "float32":
        raise ValueError("the CUDA block-solve kernel is float32 only")
    return device


class PGOAgentNode:
    """One robot's agent. Public surface mirrors ``PGOAgentROS``:
    ``runOnce()`` driven by an external tick loop; everything else happens in
    message handlers. ``device`` holds the solves' tensors (the card unless
    the caller names another)."""

    def __init__(
        self,
        robot_id: int,
        config: AgentConfig,
        transport: Transport,
        dataset: DatasetServer,
        device="cuda",
    ):
        self.id = robot_id
        self.config = config.resolve()
        self.transport = transport
        self.dataset = dataset
        self.device = check_device(device, self.config.dtype)
        self.dtype = (
            torch.float64 if self.config.dtype == "float64" else torch.float32
        )
        self.np_dt = (
            np.float64 if self.config.dtype == "float64" else np.float32
        )
        self.logger = IterationLogger(
            robot_id,
            (self.config.log_directory + f"/agent{robot_id}")
            if self.config.log_directory
            else None,
        )
        self.num_robots = self.config.num_robots
        self._tick = 0
        self.reset(complete=True)

    # ------------------------------------------------------------ lifecycle

    def reset(self, complete: bool = False) -> None:
        """End-of-round reset (reference ``reset()`` override :222-243).
        Warm-start caches survive unless ``complete`` or complete_reset."""
        self.state = AgentState.WAIT_FOR_DATA
        self.iteration = 0
        self.instance = getattr(self, "instance", -1) + (0 if complete else 1)
        if complete:
            self.instance = 0
            self.cached_trajectory: Optional[np.ndarray] = None
            self.cached_weights: Optional[Dict] = None
        if complete or self.config.complete_reset:
            self.cached_trajectory = None
            self.cached_weights = None
        self.measurements: Optional[MeasurementBatch] = None
        self.n_local = 0
        self.neighbor_slots: Dict[Tuple[int, int], int] = {}
        self.edges = None  # the local EdgeSet on the device
        self.host_edges: Optional[HostEdges] = None  # its numpy mirror
        self.weights: Optional[np.ndarray] = None  # host GNC edge weights
        self.windows: Optional[hbm_rtr.Windows] = None  # K4's local window
        self.X: Optional[np.ndarray] = None  # host (numpy) pose state
        self.V: Optional[np.ndarray] = None
        self.X_prev: Optional[np.ndarray] = None
        self._t_local_cache: Optional[np.ndarray] = None
        self.theta = 1.0
        self.Ylift: Optional[np.ndarray] = None
        self.anchor: Optional[np.ndarray] = None
        self.active_robots = set(range(self.num_robots))
        self.team_status: Dict[int, AgentStatus] = {}
        self.iter_received: Dict[int, int] = {}
        # last iteration each robot was told to execute (from UPDATE tokens)
        self.last_exec_iter: Dict[int, int] = {}
        self.neighbor_aux_received: Dict[int, int] = {}
        self.received_measurements: Dict[int, MeasurementBatch] = {}
        self.synced = False
        self._opt_requested = False
        self._executing_iteration = 0
        self._publish_poses_requested = False
        self.relative_change = float("inf")
        self.ready_to_terminate = False
        self.weight_update_count = 0
        self.mu = self.config.GNC_init_mu
        self.last_command_tick = 0
        self.last_status_tick: Dict[int, int] = {}
        self.timeout_count = 0
        self.terminated = False
        self.solved_iterations = 0
        self._solve_fn = None
        self._local_cache = None
        self.bytes_received = 0
        self._last_scheduled_robot = None
        self._scheduled_iteration = 0
        self._last_schedule_tick = 0
        self._init_barrier_steps = 0
        self._pending_poses: List[PublicPoses] = []
        self._pose_map_cache: Dict = {}
        self._deactivated_by_protocol: set = set()
        self._edge_mask_cache = None
        self._separator_ids_cache = None
        self._edge_index = None

    # ---------------------------------------------------------- properties

    @property
    def cluster_id(self) -> int:
        """Cluster = minimum active connected robot id
        (``PGOAgentROS.cpp:1470-1513``)."""
        return min(self.active_robots) if self.active_robots else self.id

    def is_leader(self) -> bool:
        return self.id == self.cluster_id

    def get_status(self) -> AgentStatus:
        return AgentStatus(
            robot_id=self.id,
            cluster_id=self.cluster_id,
            state=self.state,
            instance_number=self.instance,
            iteration_number=self.iteration,
            ready_to_terminate=self.ready_to_terminate,
            relative_change=self.relative_change,
        )

    def num_poses(self) -> int:
        return self.n_local

    # team management parity (reference setRobotActive/isRobotActive/
    # numActiveRobots/isRobotInitialized, ``PGOAgentROS.cpp:378-399,450-470``)

    def set_robot_active(self, robot_id: int, active: bool = True) -> None:
        if active:
            self.active_robots.add(robot_id)
        else:
            self.active_robots.discard(robot_id)
        self._edge_mask_cache = None

    def is_robot_active(self, robot_id: int) -> bool:
        return robot_id in self.active_robots

    def num_active_robots(self) -> int:
        return len(self.active_robots)

    def is_robot_initialized(self, robot_id: int) -> bool:
        if robot_id == self.id:
            return self.state == AgentState.INITIALIZED
        st = self.team_status.get(robot_id)
        return st is not None and st.state == AgentState.INITIALIZED

    def set_connected_peers(self, peers) -> None:
        """Connectivity feed (the reference's external
        ``/<robot>/connected_peer_ids`` topic, ``PGOAgentROS.cpp:61-63,
        909-922``): the active set tracks reachability both ways — a healed
        partition re-admits robots (unless the protocol deactivated them via
        timeout, which only a SET_ACTIVE_ROBOTS/RECOVER round undoes).
        Cluster re-election on disconnect (``:1478-1486``) is implicit —
        cluster_id = min(active set), so a partitioned component elects its
        lowest id as leader."""
        peers = set(peers) | {self.id}
        new_active = (peers & set(range(self.num_robots))) - self._deactivated_by_protocol
        if new_active != self.active_robots:
            self.active_robots = new_active
            self._edge_mask_cache = None
            self.logger.log_event("CONNECTIVITY_CHANGE")

    def trajectory_world(self) -> Optional[np.ndarray]:
        """Own block in the world frame (``getTrajectoryInGlobalFrame``),
        on the host."""
        if self.X is None or self.Ylift is None:
            return None
        return hostmath.round_via_lifting_np(
            np.asarray(self.X[: self.n_local]),
            np.asarray(self.Ylift, self.np_dt),
        )

    # ------------------------------------------------------------- runOnce

    def runOnce(self) -> None:
        """One spin (reference 100 Hz loop body, ``PGOAgentROSNode.cpp:256-261``)."""
        self._tick += 1
        for msg in self.transport.poll(self.id):
            self._dispatch(msg)
        # periodic status heartbeat (reference ≥1/3 Hz, :615-620, 1383)
        if not self.terminated and self._tick % 3 == 0:
            self._publish_status()
        if self.config.asynchronous:
            # reference ``runOnceAsynchronous`` (:119-127): no UPDATE tokens —
            # the local optimization loop runs continuously
            if not self.terminated:
                self._run_once_asynchronous()
        elif self._opt_requested:
            self._run_once_synchronous()
        if self._publish_poses_requested:
            self._publish_public_poses()
            self._publish_poses_requested = False
        # leader duties: bootstrap, scheduling, timeouts
        if self.is_leader():
            self._leader_duties()
        elif (
            self.state == AgentState.INITIALIZED
            and not self.terminated
            and self._tick - self.last_command_tick
            > 3 * self.config.timeout_threshold
        ):
            # follower lost the command channel (leader silent / TERMINATE
            # dropped): abandon the round — the reference's disconnect and
            # cluster-re-election path (``PGOAgentROS.cpp:1478-1486``)
            self.logger.log_event("TIMEOUT")
            self._terminate()

    # ------------------------------------------------------------ dispatch

    def _dispatch(self, msg) -> None:
        # received-bytes accounting (reference ``PGOAgentROS.cpp:1283``,
        # ``utils.cpp:251-260``)
        self.bytes_received += _msg_bytes(msg)
        if isinstance(msg, Command):
            self._on_command(msg)
        elif isinstance(msg, PublicPoses):
            self._on_public_poses(msg)
        elif isinstance(msg, StatusMsg):
            self._on_status(msg.status)
        elif isinstance(msg, LiftingMatrix):
            self.Ylift = np.asarray(msg.matrix)
        elif isinstance(msg, Anchor):
            self.anchor = np.asarray(msg.pose)
        elif isinstance(msg, RelativeMeasurementList):
            if msg.to_robot == self.id:
                self.received_measurements[msg.from_robot] = msg.measurements
        elif isinstance(msg, MeasurementWeights):
            self._on_weights(msg)

    # ------------------------------------------------------------ commands

    def _on_command(self, cmd: Command) -> None:
        if cmd.cluster_id != self.cluster_id:
            return  # ignore other clusters (reference :988-993)
        self.last_command_tick = self._tick
        c = cmd.command
        if c == CommandType.REQUEST_POSE_GRAPH:
            self._acquire_pose_graph()
        elif c == CommandType.INITIALIZE:
            if self.state == AgentState.WAIT_FOR_DATA:
                # missed REQUEST_POSE_GRAPH (lossy channel): the INITIALIZE
                # broadcast implies the round started — acquire data now
                self._acquire_pose_graph()
            self._initialize_round()
        elif c == CommandType.UPDATE:
            self.last_exec_iter[cmd.executing_robot] = max(
                self.last_exec_iter.get(cmd.executing_robot, 0),
                cmd.executing_iteration,
            )
            if cmd.executing_robot == self.id:
                self._opt_requested = True
                self._executing_iteration = cmd.executing_iteration
            else:
                # bookkeeping-only iterate(false) (reference :1185); re-flush
                # our separator poses so any dropped earlier delivery is
                # repaired by the next token broadcast
                self.iteration = max(self.iteration, cmd.executing_iteration - 1)
                if self.state == AgentState.INITIALIZED:
                    self._publish_poses_requested = True
        elif c == CommandType.UPDATE_WEIGHT:
            self._update_weights_round()
        elif c == CommandType.TERMINATE:
            self._terminate()
        elif c == CommandType.HARD_TERMINATE:
            self.reset(complete=True)
            self.terminated = True
        elif c == CommandType.RECOVER:
            # roll back to the leader's common iteration and re-share poses
            # (reference :1191-1209)
            self.iteration = cmd.executing_iteration
            self._publish_poses_requested = True
            self._opt_requested = False
        elif c == CommandType.SET_ACTIVE_ROBOTS:
            self.active_robots = set(cmd.active_robots)
            self._deactivated_by_protocol = set(
                range(self.num_robots)
            ) - set(cmd.active_robots)
            self._edge_mask_cache = None
            if self.id not in self.active_robots:
                self._opt_requested = False
        elif c == CommandType.NOOP:
            pass

    # ---------------------------------------------------- data acquisition

    def _acquire_pose_graph(self) -> None:
        if self.state != AgentState.WAIT_FOR_DATA:
            return
        m, n = self.dataset.request_pose_graph(self.id)
        self.measurements = m
        self.n_local = n
        self.state = AgentState.WAIT_FOR_INITIALIZATION
        self.logger.log_event("ACQUIRED_POSE_GRAPH")
        if self.is_leader():
            # sample + broadcast the lifting matrix (reference :402-410);
            # the engine's draw (a CPU generator seeded with the config's
            # seed), unless a caller set Ylift before the first tick
            r, d = self.config.relaxation_rank, self.config.dimension
            if self.Ylift is None:
                gen = torch.Generator().manual_seed(self.config.seed)
                self.Ylift = stiefel.random_lifting_matrix(
                    gen, r, d, dtype=self.dtype
                ).numpy()
            self.transport.publish(self.id, LiftingMatrix(self.id, self.Ylift))

    def _neighbors(self) -> List[int]:
        assert self.measurements is not None
        m = self.measurements
        nbrs = set(int(x) for x in m.src_robot) | set(
            int(x) for x in m.dst_robot
        )
        nbrs.discard(self.id)
        return sorted(nbrs & self.active_robots)

    # -------------------------------------------------------- measurement sync

    def _publish_shared_measurements(self) -> None:
        """Send each neighbor the shared loop closures this robot knows
        (reference ``publishPublicMeasurements`` :692-719)."""
        assert self.measurements is not None
        m = self.measurements
        for nb in self._neighbors():
            sel = (
                (m.src_robot == self.id) & (m.dst_robot == nb)
            ) | ((m.src_robot == nb) & (m.dst_robot == self.id))
            self.transport.publish(
                self.id,
                RelativeMeasurementList(
                    from_robot=self.id,
                    from_cluster=self.cluster_id,
                    to_robot=nb,
                    measurements=m.select(np.asarray(sel)),
                ),
            )

    def _sync_measurements(self) -> bool:
        """Merge measurements received from neighbors; ready once every
        active neighbor has reported (reference waits on lower-ID robots'
        shared LCs, ``tryInitialize`` :322-346)."""
        if not self.config.synchronize_measurements:
            return True
        need = set(self._neighbors())
        if not need.issubset(self.received_measurements.keys()):
            return False
        assert self.measurements is not None
        merged = self.measurements
        existing = set(
            zip(
                merged.src_robot.tolist(),
                merged.src_frame.tolist(),
                merged.dst_robot.tolist(),
                merged.dst_frame.tolist(),
            )
        )
        for nb, mm in self.received_measurements.items():
            keep = []
            for k in range(len(mm)):
                key = (
                    int(mm.src_robot[k]),
                    int(mm.src_frame[k]),
                    int(mm.dst_robot[k]),
                    int(mm.dst_frame[k]),
                )
                if key not in existing:
                    keep.append(k)
                    existing.add(key)
            if keep:
                merged = merged.concat(
                    mm.select(np.asarray(keep, dtype=np.int64))
                )
        self.measurements = merged
        return True

    # -------------------------------------------------------- initialization

    def _initialize_round(self) -> None:
        if self.state == AgentState.WAIT_FOR_DATA:
            return
        if self.state == AgentState.INITIALIZED:
            self._publish_poses_requested = True
            return
        if not self.synced:
            self._publish_shared_measurements()
            if not self._sync_measurements():
                return
            self._build_local_problem()
            self.synced = True
        self._try_initialize()

    def _host_edge_set(self, src, dst, m: MeasurementBatch, is_loop, n: int) -> HostEdges:
        """Numpy edge data of ``m`` between local poses ``src``/``dst``,
        in the agent's dtype, with its pull index over ``n`` poses."""
        E = len(m)
        return HostEdges(
            src=np.asarray(src, np.int64), dst=np.asarray(dst, np.int64),
            R=m.R.astype(self.np_dt), t=m.t.astype(self.np_dt),
            kappa=m.kappa.astype(self.np_dt), tau=m.tau.astype(self.np_dt),
            weight=m.weight.astype(self.np_dt), mask=np.ones(E, self.np_dt),
            is_loop=np.asarray(is_loop, self.np_dt),
            pull=build_pull_index(src, dst, n),
        )

    def _build_local_problem(self) -> None:
        """Local EdgeSet over [own poses | neighbor separator slots] on the
        agent's device, K4's window of it, and the solve."""
        m = self.measurements
        assert m is not None
        slots: Dict[Tuple[int, int], int] = {}

        def index_of(robot, frame):
            if robot == self.id:
                return int(frame)
            key = (int(robot), int(frame))
            if key not in slots:
                slots[key] = len(slots)  # pure slot id; local index is
                # n_local + slot everywhere
            return self.n_local + slots[key]

        E = len(m)
        src = np.array(
            [index_of(m.src_robot[k], m.src_frame[k]) for k in range(E)],
            np.int32,
        )
        dst = np.array(
            [index_of(m.dst_robot[k], m.dst_frame[k]) for k in range(E)],
            np.int32,
        )
        self.neighbor_slots = slots
        self._pose_map_cache = {}  # (sender, ids) → (rows, slots) memo
        is_loop = (m.edge_type != EdgeType.ODOMETRY) & (~m.fixed_weight)
        gnc = self.config.robust_cost_type == RobustCostType.GNC_TLS
        ntot = self.n_local + len(slots)
        self.host_edges = self._host_edge_set(
            src, dst, m, is_loop if gnc else np.zeros(E), ntot
        )
        self.edges = self.host_edges.to_torch(self.dtype, self.device)
        self.weights = self.host_edges.weight
        # rebuilt with the problem (new round, recovery): the slot set is
        # fixed per problem, and the edge mask changes the weights K4 reads,
        # never its tables
        self.windows = hbm_rtr.prepare_local_window(
            src, dst, self.n_local, ntot, self.device
        )
        # dynamic fixed-weight mask (reference ``fixedWeight``): odometry and
        # known-inlier edges start fixed; GNC freezing
        # (weight_convergence_threshold) and replicated ``fixed`` flags from
        # owners grow it during the solve
        self._fixed_np = ~np.asarray(is_loop, bool)
        self._own_np = np.zeros((ntot, 1, 1), bool)
        self._own_np[: self.n_local] = True
        self._own_mask = torch.as_tensor(
            self._own_np, dtype=self.dtype, device=self.device
        )
        # neighbor-slot participation mask for edges whose neighbor pose is
        # not yet known: start with unknown slots' edges disabled
        self._slot_known = np.zeros((len(slots),), bool)
        cfg = self.config
        rtr = RTRParams(
            max_iterations=cfg.RTR_iterations,
            max_tcg_iterations=cfg.RTR_tCG_iterations,
            gradnorm_tol=cfg.RTR_gradnorm_tol,
        )
        rgd = RGDParams(
            stepsize=cfg.RGD_stepsize,
            use_preconditioner=cfg.RGD_use_preconditioner,
        )
        self._local_cache = None

        def solve(X, weights, emask) -> torch.Tensor:
            """X (host) after one local solve, on the device."""
            e, P = self._local_problem(weights, emask)
            Xd = torch.as_tensor(X, device=self.device)
            if cfg.solver == SolverMethod.RTR:
                return hbm_rtr.rtr_solve_hbm(Xd, 0, P, e, rtr, self.windows)[0]
            return rgd_solve(Xd, e, self._own_mask, P, rgd)[0]

        self._solve_fn = solve
        self._edge_mask_cache = None
        # pre-create the lifted state with identity Stiefel blocks so
        # neighbor separator poses can be buffered before initialization
        self._t_local_cache = None
        if self.X is None:
            r, d = self.config.relaxation_rank, self.config.dimension
            X = np.zeros((ntot, r, d + 1), self.np_dt)
            X[:, :d, :d] = np.eye(d)
            self.X = X
            self.V = X.copy()
            self.X_prev = X.copy()
        # replay separator poses that arrived before the problem existed
        pending, self._pending_poses = self._pending_poses, []
        for msg in pending:
            self._on_public_poses(msg)

    def _local_problem(self, weights: np.ndarray, emask: np.ndarray):
        """(EdgeSet, P⁻¹) on the device under the host ``weights`` and edge
        mask. Both change at GNC rounds and membership events, not per
        solve, so they are cached by identity (the handlers replace the
        arrays, never write into them; the cache pins them, so their ids
        cannot be recycled) and P⁻¹ is not factored again per solve
        (reference clearDataMatrices invalidation,
        src/PGOAgentROS.cpp:1351)."""
        c = self._local_cache
        if c is None or c[0] is not weights or c[1] is not emask:
            t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
            e = dataclasses.replace(self.edges, weight=t(weights), mask=t(emask))
            P = quadratic.precond_inverse(
                quadratic.precond_blocks(e, self.X.shape[0])
            ).contiguous()
            self._local_cache = c = (weights, emask, e, P)
        return c[2], c[3]

    def _edge_mask(self) -> np.ndarray:
        """Edges are active only when both endpoints are known and both
        endpoint robots are active (active-robot masking / inactive
        neighbors, reference ``activeLoopClosures`` semantics). Cached;
        invalidated when the active set or known-slot set changes."""
        cache = self._edge_mask_cache
        key = (frozenset(self.active_robots), int(self._slot_known.sum()))
        if cache is not None and cache[0] == key:
            return cache[1]
        m = self.measurements
        E = len(m)
        ok = np.ones((E,), bool)
        for k in range(E):
            for robot, frame in (
                (int(m.src_robot[k]), int(m.src_frame[k])),
                (int(m.dst_robot[k]), int(m.dst_frame[k])),
            ):
                if robot == self.id:
                    continue
                if robot not in self.active_robots:
                    ok[k] = False
                elif not self._slot_known[
                    self.neighbor_slots[(robot, frame)]
                ]:
                    ok[k] = False
        mask = ok.astype(self.np_dt)
        self._edge_mask_cache = (key, mask)
        return mask

    def _local_init_trajectory(self) -> np.ndarray:
        """Odometry or chordal init on the private subgraph, in the LOCAL
        frame (reference localInitializationMethod)."""
        m = self.measurements
        mine = np.asarray((m.src_robot == self.id) & (m.dst_robot == self.id))
        sub = m.select(mine)
        nk = self.n_local
        if (
            self.config.local_initialization_method == InitMethod.ODOMETRY
            or len(sub) == 0
        ):
            rel = np.zeros((nk - 1, 3, 4))
            rel[:, :, :3] = np.eye(3)
            odo = sub.edge_type == EdgeType.ODOMETRY
            for k in np.where(odo)[0]:
                f = int(sub.src_frame[k])
                if f < nk - 1:
                    rel[f, :, :3] = sub.R[k]
                    rel[f, :, 3] = sub.t[k]
            return hostmath.odometry_chain_np(rel.astype(self.np_dt))
        es = self._host_edge_set(
            sub.src_frame, sub.dst_frame, sub, np.zeros(len(sub)), nk
        ).to_torch(self.dtype, self.device)
        T = chordal_ops.chordal_initialization(es, nk, max_iters=300)
        return T.cpu().numpy()

    def _try_initialize(self) -> None:
        """Global-frame initialization (reference ``tryInitialize`` +
        ``initializeInGlobalFrame``): the leader anchors its own frame;
        followers align through one shared edge with an already-initialized
        neighbor whose separator poses have arrived."""
        if self.Ylift is None:
            return
        # cached: this runs every tick until initialization succeeds
        if self._t_local_cache is None:
            self._t_local_cache = self._local_init_trajectory()
        T_local = self._t_local_cache
        if self.is_leader():
            # warm start from the cached optimized trajectory (:354-361)
            if self.cached_trajectory is not None and len(
                self.cached_trajectory
            ) == self.n_local:
                T_world = self.cached_trajectory
            else:
                T_world = hostmath.anchor_to_first_pose_np(
                    np.asarray(T_local, self.np_dt)
                )
            self._set_initialized(T_world)
            return
        # follower: need an initialized neighbor's world separator pose
        m = self.measurements
        for k in range(len(m)):
            if m.edge_type[k] != EdgeType.SHARED_LOOP_CLOSURE:
                continue
            a, fa = int(m.src_robot[k]), int(m.src_frame[k])
            b, fb = int(m.dst_robot[k]), int(m.dst_frame[k])
            Me = np.concatenate([m.R[k], m.t[k][:, None]], axis=-1).astype(
                self.np_dt
            )
            if a == self.id and self._world_pose_known(b, fb):
                # G T_local[fa] Me = T_world(b, fb)
                Tn = self._world_pose(b, fb)
                rhs = self._se(Tn, hostmath.se_inverse_np(Me))
                G = self._se(
                    rhs,
                    hostmath.se_inverse_np(
                        np.asarray(T_local[fa], self.np_dt)
                    ),
                )
            elif b == self.id and self._world_pose_known(a, fa):
                # T_world(a, fa) Me = G T_local[fb]
                Tn = self._world_pose(a, fa)
                lhs = self._se(Tn, Me)
                G = self._se(
                    lhs,
                    hostmath.se_inverse_np(
                        np.asarray(T_local[fb], self.np_dt)
                    ),
                )
            else:
                continue
            T_world = hostmath.se_compose_np(
                np.broadcast_to(
                    np.asarray(G, self.np_dt), (self.n_local, 3, 4)
                ),
                np.asarray(T_local, self.np_dt),
            )
            self._set_initialized(T_world)
            return

    def _se(self, A, B):
        return hostmath.se_compose_np(
            np.asarray(A, self.np_dt), np.asarray(B, self.np_dt)
        )

    def _world_pose_known(self, robot: int, frame: int) -> bool:
        key = (robot, frame)
        return key in self.neighbor_slots and bool(
            self._slot_known[self.neighbor_slots[key]]
        )

    def _world_pose(self, robot: int, frame: int) -> np.ndarray:
        slot = self.neighbor_slots[(robot, frame)]
        Xn = np.asarray(self.X[self.n_local + slot])
        return hostmath.round_via_lifting_np(
            Xn[None], np.asarray(self.Ylift, self.np_dt)
        )[0]

    def _set_initialized(self, T_world: np.ndarray) -> None:
        ntot = self.n_local + len(self.neighbor_slots)
        Y = np.asarray(self.Ylift, self.np_dt)
        X = np.zeros((ntot, Y.shape[0], 4), self.np_dt)
        X[: self.n_local] = hostmath.lift_trajectory_np(
            np.asarray(T_world, self.np_dt), Y
        )
        # keep previously received neighbor poses
        if self.X is not None:
            X[self.n_local :] = np.asarray(self.X)[self.n_local :]
        else:
            X[self.n_local :, :3, :3] = np.eye(3)
        self.X = X
        self.V = X.copy()
        self.X_prev = X.copy()
        # restore cached GNC weights (warm start, reference :1072-1075)
        if self.cached_weights:
            w = self.weights.copy()
            m = self.measurements
            for k in range(len(m)):
                key = (
                    int(m.src_robot[k]),
                    int(m.src_frame[k]),
                    int(m.dst_robot[k]),
                    int(m.dst_frame[k]),
                )
                if key in self.cached_weights:
                    w[k] = self.cached_weights[key]
            self.weights = w
        self.state = AgentState.INITIALIZED
        self.iteration = 0
        self._publish_poses_requested = True
        self._publish_status()
        self.logger.log_event("INITIALIZED")

    # ----------------------------------------------------------- public poses

    def _separator_ids(self) -> np.ndarray:
        """Own poses touched by shared edges (what neighbors need). Cached —
        the measurement set is fixed after synchronization."""
        if self._separator_ids_cache is not None:
            return self._separator_ids_cache
        m = self.measurements
        shared = m.edge_type == EdgeType.SHARED_LOOP_CLOSURE
        own_src = m.src_frame[shared & (m.src_robot == self.id)]
        own_dst = m.dst_frame[shared & (m.dst_robot == self.id)]
        ids = np.unique(np.concatenate([own_src, own_dst])).astype(np.int32)
        self._separator_ids_cache = ids
        return ids

    def _publish_public_poses(self) -> None:
        if self.X is None:
            return
        ids = self._separator_ids()
        if ids.size == 0:
            return
        poses = self.X[ids]
        self.transport.publish(
            self.id,
            PublicPoses(
                robot_id=self.id,
                cluster_id=self.cluster_id,
                instance_number=self.instance,
                iteration_number=self.iteration,
                is_auxiliary=False,
                pose_ids=ids,
                poses=poses,
            ),
        )
        if self.config.acceleration and self.V is not None:
            self.transport.publish(
                self.id,
                PublicPoses(
                    robot_id=self.id,
                    cluster_id=self.cluster_id,
                    instance_number=self.instance,
                    iteration_number=self.iteration,
                    is_auxiliary=True,
                    pose_ids=ids,
                    poses=self.V[ids],
                ),
            )

    def _on_public_poses(self, msg: PublicPoses) -> None:
        """Reference ``publicPosesCallback`` :1255-1284."""
        if msg.cluster_id != self.cluster_id:
            return
        if self.edges is None:
            # local problem not built yet — buffer and replay after build
            self._pending_poses.append(msg)
            return
        if (
            msg.destination_robot_id is not None
            and msg.destination_robot_id != self.id
        ):
            return
        # vectorized slot update: one scatter per message, not per pose.
        # The (sender, pose_ids) → (rows, slots) mapping is FIXED for the
        # round (each robot's separator-id set never changes), so it is
        # resolved once per sender and cached
        pose_ids = np.asarray(msg.pose_ids)
        ck = (msg.robot_id, pose_ids.shape[0], int(pose_ids[0]) if pose_ids.shape[0] else -1)
        cached = self._pose_map_cache.get(ck)
        if cached is not None and np.array_equal(cached[0], pose_ids):
            rows, slots = cached[1], cached[2]
        else:
            rows_l, slots_l = [], []
            for i in range(pose_ids.shape[0]):
                slot = self.neighbor_slots.get(
                    (msg.robot_id, int(pose_ids[i]))
                )
                if slot is not None:
                    rows_l.append(i)
                    slots_l.append(slot)
            rows = np.asarray(rows_l, np.int64)
            slots = np.asarray(slots_l, np.int64)
            self._pose_map_cache[ck] = (pose_ids.copy(), rows, slots)
        if rows.size == 0:
            return
        idx = slots + self.n_local
        vals = np.asarray(msg.poses[rows], self.np_dt)
        if msg.is_auxiliary:
            if self.V is not None:
                self.V[idx] = vals
        else:
            if self.X is not None:
                self.X[idx] = vals
                if self.V is not None and not self.config.acceleration:
                    self.V[idx] = vals
            if not self._slot_known[slots].all():
                self._slot_known[slots] = True
                self._edge_mask_cache = None
            self.iter_received[msg.robot_id] = max(
                self.iter_received.get(msg.robot_id, -1),
                msg.iteration_number,
            )

    def _on_status(self, status: AgentStatus) -> None:
        self.team_status[status.robot_id] = status
        self.last_status_tick[status.robot_id] = self._tick
        if self.config.asynchronous and status.robot_id == self.cluster_id:
            # async mode sends no periodic commands — the leader's status
            # heartbeat is the command-channel liveness signal
            self.last_command_tick = self._tick
        if (
            status.robot_id == self._last_scheduled_robot
            and status.iteration_number >= self._scheduled_iteration
        ):
            self.timeout_count = 0  # consecutive-timeout counter (reference)

    def _publish_status(self) -> None:
        self.transport.publish(self.id, StatusMsg(self.get_status()))

    # ------------------------------------------------------------- optimize

    def _staleness_ok(self) -> bool:
        """Bounded-staleness gate (reference :136-149): for every active
        neighbor, the poses from its last *scheduled execution* (tracked via
        broadcast UPDATE tokens) must have arrived, up to
        ``maxDelayedIterations`` of slack; acceleration forces exact sync."""
        max_delay = (
            0 if self.config.acceleration else self.config.max_delayed_iterations
        )
        for nb in self._neighbors():
            required = min(
                self.last_exec_iter.get(nb, 0), self._executing_iteration - 1
            ) - max_delay
            if self.iter_received.get(nb, 0) < required:
                return False
        return True

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """A writable host copy of a solve's result (message handlers
        mutate the state in place)."""
        return np.array(t.detach().cpu().numpy(), self.np_dt)

    def _run_once_synchronous(self) -> None:
        """Reference ``runOnceSynchronous`` :129-220. Each solve is one K4
        launch on the card (on V, and on X again where the accelerated
        step restarts)."""
        if self.state != AgentState.INITIALIZED:
            self._opt_requested = False
            return
        if not self._staleness_ok():
            return  # wait for fresher separators
        t0 = time.time()
        emask = self._edge_mask()
        if self.config.acceleration:
            theta_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * self.theta**2))
            beta = float(
                self.config.acceleration_beta
                if self.config.acceleration_beta is not None
                else (self.theta - 1.0) / theta_new
            )
            Z = self._solve_fn(self.V, self.weights, emask)
            e, _ = self._local_problem(self.weights, emask)
            own = self._own_mask
            Xd = torch.as_tensor(self.X, device=self.device)
            X_acc = torch.where(own > 0, Z, Xd)
            f_acc, f_cur = torch.stack(
                [quadratic.cost(X_acc, e), quadratic.cost(Xd, e)]
            ).tolist()
            if f_acc <= f_cur:
                X_prev = torch.as_tensor(self.X_prev, device=self.device)
                Vk = stiefel.retract_polar_ns(
                    X_acc,
                    beta * stiefel.proj_tangent(X_acc, own * (X_acc - X_prev)),
                )
                X_new = X_acc
                V_new = torch.where(
                    own > 0, Vk, torch.as_tensor(self.V, device=self.device)
                )
                self.theta = theta_new
            else:
                X_new = self._solve_fn(self.X, self.weights, emask)
                V_new = X_new
                self.theta = 1.0
            if (self.iteration + 1) % self.config.restart_interval == 0:
                self.theta = 1.0
        else:
            X_new = self._solve_fn(self.X, self.weights, emask)
            V_new = X_new
        X_new = self._host(X_new)
        V_new = self._host(V_new)
        diff = (X_new - self.X)[: self.n_local]
        self.relative_change = float(np.sqrt(np.sum(diff * diff)))
        self.X_prev = np.where(self._own_np, self.X, self.X_prev)
        self.X = X_new
        self.V = V_new
        self.iteration = self._executing_iteration
        self.solved_iterations += 1
        if self.config.publish_iterate:
            # per-iteration trajectory stream (reference publishIterate,
            # ``PGOAgentROS.cpp:178-189``) — kept as an in-memory history
            # consumable by visualization
            if not hasattr(self, "iterate_history"):
                self.iterate_history = []
            self.iterate_history.append(
                (self.iteration, self.trajectory_world())
            )
        self.ready_to_terminate = (
            self.relative_change < self.config.relative_change_tolerance
        )
        self._opt_requested = False
        self._publish_poses_requested = True
        self._publish_status()
        self.logger.log_iteration(
            num_active_robots=len(self.active_robots),
            iteration=self.iteration,
            num_poses=self.n_local,
            bytes_received=self.bytes_received,
            iter_time_sec=time.time() - t0,
            rel_change=self.relative_change,
        )

    def _run_once_asynchronous(self) -> None:
        """Reference ``runOnceAsynchronous`` (``PGOAgentROS.cpp:119-127``;
        solver pick RGD at ``PGOAgentROSNode.cpp:87-93``): the core's local
        RGD loop spins at ``asynchronous_rate`` while the ~100 Hz wrapper
        flushes poses/status whenever the core requests
        (``mPublishAsynchronousRequested``). Deterministic analogue: each
        controller tick executes one local solve (``rgd_solve`` — the
        resolved async solver) against whatever neighbor separators have
        arrived (naturally stale, bounded by the transport), then flushes
        public poses and status. No UPDATE tokens, no staleness gate."""
        if self.state != AgentState.INITIALIZED:
            return
        t0 = time.time()
        emask = self._edge_mask()
        X_new = self._host(self._solve_fn(self.X, self.weights, emask))
        diff = (X_new - self.X)[: self.n_local]
        self.relative_change = float(np.sqrt(np.sum(diff * diff)))
        self.X_prev = self.X  # old buffer; X gets a fresh one below
        self.X = X_new
        self.V = X_new.copy()
        self.iteration += 1
        self.solved_iterations += 1
        self.ready_to_terminate = (
            self.relative_change < self.config.relative_change_tolerance
        )
        self._publish_poses_requested = True
        self._publish_status()
        self.logger.log_iteration(
            num_active_robots=len(self.active_robots),
            iteration=self.iteration,
            num_poses=self.n_local,
            bytes_received=self.bytes_received,
            iter_time_sec=time.time() - t0,
            rel_change=self.relative_change,
        )

    # ---------------------------------------------------------- GNC weights

    def _residuals(self) -> np.ndarray:
        """Whitened residuals of the local edges at the world trajectory of
        the local problem (own poses and separators), on the host."""
        he = self.host_edges
        return hostmath.measurement_residuals_np(
            self._world_trajectory_with_neighbors(),
            he.src, he.dst, he.R, he.t, he.kappa, he.tau,
        )

    def _update_weights_round(self) -> None:
        """Reference UPDATE_WEIGHT handler :1211-1233 + weight replication
        :721-754: owner (lower-ID endpoint) computes shared-edge weights."""
        if self.state != AgentState.INITIALIZED:
            return
        m = self.measurements
        emask_np = self._edge_mask()
        r = self._residuals()
        w = self.weights.copy()
        mu, barc = hostmath.gnc_round_params_np(
            self.weight_update_count,
            self.config,
            self.mu,
            residuals=r,
            loop_mask=self.host_edges.is_loop * emask_np,
        )
        # vectorized: all TLS weights in one call; apply to edges this robot
        # owns (private, or shared with the lower-ID-owner rule), skipping
        # frozen weights (``fixedWeight``, reference ``PGOAgentROS.cpp:1049``)
        w_all = hostmath.gnc_tls_weights_np(r, mu, barc)
        is_loop = self.host_edges.is_loop > 0
        a_ids = m.src_robot.astype(np.int64)
        b_ids = m.dst_robot.astype(np.int64)
        shared = a_ids != b_ids
        owner_is_me = np.minimum(a_ids, b_ids) == self.id
        mine = is_loop & (~shared | owner_is_me) & ~self._fixed_np
        w[mine] = w_all[mine]
        # weight-convergence freezing (reference
        # ``weightConvergenceThreshold``, ``PGOAgentROS.cpp:1049-1056``):
        # an edge whose GNC weight fell below the threshold is REJECTED and
        # frozen (weight=0, fixedWeight=true) — later rounds (and the
        # TERMINATE undecided-resolution) can no longer re-admit it
        thr = self.config.weight_convergence_threshold
        if thr > 0:
            conv = mine & (w < thr)
            w[conv] = 0.0
            self._fixed_np |= conv
        # replicate owned shared-edge weights WITH their fixed flags
        # (reference ``publishMeasurementWeights`` :720-754 sends
        # ``m.fixedWeight`` alongside each weight)
        rep = is_loop & shared & owner_is_me
        src_ids = a_ids[rep].tolist()
        src_f = m.src_frame[rep].tolist()
        dst_ids = b_ids[rep].tolist()
        dst_f = m.dst_frame[rep].tolist()
        w_out = w[rep].tolist()
        fixed_out = self._fixed_np[rep].tolist()
        self.weights = w
        self.mu = mu * self.config.GNC_mu_step
        self.weight_update_count += 1
        # robustOptNumResets (reference ``PGOAgentROSNode.cpp:212-221``):
        # after early weight updates, re-initialize the local block in the
        # current global frame so the next rounds descend from a clean
        # iterate under the new weights
        if self.weight_update_count <= self.config.robust_opt_num_resets:
            self._reinitialize_block()
        if src_ids:
            self.transport.publish(
                self.id,
                MeasurementWeights(
                    robot_id=self.id,
                    cluster_id=self.cluster_id,
                    src_robot_ids=np.asarray(src_ids),
                    src_pose_ids=np.asarray(src_f),
                    dst_robot_ids=np.asarray(dst_ids),
                    dst_pose_ids=np.asarray(dst_f),
                    weights=np.asarray(w_out),
                    fixed=np.asarray(fixed_out),
                ),
            )
        self.ready_to_terminate = False
        self.relative_change = float("inf")
        self.theta = 1.0
        self.V = None if self.X is None else self.X.copy()
        self._publish_status()
        self.logger.log_event("UPDATE_WEIGHT")

    def _on_weights(self, msg: MeasurementWeights) -> None:
        """Apply replicated shared-edge weights (reference
        ``measurementWeightsCallback`` :1315-1353)."""
        if self.edges is None:
            return
        m = self.measurements
        w = self.weights.copy()
        changed = False
        if self._edge_index is None:
            self._edge_index = {
                (
                    int(m.src_robot[k]),
                    int(m.src_frame[k]),
                    int(m.dst_robot[k]),
                    int(m.dst_frame[k]),
                ): k
                for k in range(len(m))
            }
        index = self._edge_index
        for i in range(len(msg.weights)):
            key = (
                int(msg.src_robot_ids[i]),
                int(msg.src_pose_ids[i]),
                int(msg.dst_robot_ids[i]),
                int(msg.dst_pose_ids[i]),
            )
            if key not in index:
                continue
            # only the lower-ID endpoint owns a shared edge's weight
            # (reference ``measurementWeightsCallback`` :1315-1353 applies
            # only when otherID < getID())
            if msg.robot_id != min(key[0], key[2]) or msg.robot_id >= self.id:
                continue
            k = index[key]
            w[k] = float(msg.weights[i])
            if msg.fixed is not None and bool(msg.fixed[i]):
                self._fixed_np[k] = True  # replicated freeze (fixed_weights[])
            changed = True
        if changed:
            # a new weights array: the solve's cached device copy and P⁻¹
            # follow it (clearDataMatrices analogue — the operators are
            # matrix-free, so only weights change)
            self.weights = w

    def _reinitialize_block(self) -> None:
        """robustOptNumResets re-initialization: rebuild this robot's block
        from its local initialization, re-anchored so the first pose keeps
        its current world placement (the global frame — and the neighbors'
        view of it — survives the reset)."""
        if self.X is None or self.Ylift is None:
            return
        T_local = self._local_init_trajectory()
        Tw = self.trajectory_world()
        if Tw is None or len(T_local) != self.n_local:
            return
        # G such that G T_local[0] = T_world[0]
        G = self._se(
            Tw[0], hostmath.se_inverse_np(np.asarray(T_local[0], self.np_dt))
        )
        T_world = hostmath.se_compose_np(
            np.broadcast_to(
                np.asarray(G, self.np_dt), (self.n_local, 3, 4)
            ),
            np.asarray(T_local, self.np_dt),
        )
        Y = np.asarray(self.Ylift, self.np_dt)
        Xown = hostmath.lift_trajectory_np(T_world, Y)
        X = np.array(self.X)
        X[: self.n_local] = Xown
        self.X = X
        self.V = X.copy()
        self.X_prev = X.copy()
        self.theta = 1.0
        self._publish_poses_requested = True
        self.logger.log_event("ROBUST_RESET")

    def _world_trajectory_with_neighbors(self) -> np.ndarray:
        return hostmath.round_via_lifting_np(
            np.asarray(self.X), np.asarray(self.Ylift, self.np_dt)
        )

    # ------------------------------------------------------------ terminate

    def _terminate(self) -> None:
        """Reference TERMINATE :1036-1082: freeze/reject undecided weights,
        cache results for warm start, reset."""
        if self.edges is not None and self.measurements is not None:
            w = self.weights.copy()
            loops = self.host_edges.is_loop > 0
            und = loops & (w > 1e-6) & (w < 1 - 1e-6) & ~self._fixed_np
            if self.config.gnc_finalize_by_residual and und.any() and (
                self.X is not None and self.Ylift is not None
            ):
                r = self._residuals()
                w[und] = (r[und] <= self.config.GNC_barc).astype(float)
            else:
                w[und] = 0.0
            m = self.measurements
            self.cached_weights = {
                (
                    int(m.src_robot[k]),
                    int(m.src_frame[k]),
                    int(m.dst_robot[k]),
                    int(m.dst_frame[k]),
                ): float(w[k])
                for k in range(len(m))
            }
            self.final_weights = w
            self.final_measurements = m  # survives reset() for fleet stats
            # robustOptMinConvergenceRatio gate (reference
            # ``PGOAgentROSNode.cpp:212-221``): warn when too few loop
            # closures were decided by the GNC rounds
            if self.config.robust_cost_type == RobustCostType.GNC_TLS:
                dec = int(((w[loops] >= 1 - 1e-6) | (w[loops] <= 1e-6)).sum())
                ratio = dec / max(int(loops.sum()), 1)
                if ratio < self.config.robust_opt_min_convergence_ratio:
                    self.logger.log_event("GNC_LOW_CONVERGENCE")
        self.final_trajectory = self.trajectory_world()
        self.cached_trajectory = self.final_trajectory
        self.final_iterations = self.solved_iterations
        self.final_active = sorted(self.active_robots)
        self.logger.log_event("TERMINATE")
        self.reset(complete=False)
        self.terminated = True

    # --------------------------------------------------------- leader logic

    def _leader_duties(self) -> None:
        cfg = self.config
        # bootstrap: kick off a round when idle (reference 3 s timer,
        # timerCallback :1355-1371)
        if self.state == AgentState.WAIT_FOR_DATA and not self.terminated:
            if self._tick - self.last_command_tick > 3:
                self._broadcast(CommandType.REQUEST_POSE_GRAPH)
                self._acquire_pose_graph()
                self.last_command_tick = self._tick
            return
        if self.state == AgentState.WAIT_FOR_INITIALIZATION:
            if self._tick - self.last_command_tick >= 1:
                self._broadcast(CommandType.INITIALIZE)
                self._initialize_round()
                self.last_command_tick = self._tick
            return
        if self.state != AgentState.INITIALIZED or self.terminated:
            return
        # barrier: all active robots initialized?
        ready = all(
            self.team_status.get(k) is not None
            and self.team_status[k].state == AgentState.INITIALIZED
            for k in self.active_robots
            if k != self.id
        )
        if self.iteration == 0 and not self._opt_requested and not ready:
            self._init_barrier_steps += 1
            if self._init_barrier_steps >= cfg.max_distributed_init_steps:
                # shrink to the initialized subset (reference :1108-1156)
                act = {self.id} | {
                    k
                    for k in self.active_robots
                    if self.team_status.get(k) is not None
                    and self.team_status[k].state == AgentState.INITIALIZED
                }
                self.active_robots = act
                self._deactivated_by_protocol = (
                    set(range(self.num_robots)) - act
                )
                self._edge_mask_cache = None
                self._broadcast(
                    CommandType.SET_ACTIVE_ROBOTS, active_robots=tuple(sorted(act))
                )
                self.logger.log_event("SHRINK_ACTIVE")
            else:
                self._broadcast(CommandType.INITIALIZE)
                self._initialize_round()
                return
        if cfg.asynchronous:
            # no UPDATE tokens in async mode (``publishUpdateCommand`` is a
            # no-op, reference :482-486) — only weight rounds + termination
            self._leader_duties_async()
            return
        if self.iteration == 0 and not self._scheduled_any():
            self._schedule_next_update()
            return
        # command-channel timeout / dead-robot detection (reference
        # checkTimeout :1515-1575); timeouts count ticks, not seconds
        exec_robot = self._last_scheduled_robot
        if exec_robot is not None and exec_robot != self.id:
            last = self.last_status_tick.get(exec_robot, 0)
            if self._tick - max(last, self._last_schedule_tick) > cfg.timeout_threshold:
                self.timeout_count += 1
                self.logger.log_event("TIMEOUT")
                if self.timeout_count >= 3:
                    # 3× timeout → hard reset (reference :1561-1574)
                    self._broadcast(CommandType.HARD_TERMINATE)
                    self.reset(complete=True)
                    self.terminated = True
                    return
                if cfg.enable_recovery:
                    # drop the stuck robot and roll the team back
                    # (reference :1515-1575, :1191-1209)
                    self.active_robots = self.active_robots - {exec_robot}
                    self._deactivated_by_protocol.add(exec_robot)
                    self._edge_mask_cache = None
                    self._broadcast(
                        CommandType.SET_ACTIVE_ROBOTS,
                        active_robots=tuple(sorted(self.active_robots)),
                    )
                    self._broadcast(
                        CommandType.RECOVER,
                        executing_iteration=self.iteration,
                    )
                    self._publish_poses_requested = True
                    self.logger.log_event("RECOVER")
                    self._schedule_next_update()
                else:
                    # retry: re-issue the same UPDATE token (the reference
                    # re-publishes the command on its control timer)
                    self._last_schedule_tick = self._tick
                    self._publish_poses_requested = True
                    self._broadcast(
                        CommandType.UPDATE,
                        executing_robot=exec_robot,
                        executing_iteration=self._scheduled_iteration,
                    )
                return
        # did the executing robot finish its iteration?
        if exec_robot is not None:
            st = (
                self.get_status()
                if exec_robot == self.id
                else self.team_status.get(exec_robot)
            )
            if st is None or st.iteration_number < self._scheduled_iteration:
                return  # still working
        # termination / weight rounds / next token
        gnc = cfg.robust_cost_type == RobustCostType.GNC_TLS
        inner = cfg.robust_opt_inner_iters_per_robot * len(self.active_robots)
        if gnc and self._scheduled_iteration > 0 and (
            self._scheduled_iteration % inner == 0
        ) and self.weight_update_count < cfg.robust_opt_num_weight_updates:
            self._broadcast(CommandType.UPDATE_WEIGHT)
            self._update_weights_round()
            self._schedule_next_update()
            return
        all_ready = all(
            (
                self.get_status()
                if k == self.id
                else self.team_status.get(k, AgentStatus(robot_id=k))
            ).ready_to_terminate
            for k in self.active_robots
        )
        gnc_done = (not gnc) or (
            self.weight_update_count >= cfg.robust_opt_num_weight_updates
        )
        if (
            all_ready and gnc_done
        ) or self._scheduled_iteration >= cfg.max_iteration_number:
            self._broadcast(CommandType.TERMINATE)
            self._terminate()
            return
        self._schedule_next_update()

    def _leader_duties_async(self) -> None:
        """Async-mode leader: GNC weight rounds on the iteration cadence and
        relative-change termination via status gossip — the reference's
        ``shouldTerminate`` / ``shouldUpdateMeasurementWeights`` checks,
        which remain leader duties even without UPDATE tokens."""
        cfg = self.config
        # keep re-broadcasting INITIALIZE while teammates are still aligning
        # (the async path has no iteration-0 barrier — the leader optimizes
        # from tick one, reference :119-127, while stragglers join live)
        uninit = [
            k
            for k in self.active_robots
            if k != self.id
            and (
                self.team_status.get(k) is None
                or self.team_status[k].state != AgentState.INITIALIZED
            )
        ]
        if uninit:
            self._init_barrier_steps += 1
            if self._init_barrier_steps < cfg.max_distributed_init_steps:
                self._broadcast(CommandType.INITIALIZE)
                self._initialize_round()
                return
        gnc = cfg.robust_cost_type == RobustCostType.GNC_TLS
        inner = cfg.robust_opt_inner_iters_per_robot * len(self.active_robots)
        if gnc and self.iteration > 0 and (
            self.iteration % inner == 0
        ) and self.weight_update_count < cfg.robust_opt_num_weight_updates:
            self._broadcast(CommandType.UPDATE_WEIGHT)
            self._update_weights_round()
            return
        all_ready = all(
            (
                self.get_status()
                if k == self.id
                else self.team_status.get(k, AgentStatus(robot_id=k))
            ).ready_to_terminate
            for k in self.active_robots
        )
        gnc_done = (not gnc) or (
            self.weight_update_count >= cfg.robust_opt_num_weight_updates
        )
        if (
            all_ready and gnc_done
        ) or self.iteration >= cfg.max_iteration_number:
            self._broadcast(CommandType.TERMINATE)
            self._terminate()

    def _scheduled_any(self) -> bool:
        return self._last_scheduled_robot is not None

    def _schedule_next_update(self) -> None:
        """Reference ``publishUpdateCommand`` :443-504 (Uniform/RoundRobin);
        Uniform draws from numpy's ``default_rng(seed)``, as JAX's agent
        does, so the two schedules are one."""
        cfg = self.config
        act = sorted(self.active_robots)
        it = self._scheduled_iteration + 1
        if cfg.update_rule == UpdateRule.ROUND_ROBIN or cfg.update_rule == UpdateRule.PARALLEL:
            nxt = act[(it - 1) % len(act)]
        else:
            rng = getattr(self, "_sched_rng", None)
            if rng is None:
                rng = self._sched_rng = np.random.default_rng(cfg.seed)
            nxt = act[int(rng.integers(len(act)))]
        self._scheduled_iteration = it
        self._last_scheduled_robot = nxt
        self._last_schedule_tick = self._tick
        if cfg.inter_update_sleep_time > 0:
            # reference paces UPDATE commands to let the (lossy) network
            # flush: ``PGOAgentROS.cpp:492`` sleeps inside
            # publishUpdateCommand; dpgo_demo.launch uses 0.1 s
            time.sleep(cfg.inter_update_sleep_time)
        self._broadcast(
            CommandType.UPDATE, executing_robot=nxt, executing_iteration=it
        )
        if nxt == self.id:
            self._opt_requested = True
            self._executing_iteration = it

    def _broadcast(self, command: CommandType, **kw) -> None:
        self.transport.publish(
            self.id,
            Command(
                command=command,
                cluster_id=self.cluster_id,
                publishing_robot=self.id,
                **kw,
            ),
        )
