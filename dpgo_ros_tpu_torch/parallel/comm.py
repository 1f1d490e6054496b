"""Wire protocol + pluggable in-process transports (with fault injection).

Message-schema parity with the reference's ROS protocol (SURVEY.md §2.2):
``msg/Command.msg``, ``msg/Status.msg``, ``msg/PublicPoses.msg``,
``msg/RelativeMeasurementList.msg``, ``msg/RelativeMeasurementWeights.msg``,
the lifting-matrix broadcast, and the anchor broadcast. All delivery is
broadcast with receiver-side filtering on ``destination_robot_id`` — exactly
the reference's topic semantics (``src/PGOAgentROS.cpp:1286-1290``).

The reference's communication failures (dropped queue entries, robot
disconnects) are load-bearing for its protocol design; here they are
*simulated deterministically* by ``LossyTransport`` so the recovery paths
(timeout → SET_ACTIVE_ROBOTS / RECOVER / HARD_TERMINATE) are testable — the
fault-injection capability the reference lacks (SURVEY.md §5.3).

Copy of ``dpgo_ros_tpu/parallel/comm.py`` for the PyTorch port (numpy
only): the same messages, the same seeded drops, the same byte counts.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dpgo_ros_tpu_torch.types import AgentStatus, CommandType, MeasurementBatch


# ----------------------------------------------------------------- messages


@dataclasses.dataclass
class Command:
    """``msg/Command.msg`` parity."""

    command: CommandType
    cluster_id: int = 0
    publishing_robot: int = 0
    executing_robot: int = 0
    executing_iteration: int = 0
    active_robots: Tuple[int, ...] = ()


@dataclasses.dataclass
class PublicPoses:
    """``msg/PublicPoses.msg`` parity: separator lifted poses X ∈ R^{r×(d+1)};
    ``is_auxiliary`` carries the Nesterov auxiliary sequence Y."""

    robot_id: int
    cluster_id: int
    instance_number: int
    iteration_number: int
    is_auxiliary: bool
    pose_ids: np.ndarray  # (S,) local frame ids
    poses: np.ndarray  # (S, r, d+1)
    destination_robot_id: Optional[int] = None  # None = broadcast


@dataclasses.dataclass
class RelativeMeasurementList:
    """``msg/RelativeMeasurementList.msg`` parity (shared-LC sync)."""

    from_robot: int
    from_cluster: int
    to_robot: int
    measurements: MeasurementBatch


@dataclasses.dataclass
class MeasurementWeights:
    """``msg/RelativeMeasurementWeights.msg`` parity (GNC replication;
    owner = lower-ID robot, ``src/PGOAgentROS.cpp:732,1340``)."""

    robot_id: int
    cluster_id: int
    src_robot_ids: np.ndarray
    src_pose_ids: np.ndarray
    dst_robot_ids: np.ndarray
    dst_pose_ids: np.ndarray
    weights: np.ndarray
    fixed: np.ndarray
    destination_robot_id: Optional[int] = None


@dataclasses.dataclass
class LiftingMatrix:
    """Lifting-matrix broadcast (``src/PGOAgentROS.cpp:402-410``; the
    declared-but-unused ``srv/QueryLiftingMatrix.srv`` service is subsumed)."""

    robot_id: int
    matrix: np.ndarray  # (r, d)


@dataclasses.dataclass
class Anchor:
    """Global-anchor broadcast (``publishAnchor``,
    ``src/PGOAgentROS.cpp:412-441``): the leader's first lifted pose."""

    robot_id: int
    pose: np.ndarray  # (r, d+1)


@dataclasses.dataclass
class StatusMsg:
    status: AgentStatus


Message = object  # any of the dataclasses above


# ---------------------------------------------------------------- transports


class Transport:
    """Broadcast transport: every robot receives every message (except its
    own) on poll; receiver filters. Subclasses inject faults."""

    def __init__(self, num_robots: int):
        self.num_robots = num_robots
        self.queues: Dict[int, deque] = {
            k: deque() for k in range(num_robots)
        }
        self.bytes_delivered: Dict[int, int] = defaultdict(int)
        self.messages_sent = 0

    def publish(self, sender: int, msg: Message) -> None:
        self.messages_sent += 1
        for k in range(self.num_robots):
            if k == sender:
                continue
            self._enqueue(sender, k, msg)

    def _enqueue(self, sender: int, receiver: int, msg: Message) -> None:
        self.queues[receiver].append(msg)

    def poll(self, robot_id: int) -> List[Message]:
        q = self.queues[robot_id]
        out = list(q)
        q.clear()
        for m in out:
            self.bytes_delivered[robot_id] += _msg_bytes(m)
        return out

    def tick(self) -> None:
        """Advance simulated time (used by delaying transports)."""


class PerfectTransport(Transport):
    """Reliable, in-order, zero-delay delivery."""


class LossyTransport(Transport):
    """Seeded fault injection: per-message drop probability, fixed delivery
    delay in ticks, and link partitions (robot pairs that cannot talk) —
    models the lossy robot mesh the reference is designed for."""

    def __init__(
        self,
        num_robots: int,
        drop_prob: float = 0.0,
        delay_ticks: int = 0,
        seed: int = 0,
        partitioned: Sequence[Tuple[int, int]] = (),
        dead_robots: Sequence[int] = (),
    ):
        super().__init__(num_robots)
        self.drop_prob = drop_prob
        self.delay_ticks = delay_ticks
        self.rng = np.random.default_rng(seed)
        self.partitioned = {tuple(sorted(p)) for p in partitioned}
        self.dead = set(dead_robots)
        self._pending: deque = deque()  # (deliver_at_tick, receiver, msg)
        self._now = 0

    def kill_robot(self, robot_id: int) -> None:
        """Simulated crash: robot stops sending and receiving."""
        self.dead.add(robot_id)

    def revive_robot(self, robot_id: int) -> None:
        self.dead.discard(robot_id)

    def _enqueue(self, sender: int, receiver: int, msg: Message) -> None:
        if sender in self.dead or receiver in self.dead:
            return
        if tuple(sorted((sender, receiver))) in self.partitioned:
            return
        if self.drop_prob > 0 and self.rng.random() < self.drop_prob:
            return
        if self.delay_ticks > 0:
            self._pending.append((self._now + self.delay_ticks, receiver, msg))
        else:
            self.queues[receiver].append(msg)

    def tick(self) -> None:
        self._now += 1
        while self._pending and self._pending[0][0] <= self._now:
            _, receiver, msg = self._pending.popleft()
            if receiver not in self.dead:
                self.queues[receiver].append(msg)


def _msg_bytes(msg: Message) -> int:
    """Approximate wire size (for bytes_received telemetry parity,
    ``src/utils.cpp:251-260``)."""
    if isinstance(msg, PublicPoses):
        return 21 + msg.poses.size * 8 + msg.pose_ids.size * 4
    if isinstance(msg, MeasurementWeights):
        return 21 + msg.weights.size * 9 + msg.src_pose_ids.size * 16
    if isinstance(msg, Command):
        return 24 + 4 * len(msg.active_robots)
    if isinstance(msg, StatusMsg):
        return 32
    if isinstance(msg, LiftingMatrix):
        return 8 + msg.matrix.size * 8
    if isinstance(msg, Anchor):
        return 8 + msg.pose.size * 8
    if isinstance(msg, RelativeMeasurementList):
        return 12 + len(msg.measurements) * 120
    return 64
