"""Fleet controller: deterministic tick loop over agents + transport.

Replaces the reference's roslaunch + N OS processes + rosmaster (SURVEY.md
§4 'Multi-node without a cluster'): all agents run in one process over an
in-memory transport, making the full distributed protocol deterministic and
unit-testable — including fault injection (kill/partition robots mid-solve)
that the reference can only exercise live.

Port of ``dpgo_ros_tpu/parallel/controller.py``: the agents' solves run on
``device`` (the card unless the caller names another; every synchronous
RTR solve one K4 launch there), everything else on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from dpgo_ros_tpu_torch.parallel.agent_node import (
    DatasetServer,
    PGOAgentNode,
    check_device,
)
from dpgo_ros_tpu_torch.parallel.comm import LossyTransport, PerfectTransport, Transport
from dpgo_ros_tpu_torch.types import EdgeType, PoseGraphData
from dpgo_ros_tpu_torch.utils.config import AgentConfig


class DistributedController:
    """Owns the fleet. ``run()`` ticks every agent until the round
    terminates (every agent processed TERMINATE) or ``max_ticks``."""

    def __init__(
        self,
        data: PoseGraphData,
        config: AgentConfig,
        transport: Optional[Transport] = None,
        dataset=None,
        device="cuda",
    ):
        self.data = data
        self.config = config.resolve()
        # refused here, before any agent exists: float64 on the card
        self.device = check_device(device, self.config.dtype)
        self.transport = transport or PerfectTransport(data.num_robots)
        # ``dataset`` may be any object with the DatasetServer surface —
        # e.g. a frontend.RemoteDatasetServer, in which case every agent's
        # pose-graph pull crosses a process boundary exactly like the
        # reference service call (``src/PGOAgentROS.cpp:246-261``)
        self.dataset = dataset if dataset is not None else DatasetServer(data)
        self.agents: List[PGOAgentNode] = [
            PGOAgentNode(k, self.config, self.transport, self.dataset, self.device)
            for k in range(data.num_robots)
        ]

    def _connectivity(self, robot_id: int) -> set:
        """Reachable peers of ``robot_id`` given transport faults (the
        external connectivity feed of the reference)."""
        dead = getattr(self.transport, "dead", set())
        part = getattr(self.transport, "partitioned", set())
        if robot_id in dead:
            return set()
        return {
            k
            for k in range(self.data.num_robots)
            if k != robot_id
            and k not in dead
            and tuple(sorted((robot_id, k))) not in part
        }

    def run(self, max_ticks: int = 10_000, snapshot=None) -> Dict:
        """Tick the fleet to termination. ``snapshot`` (any object with a
        ``_due(tick)`` test and a ``snapshot(tick, T, weights=)`` method, as
        the JAX package's ``utils.snapshots.SnapshotWriter``) gets a rounded
        live global trajectory + current GNC weights whenever one is due —
        the fleet analog of the reference's continuous 30 s viz timer
        (``src/PGOAgentROS.cpp:85-86,622-660``)."""
        feed_connectivity = isinstance(self.transport, LossyTransport)
        for t in range(max_ticks):
            self.transport.tick()
            for a in self.agents:
                if not _is_dead(self.transport, a.id):
                    if feed_connectivity:
                        a.set_connected_peers(self._connectivity(a.id))
                    a.runOnce()
            if snapshot is not None and snapshot._due(t):
                T = self._live_global_trajectory()
                if T is not None:
                    snapshot.snapshot(
                        t, T, weights=self._live_global_weights()
                    )
            if all(a.terminated for a in self.agents if not _is_dead(self.transport, a.id)):
                break
        trajs = {
            a.id: a.final_trajectory
            for a in self.agents
            if getattr(a, "final_trajectory", None) is not None
        }
        return {
            "ticks": t + 1,
            "terminated": [a.terminated for a in self.agents],
            "trajectories": trajs,
            "iterations": {
                a.id: getattr(a, "final_iterations", a.solved_iterations)
                for a in self.agents
            },
            "messages_sent": self.transport.messages_sent,
            "bytes_received": dict(self.transport.bytes_delivered),
            "active_robots": getattr(
                self.agents[0],
                "final_active",
                sorted(self.agents[0].active_robots),
            ),
            "weights": {
                a.id: getattr(a, "final_weights", None) for a in self.agents
            },
        }

    def _live_global_trajectory(self) -> Optional[np.ndarray]:
        """Concatenated world trajectories of the LIVE agents (mid-run);
        None until every non-dead agent is initialized. Only evaluated
        when a snapshot is due (rounding every agent every tick would
        dominate the tick)."""
        parts = []
        for a in self.agents:
            if _is_dead(self.transport, a.id):
                return None
            T = a.trajectory_world()
            if T is None:
                return None
            parts.append(T)
        return np.concatenate(parts, axis=0)

    def _live_global_weights(self) -> Optional[np.ndarray]:
        """Current GNC weights mapped onto the global measurement batch
        (lower-ID-owner rule) — the mid-run analog of
        :meth:`global_weights`."""
        live = {
            a.id: a.weights if a.edges is not None else None
            for a in self.agents
        }
        if all(w is None for w in live.values()):
            return None
        fake_result = {"weights": live}
        return self.global_weights(fake_result, self.data.measurements)

    def start_new_round(self) -> None:
        """Begin another optimization instance: agents keep their warm-start
        caches (optimized trajectory re-anchoring + GNC weights) unless
        ``complete_reset`` (reference across-rounds semantics, SURVEY.md
        §5.4; ``PGOAgentROS.cpp:354-361, 1072-1075``)."""
        for a in self.agents:
            a.terminated = False

    # ------------------------------------------------------------ persistence

    def save_checkpoint(self, path: str, meta: Optional[Dict] = None) -> str:
        """Durable fleet checkpoint: every agent's warm-start caches — the
        exact state the reference retains across rounds in memory only
        (cached optimized trajectory + GNC edge weights,
        ``PGOAgentROS.cpp:354-361, 1072-1075``) — written to disk so a
        killed/preempted fleet resumes its next round warm instead of cold.

        Post-round caches are the protocol-consistent persistence boundary:
        mid-round agent state is entangled with in-flight messages (the
        reference cannot checkpoint there either — a timeout triggers
        RECOVER, not resume).
        """
        import json as _json
        import os as _os

        _os.makedirs(path, exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}
        weights = {}
        for a in self.agents:
            traj = getattr(a, "cached_trajectory", None)
            if traj is None:
                traj = getattr(a, "final_trajectory", None)
            if traj is not None:
                arrays[f"traj_{a.id}"] = np.asarray(traj)
            cw = getattr(a, "cached_weights", None)
            if cw:
                weights[str(a.id)] = [
                    [list(map(int, k)), float(v)] for k, v in cw.items()
                ]
        np.savez_compressed(_os.path.join(path, "fleet_caches.npz"), **arrays)
        with open(_os.path.join(path, "fleet_meta.json"), "w") as f:
            _json.dump(
                {
                    "num_robots": self.data.num_robots,
                    "weights": weights,
                    "meta": meta or {},
                },
                f,
            )
        return path

    def restore_checkpoint(self, path: str) -> None:
        """Load warm-start caches saved by :meth:`save_checkpoint` into the
        fleet's agents (the durable analogue of the reference's in-memory
        across-round warm start)."""
        import json as _json
        import os as _os

        with np.load(_os.path.join(path, "fleet_caches.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(_os.path.join(path, "fleet_meta.json")) as f:
            doc = _json.load(f)
        if doc["num_robots"] != self.data.num_robots:
            raise ValueError(
                f"checkpoint has {doc['num_robots']} robots, fleet has "
                f"{self.data.num_robots}"
            )
        for a in self.agents:
            key = f"traj_{a.id}"
            if key in arrays:
                a.cached_trajectory = arrays[key]
            cw = doc["weights"].get(str(a.id))
            if cw:
                a.cached_weights = {tuple(k): v for k, v in cw}

    def gnc_statistics(self, result: Dict) -> Optional[Dict]:
        """Fleet-wide GNC accept/reject/undecided statistics over *unique*
        loop closures (reference ``PoseGraph::statistics()``,
        ``src/PGOAgentROS.cpp:1058-1067``). Shared edges are counted once,
        using the owner's (lower-ID robot's) final weight — the same
        ownership rule the weight-replication protocol uses."""
        seen = {}
        for a in self.agents:
            w = result["weights"].get(a.id)
            m = getattr(a, "final_measurements", None) or a.measurements
            if w is None or m is None:
                continue
            loops = np.asarray(m.edge_type != EdgeType.ODOMETRY)
            for k in np.where(loops)[0]:
                key = (
                    int(m.src_robot[k]), int(m.src_frame[k]),
                    int(m.dst_robot[k]), int(m.dst_frame[k]),
                )
                owner = min(key[0], key[2])
                if key not in seen or owner == a.id:
                    seen[key] = float(w[k])
        if not seen:
            return None
        vals = np.asarray(list(seen.values()))
        acc = int((vals >= 1 - 1e-6).sum())
        rej = int((vals <= 1e-6).sum())
        und = int(len(vals) - acc - rej)
        return {
            "accepted": acc,
            "rejected": rej,
            "undecided": und,
            "convergence_ratio": (acc + rej) / max(len(vals), 1),
        }

    def global_weights(
        self, result: Dict, measurements
    ) -> Optional[np.ndarray]:
        """Map per-agent final GNC weights onto a global measurement batch
        (same edge-key matching and lower-ID-owner rule as
        :meth:`gnc_statistics`). Odometry and unmatched edges get weight 1.
        Feeds the TERMINATE-time export so the loop-closure overlay/report
        reflects the fleet's actual accept/reject split
        (``publishOptimizedTrajectory`` dump, ``PGOAgentROS.cpp:1077-1080``)."""
        seen = {}
        for a in self.agents:
            w = result["weights"].get(a.id)
            m = getattr(a, "final_measurements", None) or a.measurements
            if w is None or m is None:
                continue
            loops = np.asarray(m.edge_type != EdgeType.ODOMETRY)
            for k in np.where(loops)[0]:
                key = (
                    int(m.src_robot[k]), int(m.src_frame[k]),
                    int(m.dst_robot[k]), int(m.dst_frame[k]),
                )
                owner = min(key[0], key[2])
                if key not in seen or owner == a.id:
                    seen[key] = float(w[k])
        if not seen:
            return None
        g = measurements
        out = np.ones(len(g.edge_type), np.float64)
        for k in range(len(g.edge_type)):
            if int(g.edge_type[k]) == int(EdgeType.ODOMETRY):
                continue
            key = (
                int(g.src_robot[k]), int(g.src_frame[k]),
                int(g.dst_robot[k]), int(g.dst_frame[k]),
            )
            if key in seen:
                out[k] = seen[key]
        return out

    def global_trajectory(self, result: Dict) -> Optional[np.ndarray]:
        """Concatenate per-robot world trajectories (robots 0..R-1)."""
        trajs = result["trajectories"]
        if not trajs:
            return None
        return np.concatenate(
            [trajs[k] for k in sorted(trajs.keys())], axis=0
        )


def _is_dead(transport: Transport, robot_id: int) -> bool:
    return robot_id in getattr(transport, "dead", set())
