"""Out-of-process SLAM front-end service.

The reference's data ingestion is a NETWORK service: each robot's pose
graph is served over a ROS service ``/<robot>/distributed_loop_closure/
request_pose_graph`` (``src/PGODatasetPublisherNode.cpp:46-51``), and the
agents pull from it across a process boundary
(``src/PGOAgentROS.cpp:246-261``) — in production (Kimera-Multi) a real
SLAM front-end serves the same interface. This module is its
cross-process analog; copy of ``dpgo_ros_tpu/parallel/frontend.py`` for the
PyTorch port (numpy and sockets only), with the same wire format, so a
client of either package talks to a server of the other:

* :class:`PoseGraphPublisher` — a TCP server process serving per-robot
  pose graphs from a loaded :class:`PoseGraphData` (g2o partitions, the
  tunnels per-robot CSVs or a synthetic world), and accepting optimized
  trajectories back (the ``publishOptimizedTrajectory`` return path,
  ``src/PGOAgentROS.cpp:622-660``). Run it as a process:
  ``python -m dpgo_ros_tpu_torch.parallel.frontend --dataset tunnels --port 7750``.
* :class:`RemoteDatasetServer` — the client. Implements the same
  ``request_pose_graph(robot_id) -> (MeasurementBatch, n_k)`` surface as
  the in-process ``DatasetServer``, so fleet agents can be pointed at a
  separate front-end process unchanged; ``fetch_data()`` reconstructs the
  full :class:`PoseGraphData` for the other modes; ``publish_trajectory``
  sends a solved trajectory back.

Wire format (host-side ingestion plumbing with no dependency beyond
numpy): each message is a 4-byte big-endian length followed by an
``.npz`` archive; the ``__op__`` array carries the JSON-encoded header,
numpy arrays carry the payload.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import socket
import socketserver
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from dpgo_ros_tpu_torch.types import MeasurementBatch, PoseGraphData

_MAX_MSG = 1 << 30  # 1 GiB sanity cap


# --------------------------------------------------------------- framing


def _pack(header: dict, arrays: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    buf = io.BytesIO()
    payload = dict(arrays or {})
    payload["__op__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8
    )
    np.savez(buf, **payload)
    raw = buf.getvalue()
    return len(raw).to_bytes(4, "big") + raw


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        c = sock.recv(min(n - got, 1 << 20))
        if not c:
            raise ConnectionError("peer closed mid-message")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket) -> Tuple[dict, Dict[str, np.ndarray]]:
    n = int.from_bytes(_recv_exact(sock, 4), "big")
    if not 0 < n <= _MAX_MSG:
        raise ConnectionError(f"bad frame length {n}")
    raw = _recv_exact(sock, n)
    z = np.load(io.BytesIO(raw), allow_pickle=False)
    arrays = {k: z[k] for k in z.files if k != "__op__"}
    header = json.loads(bytes(z["__op__"]).decode())
    return header, arrays


def _batch_arrays(m: MeasurementBatch) -> Dict[str, np.ndarray]:
    return {
        f.name: np.asarray(getattr(m, f.name))
        for f in dataclasses.fields(MeasurementBatch)
    }


def _batch_from_arrays(arrays: Dict[str, np.ndarray]) -> MeasurementBatch:
    return MeasurementBatch(
        **{
            f.name: arrays[f.name]
            for f in dataclasses.fields(MeasurementBatch)
        }
    )


# ---------------------------------------------------------------- server


class PoseGraphPublisher:
    """TCP front-end serving per-robot pose graphs (reference
    ``DatasetPublisher``) and collecting optimized trajectories."""

    def __init__(
        self,
        data: PoseGraphData,
        host: str = "127.0.0.1",
        port: int = 0,
        output_dir: Optional[str] = None,
    ):
        self.data = data
        self.output_dir = output_dir
        self.trajectories: Dict[int, np.ndarray] = {}
        self._shutdown = threading.Event()
        publisher = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # one connection, many requests
                while True:
                    try:
                        header, arrays = _recv_msg(self.request)
                    except (ConnectionError, OSError):
                        return
                    resp = publisher._dispatch(header, arrays)
                    if resp is None:
                        return
                    try:
                        self.request.sendall(resp)
                    except OSError:
                        return
                    if header.get("op") == "shutdown":
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address

    # each op mirrors a reference interaction; citations in _dispatch
    def _dispatch(self, header: dict, arrays) -> Optional[bytes]:
        op = header.get("op")
        d = self.data
        if op == "meta":
            return _pack(
                {"ok": True, "d": d.d, "num_robots": d.num_robots},
                {"num_poses": np.asarray(d.num_poses, np.int64)},
            )
        if op == "request_pose_graph":
            # reference queryPoseGraphCallback
            # (src/PGODatasetPublisherNode.cpp:62-72)
            k = int(header["robot_id"])
            if not 0 <= k < d.num_robots:
                return _pack({"ok": False, "error": f"bad robot_id {k}"})
            m = d.robot_measurements(k)
            out = _batch_arrays(m)
            hdr = {
                "ok": True,
                "d": d.d,
                "num_poses": int(d.num_poses[k]),
                "num_robots": d.num_robots,
                "has_initial_guess": bool(
                    d.initial_guess is not None and k in d.initial_guess
                ),
            }
            if hdr["has_initial_guess"]:
                out["initial_guess"] = np.asarray(d.initial_guess[k])
            return _pack(hdr, out)
        if op == "full_data":
            # whole-problem pull for the non-fleet modes (the reference has
            # no single-shot analog; agents each pull their slice)
            out = _batch_arrays(d.measurements)
            out["num_poses"] = np.asarray(d.num_poses, np.int64)
            return _pack({"ok": True, "d": d.d}, out)
        if op == "publish_trajectory":
            # return path: optimized trajectory from the solver
            # (reference publishOptimizedTrajectory,
            # src/PGOAgentROS.cpp:622-660)
            k = int(header["robot_id"])
            T = arrays["trajectory"]
            self.trajectories[k] = T
            if self.output_dir:
                os.makedirs(self.output_dir, exist_ok=True)
                np.save(
                    os.path.join(self.output_dir, f"robot{k}_trajectory.npy"),
                    T,
                )
            return _pack({"ok": True, "stored": int(T.shape[0])})
        if op == "shutdown":
            self._shutdown.set()
            threading.Thread(
                target=self._server.shutdown, daemon=True
            ).start()
            return _pack({"ok": True})
        return _pack({"ok": False, "error": f"unknown op {op!r}"})

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# ---------------------------------------------------------------- client


class RemoteDatasetServer:
    """Drop-in ``DatasetServer`` whose pose graphs come from a
    :class:`PoseGraphPublisher` in ANOTHER process (the reference agents'
    service-client role, ``src/PGOAgentROS.cpp:246-261``)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._lock = threading.Lock()

    def _call(self, header: dict, arrays=None):
        with self._lock:
            self._sock.sendall(_pack(header, arrays))
            return _recv_msg(self._sock)

    def meta(self) -> Tuple[int, int, np.ndarray]:
        hdr, arr = self._call({"op": "meta"})
        return int(hdr["num_robots"]), int(hdr["d"]), arr["num_poses"]

    def request_pose_graph(
        self, robot_id: int
    ) -> Tuple[MeasurementBatch, int]:
        hdr, arr = self._call(
            {"op": "request_pose_graph", "robot_id": int(robot_id)}
        )
        if not hdr.get("ok"):
            raise RuntimeError(hdr.get("error", "request failed"))
        arr.pop("initial_guess", None)
        return _batch_from_arrays(arr), int(hdr["num_poses"])

    def fetch_data(self) -> PoseGraphData:
        """Reconstruct the full PoseGraphData (the non-fleet modes)."""
        hdr, arr = self._call({"op": "full_data"})
        if not hdr.get("ok"):
            raise RuntimeError(hdr.get("error", "request failed"))
        num_poses = arr.pop("num_poses")
        return PoseGraphData(
            measurements=_batch_from_arrays(arr),
            num_poses=num_poses,
            d=int(hdr["d"]),
        )

    def publish_trajectory(self, robot_id: int, T: np.ndarray) -> int:
        hdr, _ = self._call(
            {"op": "publish_trajectory", "robot_id": int(robot_id)},
            {"trajectory": np.asarray(T)},
        )
        if not hdr.get("ok"):
            raise RuntimeError(hdr.get("error", "publish failed"))
        return int(hdr["stored"])

    def shutdown_server(self) -> None:
        try:
            self._call({"op": "shutdown"})
        except (ConnectionError, OSError):
            pass

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# ------------------------------------------------------------- CLI entry


def main(argv=None) -> int:
    """Serve a dataset, or a synthetic world, as a standalone front-end
    process."""
    import argparse

    p = argparse.ArgumentParser(
        description=(
            "dpgo_ros_tpu_torch front-end service: serve per-robot pose "
            "graphs over TCP (reference PGODatasetPublisherNode analog)"
        )
    )
    p.add_argument("--dataset", default="tunnels",
                   help="bundled g2o name or 'tunnels'")
    p.add_argument("--synthetic", choices=["sphere", "grid3d"],
                   help="serve a synthetic world instead of --dataset")
    p.add_argument("--synthetic_n", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_robots", type=int, default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7750)
    p.add_argument("--output", default=None,
                   help="directory for received trajectories")
    a = p.parse_args(argv)
    if a.synthetic:
        from dpgo_ros_tpu_torch.io.synthetic import generate_world

        kw = dict(n=a.synthetic_n)
        if a.synthetic == "grid3d":
            side = max(2, round(a.synthetic_n ** (1.0 / 3.0)))
            kw = dict(grid_shape=(side, side, side))
        data = generate_world(a.synthetic, num_robots=a.num_robots or 2,
                              seed=a.seed, **kw)[0]
        name = f"{a.synthetic} n={a.synthetic_n}"
    elif a.dataset == "tunnels":
        from dpgo_ros_tpu_torch.io.datasets import load_tunnels

        data, name = load_tunnels(num_robots=a.num_robots or 8), a.dataset
    else:
        from dpgo_ros_tpu_torch.io.datasets import load_g2o_dataset

        data = load_g2o_dataset(a.dataset, num_robots=a.num_robots or 2)
        name = a.dataset
    srv = PoseGraphPublisher(
        data, host=a.host, port=a.port, output_dir=a.output
    )
    print(
        f"frontend: serving {name} ({data.num_robots} robots, "
        f"{len(data.measurements)} measurements) on "
        f"{srv.host}:{srv.port}",
        flush=True,
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
