"""The port's front-end service (``parallel/frontend.py``) against the JAX
package's: one wire format, so each package's client talks to the other's
server and gets the same per-robot pose graphs; and a two-process fleet
solve through the port's CLI (``--mode fleet --frontend``, CPU) against a
port server in its own process, which stores the trajectories sent back.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dpgo_ros_tpu.parallel import frontend as j_frontend
from dpgo_ros_tpu.parallel.agent_node import DatasetServer as JaxDatasetServer
from dpgo_ros_tpu_torch import cli
from dpgo_ros_tpu_torch.io.synthetic import generate_world
from dpgo_ros_tpu_torch.parallel import frontend
from dpgo_ros_tpu_torch.parallel.agent_node import DatasetServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("server,client", [
    (frontend, j_frontend),  # a port server, a JAX client
    (j_frontend, frontend),  # a JAX server, a port client
], ids=["port-server", "jax-server"])
def test_servers_and_clients_interchange(server, client, tmp_path):
    data, _, _ = generate_world("sphere", n=150, num_robots=3, seed=4)
    srv = server.PoseGraphPublisher(data, output_dir=str(tmp_path))
    srv.serve_background()
    try:
        cl = client.RemoteDatasetServer(srv.host, srv.port)
        nR, d, num_poses = cl.meta()
        assert (nR, d) == (3, data.d)
        np.testing.assert_array_equal(num_poses, data.num_poses)
        for k in range(3):
            got, n_k = cl.request_pose_graph(k)
            for local in (DatasetServer(data), JaxDatasetServer(data)):
                want, n_want = local.request_pose_graph(k)
                assert n_k == n_want
                for f in dataclasses.fields(want):
                    np.testing.assert_array_equal(getattr(got, f.name),
                                                  getattr(want, f.name))
        full = cl.fetch_data()
        np.testing.assert_array_equal(full.num_poses, data.num_poses)
        for f in dataclasses.fields(data.measurements):
            np.testing.assert_array_equal(getattr(full.measurements, f.name),
                                          getattr(data.measurements, f.name))
        T = np.random.default_rng(0).standard_normal((int(num_poses[1]), 3, 4))
        assert cl.publish_trajectory(1, T) == T.shape[0]
        np.testing.assert_array_equal(np.load(tmp_path / "robot1_trajectory.npy"), T)
        cl.close()
    finally:
        srv.close()


def test_two_process_fleet_solve(tmp_path):
    """Process A (``python -m dpgo_ros_tpu_torch.parallel.frontend``)
    serves a synthetic world; this process runs the port's fleet against
    it through ``--frontend`` (every agent's pose-graph pull crosses the
    socket) and sends the solved trajectories back, which A stores."""
    served = str(tmp_path / "served")
    world = ["--synthetic", "sphere", "--synthetic_n", "200", "--num_robots", "2",
             "--seed", "42"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpgo_ros_tpu_torch.parallel.frontend", *world,
         "--port", "0", "--output", served],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    try:
        line = proc.stdout.readline()
        assert "serving" in line, line
        host, _, port = line.rsplit(" on ", 1)[1].strip().rpartition(":")
        summary, extras = cli.run([
            "--frontend", f"{host}:{port}", "--mode", "fleet", "--num_robots", "2",
            "--update_rule", "RoundRobin", "--RTR_gradnorm_tol", "0.5",
            "--device", "cpu", "--output", str(tmp_path / "sol"),
        ])
        assert summary["mode"] == "fleet" and all(extras["terminated"])
        data, _, _ = generate_world("sphere", n=200, num_robots=2, seed=42)
        want = [os.path.join(served, f"robot{k}_trajectory.npy") for k in range(2)]
        deadline = time.time() + 10
        while time.time() < deadline and not all(map(os.path.exists, want)):
            time.sleep(0.1)
        for k, path in enumerate(want):
            T = np.load(path)
            assert T.shape == (int(data.num_poses[k]), 3, 4)
            assert np.isfinite(T).all()
        assert os.path.getsize(str(tmp_path / "sol") + "_global.g2o") > 0
    finally:
        proc.terminate()
        proc.wait(timeout=10)
