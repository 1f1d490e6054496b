"""Registry of the benchmark datasets bundled with the reference (its
``data/`` directory, SURVEY.md §2.5). Paths resolve against
``DPGO_TPU_DATA_DIR`` if set, else ``data/`` at the repository root."""

from __future__ import annotations

import os
from typing import List

from dpgo_ros_tpu_torch.io.csv_loader import load_multi_robot_csv
from dpgo_ros_tpu_torch.io.partition import partition_g2o
from dpgo_ros_tpu_torch.types import PoseGraphData

DEFAULT_DATA_DIR = os.environ.get(
    "DPGO_TPU_DATA_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data"),
)

G2O_DATASETS = {
    # name: (poses, edges) — SURVEY.md §2.5
    "tinyGrid3D": (9, 11),
    "smallGrid3D": (125, 297),
    "parking-garage": (1661, 6275),
    "sphere2500": (2500, 4949),
    "torus3D": (5000, 9048),
    "cubicle": (5750, 16869),
}


def dataset_path(name: str, data_dir: str | None = None) -> str:
    root = data_dir or DEFAULT_DATA_DIR
    return os.path.join(root, f"{name}.g2o")


def load_g2o_dataset(
    name: str, num_robots: int = 1, data_dir: str | None = None,
    balance: str = "poses",
) -> PoseGraphData:
    """``balance``: "poses" (reference equal-count blocks) or "work"
    (contiguous blocks balancing poses + owned edges — see
    ``io/partition.py::balanced_contiguous_partition``)."""
    return partition_g2o(
        dataset_path(name, data_dir), num_robots, balance=balance
    )


def tunnels_paths(data_dir: str | None = None, num_robots: int = 8) -> List[str]:
    root = data_dir or DEFAULT_DATA_DIR
    return [
        os.path.join(root, "tunnels", f"robot{r}", "measurements.csv")
        for r in range(num_robots)
    ]


def load_tunnels(data_dir: str | None = None, num_robots: int = 8) -> PoseGraphData:
    """8-robot MIT tunnels dataset with outlier loop closures (GNC demo,
    reference ``launch/dpgo_gnc_demo.launch:2,15``)."""
    return load_multi_robot_csv(tunnels_paths(data_dir, num_robots))
