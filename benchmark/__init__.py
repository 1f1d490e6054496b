"""The benchmark of ``dpgo_ros_tpu_torch`` on one NVIDIA H100: one command
runs one cell (``python -m benchmark.run --workload <cell> ...``); see
``benchmark/README.md``."""
