"""Pose-graph input: g2o and CSV readers, partitioning, synthetic worlds.

Copies of the JAX package's numpy-only ``dpgo_ros_tpu/io`` modules under the
same names, so that this package imports nothing of the JAX package.
``generate_world`` gives bit-identical arrays to the JAX package's for the
same arguments (``tests/test_torch_io.py`` pins it)."""
