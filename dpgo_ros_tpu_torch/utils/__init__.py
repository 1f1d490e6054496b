"""Configuration, export, visualization and telemetry: copies of the JAX
package's numpy-only ``dpgo_ros_tpu/utils`` modules under the same names,
so that this package imports nothing of the JAX package; and ``work``, the
port's own count of the bytes and operations a kernel call needs."""
