"""dpgo_ros_tpu_torch — the PyTorch/CUDA port of ``dpgo_ros_tpu``.

Same algorithms, same public layouts, same module map as the JAX package
(``io/``, ``ops/``, ``models/``, ``parallel/``, ``utils/``, ``cli.py``).
Plain tensor code is PyTorch; the kernels the JAX package ran in Pallas are
hand-written CUDA kernels (``csrc/``): the RTR block solve (K1), the
multi-step runner (K2), the ASAPP tick (K3), the windowed block solve (K4)
and the roofline's calibration chains (K5, K6; ``scripts/`` holds the
measurement scripts). This package imports
nothing of the JAX package, not even its numpy-only modules: ``types``,
``io/`` and ``utils/`` here are its own copies.
"""

__version__ = "0.1.0"
