"""dpgo_ros_tpu_torch — the PyTorch/CUDA port of ``dpgo_ros_tpu``.

Same algorithms, same public layouts, same module map as the JAX package
(``ops/``, ``models/``, ``parallel/``, ``cli.py``). Plain tensor code is
PyTorch; the RTR block solve that the JAX package ran as a Pallas kernel
is a hand-written CUDA kernel (``csrc/rtr_block.cu``, bound in
``ops/fused_rtr.py``). This package never imports jax: it reuses only the
JAX package's numpy-only modules (``types``, ``io``, ``utils.config``,
``utils.export``).
"""

__version__ = "0.1.0"
