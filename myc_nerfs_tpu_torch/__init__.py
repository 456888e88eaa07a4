"""myc_nerfs_tpu_torch — the PyTorch + CUDA port of myc_nerfs_tpu.

Each sub-package mirrors its counterpart in ``myc_nerfs_tpu`` file for
file; the JAX package is the reference the port is tested against. The
port imports ``torch`` and never ``jax``.

Ported so far: the Instant-NGP path, training and rendering
(``cli/run_net.py --task train|test|render``): brick3/hash grid encode, SH
encode, the two NGP MLPs forward and backward through the hand-written
Hopper kernels (``csrc/fused_mlp.cu``), the occupancy grid and its update,
the fused march, the compositor, the Adam/EMA trainer, blender and
synthetic data, and JAX-format checkpoints.
"""

__version__ = "0.1.0"
