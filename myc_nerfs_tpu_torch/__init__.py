"""myc_nerfs_tpu_torch — the PyTorch + CUDA port of myc_nerfs_tpu.

Each sub-package mirrors its counterpart in ``myc_nerfs_tpu`` file for
file; the JAX package is the reference the port is tested against. The
port imports ``torch`` and never ``jax``.

Ported so far: the Instant-NGP path, training and rendering
(``cli/run_net.py --task train|test|render``): brick3/hash grid encode, SH
encode, the two NGP MLPs and the brick3 encode forward and backward
through hand-written Hopper kernels (``csrc/fused_mlp.cu``,
``csrc/grid_encode.cu``), the occupancy grid and its update, the fused
march, the compositor, the Adam/EMA trainer, blender and synthetic data,
JAX-format checkpoints, and the gather/scatter-add rate probes
(``cli/probe_grid.py``, ``csrc/grid_probe.cu``).
"""

__version__ = "0.1.0"
