"""myc_nerfs_tpu_torch — the PyTorch + CUDA port of myc_nerfs_tpu.

Each sub-package mirrors its counterpart in ``myc_nerfs_tpu`` file for
file; the JAX package is the reference the port is tested against. The
port imports ``torch`` and never ``jax``.

Ported so far: the Instant-NGP render path (``cli/run_net.py --task
test|render``): brick3/hash grid encode, SH encode, the two NGP MLPs
through the hand-written Hopper fused-MLP kernel (``csrc/fused_mlp.cu``),
the occupancy grid and its update, the fused march and the compositor.
"""

__version__ = "0.1.0"
