"""The multi-GPU layer: a (data, model) mesh of torch.distributed ranks
(mesh.py) and the data-parallel and group-tensor-parallel train and render
programs built on it (spmd.py). Counterpart of myc_nerfs_tpu/parallel."""
