"""The cells at a size a CPU run holds (overrides for harness.run_cell).

At this size the checks read higher than at the cells' sizes, so two
limits are wider here: the NGP gradient's (4 grid levels and 64 rays per
step let bf16 rounding weigh more: 0.0198 on the CPU) at 0.05, and the
TensoRF loss's (a 9x73x58 grid, 256 rays: 2.9e-05) at 1e-04. The faults
the tests plant read 0.1 and more."""

NGP_TINY = {"config": {"run_net": {"hash_grid_overrides": {"log2_hashmap_size": 10,
                                                           "n_levels": 4},
                                   "n_grid_uniform": 4096, "n_grid_nonuniform": 4096,
                                   "n_coarse": 64, "n_samples": 16, "n_rays_per_batch": 64,
                                   "target_batch_size": 1024},
                       "scene": {"views": 4, "H": 16, "W": 16, "gt_samples": 32}},
            "mix": {"warm_steps": 32, "trace_steps": 16, "H": 16, "W": 16, "views": 2,
                    "chunk": 64, "trace_frames": 1, "occupancy_points": 1},
            "limits": {"grad_gap": 0.05}}
TENSORF_TINY = {"config": {"tensorf": {"batch_size": 256}, "stage": {"n_voxels": 40000},
                           "scene": {"views": 2, "H": 16, "W": 16, "gt_samples": 32}},
                "mix": {"warm_steps": 3, "trace_steps": 2},
                "limits": {"loss_gap": 1e-04}}
TINY = {"ngp_car.train": NGP_TINY, "ngp_car.render": NGP_TINY,
        "tensorf_coffee.train": TENSORF_TINY}
