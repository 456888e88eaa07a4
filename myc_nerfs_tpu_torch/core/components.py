"""Registered component factories (counterpart of myc_nerfs_tpu/core/components.py).

The ``type=`` names that cli/run_net.py's build_trainer reads from the NGP
configs. Each returns the port's config object, a plain dict of
hyperparameters, a callable loss, or (NerfDataset) the loaded dataset.
"""
from __future__ import annotations

from typing import Optional

from ..models.ngp import HashGridConfig, NGPModelConfig
from .registry import DATASETS, ENCODERS, LOSSES, NETWORKS, OPTIMS, SAMPLERS, SCHEDULERS


@ENCODERS.register_module("HashEncoder")
def build_hash_encoder(aabb_scale: int = 1, n_levels: int = 16,
                       n_features: int = 2, base_resolution: int = 16,
                       log2_hashmap_size: int = 19,
                       desired_resolution: float = 2048.0,
                       **_ignored) -> HashGridConfig:
    """HashEncoder (jnerf hash_encoder.py:10-29): per-level geometry."""
    return HashGridConfig(n_levels=n_levels, n_features=n_features,
                          base_resolution=base_resolution,
                          log2_hashmap_size=log2_hashmap_size,
                          aabb_scale=aabb_scale,
                          desired_resolution=desired_resolution)


@ENCODERS.register_module("SHEncoder")
def build_sh_encoder(degree: int = 4, **_ignored) -> dict:
    return {"degree": degree}


@ENCODERS.register_module("FrequencyEncoder")
def build_freq_encoder(multires: int = 10, **_ignored) -> dict:
    return {"multires": multires}


@NETWORKS.register_module("NGPNetworks")
def build_ngp_networks(grid: Optional[HashGridConfig] = None,
                       use_fully: bool = True, use_bf16: bool = False,
                       grid_impl: str = "brick3",
                       density_n_neurons: int = 64, rgb_n_neurons: int = 64,
                       **_ignored) -> NGPModelConfig:
    """NGPNetworks (jnerf ngp_network.py:41-96). ``use_fully`` runs both
    MLPs through the fused kernel, as the reference's FullyFusedMLP."""
    return NGPModelConfig(grid=grid or HashGridConfig(), use_bf16=use_bf16,
                          grid_impl=grid_impl,
                          density_n_neurons=density_n_neurons,
                          rgb_n_neurons=rgb_n_neurons, use_fully=use_fully)


@NETWORKS.register_module("OriginNeRFNetworks")
def build_origin_nerf_networks(grid=None, dir_encoder=None,
                               use_bf16: bool = False, D: int = 8,
                               W: int = 256, skips=(4,), **_ignored):
    """OriginNeRFNetworks (jnerf ori_nerf_network.py:10-77): the 8x256 NeRF
    MLP behind the DensityGridSampler pipeline. ``grid``/``dir_encoder`` are
    the built FrequencyEncoder configs ({'multires': L}). As in the JAX
    package, the factory leaves ``use_fused`` off."""
    from ..models.ori_nerf import OriginNeRFConfig

    multires_pos = grid.get("multires", 10) if isinstance(grid, dict) else 10
    multires_dir = (dir_encoder or {}).get("multires", 4)
    return OriginNeRFConfig(D=D, W=W, skips=tuple(skips),
                            multires_pos=multires_pos,
                            multires_dir=multires_dir, use_bf16=use_bf16)


@SAMPLERS.register_module("DensityGridSampler")
def build_density_grid_sampler(update_den_freq: int = 16, **kw) -> dict:
    return {"update_den_freq": update_den_freq, **kw}


@LOSSES.register_module("HuberLoss")
def build_huber_loss(delta: float = 0.1, **_ignored):
    from ..train.ngp_trainer import huber_loss

    return lambda x, y: huber_loss(x, y, delta=delta)


@LOSSES.register_module("MSELoss")
def build_mse_loss(**_ignored):
    return lambda x, y: (x - y) ** 2


@OPTIMS.register_module("Adam")
def build_adam(lr: float = 1e-1, eps: float = 1e-15, betas=(0.9, 0.99),
               **_ignored) -> dict:
    return {"lr": lr, "eps": eps, "betas": tuple(betas)}


@OPTIMS.register_module("EMA")
def build_ema(decay: float = 0.95, **_ignored) -> dict:
    return {"decay": decay}


@SCHEDULERS.register_module("ExpDecay")
def build_expdecay(decay_start: int = 20000, decay_interval: int = 10000,
                   decay_base: float = 0.33, decay_end=None, **_ignored) -> dict:
    return {"decay_start": decay_start, "decay_interval": decay_interval,
            "decay_base": decay_base}


@DATASETS.register_module("NerfDataset")
def build_nerf_dataset(root_dir: str = "data", mode: str = "train",
                       aabb_scale: int = 1, scale=None, offset=None,
                       correct_pose=(-1, -1, 1), **_ignored):
    """NerfDataset (jnerf dataset.py): train mode merges the train and val
    JSONs; other modes read one split, images optional."""
    from ..data import blender

    if mode == "train":
        return blender.load_ngp_train_data(root_dir, aabb_scale=aabb_scale, scale=scale,
                                           offset=offset, correct_pose=tuple(correct_pose))
    scene = blender.load_blender_split(root_dir, mode, require_images=False)
    return blender.NGPDataset.from_scene(scene, aabb_scale=aabb_scale, scale=scale,
                                         offset=offset, correct_pose=tuple(correct_pose))
