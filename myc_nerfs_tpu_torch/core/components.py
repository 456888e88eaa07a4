"""Registered component factories (counterpart of myc_nerfs_tpu/core/components.py).

The ``type=`` names that cli/run_net.py's build_trainer reads from the NGP
configs. Each returns the port's config object, a plain dict of
hyperparameters, or a callable loss.
"""
from __future__ import annotations

from typing import Optional

from ..models.ngp import HashGridConfig, NGPModelConfig
from .registry import ENCODERS, LOSSES, NETWORKS, OPTIMS, SAMPLERS, SCHEDULERS


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


@SAMPLERS.register_module("DensityGridSampler")
def build_density_grid_sampler(update_den_freq: int = 16, **kw) -> dict:
    return {"update_den_freq": update_den_freq, **kw}


@LOSSES.register_module("HuberLoss")
def build_huber_loss(delta: float = 0.1, **_ignored):
    from ..train.ngp_trainer import huber_loss

    return lambda x, y: huber_loss(x, y, delta=delta)


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
