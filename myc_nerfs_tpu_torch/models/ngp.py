"""Instant-NGP: multiresolution grid encode + bias-free MLPs (counterpart of
myc_nerfs_tpu/models/ngp.py).

- ``hash_encode``: the reference's per-vertex layout ('hash'), 8 hashed or
  dense corners per level, trilinear weights (jnerf HashEncode.h:37-200).
- ``NGPNetwork``: bias-free density MLP (32->64->16) and rgb MLP
  (16+16->64->64->3), raw outputs (jnerf ngp_network.py:41-96). With
  ``use_fully`` (the default, as configs/ngp/ngp_base.py asks) both MLPs go
  through ops/cuda/fused_mlp, the reference's FullyFusedMLP; the rgb head's
  width-3 last layer is zero-padded to 16 columns for the kernel and
  sliced back to 3.
- ``NGPModel``: grid table(s) + SH direction encode + the network, for
  ``grid_impl`` 'brick3' (default) and 'hash'. The brick3 encode runs
  through the hand-written kernels of ops/cuda/grid_encode
  (``use_encode_kernel``), as the reference runs its CUDA grid encode;
  the 'hash' encode is torch ops.

bf16 (``use_bf16``) follows the JAX package: MLP weights are bf16, the
grid tables stay f32 while the brick encode interpolates in bf16, and both
encodings are cast to bf16 before the MLPs.

Every table and weight is a trainable parameter; renders and grid updates
run under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.cuda.fused_mlp import fused_mlp, fused_mlp_reference
from ..ops.sh import sh_encode

HASH_PRIMES = (1, 19349663, 83492791)  # configs/Easyship.py:89
_U32 = 0xFFFFFFFF  # uint32 wraparound, emulated in int64


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    aabb_scale: int = 1
    desired_resolution: float = 2048.0

    @property
    def per_level_scale(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return float(np.exp(np.log(self.desired_resolution * self.aabb_scale
                                   / self.base_resolution)
                            / (self.n_levels - 1)))

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


@dataclasses.dataclass(frozen=True)
class HashGridLevels:
    """Host-side static per-level geometry (jnerf grid_encode.py:18-46)."""

    scales: Tuple[float, ...]
    resolutions: Tuple[int, ...]
    offsets: Tuple[int, ...]        # n_levels+1 entries, in feature vectors
    hashmap_sizes: Tuple[int, ...]
    dense: Tuple[bool, ...]
    n_params: int


def compute_levels(cfg: HashGridConfig) -> HashGridLevels:
    scales, resos, sizes, dense = [], [], [], []
    offsets = [0]
    offset = 0
    cap = 1 << cfg.log2_hashmap_size
    for lv in range(cfg.n_levels):
        scale = 2.0 ** (lv * np.log2(cfg.per_level_scale)) * cfg.base_resolution - 1.0
        res = int(np.ceil(scale)) + 1
        params = min(((res**3 + 7) // 8) * 8, cap)
        scales.append(float(scale))
        resos.append(res)
        sizes.append(params)
        dense.append(res**3 <= params)
        offset += params
        offsets.append(offset)
    return HashGridLevels(scales=tuple(scales), resolutions=tuple(resos),
                          offsets=tuple(offsets), hashmap_sizes=tuple(sizes),
                          dense=tuple(dense), n_params=offset)


def init_hash_table(generator: torch.Generator, cfg: HashGridConfig,
                    levels: Optional[HashGridLevels] = None,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform(+-1e-4) like jnerf hash_encoder.py:22-23. Shape [n_params, F]."""
    levels = levels or compute_levels(cfg)
    t = torch.empty((levels.n_params, cfg.n_features), dtype=dtype, device=device)
    return t.uniform_(-1e-4, 1e-4, generator=generator)


def _level_index(levels: HashGridLevels, lv: int, corner: torch.Tensor) -> torch.Tensor:
    """Feature-vector index within the whole table for int corners [..., 3]:
    dense row-major when the level fits, else the prime-XOR hash; modulo the
    level size. uint32 arithmetic is emulated in int64 with a 32-bit mask."""
    size = levels.hashmap_sizes[lv]
    res = levels.resolutions[lv]
    c = corner.to(torch.int64) & _U32
    if levels.dense[lv]:
        idx = (c[..., 0] + ((c[..., 1] * res) & _U32)
               + ((c[..., 2] * (res * res)) & _U32)) & _U32
    else:
        idx = (((c[..., 0] * HASH_PRIMES[0]) & _U32)
               ^ ((c[..., 1] * HASH_PRIMES[1]) & _U32)
               ^ ((c[..., 2] * HASH_PRIMES[2]) & _U32))
    return idx % size + levels.offsets[lv]


def hash_encode(table: torch.Tensor, positions: torch.Tensor,
                cfg: HashGridConfig, levels: Optional[HashGridLevels] = None
                ) -> torch.Tensor:
    """Encode positions [..., 3] in [0, 1] -> [..., n_levels * F]."""
    levels = levels or compute_levels(cfg)
    shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3)
    # the 8 corner offsets of a unit cube: bit0 -> x, bit1 -> y, bit2 -> z
    c = torch.arange(8, device=pos.device)
    corners = torch.stack([c & 1, (c >> 1) & 1, (c >> 2) & 1], -1)  # [8, 3]
    outs: List[torch.Tensor] = []
    for lv in range(cfg.n_levels):
        p = pos * levels.scales[lv] + 0.5
        p0 = torch.floor(p)
        frac = p - p0
        base = p0.to(torch.int32).to(torch.int64)
        idx = _level_index(levels, lv, base[:, None, :] + corners[None])  # [N, 8]
        vals = table[idx]                                                 # [N, 8, F]
        w = torch.where(corners[None] == 0, 1.0 - frac[:, None, :],
                        frac[:, None, :]).prod(-1)                         # [N, 8]
        outs.append((vals * w[..., None]).sum(1))
    return torch.cat(outs, dim=-1).reshape(shape + (cfg.out_dim,))


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default Dense init: truncated normal (+-2 std), variance
    1/fan_in; the stddev is corrected for the truncation."""
    std = math.sqrt(1.0 / w.shape[0]) / 0.87962566103423978
    with torch.no_grad():
        tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        torch.nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std,
                                    generator=generator)
        w.copy_(tmp)
    return w


class NGPNetwork(nn.Module):
    """Bias-free density + rgb MLPs; forward(pos_enc [N, in], dir_enc
    [N, 16]) -> raw [N, 4] (rgb, density). Weights are [in, out]."""

    RGB_PAD = 16  # the kernel's column granularity
    LAYERS = ("density0", "density1", "rgb0", "rgb1", "rgb2")

    def __init__(self, in_dim: int = 32, dir_dim: int = 16,
                 density_n_neurons: int = 64, rgb_n_neurons: int = 64,
                 geo_feat_dim: int = 16, use_fully: bool = True,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_fully = use_fully
        shapes = {"density0": (in_dim, density_n_neurons),
                  "density1": (density_n_neurons, geo_feat_dim),
                  "rgb0": (geo_feat_dim + dir_dim, rgb_n_neurons),
                  "rgb1": (rgb_n_neurons, rgb_n_neurons),
                  "rgb2": (rgb_n_neurons, 3)}
        for name, shape in shapes.items():
            w = torch.zeros(shape, dtype=dtype, device=device)
            if generator is not None:
                _lecun_normal_(w, generator)
            setattr(self, name, nn.Parameter(w))

    def _mlp(self, x: torch.Tensor, weights) -> torch.Tensor:
        return (fused_mlp if self.use_fully else fused_mlp_reference)(x, weights)

    def forward(self, pos_enc: torch.Tensor, dir_enc: torch.Tensor) -> torch.Tensor:
        h = self.density_forward(pos_enc)
        x = torch.cat([h, dir_enc], dim=-1)
        pad = (-self.rgb2.shape[1]) % self.RGB_PAD
        rgb2 = torch.nn.functional.pad(self.rgb2, (0, pad))
        rgb = self._mlp(x, (self.rgb0, self.rgb1, rgb2))[:, :self.rgb2.shape[1]]
        return torch.cat([rgb, h[:, :1]], dim=-1)

    def density_forward(self, pos_enc: torch.Tensor) -> torch.Tensor:
        return self._mlp(pos_enc, (self.density0, self.density1))

    def density(self, pos_enc: torch.Tensor) -> torch.Tensor:
        """Raw density channel only [N, 1]."""
        return self.density_forward(pos_enc)[:, :1]


@dataclasses.dataclass(frozen=True)
class NGPModelConfig:
    """Same fields and defaults as the JAX NGPModelConfig, plus
    ``use_fully`` (configs' NGPNetworks(use_fully=...)): run the MLPs
    through the fused kernel."""

    grid: HashGridConfig = HashGridConfig()
    sh_degree: int = 4
    density_n_neurons: int = 64
    rgb_n_neurons: int = 64
    use_bf16: bool = False
    grid_impl: str = "brick3"
    use_fully: bool = True


class NGPModel(nn.Module):
    """Grid table(s) + SH encode + NGPNetwork.

    ``tables`` holds one [rows, len(group)*F*128] tensor per level group
    ('brick3') or the single [n_params, F] table ('hash'). The generator
    fills tables and weights; without one they start at zero (for loading
    a checkpoint).
    """

    def __init__(self, cfg: NGPModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        self.compute_dtype = torch.bfloat16 if cfg.use_bf16 else None
        if cfg.grid_impl == "brick3":
            from ..ops import brick_grid as bg

            self.levels = bg.compute_brick_levels(cfg.grid)
            self.groups = bg.compute_level_groups(self.levels, group_size=3)
            shapes = [(self.levels.n_bricks[m[-1]],
                       len(m) * cfg.grid.n_features * bg.ROW_VERTS)
                      for m in self.groups.groups]
        elif cfg.grid_impl == "hash":
            self.levels = compute_levels(cfg.grid)
            shapes = [(self.levels.n_params, cfg.grid.n_features)]
        else:
            raise ValueError(f"grid_impl {cfg.grid_impl!r} is not ported; "
                             "use 'brick3' or 'hash'")
        if generator is not None:
            if cfg.grid_impl == "brick3":
                tables = bg.init_paired_table(generator, cfg.grid, self.levels,
                                              self.groups, device=device)
            else:
                tables = [init_hash_table(generator, cfg.grid, self.levels,
                                          device=device)]
        else:
            tables = [torch.zeros(s, device=device) for s in shapes]
        self.tables = nn.ParameterList([nn.Parameter(t) for t in tables])
        # brick3: encode through ops/cuda/grid_encode (its kernels on the
        # card), or, when False, through paired_encode_reference's torch ops
        # and autograd (the plain path tests compare with)
        self.use_encode_kernel = True
        self.net = NGPNetwork(in_dim=cfg.grid.out_dim,
                              density_n_neurons=cfg.density_n_neurons,
                              rgb_n_neurons=cfg.rgb_n_neurons,
                              use_fully=cfg.use_fully, dtype=dtype,
                              device=device, generator=generator)

    def param_list(self) -> List[nn.Parameter]:
        """Every trainable tensor in one fixed order: the tables, then the
        MLP weights in NGPNetwork.LAYERS order (the optimizer's and the
        checkpoint's leaf order)."""
        return list(self.tables) + [getattr(self.net, n) for n in NGPNetwork.LAYERS]

    def encode(self, positions: torch.Tensor) -> torch.Tensor:
        if self.cfg.grid_impl == "brick3":
            from ..ops import brick_grid as bg

            encode = (bg.paired_encode if self.use_encode_kernel
                      else bg.paired_encode_reference)
            return encode(list(self.tables), positions, self.cfg.grid, self.levels,
                          self.groups, compute_dtype=self.compute_dtype)
        return hash_encode(self.tables[0], positions, self.cfg.grid, self.levels)

    def encode_dirs(self, dirs: torch.Tensor) -> torch.Tensor:
        """SH encoding of dirs [N, 3] warped to [0, 1], padded to 16."""
        return sh_encode(dirs * 2.0 - 1.0, degree=self.cfg.sh_degree, pad_to=16)

    def net_inputs(self, positions: torch.Tensor, dirs: torch.Tensor):
        """(pos_enc, dir_enc): the MLPs' inputs, in their dtype."""
        pos_enc, dir_enc = self.encode(positions), self.encode_dirs(dirs)
        if self.cfg.use_bf16:
            pos_enc = pos_enc.to(torch.bfloat16)
            dir_enc = dir_enc.to(torch.bfloat16)
        return pos_enc, dir_enc

    def forward(self, positions: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        """positions [N, 3] in [0, 1], dirs [N, 3] warped to [0, 1].
        Returns raw [N, 4] in f32."""
        return self.net(*self.net_inputs(positions, dirs)).float()

    def density_raw(self, positions: torch.Tensor) -> torch.Tensor:
        pos_enc = self.encode(positions)
        if self.cfg.use_bf16:
            pos_enc = pos_enc.to(torch.bfloat16)
        return self.net.density(pos_enc).float()


class _DensityActivation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, raw):
        ctx.save_for_backward(raw)
        return torch.exp(torch.clamp_max(raw, 30.0))

    @staticmethod
    def backward(ctx, g):
        (raw,) = ctx.saved_tensors
        return torch.exp(torch.clamp(raw, -15.0, 15.0)) * g


def density_activation(raw: torch.Tensor) -> torch.Tensor:
    """exp(min(raw, 30)) (jnerf ray_sampler_header.h:926-943; the min
    guards the overflow the JAX package documents), with the reference's
    clamped derivative exp(clip(raw, +-15)) * g
    (ray_sampler_header.h:1050-1056), as the JAX custom JVP."""
    return _DensityActivation.apply(raw)


def rgb_activation(raw: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(raw)
