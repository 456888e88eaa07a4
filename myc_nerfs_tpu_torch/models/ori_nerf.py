"""OriginNeRF: the classic 8x256 NeRF MLP behind the NGP sampling pipeline
(counterpart of myc_nerfs_tpu/models/ori_nerf.py; jnerf
ori_nerf_network.py:10-77 and freq_encoder.py:10-50).

- ``freq_encode``: [x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(...)];
- ``OriginNeRFNetwork``: D dense layers of width W with biases (``pts_i``;
  after layer i in ``skips`` the positional encoding is concatenated in
  front, [pos_enc, h]), the ``alpha`` and ``feature`` heads, ``views_0`` on
  [feature, dir_enc] and ``rgb``. Kernels use the JAX layout [in, out];
- ``OriginNeRFModel``: the same interface as NGPModel for the trainer and
  the renderer: ``forward(positions, dirs)`` (also ``apply``) -> raw [N, 4]
  (rgb, density) in f32, with dirs warped to [0, 1] and mapped back by
  d * 2 - 1; ``density_raw(positions)``; ``param_list()`` in the JAX params
  tree's leaf order (layers sorted by name, each bias then kernel). Kernels
  start lecun-normal and biases zero, as flax ``Dense``.

``use_bf16`` makes the parameters and the compute bf16, as flax ``Dense(...,
param_dtype=bf16, dtype=bf16)``: each layer's input is cast to bf16, its
product rounded to bf16, then its bias added in bf16. ``remat`` recomputes
the network in the backward (``torch.utils.checkpoint``, the JAX
``jax.checkpoint``). ``use_fused`` (with ``skips=()``) runs the backbone
through ops/cuda/fused_mlp, the hand-written kernels on the card, with each
bias folded in by an augmented ones column (x @ W + b == [x, 1] @ [[W, 0],
[b, 1]]): a 64 -> 257 x 8 chain that the kernel wrapper pads to 272. The
heads then run as the JAX ``_apply_fused`` runs them, ``v @ kernel + bias``
with an f32 ``v``, so in f32 even with bf16 parameters (the plain path runs
them in bf16). ``density_raw`` always takes the plain backbone, as in JAX.
The model's ``mlp`` attribute is the chain's function: ``fused_mlp`` (the
kernels on the card), or ``fused_mlp_plain`` for their plain versions.

Not ported (TPU workarounds and probes): ``MLP_TILE``/``_tiled``, a reshape
of the samples into a 3-D batch that changes how XLA:TPU lays out the dots,
not what they compute; ``fp16_overflow_parity``, a probe whose hypothesis
was falsified.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.fused_mlp import fused_mlp
from .ngp import _lecun_normal_


def freq_encode(x: torch.Tensor, multires: int, include_input: bool = True) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)]."""
    out = [x] if include_input else []
    for i in range(multires):
        f = 2.0 ** i
        out.append(torch.sin(x * f))
        out.append(torch.cos(x * f))
    return torch.cat(out, dim=-1)


def encoded_dim(multires: int) -> int:
    return 3 + 6 * multires


class OriginNeRFNetwork(nn.Module):
    """D x W MLP with skips and alpha/feature/views/rgb heads; forward(
    positions [N, 3], dirs [N, 3] in [-1, 1]) -> [N, 4] in the param dtype."""

    def __init__(self, D: int = 8, W: int = 256, skips: Tuple[int, ...] = (4,),
                 multires_pos: int = 10, multires_dir: int = 4,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.D, self.W, self.skips = D, W, tuple(skips)
        self.multires_pos, self.multires_dir = multires_pos, multires_dir
        self.dtype = dtype
        pos_dim, dir_dim = encoded_dim(multires_pos), encoded_dim(multires_dir)
        shapes = {}
        for i in range(D):
            fan_in = pos_dim if i == 0 else W + (pos_dim if i - 1 in self.skips else 0)
            shapes[f"pts_{i}"] = (fan_in, W)
        head_in = W + (pos_dim if D - 1 in self.skips else 0)
        shapes.update({"views_0": (W + dir_dim, W // 2), "feature": (head_in, W),
                       "alpha": (head_in, 1), "rgb": (W // 2, 3)})
        self.shapes = shapes
        self.kernels = nn.ParameterDict()
        self.biases = nn.ParameterDict()
        for name, shape in shapes.items():
            k = torch.zeros(shape, dtype=dtype, device=device)
            if generator is not None:
                _lecun_normal_(k, generator)
            self.kernels[name] = nn.Parameter(k)
            self.biases[name] = nn.Parameter(torch.zeros(shape[1], dtype=dtype, device=device))

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """flax Dense: the input cast to the param dtype, x @ kernel rounded
        to it, then + bias."""
        return x.to(self.dtype) @ self.kernels[name] + self.biases[name]

    def backbone(self, pos_enc: torch.Tensor) -> torch.Tensor:
        h = pos_enc
        for i in range(self.D):
            h = torch.relu(self.dense(f"pts_{i}", h))
            if i in self.skips:
                h = torch.cat([pos_enc.to(h.dtype), h], dim=-1)
        return h

    def forward(self, positions: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        pos_enc = freq_encode(positions, self.multires_pos)
        dir_enc = freq_encode(dirs, self.multires_dir)
        h = self.backbone(pos_enc)
        alpha = self.dense("alpha", h)
        feature = self.dense("feature", h)
        h = torch.relu(self.dense("views_0", torch.cat([feature, dir_enc.to(feature.dtype)], -1)))
        return torch.cat([self.dense("rgb", h), alpha], dim=-1)

    def density(self, positions: torch.Tensor) -> torch.Tensor:
        """Raw density [N, 1] (ori_nerf_network.py:59-69)."""
        return self.dense("alpha", self.backbone(freq_encode(positions, self.multires_pos)))


@dataclasses.dataclass(frozen=True)
class OriginNeRFConfig:
    """The JAX OriginNeRFConfig's fields and defaults, without the
    fp16_overflow_parity probe."""

    D: int = 8
    W: int = 256
    skips: Tuple[int, ...] = (4,)
    multires_pos: int = 10
    multires_dir: int = 4
    use_bf16: bool = False
    use_fused: bool = False  # the backbone through the fused-MLP kernels (skips=() only)
    remat: bool = False      # recompute the network in the backward


class OriginNeRFModel(nn.Module):
    """OriginNeRFNetwork with NGPModel's interface, so NGPTrainer (``model=``)
    and the renderer take it in place of an NGPModel. The generator draws
    the kernels; without one every parameter starts at zero (for loading a
    checkpoint)."""

    def __init__(self, cfg: OriginNeRFConfig = OriginNeRFConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.net = OriginNeRFNetwork(D=cfg.D, W=cfg.W, skips=cfg.skips,
                                     multires_pos=cfg.multires_pos,
                                     multires_dir=cfg.multires_dir,
                                     dtype=torch.bfloat16 if cfg.use_bf16 else torch.float32,
                                     device=device, generator=generator)
        self.mlp = fused_mlp  # the fused backbone's chain (fused_mlp_plain: plain versions)

    def leaf_names(self) -> List[Tuple[str, str]]:
        """(layer, 'bias' | 'kernel') in the JAX params tree's leaf order."""
        return [(layer, kind) for layer in sorted(self.net.shapes)
                for kind in ("bias", "kernel")]

    def param_list(self) -> List[nn.Parameter]:
        """Every trainable tensor in leaf_names() order (the optimizer's and
        the checkpoint's)."""
        store = {"bias": self.net.biases, "kernel": self.net.kernels}
        return [store[kind][layer] for layer, kind in self.leaf_names()]

    @property
    def fused(self) -> bool:
        return self.cfg.use_fused and not self.cfg.skips

    def _plain(self, positions: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        return self.net(positions, dirs * 2.0 - 1.0).float()

    def _apply_fused(self, positions: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        """The backbone through ``self.mlp`` with the biases folded in;
        the heads in f32 (the JAX ``_apply_fused``)."""
        net, dtype = self.net, self.net.dtype
        pos_enc = freq_encode(positions, net.multires_pos)
        dir_enc = freq_encode(dirs * 2.0 - 1.0, net.multires_dir)
        ws = []
        for i in range(net.D):
            k, b = net.kernels[f"pts_{i}"], net.biases[f"pts_{i}"]
            w_aug = torch.cat([k, b[None, :]], dim=0)                    # [in+1, out]
            unit = torch.zeros((w_aug.shape[0], 1), dtype=dtype, device=k.device)
            unit[-1, 0] = 1.0
            ws.append(torch.cat([w_aug, unit], dim=1))                    # [in+1, out+1]
        x = torch.cat([pos_enc, torch.ones_like(pos_enc[..., :1])], dim=-1).to(dtype)
        lead = x.shape[:-1]
        y = self.mlp(x.reshape(-1, x.shape[-1]), ws)
        # the backbone applies ReLU after every layer; the fused MLP has none
        # after its last, so apply it again (the ones column is dropped)
        h = torch.relu(y[:, :-1].float()).reshape(*lead, -1)

        def lin(name, v):
            return v @ net.kernels[name].float() + net.biases[name].float()

        alpha = lin("alpha", h)
        feature = lin("feature", h)
        hh = torch.relu(lin("views_0", torch.cat([feature, dir_enc], dim=-1)))
        return torch.cat([lin("rgb", hh), alpha], dim=-1)

    def forward(self, positions: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        """positions [N, 3] in [0, 1], dirs [N, 3] warped to [0, 1].
        Returns raw [N, 4] in f32."""
        run = self._apply_fused if self.fused else self._plain
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(run, positions, dirs, use_reentrant=False)
        return run(positions, dirs)

    apply = forward

    def density_raw(self, positions: torch.Tensor) -> torch.Tensor:
        """Raw density [N, 1] in f32, through the plain backbone."""
        return self.net.density(positions).float()
