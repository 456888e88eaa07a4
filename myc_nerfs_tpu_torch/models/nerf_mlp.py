"""The NeRF MLP radiance field with BARF's coarse-to-fine PE and GARF's
gaussian variant (counterpart of myc_nerfs_tpu/models/nerf_mlp.py; barf
nerf.py:325-403, barf.py:344-357, nerf_garf.py).

- Feature layers with skip concatenations of the encoded points; the last
  feature layer is one unit wider, and its column 0 is the raw density
  (nerf.py:351-361). Then the rgb layers, on [feature, encoded view
  direction] when ``view_dep``.
- Parameters in the JAX layout: ``kernels[i]`` [in, out] and ``biases[i]``
  [out] for flax's ``Dense_i``, in call order (feature layers, then rgb
  layers), which is what ``param_list`` returns, each kernel before its bias.
- TF-style Xavier-uniform init (relu gain on hidden layers, gain 1 on the
  rgb output, column 0 of the density layer Xavier over its own slice),
  zero biases; ``tf_init=False`` is flax's default lecun-normal.
- ``use_bf16``: every product in bf16 (input, kernel and bias cast to bf16,
  as flax ``Dense(dtype=bf16)``, which rounds the product before adding
  the bias, where here the GEMM's epilogue adds it), the parameters f32;
  the gaussian activation, the density and the rgb heads in f32.
- ``forward(..., density_noise, noise)`` takes the standard-normal draw of
  the density noise as an argument (the JAX package draws it from a key).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoding import apply_c2f_mask, barf_c2f_weights, positional_encoding
from .ngp import _lecun_normal_

__all__ = ["NeRFMLP", "CoarseFine", "gaussian", "garf_mlp"]


def gaussian(x: torch.Tensor, c: float = 0.0, sigma: float = 0.1) -> torch.Tensor:
    """GARF activation exp(-(x-c)^2 / 2 sigma^2) (nerf_garf.py:19-22), as
    exp((x-c)^2 * (-1 / 2 sigma^2)): three elementwise passes, not five."""
    return torch.exp(torch.square(x - c if c else x) * (-1.0 / (2.0 * sigma ** 2)))


def _widen(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> f32; f32 and f64 unchanged."""
    return x.float() if x.dtype == torch.bfloat16 else x


_DENSITY_ACTIV = {"softplus": F.softplus, "relu": torch.relu, "abs": torch.abs,
                  "exp": torch.exp, "sigmoid": torch.sigmoid}


class NeRFMLP(nn.Module):
    """Radiance field MLP: points [..., 3] (+ ray_unit [..., 3]) ->
    (rgb [..., 3], density [...]). Fields and defaults as the JAX NeRFMLP
    (barf options nerf_blender.yaml arch.*)."""

    def __init__(self, widths_feat: Sequence[int] = (256,) * 8,
                 widths_rgb: Sequence[int] = (128, 3), skip: Sequence[int] = (4,),
                 posenc_L3D: Optional[int] = 10, posenc_Lview: Optional[int] = 4,
                 view_dep: bool = True, activation: str = "relu",
                 gaussian_sigma: float = 0.1, density_activ: str = "softplus",
                 tf_init: bool = True, use_bf16: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if density_activ not in _DENSITY_ACTIV:
            raise ValueError(f"density_activ {density_activ!r} is not one of "
                             f"{sorted(_DENSITY_ACTIV)}")
        if activation not in ("relu", "gaussian"):
            raise ValueError(f"activation {activation!r} is not relu or gaussian")
        self.widths_feat, self.widths_rgb = tuple(widths_feat), tuple(widths_rgb)
        self.skip = tuple(skip)
        self.posenc_L3D, self.posenc_Lview = posenc_L3D, posenc_Lview
        self.view_dep, self.activation = view_dep, activation
        self.gaussian_sigma, self.density_activ = gaussian_sigma, density_activ
        self.use_bf16 = use_bf16
        pts_dim = 3 + (6 * posenc_L3D if posenc_L3D else 0)
        view_dim = 3 + (6 * posenc_Lview if posenc_Lview else 0)
        shapes, inits = [], []
        fan_in = pts_dim
        for li, width in enumerate(self.widths_feat):
            if li in self.skip:
                fan_in += pts_dim
            last = li == len(self.widths_feat) - 1
            shapes.append((fan_in, width + 1 if last else width))
            inits.append("first" if last else "relu")
            fan_in = width
        if view_dep:
            fan_in += view_dim
        for li, width in enumerate(self.widths_rgb):
            shapes.append((fan_in, width))
            inits.append("all" if li == len(self.widths_rgb) - 1 else "relu")
            fan_in = width
        self.kernels = nn.ParameterList()
        self.biases = nn.ParameterList()
        for shape, init in zip(shapes, inits):
            k = torch.zeros(shape, dtype=torch.float32, device=device)
            if generator is not None:
                if tf_init:
                    _xavier_init_(k, init, generator)
                else:
                    _lecun_normal_(k, generator)
            self.kernels.append(nn.Parameter(k))
            self.biases.append(nn.Parameter(torch.zeros(shape[1], dtype=torch.float32,
                                                        device=device)))

    def param_list(self):
        """Parameters in the JAX params tree's order: Dense_0 kernel, bias,
        Dense_1 kernel, bias, ..."""
        return [p for k, b in zip(self.kernels, self.biases) for p in (k, b)]

    def leaf_names(self):
        """(layer, kind) of each param_list() entry, as the JAX tree names it."""
        return [(f"Dense_{i}", kind) for i in range(len(self.kernels))
                for kind in ("kernel", "bias")]

    def _dense(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """x @ kernel + bias, the bias added in the product's epilogue."""
        k, b = self.kernels[i], self.biases[i]
        if self.use_bf16:
            x, k, b = x.bfloat16(), k.bfloat16(), b.bfloat16()
        else:
            k, b = k.to(x.dtype), b.to(x.dtype)
        return F.linear(x, k.t(), b)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation == "gaussian":
            # exp(-x^2 / 2 s^2) with s = 0.1 amplifies input error 100x: in
            # f32 even when the products run in bf16
            return gaussian(_widen(x), sigma=self.gaussian_sigma)
        return torch.relu(x)

    @staticmethod
    def _encode(x: torch.Tensor, L: Optional[int], progress, c2f) -> torch.Tensor:
        if L is None:
            return x
        enc = positional_encoding(x, L)
        if c2f is not None and progress is not None:
            enc = apply_c2f_mask(enc, barf_c2f_weights(progress, L, c2f), n_dims=x.shape[-1])
        return torch.cat([x, enc], dim=-1)

    def encode_points(self, points, progress=None, c2f=None) -> torch.Tensor:
        """[xyz | PE(xyz)], BARF's c2f mask on the PE part."""
        return self._encode(points, self.posenc_L3D, progress, c2f)

    def encode_view(self, ray_unit, progress=None, c2f=None) -> torch.Tensor:
        return self._encode(ray_unit, self.posenc_Lview, progress, c2f)

    def forward(self, points: torch.Tensor, ray_unit: Optional[torch.Tensor] = None,
                progress: Optional[torch.Tensor] = None,
                c2f: Optional[Tuple[float, float]] = None,
                density_noise: float = 0.0, noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rgb [..., 3], density [...]); ``progress`` is an f32 scalar
        tensor, ``noise`` a standard-normal draw shaped like the density,
        added times ``density_noise`` before the density activation."""
        points_enc = self.encode_points(points, progress, c2f)
        feat = points_enc
        n_feat = len(self.widths_feat)
        for li in range(n_feat):
            if li in self.skip:
                feat = torch.cat([feat.to(points_enc.dtype), points_enc], dim=-1)
            feat = self._dense(li, feat)
            if li == n_feat - 1:
                density = _widen(feat[..., 0])
                if density_noise and noise is not None:
                    density = density + noise * density_noise
                density = _DENSITY_ACTIV[self.density_activ](density)
                feat = feat[..., 1:]
            feat = self._act(feat)
        if self.view_dep:
            if ray_unit is None:
                raise ValueError("a view_dep model needs ray_unit")
            view = self.encode_view(ray_unit, progress, c2f)
            feat = torch.cat([feat.to(view.dtype), view], dim=-1)
        n_rgb = len(self.widths_rgb)
        for li in range(n_rgb):
            feat = self._dense(n_feat + li, feat)
            if li < n_rgb - 1:
                feat = self._act(feat)
        return torch.sigmoid(_widen(feat)), density


def _xavier_init_(k: torch.Tensor, init: str, generator: torch.Generator) -> None:
    """TF-style Xavier uniform on a [in, out] kernel: gain sqrt(2) ("relu"),
    1 ("all"), or for the density layer ("first") column 0 with its own
    fan-out of 1 and gain 1, the rest with gain sqrt(2) (nerf.py:351-361)."""
    fan_in, fan_out = k.shape
    with torch.no_grad():
        if init == "first":
            b0 = math.sqrt(6.0 / (fan_in + 1))
            k[:, :1].uniform_(-b0, b0, generator=generator)
            br = math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + fan_out - 1))
            k[:, 1:].uniform_(-br, br, generator=generator)
        else:
            gain = 1.0 if init == "all" else math.sqrt(2.0)
            b = gain * math.sqrt(6.0 / (fan_in + fan_out))
            k.uniform_(-b, b, generator=generator)


def garf_mlp(**overrides) -> NeRFMLP:
    """The GARF preset: gaussian activations, no PE, relu density
    (Easyship.yaml arch)."""
    kw = dict(widths_feat=(256,) * 6, widths_rgb=(128, 3), skip=(3,),
              posenc_L3D=None, posenc_Lview=None, activation="gaussian",
              density_activ="relu")
    kw.update(overrides)
    return NeRFMLP(**kw)


class CoarseFine(nn.Module):
    """The two networks of hierarchical fine sampling (barf nerf.py:203-209):
    ``coarse`` and ``fine``, of one architecture; param_list() is the
    coarse network's, then the fine one's (the JAX tree {"coarse": ...,
    "fine": ...})."""

    def __init__(self, coarse: NeRFMLP, fine: NeRFMLP):
        super().__init__()
        self.coarse, self.fine = coarse, fine

    def param_list(self):
        return self.coarse.param_list() + self.fine.param_list()
