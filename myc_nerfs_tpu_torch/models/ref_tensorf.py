"""Ref-NeRF-style reflective shading on TensorVMSplit, REFTensoRF
(counterpart of myc_nerfs_tpu/models/ref_tensorf.py; tensorf-myc
models/REFTensoRF.py).

- the appearance factors also feed linear heads for the normal, the diffuse
  rgb, the specular tint and the roughness rho (:85-96, :107-133);
- the view direction is reflected about the predicted normal; the
  reflection (with IDE-attenuated SH bases in the SH variant, :31-60) and
  the dot product feed the specular MLP; rgb = tint * clamp(rgb_s) + rgb_d
  (:213-233);
- the normal-orientation penalty sum(w * relu(-n.d)^2) over the shaded
  samples is returned in extras for the trainer to weight (:236-238).

The heads and the MLP run only at the samples whose weight passes
``ray_march_weight_thres`` (boolean indexing, as models/tensorf.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.sh import eval_sh_bases
from ..render.composite import raw2alpha
from . import tensorf as tf


class RefMLPRender(tf.DenseStack):
    """MLPRender_Fea_Ref / MLPRender_SH_Ref (REFTensoRF.py:5-60)."""

    def __init__(self, cfg: tf.TensoRFConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        mode = "SH" if cfg.shading_mode == "SH" else "Fea"
        n_in = 1 + cfg.app_dim + 3 + 2 * cfg.fea_pe * cfg.app_dim
        if mode == "SH":
            n_in += sum((l_base) ** 2 for l_base in range(1, cfg.view_pe + 1))
        else:
            n_in += 2 * cfg.view_pe * 3
        C = cfg.featureC
        super().__init__([(n_in, C), (C, C), (C, 3)], device, generator)
        self.mode, self.view_pe, self.fea_pe = mode, cfg.view_pe, cfg.fea_pe

    def forward(self, pts, viewdirs, features, dot_product, k):
        indata = [dot_product, features, viewdirs]
        if self.fea_pe > 0:
            indata.append(tf.tensorf_pe(features, self.fea_pe))
        if self.mode == "SH":
            for l_base in range(1, self.view_pe + 1):
                l = l_base ** 2  # noqa: E741
                a = torch.exp(-(l * (l + 1)) / (2.0 * k))
                indata.append(a * eval_sh_bases(l_base - 1, viewdirs))
        elif self.view_pe > 0:
            indata.append(tf.tensorf_pe(viewdirs, self.view_pe))
        x = torch.cat(indata, dim=-1)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return torch.sigmoid(self.Dense_2(x))


class Linear(nn.Module):
    """A head {"w": [in, out], "b": [out]}, both ~ U(-1/sqrt(in), 1/sqrt(in))
    (REFTensoRF.py:85-96)."""

    flat = True  # its parameters sit directly under its key in the JAX tree

    def __init__(self, n_in: int, n_out: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / np.sqrt(n_in)
        kw = dict(device=device, generator=generator)
        self.w = nn.Parameter((torch.rand((n_in, n_out), **kw) * 2 - 1) * bound)
        self.b = nn.Parameter((torch.rand((n_out,), **kw) * 2 - 1) * bound)

    def forward(self, x):
        return x @ self.w + self.b


def init_ref_heads(cfg: tf.TensoRFConfig, params, device=None,
                   generator: Optional[torch.Generator] = None):
    """params with the normal / diffuse / specular / rho heads added and the
    shading MLP replaced by the Ref variant."""
    n_in = sum(cfg.app_n_comp)
    params = dict(params)
    for name, n_out in (("normal_linear", 3), ("diffuse_linear", 3),
                        ("specular_linear", 1), ("rho_linear", 1)):
        params[name] = Linear(n_in, n_out, device, generator)
    params["mlp"] = RefMLPRender(cfg, device, generator)
    return params


def compute_ref_appfeature(cfg: tf.TensoRFConfig, params, xyz: torch.Tensor):
    """(app features, rgb_d, tint, normal, rho) at xyz [M, 3] from the shared
    factor features (REFTensoRF.py:107-133)."""
    h = tf.app_factor_cm(cfg, params, xyz).t()
    app = h @ params["basis_mat"]
    normal = params["normal_linear"](h)
    rgb_d = params["diffuse_linear"](h)
    tint = torch.relu(params["specular_linear"](h))
    rho = torch.relu(params["rho_linear"](h))
    return app, rgb_d, tint, normal, rho


def ref_tensorf_forward(cfg: tf.TensoRFConfig, geom: tf.StageGeom, params, buffers,
                        rays: torch.Tensor, jitter: Optional[torch.Tensor] = None,
                        white_bg: bool = True, n_samples: Optional[int] = None
                        ) -> tf.TensoRFOut:
    """REFTensoRF.execute (:174-256): reflective shading; extras["penalty"]
    is the normal-orientation penalty, extras["normal"] the normals of the
    shaded samples [M, 3] (in app_mask's flat order)."""
    n_s = n_samples or geom.n_samples
    rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
    aabb = buffers["aabb"]
    pts, z_vals, valid = tf.sample_ray(aabb, rays_o, viewdirs, geom.step_size, n_s,
                                       cfg.near_far, jitter)
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], torch.zeros_like(z_vals[:, :1])], -1)
    occ = tf.alpha_mask_valid(buffers, pts)
    if occ is not None:
        valid = torch.logical_and(valid, occ)
    xyz = tf.normalize_coord(aabb, pts)
    sigma = tf.masked_density(cfg, params, valid, xyz)
    alpha, weight, bg_weight = raw2alpha(sigma, dists * cfg.distance_scale)
    app_mask = weight > cfg.ray_march_weight_thres

    idx = tf.selected(app_mask)
    xyz_s = xyz.reshape(-1, 3)[idx]
    w_s = weight.reshape(-1)[idx]
    app, rgb_d, tint, normal, rho = compute_ref_appfeature(cfg, params, xyz_s)
    normal = normal / (torch.linalg.norm(normal, dim=-1, keepdim=True) + 1e-8)
    d = -viewdirs[torch.div(idx, n_s, rounding_mode="floor")]
    dot = torch.sum(d * normal, dim=-1, keepdim=True)
    reflection = 2.0 * dot * normal - d
    rgb_s = params["mlp"](xyz_s, reflection, app, -dot, 1.0 / (rho + 1e-6))
    rgb = tint * torch.clamp_min(rgb_s, 0.0) + rgb_d
    rgb_samples = tf.scatter_rows(idx, rgb, app_mask.numel()).reshape(app_mask.shape + (3,))

    # the normal-orientation penalty (:236-238), a scalar over the shaded samples
    penalty = torch.sum(w_s * torch.relu(-dot)[:, 0] ** 2)
    rgb_map, depth_map = tf.composite_maps(cfg, weight, rgb_samples, z_vals, rays, white_bg)
    return tf.TensoRFOut(rgb_map=rgb_map, depth_map=depth_map, weight=weight, sigma=sigma,
                         bg_weight=bg_weight, z_vals=z_vals,
                         extras={"app_mask": app_mask, "valid": valid, "penalty": penalty,
                                 "normal": normal})
