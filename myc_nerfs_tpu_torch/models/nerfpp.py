"""NeRF++ inverted-sphere background on TensorVMSplit (counterpart of
myc_nerfs_tpu/models/nerfpp.py; tensorf-myc models/nerfplusplus.py).

- ``nerfpp_embed``: PE with the input, then sin/cos per frequency (:7-56);
- ``BgMLPNet``: the background MLP, a skip at D // 2, base_remap and
  |sigma| (:66-140);
- the foreground is sampled from near to the exit depth of the sphere of
  radius ``radii`` (:178-194, :239-269); the background over inverse depth
  in the inverted-sphere parametrisation (x', y', z', 1/r) (:207-237),
  flipped so that its samples run from the physical far to near (:296-300);
- fg and bg are composed with the leftover foreground transmittance
  bg_lambda, gated at > 0.1 (:272-318).

Spans (utils/profiling.py): the foreground runs under the VM-split
forward's ``tensorf.sample``, ``.density``, ``.shade`` and ``.composite``;
the background under ``nerfpp.bg_points``, ``.bg_mlp`` and
``.bg_composite``; counter ``nerfpp.bg_samples`` adds rays x bg_samples
per forward.

The draws are arguments: ``draws = (fg [N, S], bg [N, bg_samples])`` in
[0, 1), the JAX package's ``uniform(k_fg, ...)`` and ``uniform(k_bg, ...)``
of ``split(key)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..render.composite import raw2alpha
from ..utils.profiling import count, span
from . import tensorf as tf

HUGE = 1e10
TINY = 1e-6


def nerfpp_embed(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    out = [x]
    for i in range(n_freqs):
        f = 2.0 ** i
        out.append(torch.sin(x * f))
        out.append(torch.cos(x * f))
    return torch.cat(out, dim=-1)


@dataclasses.dataclass(frozen=True)
class NerfPPConfig:
    """set_nerfplusplus's arguments (nerfplusplus.py:147-163)."""

    bg_freq: int = 4
    bg_view_freq: int = 2
    bg_D: int = 4
    radii: float = 20.0
    bg_samples: int = 512


class BgMLPNet(tf.DenseStack):
    """The background MLP (MLPNet, nerfplusplus.py:66-140): W = 128, the
    embedded points concatenated back in before layer D // 2; Dense_0 ..
    Dense_{D-1} the base, then sigma, base_remap (256), the view layer
    (W // 2) and rgb."""

    def __init__(self, cfg: NerfPPConfig, device=None,
                 generator: Optional[torch.Generator] = None, W: int = 128):
        D, skips = cfg.bg_D, (cfg.bg_D // 2,)
        pts_dim = 4 * (1 + 2 * cfg.bg_freq)
        view_dim = 3 * (1 + 2 * cfg.bg_view_freq)
        widths = [(pts_dim, W)]
        for i in range(D - 1):
            widths.append((W + (pts_dim if i in skips else 0), W))
        widths += [(W, 1), (W, 256), (256 + view_dim, W // 2), (W // 2, 3)]
        super().__init__(widths, device, generator)
        self.D, self.skips = D, skips

    def forward(self, pts_embed: torch.Tensor, view_embed: torch.Tensor):
        base = torch.relu(self.Dense_0(pts_embed))
        for i in range(self.D - 1):
            if i in self.skips:
                base = torch.cat([pts_embed, base], dim=-1)
            base = torch.relu(self.layer(1 + i)(base))
        sigma = torch.abs(self.layer(self.D)(base))[..., 0]
        base_remap = self.layer(self.D + 1)(base)
        h = torch.relu(self.layer(self.D + 2)(torch.cat([base_remap, view_embed], dim=-1)))
        return torch.sigmoid(self.layer(self.D + 3)(h)), sigma


def intersect_sphere(ray_o: torch.Tensor, ray_d: torch.Tensor, radii_sq) -> torch.Tensor:
    """Depth of the exit intersection with the sphere of squared radius
    ``radii_sq`` (nerfplusplus.py:178-194)."""
    d1 = -torch.sum(ray_d * ray_o, -1) / torch.sum(ray_d * ray_d, -1)
    p = ray_o + d1[..., None] * ray_d
    ray_d_cos = 1.0 / torch.linalg.norm(ray_d, dim=-1)
    p_norm_sq = torch.sum(p * p, -1)
    d2 = torch.sqrt(torch.clamp_min(radii_sq - p_norm_sq, 0.0)) * ray_d_cos
    return d1 + d2


def perturb_samples(draw: Optional[torch.Tensor], z_vals: torch.Tensor) -> torch.Tensor:
    """Jitter inside the per-sample intervals (nerfplusplus.py:196-205) by
    ``draw`` (z_vals' shape, [0, 1)); None leaves z_vals."""
    if draw is None:
        return z_vals
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    lower = torch.cat([z_vals[..., :1], mids], -1)
    return lower + (upper - lower) * draw


def depth2pts_outside(ray_o: torch.Tensor, ray_d: torch.Tensor, depth: torch.Tensor,
                      radii: float):
    """Inverted-sphere 4D points (x', y', z', 1/r) and their real depth (:207-237)."""
    d1 = -torch.sum(ray_d * ray_o, -1) / torch.sum(ray_d * ray_d, -1)
    p_mid = ray_o + d1[..., None] * ray_d
    p_mid_norm = torch.linalg.norm(p_mid, dim=-1)
    ray_d_cos = 1.0 / torch.linalg.norm(ray_d, dim=-1)
    d2 = torch.sqrt(torch.clamp_min(radii * radii - p_mid_norm ** 2, 0.0)) * ray_d_cos
    p_sphere = ray_o + (d1 + d2)[..., None] * ray_d

    rot_axis = torch.cross(ray_o, p_sphere, dim=-1)
    rot_axis = rot_axis / (torch.linalg.norm(rot_axis, dim=-1, keepdim=True) + TINY)
    phi = torch.arcsin(torch.clamp(p_mid_norm / radii, -1, 1))
    theta = torch.arcsin(torch.clamp(p_mid_norm * depth / (radii * radii), -1, 1))
    rot_angle = (phi - theta)[..., None]

    p_new = p_sphere * torch.cos(rot_angle) + \
        torch.cross(rot_axis, p_sphere, dim=-1) * torch.sin(rot_angle) + \
        rot_axis * torch.sum(rot_axis * p_sphere, -1, keepdim=True) * (1.0 - torch.cos(rot_angle))
    pts = torch.cat([p_new, depth[..., None]], -1)
    depth_real = radii / (depth + TINY) * torch.cos(theta) * ray_d_cos + d1
    return pts, depth_real


def nerfpp_forward(model_cfg: tf.TensoRFConfig, pp_cfg: NerfPPConfig, geom: tf.StageGeom,
                   params, buffers, rays: torch.Tensor,
                   draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   n_samples: Optional[int] = None) -> tf.TensoRFOut:
    """Foreground TensoRF + inverted-sphere background (execute, :272-318);
    params hold "bg_net" (BgMLPNet)."""
    n_s = n_samples or geom.n_samples
    ray_o, ray_d = rays[:, :3], rays[:, 3:6]
    d_fg, d_bg = draws if draws is not None else (None, None)

    # foreground: from near to the sphere's exit (sample_ray, :239-269)
    with span("tensorf.sample"):
        fg_far = intersect_sphere(ray_o, ray_d, pp_cfg.radii * pp_cfg.radii)
        near = model_cfg.near_far[0]
        step = (fg_far - near) / (n_s - 1)
        fg_depth = near + step[..., None] * torch.arange(n_s, dtype=torch.float32,
                                                         device=rays.device)[None]
        fg_depth = perturb_samples(d_fg, fg_depth)
        pts = ray_o[:, None, :] + ray_d[:, None, :] * fg_depth[..., None]
        aabb = buffers["aabb"]
        valid = torch.logical_not(torch.logical_or(aabb[0] > pts, pts > aabb[1]).any(-1))
        dists = torch.cat([fg_depth[:, 1:] - fg_depth[:, :-1],
                           torch.zeros_like(fg_depth[:, :1])], -1)
        occ = tf.alpha_mask_valid(buffers, pts)
        if occ is not None:
            valid = torch.logical_and(valid, occ)
        xyz = tf.normalize_coord(aabb, pts)
    with span("tensorf.density"):
        sigma = tf.masked_density(model_cfg, params, valid, xyz)
    with span("tensorf.shade"):
        alpha, weight, _ = raw2alpha(sigma, dists * model_cfg.distance_scale)
        app_mask = weight > model_cfg.ray_march_weight_thres
        idx = tf.selected(app_mask)
        xyz_a = xyz.reshape(-1, 3)[idx]
        dirs = ray_d[torch.div(idx, n_s, rounding_mode="floor")]
        rgb = params["mlp"](xyz_a, dirs, tf.compute_app_feature(model_cfg, params, xyz_a))
        rgb_s = tf.scatter_rows(idx, rgb, app_mask.numel()).reshape(app_mask.shape + (3,))
    with span("tensorf.composite"):
        fg_rgb_map = (weight[..., None] * rgb_s).sum(-2)
        depth_map = (weight * fg_depth).sum(-1)

    # background march over inverse depth (:283-311)
    n_bg = pp_cfg.bg_samples
    count("nerfpp.bg_samples", ray_d.shape[0] * n_bg)
    with span("nerfpp.bg_points"):
        viewdirs = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
        bg_z = tf.linspace_f32(0.0, pp_cfg.radii, n_bg, rays.device).expand(
            ray_d.shape[:-1] + (n_bg,))
        bg_z = perturb_samples(d_bg, bg_z)
        shape = ray_d.shape[:-1] + (n_bg, 3)
        bg_pts, _ = depth2pts_outside(ray_o[:, None, :].expand(shape),
                                      ray_d[:, None, :].expand(shape), bg_z, pp_cfg.radii)
        pts_embed = nerfpp_embed(bg_pts, pp_cfg.bg_freq)
        view_embed = nerfpp_embed(viewdirs[:, None, :].expand(shape), pp_cfg.bg_view_freq)
        # flip: the near_depth parameter is the physical far (:296-300)
        pts_embed = torch.flip(pts_embed, dims=(-2,))
        view_embed = torch.flip(view_embed, dims=(-2,))
        bg_z_f = torch.flip(bg_z, dims=(-1,))
    with span("nerfpp.bg_mlp"):
        bg_rgb, bg_sigma = params["bg_net"](pts_embed, view_embed)
    with span("nerfpp.bg_composite"):
        bg_dists = torch.cat([bg_z_f[..., :-1] - bg_z_f[..., 1:],
                              HUGE * torch.ones_like(bg_z_f[..., :1])], -1)
        bg_alpha = 1.0 - torch.exp(-bg_sigma * bg_dists)
        Tb = torch.cumprod(1.0 - bg_alpha + TINY, dim=-1)[..., :-1]
        Tb = torch.cat([torch.ones_like(Tb[..., :1]), Tb], -1)
        bg_weights = bg_alpha * Tb
        bg_rgb_map = (bg_weights[..., None] * bg_rgb).sum(-2)
        bg_depth_map = (bg_weights * bg_z_f).sum(-1)

        # compose with the foreground's leftover transmittance bg_lambda
        # (:279-281), gated at > 0.1 (:313-318)
        bg_lambda = torch.cumprod(1.0 - alpha + TINY, dim=-1)[..., -1]
        bg_lambda = torch.where(bg_lambda > 0.1, bg_lambda, 0.0)
        rgb_map = fg_rgb_map + bg_lambda[..., None] * bg_rgb_map
        depth_map = depth_map + bg_lambda * bg_depth_map
    return tf.TensoRFOut(rgb_map=rgb_map, depth_map=depth_map, weight=weight, sigma=sigma,
                         bg_weight=bg_lambda[..., None], z_vals=fg_depth,
                         extras={"app_mask": app_mask, "valid": valid,
                                 "bg_rgb_map": bg_rgb_map})
