"""Ray rendering for the MLP family: NeRF, BARF, GARF (counterpart of
myc_nerfs_tpu/render/mlp_renderer.py; barf nerf.py:211-284).

Depth sampling, the field over [B, R, N] samples, quadrature compositing,
and the hierarchical fine pass from the coarse ``prob``. The fine pass keeps
the gradient through ``sample_depth_from_pdf`` and the sort, as JAX does
(no detach). The stratified jitter is an argument. Not ported: the JAX
package's re-tiling of the rays into a non-power-of-two [G1, G2] batch
(``_mlp_tile_dims``), an XLA:TPU layout workaround that changes how the
products are laid out, not what they compute.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..geom import rays as rays_lib
from ..utils import profiling
from . import sampling
from .composite import composite_nerf


class RenderOut(NamedTuple):
    rgb: torch.Tensor      # [B, R, 3]
    depth: torch.Tensor    # [B, R, 1]
    opacity: torch.Tensor  # [B, R, 1]
    prob: torch.Tensor     # [B, R, N, 1]


def render_rays_mlp(apply_fn, center: torch.Tensor, ray: torch.Tensor,
                    rand: Optional[torch.Tensor], n_samples: int,
                    depth_range: Tuple[float, float],
                    bg_color: Optional[torch.Tensor] = None, view_dep: bool = True,
                    fine_apply_fn=None, n_samples_fine: int = 0) -> RenderOut:
    """Render rays [B, R, 3] (centres and unnormalised directions) with a
    field ``apply_fn(points [B, R, N, 3], ray_unit | None) -> (rgb,
    density)``. ``rand`` [B, R, n_samples, 1] is the stratified jitter, or
    None for bin midpoints. With ``fine_apply_fn`` the fine field renders
    the coarse and the inverse-CDF depths together, sorted."""
    depth = sampling.sample_depth(rand, center.shape[:2], n_samples, depth_range,
                                  device=center.device)
    out = _eval_and_composite(apply_fn, center, ray, depth, bg_color, view_dep)
    if fine_apply_fn is not None and n_samples_fine > 0:
        depth_fine = sampling.sample_depth_from_pdf(out.prob[..., 0], n_samples_fine,
                                                    depth_range)
        depth_all = torch.sort(torch.cat([depth, depth_fine], dim=-2), dim=-2).values
        out = _eval_and_composite(fine_apply_fn, center, ray, depth_all, bg_color, view_dep)
    return out


def _eval_and_composite(apply_fn, center, ray, depth, bg_color, view_dep) -> RenderOut:
    with profiling.span("nerf.field"):
        points = center[..., None, :] + ray[..., None, :] * depth
        ray_unit = None
        if view_dep:
            ray_unit = ray / (torch.linalg.norm(ray, dim=-1, keepdim=True) + 1e-8)
            ray_unit = ray_unit[..., None, :].expand(points.shape)
        rgb_s, sigma_s = apply_fn(points, ray_unit)
    profiling.count("nerf.samples", points.shape[:-1].numel())
    with profiling.span("nerf.composite"):
        return RenderOut(*composite_nerf(ray, rgb_s, sigma_s, depth, bg_color=bg_color))


def render_image_mlp(apply_fn, pose: torch.Tensor, intr: torch.Tensor, H: int, W: int,
                     n_samples: int, depth_range: Tuple[float, float],
                     bg_color: Optional[torch.Tensor] = None, view_dep: bool = True,
                     chunk: int = 4096, fine_apply_fn=None, n_samples_fine: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A whole image in chunks of ``chunk`` rays at the bin midpoints (the
    eval path, render_by_slices nerf.py:273-284) -> (rgb [H, W, 3], depth
    [H, W]); with ``fine_apply_fn`` each chunk runs the coarse -> fine
    graph of training."""
    center, ray = rays_lib.get_center_and_ray(pose[None], intr[None], H, W)
    rgbs, depths = [], []
    for i in range(0, H * W, chunk):
        out = render_rays_mlp(apply_fn, center[:, i:i + chunk], ray[:, i:i + chunk], None,
                              n_samples, depth_range, bg_color=bg_color, view_dep=view_dep,
                              fine_apply_fn=fine_apply_fn, n_samples_fine=n_samples_fine)
        rgbs.append(out.rgb[0])
        depths.append(out.depth[0, :, 0])
    return torch.cat(rgbs).reshape(H, W, 3), torch.cat(depths).reshape(H, W)
