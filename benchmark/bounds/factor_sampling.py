"""The least time of TensoRF's factor sampling in a traced run, forward and
backward: per step (``r.calls["factor_sampling"]``: the rays, the gated
and shaded masks and the sample depths) and per plane-line pair, the
coordinates in, the products out (their gradient in), and the plane and
line elements the gated (density) and shaded (appearance) samples touch,
each once (the backward reads and writes them)."""
from __future__ import annotations

from typing import Optional

import torch

from benchmark.lib import work
from benchmark.reference import tensorf as ref


def texels(c: torch.Tensor, size: int) -> torch.Tensor:
    """The lower corner index of align-corners, border-clamped coordinates."""
    i = torch.clamp((c + 1.0) * 0.5 * (size - 1), 0.0, size - 1.0)
    return torch.clamp(torch.floor(i), max=max(size - 2, 0)).to(torch.int64)


def plane_texels(x: torch.Tensor, y: torch.Tensor, H: int, W: int) -> int:
    """Distinct plane texels the bilinear taps at (x, y) read."""
    x0, y0 = texels(x, W), texels(y, H)
    idx = torch.cat([(y0 + dy).clamp(max=H - 1) * W + (x0 + dx).clamp(max=W - 1)
                     for dy in (0, 1) for dx in (0, 1)])
    return int(torch.unique(idx).numel())


def line_texels(t: torch.Tensor, L: int) -> int:
    t0 = texels(t, L)
    return int(torch.unique(torch.cat([t0, (t0 + 1).clamp(max=L - 1)])).numel())


def bound_s(r) -> Optional[float]:
    steps = r.calls.get("factor_sampling")
    if not steps:
        return None
    spec = r.spec
    aabb = torch.tensor(spec.aabb, dtype=torch.float32, device=steps[0][0].device)
    total = 0.0
    for rays, valid, shaded, z in steps:
        pts = rays[:, None, :3] + rays[:, None, 3:6] * z[..., None]
        xyz = ref.normalize(aabb, pts).reshape(-1, 3)
        for comps, mask in ((spec.density_comp, valid), (spec.app_comp, shaded)):
            x = xyz[mask.reshape(-1)]
            for i in range(3):
                m0, m1 = ref.MAT_MODE[i]
                H, W = spec.grid[m1], spec.grid[m0]
                L = spec.grid[ref.VEC_MODE[i]]
                plane = plane_texels(x[:, m0], x[:, m1], H, W)
                line = line_texels(x[:, ref.VEC_MODE[i]], L)
                for backward in (False, True):
                    f, n = work.factor_work(x.shape[0], comps[i], (H, W), L,
                                            plane * comps[i], line * comps[i], backward)
                    total += work.bound_s(f, n, "f32")
    return total
