"""First-K compaction (counterpart of myc_nerfs_tpu/ops/compaction.py).

The reference compacts live samples with atomics and boolean indexing
(CompactedCoord, compacted_coord.h:62-77). The static-shape version keeps
the first K True positions of each row by a cumsum rank, so the shapes that
follow are fixed.
"""
from __future__ import annotations

from typing import Tuple

import torch


def compact_first_k(mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first ``k`` True entries per row of mask [..., S].

    Returns (idx [..., k] int64 clamped into [0, S-1], valid [..., k] bool):
    slot j holds the j-th True position when there is one (valid), else a
    clamped placeholder (invalid). The JAX package returns int32 indices;
    torch gathers take int64.
    """
    S = mask.shape[-1]
    c = torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int32)    # [..., S]
    j = torch.arange(k, dtype=torch.int32, device=mask.device)
    # the first i with c[i] > j == the count of i with c[i] <= j
    idx = torch.searchsorted(c.contiguous(), j.expand(*c.shape[:-1], k).contiguous(),
                             right=True)
    idx = torch.clamp_max(idx, S - 1)
    valid = j < c[..., -1:]
    return idx, valid
