"""Model FLOPs of the untraced window over its wall time and the peak of
the field's dtype (%): the field's forward FLOPs x 3 over the samples its
steps evaluated (and the forward of the occupancy updates)."""


def read(r):
    return r.mfu_pct if r.mode == "train" else None
