"""Model FLOPs of the untraced window over its wall time and the peak of
the field's dtype (%): the field's forward FLOPs over the valid samples of
every frame rendered."""


def read(r):
    return r.mfu_pct if r.mode == "render" else None
