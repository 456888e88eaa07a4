"""Milliseconds of one occupancy-grid update (NGPTrainer.grid_update),
host clock between two synchronisations, mean over the traced steps' updates."""


def read(r):
    s = r.grid_update_s
    return 1e3 * sum(s) / len(s) if r.mode == "train" and s else None
