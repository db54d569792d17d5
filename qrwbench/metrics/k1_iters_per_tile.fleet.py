"""Iterations a tile of kernel K1 ran in the fleet's phase solves: the
port's counters `mpc.k1_tile_iters` (the sum over tiles of the most
iterations any lane of the tile ran, reduced on the card) over
`mpc.k1_tiles`. With stop_at_eps a tile stops once all its lanes
converged, so this is K1's work a tile."""


def read(tr):
    try:
        from qrw_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("mpc.k1_tiles"):
        return None
    return c["mpc.k1_tile_iters"] / c["mpc.k1_tiles"]
