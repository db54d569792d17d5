"""Robot-ticks per second of the traced run's untraced cycles (B x k_mpc
x whole cycles over their wall, each ending in a synchronize). The
fleet is host-paced at every size that fits (PERF.md), so its rate is a
per-layer reading, not an end-to-end metric with a bound."""


def read(tr):
    win = tr.window
    if win is None or not win.cycles:
        return None
    ticks = sum(c["ticks"] for c in win.cycles)
    return ticks / sum(c["wall_s"] for c in win.cycles) if ticks else None
