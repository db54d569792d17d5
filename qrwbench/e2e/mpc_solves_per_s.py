"""MPC solves per second: problems x whole cycles over the wall of those
cycles, each ending in a synchronize."""


def read(win):
    solves = sum(c["solves"] for c in win.cycles)
    if not solves:
        return None
    return solves / sum(c["wall_s"] for c in win.cycles)
