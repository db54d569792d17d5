"""The converged share of all (cycle, problem) solves in the window,
after the rescue stage where the cell has one."""


def read(win):
    solves = sum(c["solves"] for c in win.cycles)
    if not solves:
        return None
    return sum(c["converged"] for c in win.cycles) / solves
