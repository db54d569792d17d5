"""Set-up: from the process's start to the window's start (imports,
inputs, the kernels' build where there is none, and the one warm-up
cycle)."""


def read(win):
    return win.setup_s
