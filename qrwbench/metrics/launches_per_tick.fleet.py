"""Device operations (kernels, copies) launched per fleet tick in the
traced cycles: the cycle loop's dispatch count."""


def read(tr):
    ticks = tr.cycles * tr.constants["k_mpc"]
    return tr.n_kernels / ticks if tr.n_kernels else None
