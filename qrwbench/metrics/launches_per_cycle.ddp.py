"""Device operations (kernels, copies) launched per cycle of the DDP
batch in the traced cycles: the solve's dispatch count, which does not
grow with the batch."""


def read(tr):
    return tr.n_kernels / tr.cycles if tr.n_kernels else None
