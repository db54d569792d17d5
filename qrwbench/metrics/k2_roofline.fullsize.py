"""K2's share of its roofline in the full-size batch, in percent: the
ADMM rounds' work with A applied by its cone structure (4N blocks and an
identity row a variable, N from the configuration) at the float32 peak,
or the bytes at the memory rate, over the device time of the kernels
launched inside `ops/qp_pallas._run_kernel`."""

from qrwbench import work


def read(tr):
    recs = tr.records.get("k2", [])
    if not recs:
        return None
    nb = 4 * tr.constants["n_steps"]
    bound = sum(work.bound_s(*work.k2_cone_work(
        r["R"], r["n"], r["m"], r["n_iters"], nb, True, r["k_ref"]))
        for r in recs)
    return work.roofline_pct(bound, tr.kernel_s("k2"))
