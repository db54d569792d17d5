"""K3's share of its roofline in the full-size batch, in percent: the
Newton-Schulz products' work at three TF32 operations a float32 one
(495 TFLOP/s) or the bytes at the memory rate, over the device time of
the kernels launched inside `ops/qp_pallas._ns_refine`."""

from qrwbench import work


def read(tr):
    recs = tr.records.get("k3", [])
    if not recs:
        return None
    bound = sum(work.bound_s(*work.k3_work(r["B"], r["n"], r["ns_iters"]),
                             tf32x3=True) for r in recs)
    return work.roofline_pct(bound, tr.kernel_s("k3"))
