"""The share of (problem, iteration) pairs of the iLQR that accepted a
step (the best of the line search lowered the cost): the port's
counters `ilqr.accepted` (summed on the card) over `ilqr.problems`
(problems x iterations) in the traced cycles. A rejected iteration
raises the problem's regularization and leaves its iterate unchanged."""


def read(tr):
    try:
        from qrw_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("ilqr.problems") or "ilqr.accepted" not in c:
        return None
    return c["ilqr.accepted"] / c["ilqr.problems"]
