"""Lanes a cycle that the MPC's rescue stage re-solved (core/mpc_lane.
_rescue_failed_lanes: failed lanes of the phase solve, up to its
capacity): the port's counter `mpc.rescued`, summed on the card, over
the traced cycles; 0 where the stage ran and found no failed lane."""


def read(tr):
    try:
        from qrw_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    n = counters().get("mpc.rescued")
    return None if n is None else n / tr.cycles
