"""Faults planted under the timed path, for the tests that see `correct`
come out false. Each takes pytest's monkeypatch."""

import torch


def mpc_altered(mp):
    """The phase solve's (K1's) answer altered where it is produced."""
    from qrw_tpu_torch.ops import qp_phase
    orig = qp_phase.solve

    def bad(*a, **k):
        sol = orig(*a, **k)
        return sol._replace(x=sol.x + 0.5)
    mp.setattr(qp_phase, "solve", bad)


def mpc_half(mp):
    """Half of the batch left out of the phase solve: those lanes keep
    their warm start."""
    from qrw_tpu_torch.ops import qp_phase
    orig = qp_phase.solve

    def bad(q, *a, **k):
        sol = orig(q, *a, **k)
        x0 = k.get("x0")
        x0 = torch.zeros_like(sol.x) if x0 is None else x0
        h = q.shape[-1] // 2
        return sol._replace(x=torch.cat([sol.x[:, :h], x0[:, h:]], dim=1))
    mp.setattr(qp_phase, "solve", bad)


def full_altered(mp):
    """The full-size solve's answer altered where it is produced."""
    from qrw_tpu_torch.ops import qp_pallas
    orig = qp_pallas.solve

    def bad(*a, **k):
        sol = orig(*a, **k)
        return sol._replace(x=sol.x + 0.5)
    mp.setattr(qp_pallas, "solve", bad)


def full_half(mp):
    """Half of the batch left out of the full-size solve: those problems
    keep their warm start."""
    from qrw_tpu_torch.ops import qp_pallas
    orig = qp_pallas.solve

    def bad(P, *a, **k):
        sol = orig(P, *a, **k)
        x0 = k.get("x0")
        x0 = torch.zeros_like(sol.x) if x0 is None else x0
        h = P.shape[0] // 2
        return sol._replace(x=torch.cat([sol.x[:h], x0[h:]]))
    mp.setattr(qp_pallas, "solve", bad)


def physics_unchanged(mp):
    """A physics step that returns its state unchanged."""
    from qrw_tpu_torch.sim import fleet
    orig = fleet.step_lane

    def bad(cfg, lane, state, *a, **k):
        _, dev = orig(cfg, lane, state, *a, **k)
        return state, dev
    mp.setattr(fleet, "step_lane", bad)


def physics_half(mp):
    """Half of the fleet left out of the physics step."""
    from qrw_tpu_torch.sim import fleet
    orig = fleet.step_lane

    def bad(cfg, lane, state, *a, **k):
        new, dev = orig(cfg, lane, state, *a, **k)
        h = state.q.shape[0] // 2
        mix = lambda n, o: torch.cat([n[:h], o[h:]])  # noqa: E731
        return new._replace(q=mix(new.q, state.q), v=mix(new.v, state.v)), dev
    mp.setattr(fleet, "step_lane", bad)


def wbc_altered(mp):
    """The WBC's torques altered where they are produced."""
    from qrw_tpu_torch.sim import fleet
    orig = fleet.compute_wbc_lane

    def bad(*a, **k):
        res = orig(*a, **k)
        return res._replace(tau_ff=res.tau_ff + 0.05)
    mp.setattr(fleet, "compute_wbc_lane", bad)


def wbc_inputs_altered(mp):
    """The WBC's foot acceleration targets altered where they are
    assembled."""
    from qrw_tpu_torch.sim import fleet
    orig = fleet.wbc_inputs

    def bad(*a, **k):
        inp = orig(*a, **k)
        return inp._replace(feet_a_cmd=inp.feet_a_cmd + 0.05)
    mp.setattr(fleet, "wbc_inputs", bad)


BY_CELL = {
    "hetero-fleet": [mpc_altered, mpc_half, wbc_inputs_altered, wbc_altered,
                     physics_unchanged, physics_half],
    "trot-mpc-rolled": [mpc_altered, mpc_half],
    "trot-fullsize-ns": [full_altered, full_half],
}
