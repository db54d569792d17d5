"""How far float32 rounding alone moves the rescued trot fleet, in qrw_tpu
and in qrw_tpu_torch: the numbers behind the `.wbc.qp_y` tolerance of
tests/test_torch_fleet_rescue.py.

The fleet and schedules are that test's (B = 4, tile 1, seed 0, two
crippled cycles with rescue_cap = B, stop_at_eps off; JAX on its plain
phase path and its Pallas rescue kernel interpreted, the port on CPU
tensors).

    python tests/torch_rescue_rounding.py spread [K]
        K runs (default 32). Run 0 starts from the fleet's carry; run k > 0
        from the same carry with the simulator's q and v each multiplied
        by (1 + 1.2e-7 g), g standard normal (about one float32 ulp), the
        same perturbed carry for both packages. Prints, per cycle and
        leaf, each package's own spread (the largest difference between
        two of its K runs) and the port-vs-qrw_tpu gap of each run (run 0,
        the largest, the median, the smallest, how many runs over 1e-3).

    python tests/torch_rescue_rounding.py f64
        The fleet built in float64 by qrw_tpu (the same robots as the
        float32 fleet) and each package run from it in float64 (the MPC
        stays float32 in both by design); prints the port-vs-qrw_tpu gap
        of the second cycle's leaves in float32 and in float64, and each
        package's float32-vs-float64 difference.

Run it from the repository root on the CPU.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)       # as tests/conftest.py

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from qrw_tpu.config import Config  # noqa: E402
from qrw_tpu.core import mpc_lane as jml  # noqa: E402
from qrw_tpu.sim import fleet as jfl  # noqa: E402
from qrw_tpu_torch import convert  # noqa: E402
from qrw_tpu_torch.core import mpc_lane as tml  # noqa: E402
from qrw_tpu_torch.sim import fleet as tfl  # noqa: E402

torch.set_num_threads(1)

CFG = Config()
B = 4
T = CFG.k_mpc
LEAVES = {"qp_y": lambda c: c.ctl_states.wbc.qp_y,
          "x_f_mpc": lambda c: c.ctl_states.x_f_mpc,
          "sim q": lambda c: c.sim_states.q}


def schedules():
    """tests/test_torch_fleet_rescue.py::_schedules."""
    rng = np.random.default_rng(5)
    v_ref = np.zeros((T, B, 6), np.float32)
    v_ref[:, :, 0] = rng.uniform(0.0, 0.3, B)
    v_ref[:, :, 5] = rng.uniform(-0.2, 0.2, B)
    f_ext = rng.normal(scale=3.0, size=(T, B, 3)).astype(np.float32)
    return v_ref, f_ext


def two_cycles(carry, dtype):
    """Both packages' carries after each of the two crippled cycles, as
    numpy leaf dicts: ([jax cycle 0, jax cycle 1], [port 0, port 1])."""
    v_ref, f_ext = schedules()
    jdt = jnp.float64 if dtype == "f64" else jnp.float32
    tdt = torch.float64 if dtype == "f64" else torch.float32
    key = (dtype,)
    if key not in _JIT:
        jps = jml.build_phase_data(CFG, jml.trot_phase_fsteps(CFG))
        jctl, _ = jfl.make_fleet(CFG, B, jps, tile=1, seed=0, dtype=jdt)
        _JIT[key] = jax.jit(lambda c: jfl.fleet_rollout(
            jctl, c, 1, jps, tile=1, n_iters=1, rescue_cap=B, use_ref=True,
            interpret=True, stop_at_eps=False,
            v_ref_schedule=jnp.asarray(v_ref, jdt),
            f_ext_schedule=jnp.asarray(f_ext, jdt)))
    crippled = _JIT[key]
    tps = tml.build_phase_data(CFG, tml.trot_phase_fsteps(CFG),
                               device="cpu")
    tctl = tfl.make_controller(CFG)
    kw = dict(tile=1, n_iters=1, rescue_cap=B, stop_at_eps=False,
              v_ref_schedule=torch.as_tensor(v_ref, dtype=tdt),
              f_ext_schedule=torch.as_tensor(f_ext, dtype=tdt))
    j1 = crippled(carry)
    j2 = crippled(j1[0])
    t1 = tfl.fleet_rollout(tctl, convert.to_torch(carry), 1, tps, **kw)
    t2 = tfl.fleet_rollout(tctl, t1[0], 1, tps, **kw)
    jn = [jax.tree.map(np.asarray, j[0]) for j in (j1, j2)]
    tn = [convert.to_numpy(t1[0], like=jn[0]),
          convert.to_numpy(t2[0], like=jn[1])]
    leaves = lambda c: {k: np.asarray(f(c), np.float64)
                        for k, f in LEAVES.items()}
    return [leaves(c) for c in jn], [leaves(c) for c in tn]


_JIT = {}


def perturbed(carry, k):
    """The carry with the simulator's q and v moved by about one float32
    ulp (run k > 0), or unchanged (k = 0)."""
    if k == 0:
        return carry
    rng = np.random.default_rng(100 + k)
    f = lambda a: (a.astype(np.float64) * (
        1 + 1.2e-7 * rng.standard_normal(a.shape))).astype(np.float32)
    sim = carry.sim_states
    return carry._replace(sim_states=sim._replace(q=f(sim.q), v=f(sim.v)))


def fleet_carry(dtype="f32"):
    jps = jml.build_phase_data(CFG, jml.trot_phase_fsteps(CFG))
    _, c32 = jfl.make_fleet(CFG, B, jps, tile=1, seed=0)
    c32 = jax.tree.map(np.asarray, c32)
    if dtype == "f32":
        return c32
    _, c64 = jfl.make_fleet(CFG, B, jps, tile=1, seed=0, dtype=jnp.float64)
    # the float32 fleet's robots, widened
    return jax.tree.map(lambda a, b: (np.asarray(b, np.float64)
                                      if np.asarray(a).dtype == np.float64
                                      and b.dtype == np.float32
                                      else np.asarray(a)), c64, c32)


def spread(K):
    carry = fleet_carry()
    J, P = [], []
    for k in range(K):
        j, p = two_cycles(perturbed(carry, k), "f32")
        J.append(j)
        P.append(p)
    for cyc in (0, 1):
        for leaf in LEAVES:
            own = lambda R: max(np.abs(R[a][cyc][leaf]
                                       - R[b][cyc][leaf]).max()
                                for a in range(K) for b in range(a))
            gap = [np.abs(P[k][cyc][leaf] - J[k][cyc][leaf]).max()
                   for k in range(K)]
            print(f"cycle {cyc} {leaf} (scale "
                  f"{np.abs(J[0][cyc][leaf]).max():.4g}): qrw_tpu's own "
                  f"spread {own(J):.4e}, the port's {own(P):.4e}; "
                  f"port-vs-qrw_tpu gap: run 0 {gap[0]:.4e}, largest "
                  f"{max(gap):.4e}, median {np.median(gap):.4e}, smallest "
                  f"{min(gap):.4e}, over 1e-3 in {sum(g > 1e-3 for g in gap)} "
                  f"of {K} runs")


def f64():
    out = {}
    for dt in ("f32", "f64"):
        out[dt] = two_cycles(fleet_carry(dt), dt)
    for leaf in LEAVES:
        (j32, t32), (j64, t64) = ([r[1][leaf] for r in out[d]]
                                  for d in ("f32", "f64"))
        print(f"cycle 1 {leaf}: port-vs-qrw_tpu float32 "
              f"{np.abs(t32 - j32).max():.4e}, float64 "
              f"{np.abs(t64 - j64).max():.4e}; float32-vs-float64 qrw_tpu "
              f"{np.abs(j32 - j64).max():.4e}, port "
              f"{np.abs(t32 - t64).max():.4e}")


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "spread"
    if mode == "spread":
        spread(int(sys.argv[2]) if len(sys.argv) > 2 else 32)
    elif mode == "f64":
        f64()
    else:
        raise SystemExit(__doc__)
