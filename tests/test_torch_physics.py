"""Parity of the port's lane-major fleet physics with qrw_tpu, in float64.

Three robots start from the standing pose with seeded joint and base
velocity perturbations (so that feet touch down, slide and lift) and
take 6 ticks of `step_lane` under seeded PD targets, feed-forward
torques and external base forces, in both packages. After every tick
both continue from the JAX state, so a mismatch shows where it arises.
Tolerance: float64, identical algorithms; 1e-9 absolute on states and
measurements leaves room for the round-off of 4 substeps of stiff
(4000 N/m) contact while catching any change of formula."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.ops import rbd_lane as jrl
from qrw_tpu.sim import physics as jphys
from qrw_tpu.sim import physics_lane as jpl
from qrw_tpu_torch import convert
from qrw_tpu_torch.ops import rbd_lane as trl
from qrw_tpu_torch.sim import physics as tphys
from qrw_tpu_torch.sim import physics_lane as tpl

torch.set_num_threads(1)

CFG = Config()
B = 3
TOL = 1e-9


def _state0(rng):
    ss = jphys.init_sim_state(CFG, dtype=jnp.float64)
    ss = jax.tree.map(lambda a: np.broadcast_to(
        np.asarray(a), (B,) + np.shape(a)).copy(), ss)
    ss.q[:, 7:] += rng.normal(scale=0.05, size=(B, 12))
    ss.q[:, 2] -= 0.004                     # feet start in the ground
    ss.v[:, 0:6] += rng.normal(scale=0.2, size=(B, 6))
    ss.v[:, 6:] += rng.normal(scale=0.5, size=(B, 12))
    return ss


@pytest.fixture(scope="module")
def rollout():
    rng = np.random.default_rng(4)
    ss = _state0(rng)
    jlane, tlane = jrl.solo12_lane(), trl.solo12_lane()
    jstep = jax.jit(lambda s, *a: jpl.step_lane(CFG, jlane, s, *a))
    recs = []
    for _ in range(6):
        ctrl = [np.full((B, 12), CFG.joint_P), np.full((B, 12), CFG.joint_D),
                np.asarray(CFG.q_init) + rng.normal(scale=0.05, size=(B, 12)),
                rng.normal(scale=0.5, size=(B, 12)),
                rng.normal(scale=1.0, size=(B, 12)),
                rng.normal(scale=2.0, size=(B, 3))]
        want = jax.tree.map(np.asarray, jstep(
            jax.tree.map(jnp.asarray, ss), *[jnp.asarray(c) for c in ctrl]))
        tss = convert.to_torch(ss, dtype=torch.float64)
        got = tpl.step_lane(CFG, tlane, tss,
                            *[torch.as_tensor(c) for c in ctrl[:5]],
                            f_ext=torch.as_tensor(ctrl[5]))
        recs.append((got, want))
        ss = want[0]
    return recs


def test_init_sim_state_parity():
    want = jphys.init_sim_state(CFG, dtype=jnp.float64)
    got = tphys.init_sim_state(CFG, dtype=torch.float64)
    for f in ("q", "v", "anchors", "active", "prev_o_imu_vel",
              "joint_torques"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.mark.parametrize("part", ["sim_state", "device"])
def test_step_lane_parity(rollout, part):
    i = 0 if part == "sim_state" else 1
    contact_seen = False
    for t, (got, want) in enumerate(rollout):
        g, w = got[i], want[i]
        for f in w._fields:
            wv = getattr(w, f)
            if wv is None:
                assert getattr(g, f) is None
                continue
            gv = getattr(g, f).numpy()
            if np.asarray(wv).dtype == bool:
                np.testing.assert_array_equal(gv, wv, err_msg=f"{t} {f}")
            else:
                np.testing.assert_allclose(gv, wv, rtol=0, atol=TOL,
                                           err_msg=f"tick {t} {f}")
        if part == "sim_state":
            contact_seen |= bool(np.asarray(w.active).any())
    if part == "sim_state":
        assert contact_seen, "the rollout must exercise the contact model"


def test_step_lane_rejects_terrain():
    """step_lane takes None, a Terrain or a FleetTerrain (held against
    qrw_tpu in tests/test_torch_terrain.py): any other terrain raises,
    and so do the envID=1 projectiles, which are not ported."""
    ss = convert.to_torch(jax.tree.map(np.asarray, _state0(
        np.random.default_rng(0))), dtype=torch.float64)
    z = torch.zeros((B, 12), dtype=torch.float64)
    with pytest.raises(TypeError, match="not a terrain"):
        tpl.step_lane(CFG, trl.solo12_lane(), ss, z, z, z, z, z,
                      terrain=object())
    with pytest.raises(NotImplementedError):
        tpl.step_lane(CFG, trl.solo12_lane(), ss._replace(proj=()), z, z,
                      z, z, z)
