"""Parity of the port's simulators with qrw_tpu, in float64.

Three robots start from the standing pose with seeded joint and base
velocity perturbations (so that feet touch down, slide and lift) and
take 6 ticks of the lane-major fleet step `step_lane`, and 4 ticks of
the per-robot `step` of the single-robot rollout (batch-major, against
qrw_tpu's step under jax.vmap) on flat ground, on the bumpy terrain and
on the stairs course with the envID=1 spheres launched into the base,
under seeded PD targets, feed-forward torques and external base
forces, in both packages. After every tick both continue from the JAX
state, so a mismatch shows where it arises. Tolerance: float64,
identical algorithms; 1e-9 absolute on states and measurements leaves
room for the round-off of 4 substeps of stiff (4000 N/m) contact while
catching any change of formula. The sphere contact (2000 N/m) drives
base accelerations of ~1e3 m/s^2 into the IMU synthesis, so there the
bar is 1e-9 of each leaf's scale (measured: 5e-10 absolute on the
IMU acceleration, 3e-13 on states)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.ops import rbd_lane as jrl
from qrw_tpu.sim import physics as jphys
from qrw_tpu.sim import physics_lane as jpl
from qrw_tpu.sim import terrain as jter
from qrw_tpu.models.solo12 import make_solo12
from qrw_tpu.ops import rbd as jrbd
from qrw_tpu_torch import convert
from qrw_tpu_torch.ops import rbd_lane as trl
from qrw_tpu_torch.sim import physics as tphys
from qrw_tpu_torch.sim import physics_lane as tpl
from qrw_tpu_torch.sim import terrain as tter
from qrw_tpu_torch.models import solo12 as tsolo
from qrw_tpu_torch.ops import rbd as trbd
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
B = 3
TOL = 1e-9


def _state0(rng, cfg=CFG):
    ss = jphys.init_sim_state(cfg, dtype=jnp.float64)
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


WORLDS = ["flat", "bumpy", "stairs_spheres"]


def _world(name):
    """(config, JAX terrain, port terrain) of a test world."""
    if name == "flat":
        return CFG, None, None
    if name == "bumpy":
        cfg = CFG.replace(use_flat_plane=False)
    else:
        cfg = CFG.replace(envID=1)
    return (cfg, jter.make_terrain(cfg, jnp.float64),
            tter.make_terrain(cfg, torch.float64, device="cpu"))


@pytest.fixture(scope="module", params=WORLDS)
def robot_rollout(request):
    cfg, jt, tt = _world(request.param)
    rng = np.random.default_rng(7)
    ss = _state0(rng, cfg)
    if request.param == "stairs_spheres":
        # past the spheres' triggers, one sphere touching the base
        ss.q[:, 1] = 1.0
        ss.proj.pos[:, 0] = ss.q[:, 0:3] + np.array([0.12, 0.0, 0.0])
    jm = jrbd.to_jax(make_solo12())
    tm = trbd.to_torch(tsolo.make_solo12())
    jstep = jax.jit(jax.vmap(lambda s, *a: jphys.step(
        cfg, jm, s, *a[:5], f_ext=a[5], terrain=jt)))
    recs = []
    for _ in range(4):
        ctrl = [np.full((B, 12), cfg.joint_P), np.full((B, 12), cfg.joint_D),
                np.asarray(cfg.q_init) + rng.normal(scale=0.05, size=(B, 12)),
                rng.normal(scale=0.5, size=(B, 12)),
                rng.normal(scale=1.0, size=(B, 12)),
                rng.normal(scale=2.0, size=(B, 3))]
        want = jax.tree.map(np.asarray, jstep(
            jax.tree.map(jnp.asarray, ss), *[jnp.asarray(c) for c in ctrl]))
        got = tphys.step(cfg, tm, convert.to_torch(ss, dtype=torch.float64),
                         *[torch.as_tensor(c) for c in ctrl[:5]],
                         f_ext=torch.as_tensor(ctrl[5]), terrain=tt)
        recs.append((got, want))
        ss = want[0]
    return request.param, recs


@pytest.mark.parametrize("part", ["sim_state", "device"])
def test_step_parity(robot_rollout, part):
    world, recs = robot_rollout
    i = 0 if part == "sim_state" else 1
    contact_seen = launched = False
    for t, (got, want) in enumerate(recs):
        g = convert.to_numpy(got[i], like=want[i])
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_leaves_with_path(want[i])]
        for path, gv, wv in zip(paths, jax.tree_util.tree_leaves(g),
                                jax.tree_util.tree_leaves(want[i])):
            assert gv.shape == wv.shape, path
            if wv.dtype == bool:
                np.testing.assert_array_equal(gv, wv, err_msg=path)
                continue
            tol = TOL
            if world == "stairs_spheres":
                tol = TOL * max(1.0, float(np.abs(wv).max()))
            np.testing.assert_allclose(gv, wv, rtol=0, atol=tol,
                                       err_msg=f"{world} tick {t} {path}")
        if part == "sim_state":
            contact_seen |= bool(want[0].active.any())
            if want[0].proj is not None:
                launched |= bool(want[0].proj.launched.any())
    if part == "sim_state":
        assert contact_seen, "the rollout must exercise the contact model"
        assert launched == (world == "stairs_spheres")


@pytest.mark.parametrize("world", WORLDS)
def test_init_sim_state_on_terrain(world):
    """Settled onto each world's terrain, with the spheres of envID=1."""
    cfg, jt, tt = _world(world)
    want = jphys.init_sim_state(cfg, terrain=jt, dtype=jnp.float64)
    got = tphys.init_sim_state(cfg, terrain=tt, dtype=torch.float64)
    assert (got.proj is None) == (want.proj is None) == (cfg.envID != 1)
    g = convert.to_numpy(got, like=want)
    for gv, wv in zip(jax.tree_util.tree_leaves(g),
                      jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(gv, np.asarray(wv), rtol=0, atol=1e-12)


def test_contact_forces_parity():
    """The compliant contact model alone: feet above, in and sliding
    over the ground, with fresh and held anchors."""
    rng = np.random.default_rng(11)
    pos = rng.normal(scale=0.01, size=(B, 4, 3))
    vel = rng.normal(scale=0.3, size=(B, 4, 3))
    ground = rng.normal(scale=0.005, size=(B, 4))
    ss = _state0(rng)
    ss.anchors[:] = pos[..., 0:2] + rng.normal(scale=0.01, size=(B, 4, 2))
    ss.active[:] = rng.uniform(size=(B, 4)) > 0.5
    want = jax.vmap(lambda s, p, v, h: jphys._contact_forces(CFG, s, p, v, h))(
        jax.tree.map(jnp.asarray, ss), jnp.asarray(pos), jnp.asarray(vel),
        jnp.asarray(ground))
    got = tphys._contact_forces(CFG, convert.to_torch(ss), torch.as_tensor(pos),
                                torch.as_tensor(vel), torch.as_tensor(ground))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    assert np.asarray(want[2]).any() and not np.asarray(want[2]).all()
