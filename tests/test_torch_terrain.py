"""Parity of the port's terrain (sim/terrain) and of terrain in its lane
physics and initial state with qrw_tpu.

Tolerances. The height fields are built in numpy float64 and cast to
float32 in both packages: bit-equal. Bilinear lookups run the same
float32 (or float64) formula in both packages; held to 1e-6 m. The lane
physics on a FleetTerrain is held as tests/test_torch_physics.py holds
it on the flat plane: float64, both packages continue from the JAX state
after every tick, 1e-9 absolute on states and measurements.
"""

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
from qrw_tpu_torch import convert
from qrw_tpu_torch.ops import rbd_lane as trl
from qrw_tpu_torch.sim import physics as tphys
from qrw_tpu_torch.sim import physics_lane as tpl
from qrw_tpu_torch.sim import terrain as tter
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
B = 3
TOL = 1e-9


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def terrains():
    """{name: (port Terrain, JAX Terrain)} in float32."""
    return {"bumpy": (tter.make_bumpy(device="cpu"), jter.make_bumpy()),
            "stairs": (tter.make_stairs(device="cpu"), jter.make_stairs())}


@pytest.mark.parametrize("name", ["bumpy", "stairs"])
def test_heights_bit_equal(terrains, name):
    t, j = terrains[name]
    for f in ("heights", "cell", "origin"):
        got, want = _np(getattr(t, f)), np.asarray(getattr(j, f))
        assert got.dtype == want.dtype == np.float32, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _cloud(seed, shape):
    """Seeded world points over and beyond both grids (the bumpy grid
    spans +-12.8 m, the stairs grid +-5.12 m)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-6.0, 6.0, size=shape + (2,))
    xy.flat[:4] = [-20.0, 30.0, 13.0, -13.0]     # off every grid
    return xy


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["bumpy", "stairs"])
def test_height_at_terrain(terrains, name, dtype):
    t, j = terrains[name]
    xy = _cloud(1, (257,)).astype(dtype)
    want = np.asarray(jter.height_at(j, jnp.asarray(xy)))
    got = _np(tter.height_at(t, torch.as_tensor(xy)))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_height_at_fleet_terrain(terrains):
    """(4, B, 2) foot points against per-robot terrain ids (B,), the
    layout of the lane physics; tid 0 is the flat plane."""
    tid = np.array([0, 1, 2, 2, 1, 0, 1], np.int32)
    xy = _cloud(2, (4, tid.size)).astype(np.float32)
    tf = tter.FleetTerrain(tid=torch.as_tensor(tid),
                           terrains=(terrains["bumpy"][0],
                                     terrains["stairs"][0]))
    jf = jter.FleetTerrain(tid=jnp.asarray(tid),
                           terrains=(terrains["bumpy"][1],
                                     terrains["stairs"][1]))
    want = np.asarray(jter.height_at(jf, jnp.asarray(xy)))
    got = _np(tter.height_at(tf, torch.as_tensor(xy)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[:, tid == 0] == 0).all() and np.abs(got).max() > 0.01
    assert tter.height_at(None, torch.as_tensor(xy)).abs().max() == 0


@pytest.mark.parametrize("case", ["flat", "bumpy", "stairs"])
def test_make_terrain(case):
    cfg = {"flat": CFG, "bumpy": CFG.replace(use_flat_plane=False),
           "stairs": CFG.replace(envID=1)}[case]
    want = jter.make_terrain(cfg)
    got = tter.make_terrain(cfg, device="cpu")
    if case == "flat":
        assert got is None and want is None
        return
    for f in ("heights", "cell", "origin"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)))


def test_converted_terrain(terrains):
    """convert.to_torch takes both NamedTuples."""
    jf = jter.FleetTerrain(tid=jnp.asarray([0, 2], jnp.int32),
                           terrains=(terrains["bumpy"][1],
                                     terrains["stairs"][1]))
    got = convert.to_torch(jax.tree.map(np.asarray, jf))
    assert isinstance(got, tter.FleetTerrain)
    assert isinstance(got.terrains[1], tter.Terrain)
    np.testing.assert_array_equal(_np(got.terrains[1].heights),
                                  _np(terrains["stairs"][0].heights))


@pytest.mark.parametrize("name", ["bumpy", "stairs"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_init_sim_state_on_terrain(terrains, name, dtype):
    """The base is raised by the highest ground under the shoulders."""
    tdt = torch.float32 if dtype == jnp.float32 else torch.float64
    want = jphys.init_sim_state(CFG, terrain=terrains[name][1], dtype=dtype)
    got = tphys.init_sim_state(CFG, terrain=terrains[name][0], dtype=tdt)
    assert got.q.dtype == tdt
    np.testing.assert_array_equal(_np(got.q), np.asarray(want.q))


@pytest.fixture(scope="module")
def rollout(terrains):
    """6 ticks of step_lane on a FleetTerrain (flat, bumpy, stairs), in
    float64, the robots settled onto their terrain and walked over its
    relief by seeded base velocities."""
    rng = np.random.default_rng(6)
    tid = np.array([0, 1, 2], np.int32)
    jf = jter.FleetTerrain(
        tid=jnp.asarray(tid),
        terrains=tuple(jter.Terrain(*[jnp.asarray(a, jnp.float64)
                                      for a in terrains[n][1]])
                       for n in ("bumpy", "stairs")))
    tf = convert.to_torch(jax.tree.map(np.asarray, jf))
    ss = jphys.init_sim_state(CFG, dtype=jnp.float64)
    ss = jax.tree.map(lambda a: np.broadcast_to(
        np.asarray(a), (B,) + np.shape(a)).copy(), ss)
    ss.q[:, 0:2] = [[0.3, 0.2], [1.1, -0.7], [-1.5, 0.3]]   # on relief
    ground = np.asarray(jter.height_at(jf, jnp.asarray(
        ss.q[None, :, 0:2])))[0]
    ss.q[:, 2] += ground - 0.004                 # feet start in the ground
    ss.q[:, 7:] += rng.normal(scale=0.05, size=(B, 12))
    ss.v[:, 0:6] += rng.normal(scale=0.2, size=(B, 6))
    jlane, tlane = jrl.solo12_lane(), trl.solo12_lane()
    jstep = jax.jit(lambda s, *a: jpl.step_lane(CFG, jlane, s, *a,
                                                terrain=jf))
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
                            f_ext=torch.as_tensor(ctrl[5]), terrain=tf)
        recs.append((got, want))
        ss = want[0]
    return recs


@pytest.mark.parametrize("part", ["state", "device"])
def test_step_lane_on_fleet_terrain(rollout, part):
    """Feet touch the bumpy and stairs ground at its own height (their
    anchors and contact flags follow it) in both packages."""
    i = 0 if part == "state" else 1
    touched = False
    for got, want in rollout:
        g, w = convert.to_numpy(got[i], like=want[i]), want[i]
        for name in w._fields:
            a, b = getattr(g, name), getattr(w, name)
            if b is None:
                continue
            if b.dtype == bool:
                np.testing.assert_array_equal(a, b, err_msg=name)
                touched |= bool(b.any())
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                           err_msg=name)
    assert touched or part == "device"
