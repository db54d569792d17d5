"""Entry points of the processes that the port's tests spawn.

A spawned child imports the module of its target. These targets live
here, apart from the test files, so that a child imports torch and the
port only: no JAX, no qrw_tpu, no test module."""

import os
import time

import numpy as np

MESH_B = 4          # robots of the sharded rollout
MESH_TICKS = 20     # its ticks (two MPC solves)
SWEEP_GRID = (np.array([0.0, 0.3]), np.array([0.0, 0.4]))   # 2 x 2 cells
SWEEP_TICKS = 20


def ipc_writer(name: str):
    """Publish 0.0 ... 4.0 (8-vectors) into an existing mailbox."""
    from qrw_tpu_torch.runtime.ipc import Mailbox
    box = Mailbox(name, (8,), create=False)
    try:
        for i in range(5):
            box.write(np.full(8, float(i)))
            time.sleep(0.01)
    finally:
        box.close()


def mesh_workload(mesh=None) -> dict:
    """The mesh tests' work, sharded over `mesh` or (None) unsharded: a
    float64 rollout of MESH_B perturbed robots for MESH_TICKS ticks,
    scenario_metrics over seeded flags and counts, and a 2 x 2
    run_sweep. Returns numpy arrays by name."""
    import torch

    from qrw_tpu_torch.config import Config
    from qrw_tpu_torch.convert import tree_map
    from qrw_tpu_torch.eval.speed_sweep import run_sweep
    from qrw_tpu_torch.parallel.mesh import scenario_metrics, sharded_vmap
    from qrw_tpu_torch.sim.rollout import make_rollout, rollout

    cfg = Config()
    f64 = torch.float64
    ctl, carry = make_rollout(cfg, dtype=f64, device="cpu")
    carry = tree_map(lambda a: a.expand((MESH_B,) + tuple(a.shape)).clone(),
                     carry)
    rng = np.random.default_rng(0)
    q = carry.sim_state.q.clone()
    q[:, 7:] += torch.as_tensor(rng.normal(scale=0.01, size=(MESH_B, 12)))
    carry = carry._replace(sim_state=carry.sim_state._replace(q=q))
    run = lambda c: rollout(ctl, c, MESH_TICKS)
    if mesh is not None:
        run = sharded_vmap(run, mesh)
    out, logs = run(carry)

    errors = torch.as_tensor(rng.random(8) < 0.3)
    iters = torch.as_tensor(rng.integers(25, 400, size=8), dtype=torch.int32)
    m = scenario_metrics(errors, iters, mesh)
    sw = run_sweep(cfg, vx_grid=SWEEP_GRID[0], wyaw_grid=SWEEP_GRID[1],
                   n_ticks=SWEEP_TICKS, ramp_ticks=10, dtype=f64,
                   device="cpu", mesh=mesh)
    return dict(q=out.sim_state.q.numpy(), v=out.sim_state.v.numpy(),
                tau_ff=logs.tau_ff.numpy(), base_pos=logs.base_pos.numpy(),
                error=logs.error.numpy(), errors=errors.numpy(),
                iters=iters.numpy(),
                **{k: v.cpu().numpy() for k, v in m.items()},
                success=sw.success, vx_err=sw.vx_err, h_err=sw.h_err)


def mesh_rank(rank: int, world: int, port: int, out: str):
    """One rank of a gloo mesh over CPU processes, started as torchrun
    would start it; rank 0 saves mesh_workload's result to `out`."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch

    from qrw_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.world_size) == (rank, world)
        res = mesh_workload(mesh)
        if rank == 0:
            np.savez(out, **res)
    finally:
        mesh.close()
