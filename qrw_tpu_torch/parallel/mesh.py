"""Scenario-parallel execution over GPUs: one process per card.

Port of qrw_tpu/parallel/mesh.py. The JAX package splits a scenario
axis over a 1-D "dp" device mesh with shard_map and reduces
cross-scenario metrics with psum / pmax. Here the mesh is a
torch.distributed process group with one process per GPU:

  * under `torchrun` (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT in the environment) rank r drives `cuda:{LOCAL_RANK}`;
  * without it, the mesh is the one process on the one card, a group of
    world size 1 (initialized at tcp://localhost on a free port);
  * the backend is NCCL on the card and gloo on the CPU.

Every rank holds the whole batch, as every JAX program sees the global
array. `shard_batch` takes the rank's slice of each leaf's leading axis
(the batch must divide by the world size, as in qrw_tpu);
`sharded_vmap(fn, mesh)` runs `fn` on the rank's slice and all-gathers
the outputs, so every rank gets the same result as the unsharded call.
The port's functions broadcast over leading axes, so `fn` takes the
batch axis itself (the JAX package vmaps a per-scenario function).
Scenarios are independent: no collective runs inside `fn`.
`scenario_metrics` all-reduces: SUM / world size for the means, MAX for
the largest iteration count.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from qrw_tpu_torch.convert import tree_map
from qrw_tpu_torch.sim.fleet import _check_device


class Mesh:
    """A 1-D data-parallel mesh: this process's rank, the world size and
    the device this rank drives. `close()` destroys the process group
    if this mesh created it."""

    def __init__(self, rank: int, world_size: int, device: torch.device,
                 axis: str, owner: bool):
        self.rank, self.world_size = rank, world_size
        self.device, self.axis = device, axis
        self._owner = owner

    def close(self):
        if self._owner and dist.is_initialized():
            dist.destroy_process_group()
        self._owner = False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              device="cuda") -> Mesh:
    """The process group over the GPUs (`device` "cuda"; "cpu" runs
    gloo over CPU processes). n_devices, when given, must equal the
    world size: the launcher sets it, one process per card."""
    dev = _check_device(device)
    cuda = dev.type == "cuda"
    owner = not dist.is_initialized()
    if owner:
        backend = "nccl" if cuda else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                rank=0, world_size=1)
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"mesh of {n_devices} devices asked for in a "
                         f"world of {world} processes")
    if cuda:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return Mesh(rank, world, dev, axis, owner)


def shard_batch(tree, mesh: Mesh, axis: str = "dp"):
    """The rank's slice of every leaf's leading (scenario) axis, on the
    rank's device."""
    def one(a):
        B = a.shape[0]
        if B % mesh.world_size:
            raise ValueError(f"batch {B} does not divide over "
                             f"{mesh.world_size} processes")
        n = B // mesh.world_size
        return a[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)
    return tree_map(one, tree)


def _all_gather(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Concatenate every rank's `a` along the leading axis (a collective
    at any world size, so that a mesh of one card runs NCCL too)."""
    x = a.contiguous()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x)
    return torch.cat(parts).to(a.dtype)


def sharded_vmap(fn, mesh: Mesh, axis: str = "dp"):
    """`fn` over the leading scenario axis, sharded over `mesh`.

    `fn` maps batched trees to batched trees. The result takes the whole
    batch on every rank, runs `fn` on the rank's slice and returns the
    whole batch's outputs, all-gathered."""
    def sharded(*args):
        out = fn(*shard_batch(args, mesh, axis))
        return tree_map(lambda a: _all_gather(a, mesh), out)
    return sharded


def batched_mpc_solver(cfg, mesh: Optional[Mesh] = None, settings=None,
                       axis: str = "dp"):
    """Batched centroidal MPC solver, optionally sharded over a mesh.

    Returns fn(xref (B, 12, N+1), fsteps (B, N_gait, 12)) ->
    (x_f (B, 24, N), iters (B,)), each problem solved on its own
    (core/mpc.solve_mpc along the leading axis), B divisible by the
    world size when sharded."""
    from qrw_tpu_torch.core import mpc as mpc_mod

    def solve(xref, fsteps):
        res = mpc_mod.solve_mpc(cfg, xref, fsteps, settings=settings)
        return res.x_f_applied, res.iters

    return solve if mesh is None else sharded_vmap(solve, mesh, axis)


def scenario_metrics(errors, iters, mesh: Optional[Mesh] = None,
                     axis: str = "dp"):
    """Cross-scenario aggregation of (B,) error flags and iteration
    counts: the error rate, the mean and the largest iteration count.
    With a mesh each rank reduces its slice and the ranks all-reduce
    (SUM / world size for the means, MAX for max_iters); without, plain
    reductions."""
    def agg(e, i):
        return {"error_rate": e.to(torch.float32).mean(),
                "mean_iters": i.to(torch.float32).mean(),
                "max_iters": i.max()}

    if mesh is None:
        return agg(errors, iters)
    m = agg(*shard_batch((errors, iters), mesh, axis))
    for key, op in (("error_rate", dist.ReduceOp.SUM),
                    ("mean_iters", dist.ReduceOp.SUM),
                    ("max_iters", dist.ReduceOp.MAX)):
        dist.all_reduce(m[key], op=op)
    m["error_rate"] = m["error_rate"] / mesh.world_size
    m["mean_iters"] = m["mean_iters"] / mesh.world_size
    return m
