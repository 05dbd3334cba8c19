"""Data parallelism over processes: one process a device, under torchrun.

Port of mixofshow_tpu/parallel/mesh.py. The JAX package shards the leading
batch axis of one program over the mesh's 'data' axis and XLA inserts the
reductions. The port runs one process a device, started by `torchrun
--nproc_per_node N`, each with the whole model and its rows of the global
batch, and the reductions are explicit collectives:

  * `make_mesh(device)` reads torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and joins the process group: NCCL
    on `cuda` (device `cuda:LOCAL_RANK`), gloo on `cpu`. Neither backend is
    substituted for the other. Without torchrun's environment it is one
    process with no group;
  * `shard_batch(mesh, batch)` keeps this rank's rows of a global batch:
    rank r takes rows [r·b, (r+1)·b), which is what JAX's `shard_batch`
    puts on device r of the 'data' axis;
  * `all_sum` and `all_max` are differentiable reductions over the ranks
    (the backward of a sum is a sum of the ranks' gradients; that of a max
    reaches the rank that holds it); `reduce_grads` sums gradients;
  * state is replicated by construction (every rank builds it from the same
    seed and applies the same summed gradients); `replicate_` copies rank
    0's tensors to every rank where a caller wants that guaranteed.

The JAX mesh's second axis, 'model', has no counterpart: nothing in the JAX
package shards over it outside one test.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from mixofshow_tpu_torch.utils.device import as_device, require_cuda

BACKENDS = {'cuda': 'nccl', 'cpu': 'gloo'}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group. `group` is None for
    one process started without torchrun."""
    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def make_mesh(device) -> Mesh:
    """The data-parallel group of this process on `device` ('cuda' or
    'cpu'). Under torchrun (WORLD_SIZE set) the process group is
    initialized here with NCCL on the card or gloo on the CPU, the card
    being `cuda:LOCAL_RANK`. A `cuda` device without a visible card raises."""
    device = as_device(device)
    if device.type not in BACKENDS:
        raise ValueError(f'data parallelism runs on cuda or cpu, not '
                         f'{device.type}')
    if device.type == 'cuda':
        require_cuda()
    if 'WORLD_SIZE' not in os.environ:
        return Mesh(0, 1, device)
    env = os.environ
    rank, world = int(env['RANK']), int(env['WORLD_SIZE'])
    kw = {}
    if device.type == 'cuda':
        device = torch.device('cuda', int(env.get('LOCAL_RANK', '0')))
        torch.cuda.set_device(device)
        kw['device_id'] = device
    if not dist.is_initialized():
        dist.init_process_group(
            BACKENDS[device.type],
            init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            world_size=world, rank=rank, **kw)
    if dist.get_backend() != BACKENDS[device.type]:
        raise RuntimeError(f'the process group runs {dist.get_backend()}, '
                           f'not {BACKENDS[device.type]} for {device}')
    return Mesh(rank, world, device, dist.group.WORLD)


def close_mesh(mesh: Mesh) -> None:
    """Leave the process group `make_mesh` joined (no-op without one)."""
    if mesh.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(mesh: Optional[Mesh], batch: Dict) -> Dict:
    """This rank's rows of every entry of a global batch (numpy arrays,
    tensors or lists with the batch as the leading axis); the batch itself
    for one process."""
    if mesh is None or mesh.world == 1:
        return batch
    out = {}
    for key, val in batch.items():
        n = len(val)
        if n % mesh.world:
            raise ValueError(f'batch entry {key!r} has {n} rows, not a '
                             f'multiple of the world size {mesh.world}')
        b = n // mesh.world
        out[key] = val[mesh.rank * b:(mesh.rank + 1) * b]
    return out


def all_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Σ over the ranks, differentiable (the backward sums the ranks'
    gradients of the result); `x` itself with no process group."""
    if mesh is None or mesh.group is None:
        return x
    return dist_fn.all_reduce(x, group=mesh.group)


def all_max(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """max over the ranks of a scalar, differentiable: the ranks' values
    are gathered (all_gather with autograd) and reduced, so the gradient
    reaches the rank that holds the maximum."""
    if mesh is None or mesh.group is None:
        return x
    return torch.stack(dist_fn.all_gather(x, group=mesh.group)).max()


def reduce_grads(params: Iterable[torch.Tensor], mesh: Optional[Mesh]):
    """Sum the `.grad` of `params` over the ranks in place, as one flat
    buffer (one collective)."""
    if mesh is None or mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def replicate_(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh]):
    """Copy rank 0's values of `tensors` to every rank, in place."""
    if mesh is None or mesh.group is None:
        return
    for t in tensors:
        dist.broadcast(t, 0, group=mesh.group)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's `obj` (picklable) on every rank."""
    if mesh is None or mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0, group=mesh.group)
    return box[0]


__all__ = ['BACKENDS', 'Mesh', 'all_max', 'all_sum', 'barrier',
           'broadcast_object', 'close_mesh', 'make_mesh', 'reduce_grads',
           'replicate_', 'shard_batch']
