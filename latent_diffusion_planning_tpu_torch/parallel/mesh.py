"""Ranks, process groups and the data-parallel and env-sharding rules.

Counterpart of ``latent_diffusion_planning_tpu/parallel/mesh.py``. JAX
builds a named device mesh and lets ``jit`` insert the gradient all-reduce
when the batch is sharded and the parameters replicated. Here each rank is
one process (started by ``torchrun``) that drives one device, and the rules
are explicit:

- ``maybe_init_distributed`` joins the process group that ``torchrun``'s
  variables describe (NCCL on the card, gloo on the CPU); without them it
  does nothing, so a single-process run never touches ``torch.distributed``;
- ``make_mesh`` lays the ranks out as a ``dp`` × ``env`` grid (row-major,
  as ``__graft_entry__.dryrun_multichip`` reshapes its devices) with the
  process group of this rank's ``dp`` column: training shards its batch
  over ``dp`` (and repeats it along ``env``); the rollout engine shards
  episodes over every rank, as JAX's ``shard_map`` over all the mesh's
  axes does (``make_env_mesh``);
- ``shard_batch`` takes a rank's rows of a global batch, ``replicate``
  broadcasts an agent's full train state from rank 0 and hands each of its
  train states the ``dp`` group, over which ``TrainState.apply_gradients``
  averages the gradients before it clips them;
- ``sharded_draws`` makes the training losses draw their timesteps and
  noise for the global batch and keep this rank's rows, so a W-rank step
  equals the one-process step on the global batch up to the all-reduce's
  summation order.

JAX's ``batch_sharding`` and ``replicated`` return ``NamedSharding``
objects that ``device_put`` applies. Torch has no counterpart: a tensor
lives on one device, and what it holds on each rank is what this module's
functions put there. They are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist

DP_AXIS = "dp"
ENV_AXIS = "env"


def maybe_init_distributed(backend: str | None = None) -> bool:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); NCCL
    when CUDA is there (each rank on device ``LOCAL_RANK``), else gloo, or
    ``backend``. A no-op returning False when those variables are absent or
    the group exists already."""
    if dist.is_initialized():
        return False
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR")):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://")
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``dp`` × ``env`` grid of ranks: ``rank`` sits at row ``rank //
    env``, column ``rank % env``. ``dp_group`` holds the ranks of this
    rank's column (the same env coordinate, different batch rows); None
    without a process group."""

    dp: int
    env: int
    rank: int = 0
    dp_group: Any = None

    @property
    def world(self) -> int:
        return self.dp * self.env

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.dp, ENV_AXIS: self.env}

    @property
    def dp_rank(self) -> int:
        return self.rank // self.env

    @property
    def env_rank(self) -> int:
        return self.rank % self.env

    def axis_rank(self, axis: str) -> int:
        return self.dp_rank if axis == DP_AXIS else self.env_rank

    @property
    def distributed(self) -> bool:
        return dist.is_initialized()


def make_mesh(dp: int | None = None, env: int = 1) -> Mesh:
    """The ranks as a ``dp`` × ``env`` grid (``dp`` defaults to the world
    size over ``env``; ``dp · env`` must be the world size). Every rank
    makes every column's group, in one order, as
    ``torch.distributed.new_group`` requires."""
    if not dist.is_initialized():
        if (dp or 1) * env != 1:
            raise ValueError(f"a {dp} x {env} mesh needs a process group of "
                             f"that size; none is initialized")
        return Mesh(1, 1)
    world, rank = dist.get_world_size(), dist.get_rank()
    dp = dp or world // env
    if dp * env != world:
        raise ValueError(f"mesh {dp} x {env} does not cover {world} ranks")
    columns = [dist.new_group([r * env + c for r in range(dp)])
               for c in range(env)]
    return Mesh(dp, env, rank, columns[rank % env])


def make_env_mesh() -> Mesh:
    """Every rank on the rollout ``env`` axis."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(dp=1, env=world)


def local_batch_slice(global_batch: int, mesh: Mesh,
                      axis: str = DP_AXIS) -> int:
    """Rows of a global batch each rank of ``axis`` holds."""
    size = mesh.shape[axis]
    if global_batch % size:
        raise ValueError(f"batch {global_batch} is not divisible by mesh "
                         f"axis {axis}={size}")
    return global_batch // size


def shard_batch(batch: Any, mesh: Mesh, axis: str = DP_AXIS) -> Any:
    """This rank's rows of dim 0 of every tensor of a (nested) batch; each
    leading dim must divide by the axis size (the JAX function's assert)."""
    size, r = mesh.shape[axis], mesh.axis_rank(axis)

    def take(x):
        if isinstance(x, Mapping):
            return {k: take(v) for k, v in x.items()}
        n = local_batch_slice(x.shape[0], mesh, axis)
        return x[r * n:(r + 1) * n]

    return batch if size == 1 else take(batch)


def _staged(fn: Callable, t: torch.Tensor, group) -> None:
    """Run collective ``fn`` on ``t`` in place; gloo takes the host copy of
    a CUDA tensor."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        fn(host, group=group)
        t.copy_(host)
    else:
        fn(t, group=group)


def all_reduce_mean_(tensors: list[torch.Tensor], group) -> None:
    """Average ``tensors`` over ``group`` in place: one flat all-reduce of
    the concatenated values, divided by the group's size."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _staged(dist.all_reduce, flat, group)
    flat /= dist.get_world_size(group)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def _train_states(agent) -> list:
    from ..train.state import TrainState
    out = []
    for value in vars(agent).values():
        if isinstance(value, TrainState):
            out.append(value)
        elif isinstance(value, Mapping):
            out += [v for v in value.values() if isinstance(v, TrainState)]
    return out


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@torch.no_grad()
def replicate(agent, mesh: Mesh):
    """Broadcast every tensor of ``agent.state_dict()`` (parameters, Adam
    moments, EMA copies, the VAE) from rank 0 and give each of the agent's
    train states ``mesh.dp_group``; returns the agent. Without a process
    group the agent is returned as it is."""
    if not mesh.distributed:
        return agent
    for t in _tensors(agent.state_dict()):
        _staged(lambda x, group: dist.broadcast(x, src=0, group=group), t,
                None)
    for state in _train_states(agent):
        state.dp_group = mesh.dp_group
    agent.weights_changed()
    return agent


def all_gather_host(obj: Any, mesh: Mesh) -> list:
    """Every rank's ``obj`` (host values: numpy arrays, numbers), in rank
    order, on every rank."""
    if not mesh.distributed:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out


# -- the losses' draws under data parallelism --------------------------------

_DRAW_SHARD: tuple[int, int] | None = None


@contextlib.contextmanager
def sharded_draws(mesh: Mesh | None):
    """Inside, ``draw_rows`` draws for ``mesh.dp`` times the rows asked and
    keeps this rank's: the draws of the global batch, sliced as
    ``shard_batch`` slices the batch."""
    global _DRAW_SHARD
    before = _DRAW_SHARD
    _DRAW_SHARD = (None if mesh is None or mesh.dp == 1
                   else (mesh.dp_rank, mesh.dp))
    try:
        yield
    finally:
        _DRAW_SHARD = before


def draw_rows(draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """``draw(n)``, or inside ``sharded_draws`` rows [r·n, (r+1)·n) of
    ``draw(n · dp)``: ``draw`` makes a tensor whose leading dim is its
    argument, its rows in batch order."""
    if _DRAW_SHARD is None:
        return draw(n)
    r, world = _DRAW_SHARD
    return draw(n * world)[r * n:(r + 1) * n]
