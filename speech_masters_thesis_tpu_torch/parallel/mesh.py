"""Data parallelism over ``torch.distributed`` (counterpart of
speech_masters_thesis_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a 1-D ``data`` mesh: the batch
is split over the devices, the state replicated, and XLA reduces the loss,
the gradients and the codebook statistics over the whole **global** batch.
The port runs one process (a rank) per GPU, each holding the whole
replicated state and its rows of the global batch, and keeps those
semantics with explicit collectives:

* ``initialize`` joins the process group (TCP rendezvous, NCCL on the card,
  gloo on the CPU) and runs one trivial all-reduce right away, as
  ``initialize_multihost`` does, so the first real collective does not meet
  the ranks' start-up skew;
* ``shard_batch`` takes this rank's rows of the global batch that every
  rank loads (``shard_batch`` / ``make_array_from_process_local_data``);
* ``broadcast_module`` copies rank 0's parameters and buffers to every rank
  (``place_replicated``); ``barrier`` waits for every rank;
* the losses divide by global denominators (``global_sum``), a per-row mean
  enters as this rank's share of the global mean (``local_share``), and the
  train step adds the ranks' gradients (``all_reduce_grads``), so the
  n-rank step is the 1-process step on the global batch;
* the codebook adds its batch statistics over the ranks and draws its lazy
  init and its revivals from every rank's rows in global-batch order
  (``gather_rows``) with a generator that is the same on every rank;
* ``mix_seed`` gives each rank its own kernel dropout seeds, as the JAX
  kernels' ``shard_map`` wrappers mix in ``axis_index``.

Only ``all_reduce`` and ``broadcast`` are used (the gather is an all-reduce
of zero-padded rows), the two collectives gloo has for CUDA tensors as well
as NCCL. Outside a process group every helper is the identity, so a
one-process run is the same computation, bit for bit; ``local()`` turns the
group off for a block that each rank runs alone on the whole batch (the
data-dependent init).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import socket
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

logger = logging.getLogger(__name__)

# the JAX kernels' per-shard seed mix: bits + axis_index * 1640531527 in int32
KERNEL_SEED_MIX = 1640531527
# how long a collective waits for the slowest rank before the group fails
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass
class _Group:
    world: int
    rank: int
    device: torch.device
    local_depth: int = 0


_GROUP: Optional[_Group] = None


def free_port() -> int:
    """A free TCP port on localhost, for a run's own rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator: str, world_size: int, rank: int, device: torch.device,
               backend: Optional[str] = None) -> None:
    """Joins the process group at ``coordinator`` (``host:port``, the JAX
    CLI's form, or ``tcp://host:port``): NCCL on a CUDA device and gloo on
    the CPU unless ``backend`` says otherwise; then one all-reduce of ones,
    checked."""
    global _GROUP
    if _GROUP is not None:
        raise RuntimeError("the data-parallel process group is already set up")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=world_size, rank=rank, timeout=TIMEOUT)
    _GROUP = _Group(world_size, rank, device)
    total = torch.ones((), device=device)
    dist.all_reduce(total)
    if float(total) != float(world_size):
        raise RuntimeError(f"the first all-reduce over {world_size} ranks gave {float(total)}")
    logger.info("rank %d of %d joined the %s group at %s", rank, world_size, backend, url)


def shutdown() -> None:
    """Leaves the process group (a no-op without one)."""
    global _GROUP
    if _GROUP is not None:
        _GROUP = None
        dist.destroy_process_group()


def active() -> bool:
    """Whether collectives run: a group is set up and no ``local()`` block is open."""
    return _GROUP is not None and _GROUP.local_depth == 0


def world_size() -> int:
    return _GROUP.world if active() else 1


def rank() -> int:
    return _GROUP.rank if active() else 0


@contextlib.contextmanager
def local() -> Iterator[None]:
    """Each rank alone for the block: no collectives, rank 0's seeds, the whole batch."""
    if _GROUP is None:
        yield
        return
    _GROUP.local_depth += 1
    try:
        yield
    finally:
        _GROUP.local_depth -= 1


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (no gradient); ``t`` itself outside a group."""
    if not active():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def global_sum_through(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks in value, with the gradient of this rank's ``t``
    (for a loss that is a nonlinear function of a global statistic)."""
    if not active():
        return t
    return t + (global_sum(t) - t).detach()


def local_share(x):
    """A mean over this rank's rows as its share of the global batch's mean
    (every rank holds as many rows): x / world."""
    n = world_size()
    return x if n == 1 else x / n


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over every rank's elements (a metric; no gradient)."""
    if world_size() == 1:
        return torch.mean(t)
    return global_sum(torch.sum(t)) / (t.numel() * world_size())


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` [N, ...] in rank order, the global batch's
    order: an all-reduce of this rank's rows at their offset in zeros."""
    if not active():
        return x
    n = x.shape[0]
    out = x.new_zeros((world_size() * n, *x.shape[1:]))
    out[rank() * n:(rank() + 1) * n] = x.detach()
    dist.all_reduce(out)
    return out


def sum_losses(scalars: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The step's scalars with every ``*loss*`` entry added over the ranks
    (each rank returns its share of the global loss), in one all-reduce."""
    out = dict(scalars)
    keys = [k for k, v in scalars.items() if "loss" in k and torch.is_tensor(v) and v.ndim == 0]
    if not active() or not keys:
        return out
    summed = global_sum(torch.stack([scalars[k].detach().to(torch.float32) for k in keys]))
    for i, k in enumerate(keys):
        out[k] = summed[i].to(scalars[k].dtype)
    return out


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Adds every parameter's gradient over the ranks, in place: one
    all-reduce of the flattened gradients per dtype."""
    if not active():
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def broadcast_module(module: nn.Module) -> None:
    """Rank 0's parameters and buffers, in place on every rank."""
    if not active():
        return
    for t in [*module.parameters(), *module.buffers()]:
        if t.dtype == torch.bool:
            as_bytes = t.to(torch.uint8)
            dist.broadcast(as_bytes, src=0)
            t.copy_(as_bytes.bool())
        else:
            dist.broadcast(t.data, src=0)


def barrier() -> None:
    """Waits for every rank (an all-reduce, which every backend has)."""
    if active():
        float(global_sum(torch.zeros((), device=_GROUP.device)))


def shard_batch(batch: Mapping):
    """This rank's rows of a global batch (numpy arrays or tensors; None
    entries pass through); the batch must divide over the ranks."""
    n = world_size()
    if n == 1:
        return batch
    out = {}
    for key, value in batch.items():
        if value is None:
            out[key] = None
            continue
        rows, rem = divmod(value.shape[0], n)
        if rem:
            raise ValueError(f"the global batch's {key} has {value.shape[0]} rows, which do not divide over {n} ranks")
        out[key] = value[rank() * rows:(rank() + 1) * rows]
    return out


def mix_seed(seed):
    """A kernel dropout seed (an int or an int64 tensor of uint32 values) for
    this rank: (seed + rank * 1640531527) mod 2^32, the JAX kernels' int32
    mix; rank 0 keeps the seed."""
    r = rank()
    if r == 0:
        return seed
    return (seed + r * KERNEL_SEED_MIX) % 2 ** 32
