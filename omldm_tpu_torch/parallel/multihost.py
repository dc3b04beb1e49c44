"""The multi-process fleet's process group and its collectives.

Counterpart of ``omldm_tpu/parallel/multihost.py``. The JAX package joins
``jax.distributed`` and lays one global mesh over every process's devices;
its collectives are XLA programs. The port joins one ``torch.distributed``
process group and keeps the fleet as the SPMD engine keeps it in one
process -- workers as the leading axis of every state tensor -- with each
process holding ``dp_local`` rows of a ``dp_global``-wide fleet
(``parallel.mesh.Mesh``). A reduction across workers is then a local
reduction over the process's rows plus one group collective (``all_reduce``
here), and the control plane's frames are group broadcasts.

- :func:`initialize_multihost` -- join the group at a ``tcp://``
  coordinator, under the shared backoff helper; with no arguments the
  single-process ``(0, 1)``, no group formed.
- :func:`choose_backend` -- the backend rule, a pure function: gloo on the
  CPU and for processes that share a card, NCCL when each process has a
  card of its own (NCCL refuses two ranks on one device).
- :func:`all_reduce`, :func:`broadcast`, :func:`all_gather`,
  :func:`ring_shift` (send to the next process of a group, receive from the
  previous one) and :func:`all_to_all` (the JAX ``all_to_all`` with
  ``tiled=True``) -- the fabric.
  Each passes its operand through :func:`on_backend_device`, the one stated
  route between a tensor's device and the backend's: gloo takes host
  tensors, so a CUDA operand is copied to the host and back on every call;
  NCCL takes card tensors, so a host operand (a control frame) goes to the
  card and back.
- :class:`EnterGroup`, :class:`SumOverGroup`, :class:`MeanOverGroup`,
  :class:`AllToAll` -- the collectives a sharded model differentiates
  through (``torch.autograd.Function``s): Megatron's conjugate pair (the
  identity forward with an all-reduce backward, and the all-reduce forward
  with the identity backward), a mean whose backward divides as its forward
  does, and an ``all_to_all`` whose backward is its inverse.
- :func:`make_multihost_mesh`, :func:`host_local_array` -- the
  dp-across-processes layout under the JAX package's names.

Each process of a CUDA fleet takes card ``pid % torch.cuda.device_count()``
(:func:`process_device`), set before anything is allocated on it.
"""

from __future__ import annotations

import datetime
import sys
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from omldm_tpu_torch.parallel.mesh import Mesh, device_slots
from omldm_tpu_torch.utils.backoff import BackoffPolicy, with_backoff
from omldm_tpu_torch.utils.device import resolve_device


def choose_backend(device_type: str, processes: int, cards: int) -> str:
    """The fleet's backend: ``"gloo"`` on the CPU; on CUDA ``"nccl"`` when
    each of the host's ``processes`` has a card of its own (``cards >=
    processes``), else ``"gloo"``: processes that share a card cannot use
    NCCL, which refuses two ranks on one device."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if cards >= processes else "gloo"


def process_device(device, process_id: int) -> torch.device:
    """This process's device: the CPU as asked, or card ``process_id %
    device_count`` made the current card (before any allocation on it)."""
    device = resolve_device(device, "process_device")
    if device.type != "cuda":
        return device
    index = process_id % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    connect_attempts: int = 3,
    connect_timeout_s: Optional[float] = None,
    device=None,
) -> Tuple[int, int]:
    """Join the fleet's process group; returns ``(process_id,
    process_count)``.

    With explicit arguments the group is joined at ``tcp://<coordinator>``
    with the backend of :func:`choose_backend` (printed on stderr), retried
    ``connect_attempts`` times under the shared backoff helper; a
    ``connect_timeout_s`` bounds the whole join and gives each attempt its
    share, so a worker launched a beat before its coordinator is up does not
    die. A join that still fails raises: it never carries on as a single
    process. With no arguments no group is formed and the result is ``(0,
    1)``, or the rank and size of a group already joined."""
    if coordinator_address is None and num_processes is None:
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a fleet join needs the coordinator, the process count and the "
                         "process id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    device = resolve_device(device, "initialize_multihost")
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = choose_backend(device.type, num_processes, cards)
    kwargs = {}
    if connect_timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(
            seconds=max(connect_timeout_s / max(connect_attempts, 1), 1.0))

    def join():
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kwargs)

    with_backoff(
        join,
        policy=BackoffPolicy(attempts=connect_attempts, base_delay=0.5, growth=2.0,
                             jitter=0.25, timeout=connect_timeout_s),
        retry_on=(RuntimeError, OSError),
    )
    print(f"[multihost p{process_id}] joined {num_processes} processes at "
          f"{coordinator_address} over {backend}", file=sys.stderr)
    return dist.get_rank(), dist.get_world_size()


def shutdown_multihost() -> None:
    """Leave the group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# --- the fabric ---

#: group collectives this process has entered (every fabric call counts one;
#: a caller sets it to 0 and reads it back to count the calls of a run)
group_calls = 0
#: bytes of the operands this process has handed to the fabric (as
#: ``group_calls``: set to 0 and read back)
group_bytes = 0


def _backend_device(group=None) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def on_backend_device(tensor: torch.Tensor, op, group=None) -> torch.Tensor:
    """Run the collective ``op`` on ``tensor`` where the backend takes it.
    The stated route between devices: a gloo group works on host tensors,
    so a CUDA operand is copied to the host and its result back, on every
    call; an NCCL group works on card tensors, so a host operand (a control
    frame, a counter vector) goes to the card and back. ``op`` works in
    place and returns None, or returns a new tensor; the result comes back
    on ``tensor``'s device (in place, for an in-place ``op``)."""
    global group_calls, group_bytes
    group_calls += 1
    group_bytes += tensor.numel() * tensor.element_size()
    where = _backend_device(group)
    moved = tensor.contiguous()
    if moved.device != where:
        moved = moved.to(where)
    out = op(moved)
    if out is None:
        if moved.data_ptr() != tensor.data_ptr():
            tensor.copy_(moved)
        return tensor
    return out.to(tensor.device)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(tensor: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``tensor`` (contiguous) reduced elementwise over every process
    (``"sum"``, ``"max"`` or ``"min"``), in place; identical on every
    process."""
    red = _REDUCE_OPS[op]

    def reduce(t):
        dist.all_reduce(t, op=red, group=group)

    return on_backend_device(tensor, reduce, group)


def broadcast(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Process ``src``'s ``tensor`` (contiguous) on every process, in
    place."""

    def bcast(t):
        dist.broadcast(t, src=src, group=group)

    return on_backend_device(tensor, bcast, group)


def all_gather(tensor: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every process's ``tensor`` (equal shapes), concatenated along ``dim``
    in process order."""
    n = dist.get_world_size(group)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts)

    out = on_backend_device(tensor.movedim(dim, 0), gather, group)
    return out.movedim(0, dim)


def ring_shift(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` sent to the next process of ``group`` (rank ``r + 1`` mod
    its size) while the previous one's is received: the JAX ``ppermute``
    over the ring ``[(j, j + 1 mod n)]``. Returns the received tensor."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    send_to = dist.get_global_rank(group, (rank + 1) % n) if group is not None else (rank + 1) % n
    recv_from = dist.get_global_rank(group, (rank - 1) % n) if group is not None else (rank - 1) % n

    def shift(t):
        received = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, send_to, group=group),
               dist.P2POp(dist.irecv, received, recv_from, group=group)]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        return received

    return on_backend_device(tensor, shift, group)


def all_to_all(tensor: torch.Tensor, split_dim: int, concat_dim: int,
               group=None) -> torch.Tensor:
    """The JAX ``all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``tensor`` is cut into ``n`` equal blocks along ``split_dim``, block
    ``i`` goes to process ``i`` of ``group``, and the blocks received are
    concatenated along ``concat_dim`` in process order."""
    n = dist.get_world_size(group)
    if tensor.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of {tuple(tensor.shape)} does "
                         f"not split into {n} blocks")
    blocks = tensor.movedim(split_dim, 0)
    blocks = blocks.reshape(n, blocks.shape[0] // n, *blocks.shape[1:])

    def exchange(t):
        received = torch.empty_like(t)
        dist.all_to_all_single(received, t, group=group)
        return received

    received = on_backend_device(blocks, exchange, group)
    return torch.cat([b.movedim(0, split_dim) for b in received.unbind(0)], dim=concat_dim)


# --- the collectives a sharded model differentiates through ---


class EnterGroup(torch.autograd.Function):
    """Megatron's ``f``: the identity forward and an all-reduce of the
    gradient over ``group``, where a replicated activation enters a block
    whose weights are split over the group (each process's gradient is
    then a part of the whole)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), group=ctx.group), None


class SumOverGroup(torch.autograd.Function):
    """Megatron's ``g``: the sum over ``group`` forward (every process gets
    the same value) and the identity backward -- the JAX ``psum``, whose
    transpose hands every process the cotangent of its own part."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class MeanOverGroup(torch.autograd.Function):
    """The JAX ``pmean`` over ``group``: the mean forward and, since every
    process holds the same cotangent downstream of it, its backward divides
    by the group's size as the forward did."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce(x.clone(memory_format=torch.contiguous_format), group=group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all`, differentiable: its backward is the inverse
    exchange (the split and concatenated dimensions swapped)."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims = (split_dim, concat_dim, group)
        return all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group = ctx.dims
        return all_to_all(g, concat_dim, split_dim, group), None, None, None


# --- the dp-across-processes layout ---


def make_multihost_mesh(device=None) -> Mesh:
    """The fleet's ("dp", "hub") mesh: ``dp_local`` workers a process, the
    process's slots over the processes and at least 1 (one card shared by
    two processes gives each one worker), ``dp_global = dp_local *
    processes``. In one process, ``parallel.mesh.make_mesh``'s mesh."""
    device = resolve_device(device, "make_multihost_mesh")
    pid, nproc = initialize_multihost()
    dp_local = max(device_slots(device) // nproc, 1)
    return Mesh(dp_local * nproc, 1, device, processes=nproc, process_id=pid)


def host_local_array(local_rows, mesh: Mesh, dtype=None) -> torch.Tensor:
    """This process's rows of a fleet-wide batch on the mesh's device: the
    identity on the ``[dp_local, ...]`` rows it was given (the JAX package
    assembles one global array from them; the port's step takes each
    process's rows as they are)."""
    t = local_rows if isinstance(local_rows, torch.Tensor) else torch.as_tensor(local_rows)
    if t.shape[0] != mesh.dp_local:
        raise ValueError(f"local rows of shape {tuple(t.shape)} are not [dp_local="
                         f"{mesh.dp_local}, ...]")
    return t.to(mesh.device) if dtype is None else t.to(mesh.device, dtype)
