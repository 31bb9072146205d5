"""Process meshes and the collectives of the sharded layer.

The framework's two parallel axes (as in the JAX package):

* ``rows``  — row-partitioned operands and vectors (the halo-exchange DIA
  bank, SPIKE, the row-sharded CSR bank; Gram reductions psum over it);
* ``nodes`` — quadrature-node batching (independent shifted solves; one
  psum of the small moments).

The JAX package is one controller over a device mesh: a ``shard_map`` body
sees its block and calls ``jax.lax.{ppermute, all_gather, psum,
axis_index}``.  The port is SPMD over ``torch.distributed``: one process per
rank, every rank calls the same function with the same host inputs and holds
only its own block.  The collectives the JAX bodies write inline are the
methods of :class:`Mesh` (``rank``/``size`` for ``axis_index`` and
``mesh.shape[axis]``, ``psum``, ``all_gather``, ``neighbour_exchange`` for
the two chain ``ppermute``\\ s), over the process groups of a
``torch.distributed`` ``DeviceMesh`` with dims ``("rows", "nodes")``.

Backends are explicit: NCCL goes with a CUDA device and gloo with the CPU.
NCCL refuses two ranks on one GPU and gloo moves CUDA tensors only in
``broadcast``/``all_reduce``, so several ranks on ONE card is the caller's
choice of ``backend="gloo"`` with ``device="cuda"``: there every collective
copies its CUDA tensor to the host, runs on the host and copies the result
back (``Mesh.host_staged``), while all compute stays on the card.  Nothing
here picks gloo or the CPU on its own.

Not carried over from ``neptpu/parallel/mesh.py``: ``P`` and
``NamedSharding`` (``mesh.py:20``), re-exports of ``jax.sharding`` that
place a global array on a device mesh - an SPMD rank holds its block and
there is nothing to place; and the virtual-device mesh of the JAX tests
(``tests/conftest.py``), whose counterpart is a world of processes.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..config import resolve_device

__all__ = ["make_mesh", "initialize_distributed", "Mesh", "PendingExchange",
           "default_backend"]

AXES = ("rows", "nodes")


def default_backend(device):
    """The backend that goes with ``device``: NCCL for CUDA, gloo for the
    CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _local_rank():
    return int(os.environ.get("LOCAL_RANK", 0))


def _merge(name, value, alias, alias_value):
    """One of two names for the same argument; both given must agree."""
    if value is not None and alias_value is not None and value != alias_value:
        raise ValueError(f"{name}={value!r} and {alias}={alias_value!r} "
                         "disagree")
    return value if value is not None else alias_value


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None, device=None,
                           init_method=None, world_size=None, rank=None):
    """Initialize the default ``torch.distributed`` process group.

    The JAX package's arguments come first and keep their meaning:
    ``coordinator_address`` (``"host:port"`` of the rendezvous, here the
    ``tcp://`` ``init_method``), ``num_processes`` (``world_size``) and
    ``process_id`` (``rank``); each may be given under either name.  With no
    arguments, reads the torchrun variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the CUDA
    device of an NCCL rank).  Safe to call more than once (True once a group
    exists, whoever made it), and a no-op returning False in a single
    process with no cluster configured.  ``backend`` defaults to the one
    that goes with ``device`` (the card unless ``device="cpu"``)."""
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    init_method = _merge("init_method", init_method, "coordinator_address",
                         coordinator_address)
    world_size = _merge("world_size", world_size, "num_processes",
                        num_processes)
    rank = _merge("rank", rank, "process_id", process_id)
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None:
        if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            return False  # no cluster configured: nothing to do
        init_method = "env://"
    if world_size is None or rank is None:
        raise ValueError("a distributed run needs its world size and rank "
                         "(WORLD_SIZE and RANK, or the arguments)")
    device = resolve_device(device)
    backend = backend or default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(_local_rank())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


class Mesh:
    """A ``(rows, nodes)`` mesh of ranks with the collectives of the sharded
    layer.  ``device`` is where this rank computes; ``backend`` the process
    groups' backend; ``host_staged`` is True for gloo over CUDA tensors."""

    def __init__(self, device_mesh, device, backend):
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.backend = backend
        self.host_staged = backend == "gloo" and self.device.type == "cuda"
        self.shape = {a: device_mesh.size(i) for i, a in enumerate(AXES)}
        self._groups = {a: device_mesh.get_group(a) for a in AXES}

    def __repr__(self):
        return (f"Mesh(rows={self.shape['rows']}, nodes={self.shape['nodes']}"
                f", backend={self.backend!r}, device={self.device}"
                f"{', host-staged' if self.host_staged else ''})")

    def rank(self, axis):
        """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
        return dist.get_group_rank(self._groups[axis], dist.get_rank())

    def size(self, axis):
        """Number of ranks along ``axis`` (``mesh.shape[axis]``)."""
        return self.shape[axis]

    def _out(self, x):
        """The tensor a collective runs on: a host copy where gloo moves a
        CUDA tensor, else a contiguous copy on the device (the collectives
        work in place)."""
        return x.detach().to("cpu" if self.host_staged else x.device,
                             copy=True).contiguous()

    def _back(self, y, like):
        return y.to(like.device) if self.host_staged else y

    def psum(self, x, axis):
        """Sum of ``x`` over the ranks of ``axis`` (``all_reduce``).  Off the
        host-staged path it reads nothing on the host and allocates only on
        the device, so a CUDA graph can hold it."""
        if self.shape[axis] == 1:
            return x
        y = self._out(x)
        dist.all_reduce(y, group=self._groups[axis])
        return self._back(y, x)

    def all_gather(self, x, axis):
        """The ``x`` of every rank of ``axis`` stacked on a new leading axis,
        in rank order.  NCCL gathers into one device tensor
        (``all_gather_into_tensor``, which a CUDA graph can hold); gloo into
        a list of tensors, stacked."""
        size = self.shape[axis]
        if size == 1:
            return x[None]
        y = self._out(x)
        group = self._groups[axis]
        if self.backend == "nccl":
            out = torch.empty((size,) + tuple(y.shape), dtype=y.dtype,
                              device=y.device)
            # rank order along the flat output = stacked along a new axis
            dist.all_gather_into_tensor(out.view(-1), y.view(-1),
                                        group=group)
            return out
        out = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(out, y, group=group)
        return self._back(torch.stack(out), x)

    def neighbour_exchange_start(self, top, bottom, axis):
        """Start the chain exchange of :meth:`neighbour_exchange` and return
        at once: a :class:`PendingExchange` whose ``wait()`` gives
        ``(from_prev, from_next)``.  Work that does not read the strips can
        run in between (the bulk of a halo apply).  Over NCCL the strips
        are device tensors and waiting makes the current stream wait on
        NCCL's stream, without blocking the host; host-staged, the strips go
        to the host here and come back to the device in ``wait()``."""
        group = self._groups[axis]
        r, size = self.rank(axis), self.shape[axis]
        from_prev = None if bottom is None else torch.zeros_like(bottom)
        from_next = None if top is None else torch.zeros_like(top)
        ops, staged = [], []

        def send(x, peer):
            ops.append(dist.P2POp(dist.isend, self._out(x),
                                  dist.get_global_rank(group, peer), group))

        def recv(buf, peer):
            dst = torch.empty_like(buf, device="cpu") if self.host_staged \
                else buf
            ops.append(dist.P2POp(dist.irecv, dst,
                                  dist.get_global_rank(group, peer), group))
            staged.append((buf, dst))

        if top is not None:  # tops travel up the chain
            if r > 0:
                send(top, r - 1)
            if r < size - 1:
                recv(from_next, r + 1)
        if bottom is not None:  # bottoms travel down
            if r < size - 1:
                send(bottom, r + 1)
            if r > 0:
                recv(from_prev, r - 1)
        works = dist.batch_isend_irecv(ops) if ops else []
        return PendingExchange(works, ops, staged, (from_prev, from_next))

    def neighbour_exchange(self, top, bottom, axis):
        """Chain exchange along ``axis``: every rank sends ``top`` to the
        previous rank and ``bottom`` to the next one.  Returns
        ``(from_prev, from_next)``: the previous rank's ``bottom`` and the
        next rank's ``top``, zeros at the chain ends (as ``ppermute``
        zero-fills a missing source).  Either argument may be None (nothing
        sent that way; None back)."""
        return self.neighbour_exchange_start(top, bottom, axis).wait()


class PendingExchange:
    """A started :meth:`Mesh.neighbour_exchange_start`; ``wait()`` finishes
    it and returns ``(from_prev, from_next)``.  It keeps the send buffers
    alive until then."""

    def __init__(self, works, ops, staged, result):
        self._works, self._ops, self._staged = works, ops, staged
        self._result = result

    def wait(self):
        for work in self._works:
            work.wait()
        for buf, dst in self._staged:
            if dst is not buf:
                buf.copy_(dst)
        self._works = self._ops = self._staged = ()
        return self._result


def make_mesh(rows=None, nodes=1, devices=None, multihost=False, *,
              device=None, backend=None):
    """A ``(rows, nodes)`` :class:`Mesh` over the ranks of the default
    process group.

    ``multihost=True`` first wires the group from the torchrun variables
    (:func:`initialize_distributed`).  Where no group exists yet and no
    cluster is configured, a world of one rank is started over an in-memory
    store (the single-process mesh).  ``devices``: the ranks' devices in
    mesh order (rank r computes on ``devices[r]``; one for each rank, and
    ``rows`` defaults to their number over ``nodes``), as the JAX package
    takes its mesh's devices; otherwise ``device``, the card unless the
    caller asks for the CPU.  ``backend`` defaults to the one that goes with
    the device (NCCL for CUDA, gloo for the CPU).  The mesh's communication
    device follows the backend: gloo meshes are built over the CPU, and with
    a CUDA device their collectives stage through the host."""
    from torch.distributed.device_mesh import init_device_mesh

    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh's devices are of one type, got "
                             f"{devices}")
        if device is None:
            device = devices[0].type
        elif torch.device(device).type != devices[0].type:
            raise ValueError(f"device={device!r} but devices={devices}")
    device = resolve_device(device)
    backend = backend or default_backend(device)
    if dist.is_initialized() and backend not in dist.get_backend():
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {backend!r}")
    if multihost or not dist.is_initialized():
        initialize_distributed(backend=backend, device=device)
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(_local_rank())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a world of {world} "
                             "ranks")
        device = devices[dist.get_rank()]
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
    if rows is None:
        rows = world // nodes
    if rows * nodes != world:
        raise ValueError(f"mesh {rows}x{nodes} != {world} ranks")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    comm = "cuda" if backend == "nccl" else "cpu"
    dm = init_device_mesh(comm, (rows, nodes), mesh_dim_names=AXES)
    return Mesh(dm, device, backend)
