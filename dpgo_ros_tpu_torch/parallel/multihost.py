"""Multi-process spmd runs on ``torch.distributed``.

Port of ``dpgo_ros_tpu/parallel/multihost.py``. The JAX package scales the
mesh program of :mod:`dpgo_ros_tpu_torch.parallel.spmd` by adding hosts to
one device mesh; here each process owns a contiguous range of mesh slots
(``local_slot_count`` of them, the counterpart of JAX's local devices), runs
the slots' block solves on its card, and the separator exchange and the
GNC round's gathers are ``torch.distributed`` collectives across processes.

* :func:`initialize` — join the process group (``tcp://`` rendezvous at the
  coordinator's address) and set this process's slots and device; with one
  process it sets them and creates no group.
* :func:`global_mesh` — the :class:`SlotMesh` this process runs:
  process-contiguous slot ranges, so process p owns slots
  [p·L, (p+1)·L) of the global ``global_slots()``.
* :func:`is_multihost` — more than one process.
* :func:`free_port` — a free localhost port for a coordinator address.

Backends: NCCL where every process has a card of its own; gloo otherwise —
on the CPU, and where several processes share one card (NCCL refuses two
ranks on one device, "Duplicate GPU detected"). With gloo the spmd
collectives stage CUDA tensors through host buffers and use the list form
of ``all_gather`` (``spmd._all_gather``).

Every process builds the identical replicated problem and calls the same
steps in the same order, as on the JAX mesh. Demo/validation entry:
``python -m dpgo_ros_tpu_torch.scripts.multihost_demo`` (one process per
rank); ``tests/test_torch_multihost.py`` runs it as 2 processes × 2 slots
against 1 × 4.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SlotMesh:
    """The mesh one process runs: its rank, its slots and its device."""

    num_processes: int
    process_id: int
    local_slots: int
    device: torch.device
    backend: Optional[str] = None  # None: one process, no collective

    @property
    def global_slots(self) -> int:
        return self.num_processes * self.local_slots

    def slots(self, M: int) -> range:
        """This process's slots of an M-slot program (M ≤ global slots):
        its contiguous range, possibly empty."""
        if not 1 <= M <= self.global_slots:
            raise ValueError(f"{M} slots on a mesh of {self.global_slots}")
        lo = min(self.process_id * self.local_slots, M)
        return range(lo, min(lo + self.local_slots, M))


_MESH: Optional[SlotMesh] = None


def _device(device, process_id: int) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost: device cuda but no CUDA device is available")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: Optional[str] = None,
    local_slot_count: Optional[int] = None,
    device=None,
) -> SlotMesh:
    """Set up this process's part of the global mesh and return it.

    ``local_slot_count`` slots per process (default 1: one slot per card);
    ``device`` "cuda" (default: ``cuda:(process_id % device_count)``) or
    "cpu". With ``num_processes`` > 1 joins the process group at
    ``tcp://coordinator_address`` with ``backend`` (default: NCCL when
    every process has a card of its own, else gloo)."""
    global _MESH
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} of {num_processes}")
    local = int(local_slot_count or 1)
    if local < 1:
        raise ValueError(f"local_slot_count {local}")
    dev = _device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's collectives run on this card
    if num_processes > 1:
        import torch.distributed as dist

        if backend is None:
            own_cards = (dev.type == "cuda"
                         and torch.cuda.device_count() >= num_processes)
            backend = "nccl" if own_cards else "gloo"
        if dist.is_initialized():
            raise RuntimeError("multihost: the process group is already initialized")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
        )
    else:
        backend = None
    _MESH = SlotMesh(num_processes, process_id, local, dev, backend)
    return _MESH


def global_mesh(device=None) -> SlotMesh:
    """The mesh :func:`initialize` set up; without it one process with one
    slot on ``device`` (default the card)."""
    return _MESH if _MESH is not None else SlotMesh(1, 0, 1, _device(device, 0))


def local_mesh(num_slots: int, device=None) -> SlotMesh:
    """One process owning ``num_slots`` slots on ``device`` (default the
    card), without touching the global state: the mesh of a single-process
    run."""
    return SlotMesh(1, 0, int(num_slots), _device(device, 0))


def global_slots() -> int:
    """Slots of the global mesh (JAX: ``len(jax.devices())``): 1 until
    :func:`initialize` sets more."""
    return _MESH.global_slots if _MESH is not None else 1


def is_multihost() -> bool:
    return _MESH is not None and _MESH.num_processes > 1


def free_port() -> int:
    """A TCP port on localhost that no socket holds now: the coordinator
    port of a run whose processes all start on this machine."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shutdown() -> None:
    """Leave the process group (if any) and forget the mesh."""
    global _MESH
    if _MESH is not None and _MESH.backend is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    _MESH = None
