"""Device mesh and sharding helpers.

Counterpart of ``dctsvd_tpu/parallel/mesh.py``. The work is an
embarrassingly parallel map over frames or images, so the canonical mesh
is 1-D over ``'batch'``: frames shard across cards, each card runs the
single-device pipeline on its shard, and the outputs come back to the
mesh's first device. A 2-D ``('batch', 'plane')`` mesh keeps the JAX
package's shape, which it reserves for a plane-sharded whole-frame SVD
that neither package has: there ``P('batch')`` repeats each batch shard's
work over its row, here a batch shard runs once, on the first device of
its row, and the row's other devices stay idle.

A :class:`Mesh` is a plain value naming its devices. An explicit device
list may repeat a device (the counterpart of the JAX tests' virtual CPU
devices): the shards then run one after another on that device. A mesh
spans the cards of its own process; :func:`init_distributed` joins the
processes of a multi-host run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

BATCH_AXIS = "batch"
PLANE_AXIS = "plane"


@dataclass(frozen=True)
class Mesh:
    """``devices``: a tuple of ``torch.device`` (1-D) or a tuple of rows
    of them (2-D); ``axis_names``: one name per dimension."""
    devices: tuple
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Shards along each axis, as ``jax.sharding.Mesh.shape``."""
        dims = [len(self.devices)]
        if len(self.axis_names) > 1:
            dims.append(len(self.devices[0]))
        return dict(zip(self.axis_names, dims))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """``torch.distributed.init_process_group`` passthrough (NCCL) for
    multi-host runs. Every given argument is forwarded, and only those:
    ``coordinator`` ("host:port") as ``init_method=tcp://...``,
    ``num_processes`` as ``world_size``, ``process_id`` as ``rank``. With
    none given the group reads the environment (``env://``), as
    ``jax.distributed.initialize()`` does."""
    import torch.distributed as dist
    kw = {}
    if coordinator is not None:
        kw["init_method"] = f"tcp://{coordinator}"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend="nccl", **kw)


def _canonical(d) -> torch.device:
    """``d`` as a torch.device with its index: a bare ``cuda`` names the
    current card, so that a tensor's ``.device`` compares equal to it."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              plane: int = 1) -> Mesh:
    """1-D ``('batch',)`` mesh by default; ``plane > 1`` for the 2-D
    variant. Without ``devices`` it takes every local CUDA device and
    raises when there is none: there is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "explicitly (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_canonical(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            # devices[:n] would silently build a SMALLER mesh and report
            # n-device numbers measured on fewer cards
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are available")
        devices = devices[:n_devices]
    if plane > 1:
        if len(devices) % plane:
            raise ValueError(f"{len(devices)} devices do not divide into "
                             f"rows of plane={plane}")
        rows = tuple(tuple(devices[i:i + plane])
                     for i in range(0, len(devices), plane))
        return Mesh(rows, (BATCH_AXIS, PLANE_AXIS))
    return Mesh(tuple(devices), (BATCH_AXIS,))


def batch_devices(mesh: Mesh) -> List[torch.device]:
    """The device of each batch shard: the first of its row on a 2-D
    mesh."""
    if len(mesh.axis_names) > 1:
        return [row[0] for row in mesh.devices]
    return list(mesh.devices)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """The per-shard tensors of ``x`` along dim 0, each on its shard's
    device. The leading size must divide by the batch shards."""
    devs = batch_devices(mesh)
    if x.shape[0] % len(devs):
        raise ValueError(f"batch {x.shape[0]} does not divide over "
                         f"{len(devs)} batch shards")
    return [c.to(d) for c, d in zip(torch.chunk(x, len(devs)), devs)]


def replicate(x: torch.Tensor, mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """``x`` on each distinct device of the mesh's batch shards, copied
    once per device."""
    return {d: x.to(d) for d in dict.fromkeys(batch_devices(mesh))}


@dataclass(frozen=True)
class Placement:
    """Where a tensor goes on a mesh: split along dim 0 over the batch
    shards (``split``), or a copy on each distinct device. The
    counterpart of the JAX package's NamedShardings; map_shards places
    its arguments through these."""
    mesh: Mesh
    split: bool

    def put(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` placed: one tensor a batch shard, on its device."""
        if self.split:
            return shard_batch(x, self.mesh)
        copies = replicate(x, self.mesh)
        return [copies[d] for d in batch_devices(self.mesh)]


def batch_sharding(mesh: Mesh) -> Placement:
    """Leading-axis sharding for frame/image batches."""
    return Placement(mesh, True)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, False)


def gather(parts: List[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Per-shard outputs concatenated along dim 0 on the mesh's first
    device; a single shard comes back as it is."""
    if len(parts) == 1:
        return parts[0]
    first = batch_devices(mesh)[0]
    return torch.cat([p.to(first) for p in parts])


def map_shards(mesh: Optional[Mesh], fn: Callable,
               batch_args: Sequence[torch.Tensor],
               rep_args: Sequence[torch.Tensor], alpha):
    """``fn(*batch shard i, *replicated, alpha)`` for each batch shard on
    its device (the mesh of every local card when ``mesh`` is None), the
    outputs gathered on the first device: a tensor, or a tuple of
    tensors. Every input is placed before the first launch, and nothing
    waits on the host between two shards, so shards on separate cards
    overlap. ``alpha`` is a number, or a tensor copied to each device."""
    if mesh is None:
        mesh = make_mesh()
    split, rep = batch_sharding(mesh), replicated(mesh)
    n = len(batch_devices(mesh))
    shards = [split.put(a) for a in batch_args]
    reps = [rep.put(a) for a in rep_args]
    alphas = (rep.put(alpha) if isinstance(alpha, torch.Tensor)
              else [alpha] * n)
    outs = [fn(*(s[i] for s in shards), *(r[i] for r in reps), alphas[i])
            for i in range(n)]
    if isinstance(outs[0], torch.Tensor):
        return gather(outs, mesh)
    return tuple(gather(list(parts), mesh) for parts in zip(*outs))
