"""Data-parallel meshes: the counterpart of cufhe_tpu/parallel/mesh.py.

The reference scales by replicating the keys on every GPU and sending each
GPU its share of the gates (SetGPUNum, bootstrap_gpu.cu:115-137). Here a
DataMesh is a tuple of torch devices: the keys are copied once to each
distinct device (replicate), a batch is cut into equal row blocks, one per
device (shard_batch), every block runs on its device with that device's
keys, and the results are joined on the mesh's first device
(data_parallel). Rows are independent, so no shard ever talks to another:
there is no collective anywhere on the path.

A device may appear more than once: data_mesh(["cpu"] * 8) is eight shards
run one after another on the CPU (the JAX tests' eight virtual CPU
devices), data_mesh(["cuda:0", "cuda:0"]) two shards on one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

#: the mesh's one axis, named as in the JAX package (kept for its API)
DATA_AXIS = "data"


def init_distributed(**kwargs) -> None:
    """Join a process group (torch.distributed.init_process_group, the
    counterpart of jax.distributed.initialize): pass init_method (e.g.
    "tcp://localhost:<port>"), world_size, rank and backend ("nccl" between
    cards, "gloo" on the CPU). The gate path itself calls nothing of
    torch.distributed: each process evaluates its own rows (local_rows)."""
    torch.distributed.init_process_group(**kwargs)


def _canonical(dev) -> torch.device:
    """torch.device with a CUDA index: "cuda" and "cuda:0" compare unequal
    as devices, while a tensor always reports the indexed form."""
    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh over the data axis: the devices of the shards, in order."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first device: where inputs are cut and results joined."""
        return self.devices[0]


def data_mesh(devices: Optional[Sequence] = None,
              n_devices: Optional[int] = None) -> DataMesh:
    """A mesh over the given devices, or over every CUDA device (the
    counterpart of SetGPUNum, cufhe_gates_gpu.cu:38); n_devices keeps the
    first n. Without CUDA the default raises: a CPU mesh exists only where
    the caller names its devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh() covers the CUDA devices and there "
                               "is none; name the devices of a CPU mesh, "
                               "e.g. data_mesh(['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(_canonical(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DataMesh(devs)


class Replicated(dict):
    """One copy of a value per distinct device of a mesh (replicate):
    data_parallel hands each shard its device's copy."""


def to_device(tree, dev: torch.device):
    """A copy of `tree` (a tensor, or a dataclass of tensors) on dev."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), dev)
            for f in dataclasses.fields(tree)})
    return tree


def _device_of(tree) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            dev = _device_of(getattr(tree, f.name))
            if dev is not None:
                return dev
    return None


def replicate(tree, mesh: DataMesh) -> Replicated:
    """A copy of `tree` (a tensor, or a dataclass of tensors such as
    DeviceKeys) on every distinct device of the mesh: the multi-GPU key
    upload (bootstrap_gpu.cu:115-137). Where the tree already lives on a
    device, it is used as it is: a mesh of one card holds one key set."""
    own = _device_of(tree)
    return Replicated({d: tree if d == own else to_device(tree, d)
                       for d in dict.fromkeys(mesh.devices)})


def _move(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """x on dev; a copy onto a card does not wait for the host (a copy to
    the CPU must, to be readable)."""
    return x.to(dev, non_blocking=dev.type == "cuda")


def shard_batch(x: torch.Tensor, mesh: DataMesh) -> list:
    """x's rows cut into mesh.size equal blocks, block i on device i. The
    batch must divide."""
    rows, rem = divmod(x.shape[0], mesh.size)
    if rem:
        raise ValueError(f"batch {x.shape[0]} is not divisible by the "
                         f"{mesh.size}-device mesh")
    return [_move(x[i * rows:(i + 1) * rows], d)
            for i, d in enumerate(mesh.devices)]


def local_rows(x: torch.Tensor, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> torch.Tensor:
    """This process's block of a batch every process holds whole, for a
    multi-process run (the counterpart of
    jax.make_array_from_process_local_data): rank and world size default
    to the process group's."""
    if rank is None:
        rank = torch.distributed.get_rank()
    if world_size is None:
        world_size = torch.distributed.get_world_size()
    rows, rem = divmod(x.shape[0], world_size)
    if rem:
        raise ValueError(f"batch {x.shape[0]} is not divisible by "
                         f"{world_size} processes")
    return x[rank * rows:(rank + 1) * rows]


def _on(dev: torch.device):
    """The device guard of a shard (the CUDA current device)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def data_parallel(fn, mesh: DataMesh, batch_argnums: Sequence[int],
                  out_dim: int = 0):
    """fn wrapped to run on every shard of the mesh.

    The arguments listed in batch_argnums have their rows split across the
    mesh (shard_batch); a Replicated argument gives each shard its device's
    copy; any other tensor is copied to the shard's device, and the rest is
    passed as it is. Each shard runs on its device's current stream, so
    the shards of several cards overlap; the results are joined along
    out_dim on the mesh's first device. A failing shard raises."""
    bset = set(batch_argnums)

    def local(a, dev):
        if isinstance(a, Replicated):
            return a[dev]
        if isinstance(a, torch.Tensor):
            return _move(a, dev)
        return a

    def wrapper(*args):
        blocks = {i: shard_batch(args[i], mesh) for i in bset}
        outs = []
        for s, dev in enumerate(mesh.devices):
            with _on(dev):
                outs.append(fn(*(blocks[i][s] if i in bset else local(a, dev)
                                 for i, a in enumerate(args))))
        return torch.cat([_move(o, mesh.device) for o in outs], dim=out_dim)

    return wrapper
