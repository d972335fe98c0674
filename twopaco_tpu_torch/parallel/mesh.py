"""The mesh of the distributed engine: D shards, on devices of this process
or one shard per process.

The port of twopaco_tpu/parallel/sharded.py:45 make_mesh and of
twopaco_tpu/parallel/multihost.py's make_put, fetch, barrier and
is_writer. Every step of the engine (parallel/sortshard.py,
parallel/distpipe.py) is written once against this interface:

  - n_shards, and `shards`: the shards this process runs;
  - device(s): the device of shard s; put_rows(a): shard s's rows of a
    host batch array, on its device (a process uploads its rows only);
  - all_to_all(send): shard s sends block send[s][d] to shard d;
  - all_gather(values): a small 1-D int64 tensor of every shard, on the
    host of every process;
  - gather(objs): a host object of every shard (blocks of any size), on
    every process;
  - barrier(name), is_writer().

LocalMesh runs D shards in one process (a device may repeat: [cuda:0] * 4
is four shards on one card, as the JAX tests' virtual devices); its
exchange is a transpose of the stacked send blocks. ProcessMesh runs one
shard per torch.distributed rank (parallel/multihost.py starts it): the
exchange is all_to_all_single, over NCCL for CUDA tensors and gloo for
CPU ones, and host gathers go through a gloo group.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch


# the types the collectives carry a tensor of another type as (same width)
_WIRE = {torch.uint32: torch.int32, torch.uint64: torch.int64, torch.bool: torch.uint8}


def on_device(dev: torch.device):
    """Context in which a shard's kernels launch: its CUDA device current
    (kernels/build.py on_cpu raises otherwise), nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class _Mesh:
    n_shards: int
    shards: Sequence[int]

    def device(self, s: int) -> torch.device:
        raise NotImplementedError

    def put_rows(self, a: np.ndarray) -> dict[int, torch.Tensor]:
        """{s: rows [s*n/D, (s+1)*n/D) of a on device(s)} for this
        process's shards (n = a.shape[0], a multiple of D)."""
        n = a.shape[0] // self.n_shards
        return {
            s: torch.from_numpy(np.ascontiguousarray(a[s * n : (s + 1) * n])).to(self.device(s))
            for s in self.shards
        }


class LocalMesh(_Mesh):
    """D shards in this process: devices[s] runs shard s."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.n_shards = len(self.devices)
        self.shards = range(self.n_shards)

    def device(self, s: int) -> torch.device:
        return self.devices[s]

    def shards_per_device(self, s: int) -> int:
        """Shards sharing shard s's device (they share its memory)."""
        return self.devices.count(self.devices[s])

    def all_to_all(self, send):
        """send: {s: tuple of tensors (D, cap, ...)} -> {d: tuple of
        tensors (D * cap, ...) on device(d)}, block s of d's = send[s][d]."""
        return {
            d: tuple(
                torch.cat([send[s][c][d].to(self.devices[d]) for s in self.shards])
                for c in range(len(send[d]))
            )
            for d in self.shards
        }

    def all_gather(self, values) -> np.ndarray:
        """values: {s: (n,) int64 tensor} -> (D, n) int64 numpy."""
        return np.stack([values[s].cpu().numpy() for s in self.shards])

    def gather(self, objs) -> list:
        return [objs[s] for s in self.shards]

    def barrier(self, name: str) -> None:
        pass

    def is_writer(self) -> bool:
        return True


def local_mesh(device) -> LocalMesh:
    """The CLI's mesh: one shard per visible CUDA device, or one CPU shard
    (as make_mesh() over jax.devices())."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return LocalMesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    return LocalMesh([dev])


class ProcessMesh(_Mesh):
    """One shard per rank of the initialized torch.distributed group (rank
    r runs shard r on `device`; rank 0 writes)."""

    def __init__(self, device):
        import torch.distributed as dist

        self._dist = dist
        self._device = torch.device(device)
        self.rank = dist.get_rank()
        self.n_shards = dist.get_world_size()
        self.shards = (self.rank,)
        # variable-length host gathers and barriers: gloo, whatever the
        # exchange's backend
        self._host = (
            dist.group.WORLD if dist.get_backend() == "gloo"
            else dist.new_group(backend="gloo")
        )

    def device(self, s: int) -> torch.device:
        assert s == self.rank
        return self._device

    def shards_per_device(self, s: int) -> int:
        return 1

    def all_to_all(self, send):
        """One all_to_all_single per tensor: block d of this rank's send
        goes to rank d (uint32, uint64 and bool travel as int32, int64 and
        uint8 views: the collectives' types)."""
        (s,) = self.shards
        out = []
        for x in send[s]:
            x = x.contiguous()
            xs = x.view(_WIRE.get(x.dtype, x.dtype))
            y = torch.empty_like(xs)
            self._dist.all_to_all_single(y, xs)
            out.append(y.view(x.dtype).reshape(-1, *x.shape[2:]))
        return {s: tuple(out)}

    def all_gather(self, values) -> np.ndarray:
        (s,) = self.shards
        x = values[s].contiguous()
        parts = [torch.empty_like(x) for _ in range(self.n_shards)]
        self._dist.all_gather(parts, x)
        return np.stack([p.cpu().numpy() for p in parts])

    def gather(self, objs) -> list:
        (s,) = self.shards
        out = [None] * self.n_shards
        self._dist.all_gather_object(out, objs[s], group=self._host)
        return out

    def barrier(self, name: str) -> None:
        self._dist.barrier(group=self._host)

    def is_writer(self) -> bool:
        return self.rank == 0
