"""The multi-process entry of the distributed engine: one shard per
process, started by torchrun (or any launcher that sets its variables).

The port of twopaco_tpu/parallel/multihost.py. Every process calls
build_junctions_multihost with the same arguments; each parses the input
itself (host work) and uploads only its shard's rows of each batch, the
record exchange crosses processes (NCCL between CUDA devices, gloo on the
CPU), and rank 0 writes the .dbg and the checkpoints. A process on its
own (no launcher variables) runs the same path as a one-rank group.

    torchrun --nproc_per_node 4 script.py   # script.py calls
    build_junctions_multihost([fasta], PipelineConfig(k=25), out_path="out.dbg")
"""

from __future__ import annotations

import os
import socket
from typing import Callable, Sequence

import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(device="cuda") -> torch.device:
    """Join the process group of torchrun's RANK, WORLD_SIZE, MASTER_ADDR
    and MASTER_PORT (a one-rank group on a free localhost port when they
    are unset; a no-op when a group exists). NCCL for CUDA, gloo for the
    CPU; a CUDA rank runs on cuda:LOCAL_RANK (else rank mod the visible
    devices), made current. -> the rank's device."""
    import torch.distributed as dist

    from twopaco_tpu_torch.passes.sortpipe import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", "0"))
        world = int(os.environ.get("WORLD_SIZE", "1"))
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT") or str(_free_port())
        if "MASTER_PORT" not in os.environ and world > 1:
            raise RuntimeError("MASTER_PORT is unset: start the processes with torchrun")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world,
        )
    return dev


def build_junctions_multihost(
    input_paths: Sequence[str] | None,
    config,
    out_path: str | None = None,
    sequences=None,
    log: Callable[[str], None] = lambda s: None,
    checkpoint_dir: str | None = None,
    *,
    device="cuda",
    reference: bool = False,
    bloom_gate: bool = False,
):
    """initialize(), then build over a ProcessMesh of every rank; rank 0
    writes and logs. checkpoint_dir must be on a filesystem every process
    reads (rank 0 writes the round files, a barrier orders the reads).
    bloom_gate=True: the dist-bloom engine, its filter sharded over the
    ranks. -> Enumerator (on every rank)."""
    from twopaco_tpu_torch.parallel.distpipe import build_junctions_dist
    from twopaco_tpu_torch.parallel.mesh import ProcessMesh

    dev = initialize(device)
    mesh = ProcessMesh(dev)
    return build_junctions_dist(
        input_paths, config, mesh, out_path if mesh.is_writer() else None, sequences,
        log if mesh.is_writer() else (lambda s: None), checkpoint_dir,
        device=dev, reference=reference, bloom_gate=bloom_gate,
    )
