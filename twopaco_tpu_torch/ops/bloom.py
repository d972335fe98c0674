"""The Bloom filter of the Bloom engine: layouts, capacity checks, and the
plain PyTorch fill and probe.

The port of twopaco_tpu/ops/bloom.py. Three layouts, the same bits as
the JAX package's (OR is order-free, so every schedule of the inserts
gives the same filter):

  - 'byte':  one uint8 per Bloom slot, 2^f bytes;
  - 'bit':   one bit per slot in 2^(f-5) uint32 words (the reference's
             layout), slot s is bit s & 31 of word s >> 5;
  - 'block': the same 2^(f-5) words as 2^(f-8) blocks of 256 bits (8
             words); a block is keyed by a vertex hash and its bits by the
             edge hashes of the vertex (passes/fill.py), so in-block bit b
             of block x is slot 256 x + b of the 'bit' view.

The filter is a uint8 (byte) or uint32 (bit, block) tensor on any device.
The plain versions here work through int32 views: the CPU build of torch
has no uint32 arithmetic. The kernels (passes/fill.py, passes/mark.py) set
bits with atomicOr and store bytes.
"""

from __future__ import annotations

import torch

from twopaco_tpu_torch.ops.pack import MASK32

BYTE_LAYOUT_MAX_F = 30  # the JAX package's caps, kept for the same messages
BIT_LAYOUT_MAX_F = 35
BLOCK_WORDS = 8
BLOCK_BITS = 32 * BLOCK_WORDS


def choose_layout_slots(slots: int) -> str:
    """Pick a layout for a filter of `slots` Bloom slots: byte while it
    fits, else bit."""
    if slots <= (1 << BYTE_LAYOUT_MAX_F):
        return "byte"
    if slots <= (1 << BIT_LAYOUT_MAX_F):
        return "bit"
    raise ValueError(
        f"Bloom filter of {slots} slots per device exceeds the "
        f"supported layouts (max 2^{BIT_LAYOUT_MAX_F} slots = 4 GiB of "
        "bits per device). Use --tpu-engine dist-bloom to shard the "
        "filter across a device mesh (each device then owns "
        "2^f/n_devices slots), spread it over more devices, or lower "
        "-f/--filtermemory. The default sort engine does not allocate "
        "a filter and accepts any -f."
    )


def check_layout_slots(slots: int, layout: str) -> None:
    """Validate an explicitly chosen layout against its capacity."""
    max_f = BYTE_LAYOUT_MAX_F if layout == "byte" else BIT_LAYOUT_MAX_F
    if slots > (1 << max_f):
        raise ValueError(
            f"'{layout}' Bloom layout supports at most 2^{max_f} slots "
            f"per device (got {slots}). Use --tpu-engine dist-bloom to "
            "shard the filter across a device mesh, lower "
            "-f/--filtermemory, or use the default sort engine (no "
            "filter, any -f)."
        )


def make_filter(f: int, layout: str, device, slots: int | None = None) -> torch.Tensor:
    """An empty filter on `device`: 2^f uint8 slots (byte) or 2^(f-5)
    uint32 words (bit, block). slots: another slot count (byte, bit; a
    multiple of 32 for bit), as a shard of the dist-bloom engine's
    filter holds."""
    if layout == "byte":
        return torch.zeros(slots or 1 << f, dtype=torch.uint8, device=device)
    if layout in ("bit", "block"):
        if layout == "block" and f < 8:
            raise ValueError("block layout needs f >= 8")
        words = slots // 32 if slots else 1 << max(f - 5, 0)
        return torch.zeros(words, dtype=torch.uint32, device=device)
    raise ValueError(layout)


def block_index(hv: torch.Tensor, f: int) -> torch.Tensor:
    """Block of a vertex: the low f-8 bits of its symmetric hash."""
    return hv & ((1 << max(f - 8, 0)) - 1)


def block_bits(e1: torch.Tensor, e2: torch.Tensor, q: int) -> torch.Tensor:
    """q distinct in-block bits from the symmetric edge hashes:
    (e1 + j * (e2 | 1)) mod 256 (an odd step is distinct mod 256)."""
    h2 = e2 | 1
    return torch.stack([(e1 + j * h2) & (BLOCK_BITS - 1) for j in range(q)], dim=-1)


def fill(filt: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, layout: str) -> torch.Tensor:
    """Set slots idx (int64, any shape) where valid, in place; returns filt.

    'bit': the distinct slots' powers of two are summed per word (a sum of
    distinct powers of two is their OR) and ORed into the words."""
    idx = idx.reshape(-1)[valid.reshape(-1)]
    if layout == "byte":
        filt[idx] = 1
        return filt
    slots = torch.unique(idx)  # sorted, so words come in runs
    words, inv = torch.unique_consecutive(slots >> 5, return_inverse=True)
    acc = torch.zeros(len(words), dtype=torch.int64, device=filt.device)
    acc.index_add_(0, inv, 1 << (slots & 31))
    fv = filt.view(torch.int32)
    fv[words] |= acc.to(torch.int32)  # wraps: bit 31 lands as the sign bit
    return filt


def fill_blocks(filt, block, bits, valid) -> torch.Tensor:
    """Vertex-blocked fill: set in-block `bits` (..., q) of `block` (...)
    where valid (...); in place, returns filt."""
    slots = block[..., None] * BLOCK_BITS + bits
    return fill(filt, slots, valid[..., None].expand(slots.shape), "bit")


def probe(filt: torch.Tensor, idx: torch.Tensor, layout: str) -> torch.Tensor:
    """True where slot idx (int64, any shape) is set."""
    if layout == "byte":
        return filt[idx] > 0
    words = filt.view(torch.int32)[idx >> 5].to(torch.int64) & MASK32
    return ((words >> (idx & 31)) & 1) > 0


def probe_all(filt: torch.Tensor, idx_q: torch.Tensor, layout: str) -> torch.Tensor:
    """AND of the q probes of the last axis: (..., q) -> (...)."""
    return probe(filt, idx_q, layout).all(dim=-1)


def probe_blocks(filt: torch.Tensor, block: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Vertex-blocked probe: block (...), bits (..., S, q) -> (..., S),
    True where all q bits of a slot are set in the block."""
    return probe_all(filt, block[..., None, None] * BLOCK_BITS + bits, "bit")
