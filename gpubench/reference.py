"""The plain reference: a junction list (.dbg) worked out from a FASTA
file with plain numpy and PyTorch operations, independently of the
program.

Semantics (the reference TwoPaCo's, as its naive self test states them:
test.cpp FindJunctionsNaively, junctionapi.h's record format):
  - a FASTA record is a sequence; its characters are uppercased, "ACGT"
    are definite, the other letters of "ACGTURYKMSWBDHWNXV" are N, any
    other character is an error, whitespace is skipped;
  - a vertex is a k-mer of definite characters; walking both strands,
    its in- and out-extensions are the characters before and after it,
    where an N or a sequence end is a symbol of its own that equals no
    other;
  - a junction is a vertex with more than one distinct in-extension or
    out-extension (a vertex and its reverse complement are junctions
    together); its id is the 1-based rank of its canonical form (the
    smaller of the k-mer and its reverse complement, A < C < G < T) among
    the junctions' canonical forms, negative where the k-mer read is not
    the canonical one;
  - every occurrence of a junction is a record; so is each sequence's
    first and last vertex position (0 and L - k) where it is not a
    junction, with a stub id: the junction count + 42 + the stub's number
    in stream order; sequences shorter than k have no records;
  - records are (u32 position, i64 id), 12 bytes little-endian, in
    sequence then position order, with one separator record (0xFFFFFFFF,
    INT64_MAX) for each step of the sequence number between two records
    (and before the first, from sequence 0).

The k-mers are int64 codes (2 bits a character, first character on top),
so k is at most 31. The heavy work (k-mer codes, the sort, the group
judgements) runs as plain torch operations on the device given, blocks of
one sequence at a time where they are per position.
"""

from __future__ import annotations

import numpy as np
import torch

STUB_ID_OFFSET = 42
VIRTUAL = 4  # an extension that equals no other: an N or a sequence end
SEPARATOR = (-1, -1, 0x7FFFFFFF)  # (pos, id low, id high) as int32 bit patterns

_VALID = "ACGTURYKMSWBDHWNXV"
_LUT = np.full(256, 255, dtype=np.uint8)  # 255: invalid
for _ws in b" \t\r\n\v\f":
    _LUT[_ws] = 254  # skipped
for _ch in _VALID:
    _LUT[ord(_ch)] = _LUT[ord(_ch.lower())] = 4
for _i, _ch in enumerate("ACGT"):
    _LUT[ord(_ch)] = _LUT[ord(_ch.lower())] = _i


def parse_fasta(path: str) -> list[np.ndarray]:
    """The records' codes (uint8: 0-3 ACGT, 4 N), in file order."""
    buf = np.fromfile(path, dtype=np.uint8)
    if len(buf) == 0:
        return []
    if buf[0] != ord(">"):
        raise ValueError(f"{path}: does not start with a FASTA header")
    starts = np.flatnonzero((buf == ord(">")) & np.concatenate(
        [[True], buf[:-1] == ord("\n")]))
    ends = np.concatenate([starts[1:], [len(buf)]])
    out = []
    for s, e in zip(starts, ends):
        nl = np.flatnonzero(buf[s:e] == ord("\n"))
        body = buf[s + nl[0] + 1 : e] if len(nl) else buf[:0]
        codes = _LUT[body]
        if len(codes) and codes.max() == 255:
            raise ValueError(f"{path}: invalid character {chr(body[codes == 255][0])!r}")
        out.append(codes[codes != 254])
    return out


def _comp(e: torch.Tensor) -> torch.Tensor:
    return torch.where(e < 4, 3 - e, VIRTUAL)


def vertices(codes: torch.Tensor, k: int):
    """One sequence's vertex positions with their canonical k-mer, their
    extensions read on the canonical strand, and whether the k-mer read
    is the reverse complement of its canonical form.

    codes: (L,) int64 on a device, L >= k. -> (pos (n,) int64 of the
    definite k-mers, canon, left, right, is_rc), each of n entries."""
    L = codes.numel()
    n = L - k + 1
    is_n = codes == 4
    cm = torch.where(is_n, 0, codes)
    fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | cm[j : j + n]
        rev = (rev << 2) | (3 - cm[k - 1 - j : k - 1 - j + n])
    n_cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=codes.device),
                       torch.cumsum(is_n.to(torch.int64), 0)])
    definite = (n_cum[k:] - n_cum[:n]) == 0
    end = torch.full((1,), VIRTUAL, dtype=torch.int64, device=codes.device)
    prev = torch.cat([end, codes[: n - 1]])  # the char before position i
    nxt = torch.cat([codes[k:], end])  # the char after the k-mer at i
    is_rc = rev < fwd
    canon = torch.minimum(fwd, rev)
    left = torch.where(is_rc, _comp(nxt), prev)
    right = torch.where(is_rc, _comp(prev), nxt)
    pos = torch.nonzero(definite).squeeze(1)
    return pos, canon[pos], left[pos], right[pos], is_rc[pos]


def junction_mask(join_keys: torch.Tensor, left: torch.Tensor, right: torch.Tensor):
    """Which vertex positions hold a junction: those whose key's group of
    positions has more than one distinct left or right extension (each
    VIRTUAL distinct from every other)."""
    if join_keys.numel() == 0:
        return torch.zeros(0, dtype=torch.bool, device=join_keys.device)
    sk, perm = torch.sort(join_keys)
    new = torch.ones_like(sk, dtype=torch.bool)
    new[1:] = sk[1:] != sk[:-1]
    gid = torch.cumsum(new.to(torch.int64), 0) - 1
    del sk, new
    G = int(gid[-1]) + 1
    cnt = torch.bincount(gid, minlength=G)
    many = torch.zeros(G, dtype=torch.bool, device=gid.device)
    for ext in (left[perm], right[perm]):
        virt = torch.zeros(G, dtype=torch.int64, device=gid.device).scatter_add_(
            0, gid, (ext == VIRTUAL).to(torch.int64))
        lo = torch.full((G,), 9, dtype=torch.int64, device=gid.device).scatter_reduce_(
            0, gid, torch.where(ext < 4, ext, 9), "amin")
        hi = torch.full((G,), -1, dtype=torch.int64, device=gid.device).scatter_reduce_(
            0, gid, torch.where(ext < 4, ext, -1), "amax")
        many |= ((virt >= 1) & (cnt >= 2)) | (hi > lo)
    out = torch.empty(join_keys.numel(), dtype=torch.bool, device=gid.device)
    out[perm] = many[gid]
    return out


def exact_keys(canon: torch.Tensor) -> torch.Tensor:
    """The join key of the reference: the whole canonical k-mer."""
    return canon


def junction_records(seqs: list[np.ndarray], k: int, device="cpu", join=exact_keys):
    """The .dbg of the sequences' codes as an (m, 3) int32 tensor of
    record rows (pos, id low word, id high word) on the device, and the
    junction count. join(canon) gives the key whose groups are judged
    (the control passes a lossy one)."""
    if not 1 <= k <= 31 or k % 2 == 0:
        raise ValueError(f"the reference takes odd k up to 31, not {k}")
    dev = torch.device(device)
    flat, canon, left, right, is_rc = [], [], [], [], []
    starts, lengths = [], []
    ofs = 0
    for codes in seqs:
        L = len(codes)
        starts.append(ofs)
        lengths.append(L)
        if L >= k:
            got = vertices(torch.from_numpy(codes).to(dev).to(torch.int64), k)
            flat.append(got[0] + ofs)
            for lst, t in zip((canon, left, right, is_rc), got[1:]):
                lst.append(t)
        ofs += L
    cat = (lambda ts, dt: torch.cat(ts) if ts else torch.zeros(0, dtype=dt, device=dev))
    flat, canon = cat(flat, torch.int64), cat(canon, torch.int64)
    left, right = cat(left, torch.int64), cat(right, torch.int64)
    is_rc = cat(is_rc, torch.bool)

    junc = junction_mask(join(canon), left, right)
    del left, right
    table = torch.unique(canon[junc])  # sorted canonical k-mers of the junctions
    occ_flat = flat[junc]
    occ_id = torch.searchsorted(table, canon[junc]) + 1
    occ_id = torch.where(is_rc[junc], -occ_id, occ_id)
    n_junc = table.numel()
    del canon, is_rc, table

    # stubs: each sequence's first and last vertex position that is no
    # junction occurrence, numbered in stream order
    occ_set = set()
    starts_t = torch.tensor(starts, dtype=torch.int64)
    ends = [(s, s + L - k) for s, L in zip(starts, lengths) if L >= k]
    cand = sorted({f for pair in ends for f in pair})
    if cand:
        cand_t = torch.tensor(cand, dtype=torch.int64, device=dev)
        hit = torch.isin(cand_t, occ_flat).cpu().tolist()
        occ_set = {f for f, h in zip(cand, hit) if h}
    stub_flat = [f for f in cand if f not in occ_set]
    stub_flat_t = torch.tensor(stub_flat, dtype=torch.int64, device=dev)
    stub_id = n_junc + STUB_ID_OFFSET + torch.arange(len(stub_flat), dtype=torch.int64,
                                                     device=dev)
    all_flat = torch.cat([occ_flat, stub_flat_t])
    all_id = torch.cat([occ_id, stub_id])
    del occ_flat, occ_id
    all_flat, order = torch.sort(all_flat)
    all_id = all_id[order]
    del order

    seq = torch.searchsorted(starts_t.to(dev), all_flat, right=True) - 1
    pos = all_flat - starts_t.to(dev)[seq]
    del all_flat
    prev = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), seq[:-1]])
    at = torch.arange(seq.numel(), device=dev) + torch.cumsum(seq - prev, 0)
    n_rows = int(at[-1]) + 1 if at.numel() else 0
    rows = torch.tensor(SEPARATOR, dtype=torch.int32, device=dev).repeat(n_rows, 1)
    rows[at, 0] = _i32(pos)
    rows[at, 1] = _i32(all_id & 0xFFFFFFFF)
    rows[at, 2] = _i32(all_id >> 32)
    return rows, n_junc


def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [-2^31, 2^32) as the int32 of their low 32 bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def reference_dbg(fasta_path: str, k: int, device="cpu", join=exact_keys):
    """-> (the .dbg's bytes as a uint8 numpy array, the junction count)."""
    rows, n_junc = junction_records(parse_fasta(fasta_path), k, device, join)
    return rows.cpu().numpy().view(np.uint8).reshape(-1), n_junc


def records_differing(got: np.ndarray | bytes, want: np.ndarray) -> int:
    """The number of 12-byte records in which two .dbg byte strings
    differ, counting each record that only one of them has. A length
    that is no multiple of 12 counts every record of the longer one."""
    a = np.frombuffer(got, dtype=np.uint8) if isinstance(got, (bytes, bytearray)) else got
    b = want
    if len(a) % 12 or len(b) % 12:
        return max(len(a), len(b)) // 12 + 1
    n = min(len(a), len(b))
    diff = 0
    step = 12 << 22  # 48 MiB blocks
    for s in range(0, n, step):
        e = min(s + step, n)
        x = a[s:e].reshape(-1, 12)
        y = b[s:e].reshape(-1, 12)
        diff += int((x != y).any(axis=1).sum())
    return diff + abs(len(a) - len(b)) // 12
