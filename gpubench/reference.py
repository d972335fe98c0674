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
judgements) runs as plain torch operations on the device given, in B
blocks by canonical k-mer range, so that an input of Gbases fits one card:
each block walks every sequence in chunks of CHUNK positions, keeps the
vertices whose canonical k-mer falls in its range and judges them; its
junctions take the ranks after the earlier blocks'. Each block's
occurrences go to the host sorted by position; the records are then put
in order in pieces of CHUNK positions. B comes from the input's positions
and the card's free memory (plan_blocks); the .dbg is the same for every B.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STUB_ID_OFFSET = 42
VIRTUAL = 4  # an extension that equals no other: an N or a sequence end
SEPARATOR = (-1, -1, 0x7FFFFFFF)  # (pos, id low, id high) as int32 bit patterns
CHUNK = 1 << 24  # positions whose k-mers are worked out at once; records ordered at once
# the card's peak a vertex of a block, with room: at one block an H100 peaked
# at 59 bytes a position on ecoli62 and 89 on chr1, one chunk's work
# included; and the peak of one chunk's vertices() a position
BLOCK_BYTES_A_VERTEX = 128
CHUNK_BYTES_A_POSITION = 160

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


def vertices(codes: torch.Tensor, k: int, before: int = VIRTUAL, after: int = VIRTUAL):
    """The vertex positions of a run of a sequence with their canonical
    k-mer, their extensions read on the canonical strand, and whether the
    k-mer read is the reverse complement of its canonical form.

    codes: (L,) int64 on a device, L >= k, the characters of positions 0 ..
    L - k's k-mers; before, after: the characters just before and just after
    them (VIRTUAL at a sequence's ends). -> (pos (n,) int64 of the definite
    k-mers, canon, left, right, is_rc), each of n entries."""
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
    first = torch.full((1,), before, dtype=torch.int64, device=codes.device)
    last = torch.full((1,), after, dtype=torch.int64, device=codes.device)
    prev = torch.cat([first, codes[: n - 1]])  # the char before position i
    nxt = torch.cat([codes[k:], last])  # the char after the k-mer at i
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
    for ext in (left, right):
        ext = ext[perm].to(torch.int64)
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


def plan_blocks(positions: int, free: int | None) -> int:
    """The number of blocks B for `positions` k-mer positions on a device
    with `free` bytes free (None: no limit, one block): each block's
    vertices at BLOCK_BYTES_A_VERTEX, besides one chunk's work."""
    if free is None:
        return 1
    room = free - CHUNK * CHUNK_BYTES_A_POSITION
    if room <= 0:
        raise RuntimeError(f"the reference needs {CHUNK * CHUNK_BYTES_A_POSITION} bytes "
                           f"for one chunk; {free} are free")
    return max(1, -(-positions * BLOCK_BYTES_A_VERTEX // room))


def key_bounds(k: int, blocks: int) -> list[int]:
    """The B + 1 bounds [0, ..., 4^k] of the blocks' canonical k-mer ranges,
    cut so that a random sequence gives each block as many vertices: the
    canonical code, the smaller of two uniform codes, lies below x with
    chance 1 - (1 - x / 4^k)^2."""
    top = 1 << (2 * k)
    inner = [min(top, int(top * (1 - math.sqrt(1 - b / blocks)))) for b in range(1, blocks)]
    return [0, *inner, top]


def free_bytes(device) -> int | None:
    """The free memory of a card, as plan_blocks takes it (None off a
    card)."""
    dev = torch.device(device)
    return torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else None


def block_vertices(seqs, k: int, dev, lo: int, hi: int):
    """The vertices of every sequence whose canonical k-mer lies in [lo,
    hi), in position order: (flat position (the sequences laid end to end)
    int64, canon int64, left int8, right int8, is_rc bool)."""
    parts = [[], [], [], [], []]
    ofs = 0
    for codes in seqs:
        L = len(codes)
        for a in range(0, L - k + 1, CHUNK):
            n = min(CHUNK, L - k + 1 - a)
            win = torch.from_numpy(codes[a : a + n + k - 1]).to(dev).to(torch.int64)
            before = int(codes[a - 1]) if a else VIRTUAL
            after = int(codes[a + n + k - 1]) if a + n + k - 1 < L else VIRTUAL
            pos, canon, left, right, is_rc = vertices(win, k, before, after)
            keep = torch.nonzero((canon >= lo) & (canon < hi)).squeeze(1)
            got = (pos[keep] + (ofs + a), canon[keep], left[keep].to(torch.int8),
                   right[keep].to(torch.int8), is_rc[keep])
            for lst, t in zip(parts, got):
                lst.append(t)
            del win, pos, canon, left, right, is_rc, keep, got
        ofs += L
    dtypes = (torch.int64, torch.int64, torch.int8, torch.int8, torch.bool)
    return [torch.cat(p) if p else torch.zeros(0, dtype=dt, device=dev)
            for p, dt in zip(parts, dtypes)]


def junction_records(seqs: list[np.ndarray], k: int, device="cpu", join=exact_keys,
                     blocks: int | None = None):
    """The .dbg of the sequences' codes as an (m, 3) int32 CPU tensor of
    record rows (pos, id low word, id high word), and the junction count.
    join(canon) gives the key whose groups are judged (the control passes
    a lossy one; its groups are judged within a block). blocks: B, by
    default plan_blocks's for the device's free memory."""
    if not 1 <= k <= 31 or k % 2 == 0:
        raise ValueError(f"the reference takes odd k up to 31, not {k}")
    dev = torch.device(device)
    lengths = [len(c) for c in seqs]
    starts = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])[:-1].astype(np.int64)
    if blocks is None:
        blocks = plan_blocks(sum(max(L - k + 1, 0) for L in lengths), free_bytes(dev))
    # stub candidates: each sequence's first and last vertex position
    cand = np.unique(np.array([f for s, L in zip(starts, lengths) if L >= k
                               for f in (s, s + L - k)], dtype=np.int64))
    cand_t = torch.from_numpy(cand).to(dev)
    hit = torch.zeros(len(cand), dtype=torch.bool, device=dev)
    lists = []  # each block's occurrences on the host: (flat positions ascending, ids)
    n_junc = 0
    bounds = key_bounds(k, blocks)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        flat, canon, left, right, is_rc = block_vertices(seqs, k, dev, lo, hi)
        junc = torch.nonzero(junction_mask(join(canon), left, right)).squeeze(1)
        del left, right
        canon = canon[junc]
        table = torch.unique(canon)  # sorted canonical k-mers of the block's junctions
        occ_id = torch.searchsorted(table, canon) + (1 + n_junc)
        occ_id = torch.where(is_rc[junc], -occ_id, occ_id)
        occ_flat = flat[junc]  # ascending: the vertices are in position order
        n_junc += table.numel()
        del flat, canon, is_rc, junc, table
        hit |= torch.isin(cand_t, occ_flat)
        lists.append((occ_flat.cpu().numpy(), occ_id.cpu().numpy()))
        del occ_flat, occ_id
    # stubs: the candidates that are no junction occurrence, numbered in
    # stream order
    stubs = cand[~hit.cpu().numpy()]
    lists.append((stubs, n_junc + STUB_ID_OFFSET + np.arange(len(stubs), dtype=np.int64)))
    return torch.from_numpy(ordered_rows(lists, starts, dev)), n_junc


def ordered_rows(lists, starts: np.ndarray, dev) -> np.ndarray:
    """The records of `lists` ([(flat positions ascending, ids), ...], no
    position in two) as .dbg rows in position order, with the separators:
    an (m, 3) int32 array. Ordered on the device in pieces of CHUNK
    positions, which hold at most CHUNK records."""
    n = sum(len(f) for f, _i in lists)
    if n == 0:
        return np.zeros((0, 3), dtype=np.int32)
    top = max(int(f[-1]) for f, _i in lists if len(f))
    out = np.empty((n + int(np.searchsorted(starts, top, side="right")) - 1, 3),
                   dtype=np.int32)
    starts_t = torch.from_numpy(starts).to(dev)
    sep = torch.tensor(SEPARATOR, dtype=torch.int32, device=dev)
    row, last_seq = 0, 0
    for p in range(0, top + 1, CHUNK):
        cut = [(np.searchsorted(f, p), np.searchsorted(f, p + CHUNK)) for f, _i in lists]
        flat = torch.from_numpy(np.concatenate([f[a:b] for (f, _i), (a, b) in zip(lists, cut)]))
        if flat.numel() == 0:
            continue
        ids = torch.from_numpy(np.concatenate([i[a:b] for (_f, i), (a, b) in zip(lists, cut)]))
        flat, order = torch.sort(flat.to(dev))
        ids = ids.to(dev)[order]
        del order
        seq = torch.searchsorted(starts_t, flat, right=True) - 1
        pos = flat - starts_t[seq]
        prev = torch.cat([torch.full((1,), last_seq, dtype=torch.int64, device=dev), seq[:-1]])
        at = torch.arange(seq.numel(), device=dev) + torch.cumsum(seq - prev, 0)
        rows = sep.repeat(int(at[-1]) + 1, 1)
        rows[at, 0] = _i32(pos)
        rows[at, 1] = _i32(ids & 0xFFFFFFFF)
        rows[at, 2] = _i32(ids >> 32)
        out[row : row + len(rows)] = rows.cpu().numpy()
        row += len(rows)
        last_seq = int(seq[-1])
        del flat, ids, seq, pos, prev, at, rows
    if row != len(out):
        raise RuntimeError(f"the reference ordered {row} rows of {len(out)}")
    return out


def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [-2^31, 2^32) as the int32 of their low 32 bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def reference_dbg(fasta_path: str, k: int, device="cpu", join=exact_keys,
                  blocks: int | None = None):
    """-> (the .dbg's bytes as a uint8 numpy array, the junction count)."""
    rows, n_junc = junction_records(parse_fasta(fasta_path), k, device, join, blocks)
    return rows.numpy().view(np.uint8).reshape(-1), n_junc


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


_RECORD = np.dtype([("pos", "<u4"), ("id", "<i8")])  # 12 bytes, packed


def occurrences(dbg: np.ndarray | bytes, n_junc: int) -> tuple[int, int]:
    """The junction occurrences among a .dbg's records (ids of absolute
    value 1 .. n_junc: no stub, no separator), and the most occurrences
    of one junction."""
    rec = np.frombuffer(dbg, dtype=np.uint8)
    counts = np.zeros(n_junc + 1, dtype=np.int64)
    step = 12 << 22  # 48 MiB blocks
    end = len(rec) - len(rec) % 12
    for s in range(0, end, step):
        ids = np.abs(rec[s : min(s + step, end)].view(_RECORD)["id"])
        counts += np.bincount(ids[ids <= n_junc], minlength=n_junc + 1)
    return int(counts.sum()), int(counts.max()) if n_junc else 0
