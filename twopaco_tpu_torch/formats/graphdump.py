"""graphdump: render the binary junction list to text formats.

The port of twopaco_tpu/formats/graphdump.py, the reference graphdump's
semantics (graphdump.cpp): seq, group, dot, gfa1, gfa2, fasta. Host text
generation in numpy (no device work).

Segment identity (graphdump.cpp:42-113): the unitig between consecutive
junctions (begin, end) gets a deterministic id derived from its
lower-abs-id endpoint:
    segId = beginId << 3 | signbit << 2 | code(first-edge-char)
negated if the orientation was flipped; paths whose edge char is 'N'
get sequential "reserved" ids from 2^34 (ID_POWER = 35).

Divergence note: for non-ACGT, non-N edge chars (e.g. 'Y') the reference
computes an out-of-range char code (DnaChar::MakeUpChar returns
(size_t)-1, graphdump.cpp:64), which is undefined behavior. Here any
non-ACGT edge char takes the reserved-id path.
"""

from __future__ import annotations

from typing import Iterable, TextIO

import numpy as np

from twopaco_tpu_torch.io import fasta as fasta_io
from twopaco_tpu_torch.io import junctions as junction_io

ID_POWER = 35
RESERVED_START = 1 << (ID_POWER - 1)
MAX_JUNCTION_ID = 1 << (ID_POWER - 4)

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
_REV = {"A": "T", "T": "A", "C": "G", "G": "C"}

# char -> 2-bit code (255 = non-ACGT) for vectorized edge-char gathers
_CODE_TABLE = np.full(256, 255, np.uint8)
for _ch, _cd in _CODE.items():
    _CODE_TABLE[ord(_ch)] = _cd

# DnaChar::ReverseCompliment as a translate table (ambiguity -> 'N')
_REVCOMP_TABLE = str.maketrans(
    {chr(b): _REV.get(chr(b), "N") for b in range(256)}
)


def _revcomp_text(s: str) -> str:
    """DnaChar::ReverseCompliment over text (ambiguity chars -> 'N')."""
    return s.translate(_REVCOMP_TABLE)[::-1]


def _sign(x: int) -> str:
    return "+" if x >= 0 else "-"


_CHUNK = 1 << 18  # rows per buffered write (numpy-scalar formatting and
# per-line write() syscalls dominate at Mbase scale otherwise)


def generate_seq(in_path: str, out: TextIO) -> None:
    """One line 'chr pos id' per occurrence (graphdump.cpp:160-168)."""
    c, pos, ids = junction_io.read_junctions(in_path)
    n = len(c)
    for s in range(0, n, _CHUNK):
        e = min(s + _CHUNK, n)
        rows = zip(
            c[s:e].tolist(), pos[s:e].tolist(), ids[s:e].tolist()
        )
        out.write("".join(f"{a} {b} {i}\n" for a, b, i in rows))


def generate_group(in_path: str, out: TextIO) -> None:
    """Occurrences grouped by junction id; classes ordered by their first
    (chr, pos); line = 'chr pos; ' per member (graphdump.cpp:120-158)."""
    c, pos, ids = junction_io.read_junctions(in_path)
    order = np.lexsort((pos, c, ids))
    c, pos, ids = c[order], pos[order], ids[order]
    n = len(ids)
    starts = np.flatnonzero(
        np.concatenate([[True], ids[1:] != ids[:-1]])
    )
    bounds = np.append(starts, n)
    # one %-format pass over all occurrences (measured ~2x faster than
    # per-member f-strings at 126M records), then per-class joins
    members = list(
        map("%d %d; ".__mod__, zip(c.tolist(), pos.tolist()))
    )
    classes = []
    for gi in range(len(starts)):
        s, e = bounds[gi], bounds[gi + 1]
        classes.append("".join(members[s:e]) + "\n")
    # classes ordered by their first (chr, pos)
    first = np.lexsort((pos[starts], c[starts]))
    buf = []
    for j in first.tolist():
        buf.append(classes[j])
        if len(buf) >= 4096:
            out.write("".join(buf))
            buf.clear()
    out.write("".join(buf))


def generate_dot(in_path: str, out: TextIO) -> None:
    """Blue forward / red reverse edges between consecutive same-chr
    junctions (graphdump.cpp:585-606)."""
    c, pos, ids = junction_io.read_junctions(in_path)
    out.write("digraph G\n{\n\trankdir = LR\n")
    cl, pl, il = c.tolist(), pos.tolist(), ids.tolist()
    buf = []
    prev = None
    for cc, pp, ii in zip(cl, pl, il):
        if prev is not None and prev[0] == cc:
            pc, ppos, pid = prev
            buf.append(
                f"\t{pid} -> {ii}"
                f'[color="blue", label="chr={pc} pos={ppos}"]\n'
                f"\t{-ii} -> {-pid}"
                f'[color="red", label="chr={pc} pos={ppos}"]\n'
            )
            if len(buf) >= 4096:
                out.write("".join(buf))
                buf.clear()
        prev = (cc, pp, ii)
    out.write("".join(buf))
    out.write("}\n")


def _read_input_names(
    genomes: Iterable[str], prefix: bool
) -> tuple[list[str], list[int], dict[str, str]]:
    """Chromosome display names + lengths (ReadInputSequences,
    graphdump.cpp:175-204; note the reference never increments chrCount,
    so --prefix yields 's0_<header>' for every record — replicated)."""
    names, lengths, file_of = [], [], {}
    for path in genomes:
        for header, codes in fasta_io.read_fasta(path):
            name = f"s0_{header}" if prefix else header
            names.append(name)
            lengths.append(len(codes))
            file_of[name] = str(path)
    return names, lengths, file_of


class _Gfa1:
    def header(self, out):
        out.write("H\tVN:Z:1.0\n")

    def list_input_sequences(self, names, file_of, out):
        for n in names:
            out.write(f"S\t{n}\t*\tUR:Z:{file_of[n]}\n")

    def segment(self, seg_id, seg_size, body, out):
        out.write(f"S\t{abs(seg_id)}\t{body}\n")

    def occurrence(self, seg_id, seg_size, chr_name, chr_len, begin, end, k, out):
        out.write(
            f"C\t{abs(seg_id)}\t{_sign(seg_id)}\t{chr_name}\t+\t{end}\n"
        )

    def edge(self, prev_id, prev_size, seg_id, seg_size, k, out):
        out.write(
            f"L\t{abs(prev_id)}\t{_sign(prev_id)}\t{abs(seg_id)}\t"
            f"{_sign(seg_id)}\t{k}M\n"
        )

    def flush_path(self, path, chr_name, k, out):
        if path:
            body = ",".join(f"{abs(x)}{_sign(x)}" for x in path)
            out.write(f"P\t{chr_name}\t{body}\t*\n")
            path.clear()


def _gfa2_pos(pos: int, length: int) -> str:
    return f"{pos}$" if pos == length else f"{pos}"


class _Gfa2:
    def header(self, out):
        out.write("H\tVN:Z:2.0\n")

    def list_input_sequences(self, names, file_of, out):
        pass

    def segment(self, seg_id, seg_size, body, out):
        out.write(f"S\t{abs(seg_id)}\t{seg_size}\t{body}\n")

    def occurrence(self, seg_id, seg_size, chr_name, chr_len, begin, end, k, out):
        out.write(
            f"F\t{abs(seg_id)}\t{chr_name}{_sign(seg_id)}\t0\t{seg_size}$\t"
            f"{_gfa2_pos(begin, chr_len)}\t{_gfa2_pos(end + k, chr_len)}\t{k}M\n"
        )

    def edge(self, prev_id, prev_size, seg_id, seg_size, k, out):
        if prev_id > 0:
            ps, pe = prev_size - k, prev_size
        else:
            ps, pe = 0, k
        if seg_id > 0:
            ss, se = 0, k
        else:
            ss, se = seg_size - k, seg_size
        out.write(
            f"E\t{abs(prev_id)}{_sign(prev_id)}\t{abs(seg_id)}{_sign(seg_id)}\t"
            f"{_gfa2_pos(ps, prev_size)}\t{_gfa2_pos(pe, prev_size)}\t"
            f"{_gfa2_pos(ss, seg_size)}\t{_gfa2_pos(se, seg_size)}\t{k}M\n"
        )

    def flush_path(self, path, chr_name, k, out):
        if path:
            body = " ".join(f"{abs(x)}{_sign(x)}" for x in path)
            out.write(f"O\t{chr_name}p\t{body}\n")
            path.clear()


def _run_segment_ids(
    b_id: np.ndarray,
    e_id: np.ndarray,
    bpos: np.ndarray,
    epos: np.ndarray,
    text: str,
    k: int,
    reserved: int,
) -> tuple[np.ndarray, int]:
    """The segment ids of one chromosome's consecutive-junction pairs
    (graphdump.cpp:42-113): a pair is named from its begin id when |begin|
    < |end|, or they are equal and begin > 0, with the char after the
    begin junction as its edge char; else from -end with the complement of
    the char before the end junction. seg = |base| << 3 | (base < 0) << 2
    | code(edge char), negated when the base is not the begin id; an edge
    char outside ACGT takes the next reserved id instead. -> (ids, the next
    reserved id)."""
    codes = np.frombuffer(text.encode("latin-1"), np.uint8)
    absb, abse = np.abs(b_id), np.abs(e_id)
    if len(absb) and max(int(absb.max()), int(abse.max())) >= MAX_JUNCTION_ID:
        raise RuntimeError("A vertex id is too large, cannot generate GFA")
    use_pos = (absb < abse) | ((absb == abse) & (b_id > 0))
    pos_code = _CODE_TABLE[codes[bpos + k]]
    ecode = _CODE_TABLE[codes[epos - 1]]
    neg_code = np.where(ecode < 4, 3 - ecode, 255).astype(np.uint8)
    edge_code = np.where(use_pos, pos_code, neg_code)
    base = np.where(use_pos, b_id, -e_id)
    is_res = edge_code > 3
    seg = (
        edge_code.astype(np.int64)
        | np.where(base < 0, 4, 0)
        | (np.abs(base) << 3)
    )
    seg = np.where(b_id != base, -seg, seg)
    seg = np.where(is_res, reserved + np.cumsum(is_res) - 1, seg)
    return seg, reserved + int(is_res.sum())


def _iter_chr_segments(in_path: str, genomes: list[str], k: int):
    """Yield (seq_id, chr_text, seg_id, seg_size, bpos, epos) per
    chromosome appearing in the junction list — the vectorized
    equivalent of GenerateGfaOutput's lockstep walk
    (graphdump.cpp:377-478). The arrays cover the chromosome's
    consecutive-junction segments in stream order (may be empty)."""
    chr_iter = fasta_io.read_sequences_text(genomes)
    c, pos, ids = junction_io.read_junctions(in_path)
    if len(c) == 0:
        return
    pos = pos.astype(np.int64)
    # Sequences shorter than k emit no junction records, so chromosome
    # ids in the binary may skip values; advance the text reader in
    # lockstep. (The reference graphdump instead throws 'The input is
    # corrupted' on such input, graphdump.cpp:468 — deliberate fix.)
    seq_id = -1
    chr_text = None

    def advance_to(target: int):
        nonlocal seq_id, chr_text
        if target < seq_id:
            raise RuntimeError("The input is corrupted")
        while seq_id < target:
            chr_text = next(chr_iter)
            seq_id += 1

    runs = np.flatnonzero(np.r_[True, c[1:] != c[:-1]])
    bounds = np.append(runs, len(c))
    reserved = RESERVED_START
    for ri in range(len(runs)):
        s, e = int(bounds[ri]), int(bounds[ri + 1])
        advance_to(int(c[s]))
        b_id, e_id = ids[s : e - 1], ids[s + 1 : e]
        bpos, epos = pos[s : e - 1], pos[s + 1 : e]
        seg, reserved = _run_segment_ids(
            b_id, e_id, bpos, epos, chr_text, k, reserved
        )
        yield seq_id, chr_text, seg, epos + k - bpos, bpos, epos


class _ChunkedWriter:
    """Append-and-join buffer: turns millions of small write() calls
    into a few large ones (the syscall/TextIO overhead dominates GFA
    generation at Gbase scale otherwise)."""

    def __init__(self, out: TextIO, limit: int = 1 << 22):
        self.out = out
        self.parts: list[str] = []
        self.size = 0
        self.limit = limit

    def write(self, s: str) -> None:
        self.parts.append(s)
        self.size += len(s)
        if self.size >= self.limit:
            self.flush()

    def flush(self) -> None:
        if self.parts:
            self.out.write("".join(self.parts))
            self.parts.clear()
            self.size = 0


def generate_gfa(
    in_path: str,
    genomes: list[str],
    k: int,
    out: TextIO,
    version: int = 1,
    prefix: bool = False,
) -> None:
    g = _Gfa1() if version == 1 else _Gfa2()
    names, lengths, file_of = _read_input_names(genomes, prefix)
    g.header(out)
    g.list_input_sequences(names, file_of, out)

    w = _ChunkedWriter(out)
    seen: set[int] = set()
    path: list[int] = []
    for seq_id, chr_text, seg, ssz, sbp, sep in _iter_chr_segments(
        in_path, genomes, k
    ):
        name, clen = names[seq_id], lengths[seq_id]
        prev_seg, prev_size = 0, -1
        for sid, sz, bp, ep in zip(
            seg.tolist(), ssz.tolist(), sbp.tolist(), sep.tolist()
        ):
            path.append(sid)
            a = -sid if sid < 0 else sid
            if a not in seen:
                seen.add(a)
                body = chr_text[bp : ep + k]
                if sid < 0:
                    body = _revcomp_text(body)
                g.segment(sid, sz, body, w)
            g.occurrence(sid, sz, name, clen, bp, ep, k, w)
            if prev_seg != 0:
                g.edge(prev_seg, prev_size, sid, sz, k, w)
            prev_seg, prev_size = sid, sz
        g.flush_path(path, name, k, w)
    w.flush()


def generate_fasta(
    in_path: str, genomes: list[str], k: int, out: TextIO
) -> None:
    """Each distinct segment once, 80-column wrapped
    (graphdump.cpp:499-582)."""
    seen: set[int] = set()
    w = _ChunkedWriter(out)
    for _sid_chr, chr_text, seg, _ssz, sbp, sep in _iter_chr_segments(
        in_path, genomes, k
    ):
        for sid, bp, ep in zip(
            seg.tolist(), sbp.tolist(), sep.tolist()
        ):
            a = -sid if sid < 0 else sid
            if a in seen:
                continue
            seen.add(a)
            body = chr_text[bp : ep + k]
            if sid < 0:
                body = _revcomp_text(body)
            w.write(f">{a}\n")
            w.write(
                "\n".join(
                    body[j : j + 80] for j in range(0, len(body), 80)
                )
                + "\n"
            )
    w.flush()
