"""The synthetic pangenome the cells build, generated from a seed.

A frozen copy of twopaco_tpu_torch/testing/bench_data.py's generator (the
same bytes for the same arguments): one uniform random base genome and
n - 1 copies of it, each with independent substitutions and N runs. The
benchmark keeps its own copy so that a change to the program's testing
helpers cannot change what the benchmark feeds the program.

A configuration may add interspersed repeat families to the base genome
(its optional key `repeats`, a list of families; see check_repeats). Each
family has a random consensus, and copies of it, whole or 5'-truncated,
on either strand, each with its own share of substitutions, are laid into
the base until the family covers its share of it. The copies and their
places are drawn from a generator of their own, so that every draw of the
base's and the variants' stream is as without repeats: a configuration
without `repeats` gets exactly the bytes it got before repeats existed.
"""

from __future__ import annotations

import numpy as np

_ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)

# a repeat family's keys: {key: required}
FAMILY_KEYS = {"name": True, "class": True, "length": True, "share": True,
               "divergence": True, "truncated": False, "fragment": False}
_CHUNK = 1 << 24  # bases drawn, or repeat bases laid in, at once (bounds the host memory)


def make_bench_genomes(
    n_seqs: int = 8,
    length: int = 8_000_000,
    snp_rate: float = 0.01,
    n_rate: float = 1e-4,
    seed: int = 2016,
    repeats: list[dict] | None = None,
) -> list[np.ndarray]:
    """Returns byte arrays (ASCII) of the sequences. repeats: families as
    check_repeats takes them, laid into the base genome before its
    variants are made."""
    rng = np.random.default_rng(seed)
    # drawn in even chunks, the same stream as one draw, so that a genome of
    # Gbases holds no int64 code a base on the host
    base = np.empty(length, dtype=np.uint8)
    for a in range(0, length, _CHUNK):
        base[a : a + _CHUNK] = _ALPHA[rng.integers(0, 4, size=min(_CHUNK, length - a))]
    if repeats:
        insert_repeats(base, repeat_layout(repeats, length, seed))
    seqs = [base]
    for _ in range(1, n_seqs):
        s = base.copy()
        flip = rng.random(length) < snp_rate
        s[flip] = _ALPHA[rng.integers(0, 4, size=int(flip.sum()))]
        ns = rng.random(length) < n_rate
        s[ns] = ord("N")
        seqs.append(s)
    return seqs


def rng_seed(seed: int) -> int:
    """The generator's seed for a benchmark --seed: any whole number,
    taken modulo 2^64 (numpy takes non-negative seeds; the ones below
    2^63 pass unchanged)."""
    return seed % (1 << 64)


def config_genomes(config: dict, seed: int) -> list[np.ndarray]:
    """The sequences of a configuration file's sizes for --seed."""
    length = genome_length(config)
    repeats = config.get("repeats")
    if repeats is not None:
        check_repeats(repeats, length)
    seqs = make_bench_genomes(
        n_seqs=int(config["genomes"]), length=length,
        snp_rate=float(config["snp_rate"]), n_rate=float(config["n_rate"]),
        seed=rng_seed(seed), repeats=repeats,
    )
    lengths = config.get("lengths")
    if lengths is None:
        return seqs
    ends = np.cumsum([int(n) for n in lengths])
    return [s[e - int(n) : e] for s in seqs for n, e in zip(lengths, ends)]


def genome_length(config: dict) -> int:
    """A genome's length in bases: the sum of the configuration's `lengths`
    where it has them (check_lengths), else its `length`."""
    lengths = config.get("lengths")
    if lengths is None:
        return int(config["length"])
    check_lengths(lengths, config.get("length"))
    return int(sum(lengths))


def check_lengths(lengths, length=None) -> None:
    """Raises a ValueError, naming the key, unless `lengths` is a non-empty
    list of whole numbers >= 1 (a genome's sequences, in order) that adds
    up to `length` where that is given."""
    if (not isinstance(lengths, list) or not lengths
            or not all(_whole(n) and n >= 1 for n in lengths)):
        raise ValueError(f"lengths: a non-empty list of whole numbers >= 1 is wanted, "
                         f"not {lengths!r}")
    if length is not None and int(sum(lengths)) != length:
        raise ValueError(f"lengths: they add up to {int(sum(lengths))}, not to the key "
                         f"'length' {length!r}")


# ---- interspersed repeats ---------------------------------------------------


def check_repeats(repeats, length: int) -> None:
    """Raises a ValueError, naming the key, unless `repeats` is a list of
    families, each an object with these keys and no other:
      name        a name of its own;
      class       the class its share counts in (SINE, LINE, ...);
      length      its consensus length in bases, at most the genome's;
      share       the share of the genome its copies cover, in (0, 1];
                  the families' shares add to at most 1;
      divergence  [lo, hi]: a copy's share of substituted bases, drawn
                  uniformly from this range, 0 <= lo <= hi <= 1;
      truncated   (optional, 0 by default) the share of copies that are
                  5'-truncated fragments, in [0, 1]; the others are whole;
      fragment    [lo, hi] (with truncated > 0): a fragment's length,
                  drawn uniformly, 1 <= lo <= hi <= length."""
    if not isinstance(repeats, list):
        raise ValueError("repeats: a list of repeat families is wanted")
    names, total = set(), 0.0
    for i, fam in enumerate(repeats):
        where = f"repeats[{i}]"
        if not isinstance(fam, dict):
            raise ValueError(f"{where}: a repeat family is an object")
        for key in fam:
            if key not in FAMILY_KEYS:
                raise ValueError(f"{where}: unknown key {key!r}")
        for key, required in FAMILY_KEYS.items():
            if required and key not in fam:
                raise ValueError(f"{where}: key {key!r} is missing")
        name = fam["name"]
        if not isinstance(name, str) or not name or name in names:
            raise ValueError(f"{where}: key 'name' must be a name of its own, not {name!r}")
        names.add(name)
        where = f"{where} ({name})"
        if not isinstance(fam["class"], str) or not fam["class"]:
            raise ValueError(f"{where}: key 'class' must be a name")
        size = fam["length"]
        if not _whole(size) or size < 1:
            raise ValueError(f"{where}: key 'length' must be a whole number >= 1, not {size!r}")
        if size > length:
            raise ValueError(f"{where}: key 'length' {size} is longer than the genome's "
                             f"length {length}")
        share = fam["share"]
        if not _number(share) or not 0 < share <= 1:
            raise ValueError(f"{where}: key 'share' must be in (0, 1], not {share!r}")
        total += share
        _check_range(fam["divergence"], f"{where}: key 'divergence'", 0, 1)
        truncated = fam.get("truncated", 0)
        if not _number(truncated) or not 0 <= truncated <= 1:
            raise ValueError(f"{where}: key 'truncated' must be in [0, 1], not {truncated!r}")
        if "fragment" in fam:
            lo, hi = _check_range(fam["fragment"], f"{where}: key 'fragment'", 1, size)
            if not (_whole(lo) and _whole(hi)):
                raise ValueError(f"{where}: key 'fragment' must hold whole numbers")
        elif truncated > 0:
            raise ValueError(f"{where}: key 'fragment' is missing (truncated > 0)")
    if total > 1 + 1e-9:
        raise ValueError(f"repeats: the families' key 'share' adds to {total!r}, more than 1")


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _whole(x) -> bool:
    return _number(x) and float(x).is_integer()


def _check_range(r, where: str, lo: float, hi: float):
    if (not isinstance(r, list) or len(r) != 2 or not all(map(_number, r))
            or not lo <= r[0] <= r[1] <= hi):
        raise ValueError(f"{where} must be [lo, hi] with {lo} <= lo <= hi <= {hi}, not {r!r}")
    return r


def repeat_layout(repeats: list[dict], length: int, seed: int) -> dict:
    """Where the copies of each family lie in a base genome of `length`,
    drawn from the generator np.random.default_rng([seed, 1]) (seed: a
    generator seed, rng_seed's): the families' consensuses (random codes
    0-3) and one entry a copy in arrays of equal length:
      family  the copy's family (its index in `repeats`);
      start   its first base in the genome;
      size    its length: the consensus's, or a 5'-truncated fragment's,
              the consensus's last `size` bases (one copy a family may be
              cut shorter, so that its copies cover floor(share x length)
              bases);
      minus   whether it lies on the reverse strand (reverse complement);
      div     its share of substituted bases;
    and rng_state, the generator's state after these draws.
    The copies of all families are laid in one random order with random
    stretches of the base between them, so no two overlap and each family
    covers its share exactly."""
    rng = np.random.default_rng([seed, 1])
    cons, fam, size, minus, div = [], [], [], [], []
    for f, r in enumerate(repeats):
        full = int(r["length"])
        cons.append(rng.integers(0, 4, size=full, dtype=np.uint8))
        truncated = float(r.get("truncated", 0))
        lo, hi = (int(x) for x in r.get("fragment", [full, full]))
        mean = (1 - truncated) * full + truncated * (lo + hi) / 2
        target = int(float(r["share"]) * length)
        sizes, have = [], 0
        while have < target:
            m = int((target - have) / mean * 1.1) + 16
            s = np.where(rng.random(m) < truncated, rng.integers(lo, hi + 1, size=m), full)
            sizes.append(s)
            have += int(s.sum())
        s = np.concatenate(sizes) if sizes else np.zeros(0, dtype=np.int64)
        cum = np.cumsum(s)
        n = int(np.searchsorted(cum, target)) + 1 if target else 0
        s = s[:n].astype(np.int64)
        if n:
            s[-1] -= int(cum[n - 1]) - target
        fam.append(np.full(n, f, dtype=np.int32))
        size.append(s)
        minus.append(rng.random(n) < 0.5)
        dlo, dhi = (float(x) for x in r["divergence"])
        div.append(rng.uniform(dlo, dhi, size=n))
    fam, size = np.concatenate(fam), np.concatenate(size)
    minus, div = np.concatenate(minus), np.concatenate(div)
    order = rng.permutation(len(fam))
    fam, size, minus, div = fam[order], size[order], minus[order], div[order]
    background = length - int(size.sum())
    cuts = np.sort(rng.integers(0, background + 1, size=len(fam)))
    start = cuts + np.cumsum(size) - size
    return dict(consensus=cons, family=fam, start=start, size=size, minus=minus, div=div,
                rng_state=rng.bit_generator.state)


def insert_repeats(base: np.ndarray, layout: dict) -> None:
    """Lay the copies of `layout` into `base` (ASCII, in place): each copy
    is its consensus's last `size` bases, reverse-complemented on the minus
    strand, with each base substituted (by one of the three other bases)
    with the copy's `div` as its chance. The substitutions are drawn after
    the layout's draws, from the same generator (from its rng_state, so
    the same layout always gives the same bases)."""
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = layout["rng_state"]
    cons = np.concatenate(layout["consensus"])
    fam_end = np.cumsum([len(c) for c in layout["consensus"]])  # one past each consensus
    fam, start, size = layout["family"], layout["start"], layout["size"]
    minus, div = layout["minus"], layout["div"].astype(np.float32)
    bounds = _chunks(size)
    for a, b in zip(bounds[:-1], bounds[1:]):
        sz, neg = size[a:b], minus[a:b]
        n = int(sz.sum())
        first = np.cumsum(sz) - sz  # each copy's first base among the chunk's n
        # the consensus index of each base: a run up (plus strand) or down
        # (minus) from the copy's first, one cumsum over steps of +-1
        end = fam_end[fam[a:b]]
        src0 = np.where(neg, end - 1, end - sz)
        step = np.where(neg, -1, 1)
        jump = src0 - np.concatenate([[0], (src0 + step * (sz - 1))[:-1]])
        delta = np.repeat(step.astype(np.int32), sz)
        delta[first] = jump
        codes = cons[np.cumsum(delta, dtype=np.int32)]
        codes ^= np.repeat(neg.astype(np.uint8) * 3, sz)  # complement: 3 - code
        sub = rng.random(n, dtype=np.float32) < np.repeat(div[a:b], sz)
        codes[sub] = (codes[sub] + rng.integers(1, 4, size=int(sub.sum()), dtype=np.uint8)) & 3
        # the copies lie in start order without overlap: the chunk's bases
        # fill the places a mask over its span marks, in order
        lo, hi = int(start[a]), int(start[b - 1] + sz[-1])
        runs = np.empty(2 * (b - a), dtype=np.int64)
        runs[0::2] = start[a:b] - np.concatenate([[lo], (start[a:b] + sz)[:-1]])  # gaps
        runs[1::2] = sz
        base[lo:hi][np.repeat(np.tile([False, True], b - a), runs)] = _ALPHA[codes]


def _chunks(size: np.ndarray) -> list[int]:
    """Copy boundaries [0, ..., n] of groups holding at most _CHUNK bases
    each (a copy longer than that is a group of its own)."""
    cum = np.cumsum(size)
    bounds, a = [0], 0
    while a < len(size):
        b = int(np.searchsorted(cum, (cum[a - 1] if a else 0) + _CHUNK, side="right"))
        a = max(b, a + 1)
        bounds.append(a)
    return bounds


def class_shares(repeats: list[dict], layout: dict, length: int) -> dict[str, float]:
    """{class: share of the genome its families' copies cover}."""
    covered = np.bincount(layout["family"], weights=layout["size"], minlength=len(repeats))
    out: dict[str, float] = {}
    for r, c in zip(repeats, covered):
        out[r["class"]] = out.get(r["class"], 0.0) + float(c) / length
    return out


def write_fasta(path: str, seqs: list[np.ndarray]) -> int:
    """Write the sequences as FASTA, one line a record (headers g0, g1,
    ...); returns the number of bases."""
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(f">g{i}\n".encode())
            f.write(memoryview(s))
            f.write(b"\n")
    return int(sum(len(s) for s in seqs))
