"""The generator's interspersed repeat families (genome.py, a
configuration's optional key `repeats`): the bytes of a configuration
without the key are those of the generator before it, a repeat-bearing
base is deterministic from the seed, covers each class's share, holds
copies of its families' consensuses and gives junctions of high
multiplicity; a malformed file raises a ValueError naming the key; and
the harness builds and checks a repeat-bearing cell on the CPU. The whole
configurations give the bytes they gave before, and `lengths` cuts a
genome made whole at its sequences' boundaries."""

import copy
import hashlib
import json

import numpy as np
import pytest

from gpubench import genome, harness, reference
from gpubench.tests import cells

ECOLI62 = json.loads((cells.REPO / "gpubench" / "configs" / "ecoli62.json").read_text())

# The class shares of the human genome's interspersed repeats (Lander et al.
# 2001, Nature 409:860-921, the interspersed-repeat table): SINEs 13.1%, LINEs
# 20.4%, LTR elements 8.3%, DNA transposons 2.9%; Alu ~300 bp, L1 ~6.1 kb at
# full length with most copies 5'-truncated. One family stands for each
# class here. Assumed for the test (not from the paper): the LTR and DNA
# consensus lengths, every divergence range, the truncated shares and the
# fragment ranges.
HUMAN_CLASSES = [
    {"name": "Alu", "class": "SINE", "length": 300, "share": 0.131, "divergence": [0.02, 0.2]},
    {"name": "L1", "class": "LINE", "length": 6100, "share": 0.204, "truncated": 0.9,
     "fragment": [100, 6100], "divergence": [0.03, 0.25]},
    {"name": "ERV", "class": "LTR", "length": 2000, "share": 0.083, "truncated": 0.5,
     "fragment": [300, 2000], "divergence": [0.05, 0.25]},
    {"name": "hAT", "class": "DNA", "length": 1500, "share": 0.029, "truncated": 0.5,
     "fragment": [100, 1500], "divergence": [0.1, 0.3]},
]
BASE = dict(name="human2m", genomes=1, length=2_000_000, snp_rate=0.0, n_rate=0.0, k=31,
            repeats=HUMAN_CLASSES)


def _fasta_sha256(tmp_path, config, seed):
    path = tmp_path / f"{seed}.fa"
    genome.write_fasta(str(path), genome.config_genomes(config, seed))
    return hashlib.sha256(path.read_bytes()).hexdigest()


# ecoli62's keys at a reduced length: the FASTA's sha256 as the generator
# gave it before repeats existed
@pytest.mark.parametrize("length,seed,digest", [
    (20000, 7, "99464765963f0a28ab2672ee8727f9b7d00f68cac41857f373ba67eaf4162248"),
    (20000, 3000000019, "66d12abfbb0460410b18b3c30c9754e62b0b96cfe216953a69bbd8559b13cf67"),
    (20000, 2**63 + 11, "07552870c81a1467f6b9d77f399c3ea0741a536e1765113e4ef9986b72fd1ef6"),
    (20000, -5, "016b3f956727a42ad46c9102dd131ce86b46f8964f046d057718209a459849ae"),
    (100000, 7, "1d15569e458452950809f8334f81a49b5e2ee5a21e9f666d134b3e9d0c726a71"),
    (100000, 3000000019, "4256888ce42829db66e0c901ceba585ccd4eb70c709b0735ea544860e21f66a3"),
])
def test_ecoli62_bytes_as_before(tmp_path, length, seed, digest):
    assert _fasta_sha256(tmp_path, dict(ECOLI62, length=length), seed) == digest
    # an empty list of families is no repeats
    assert _fasta_sha256(tmp_path, dict(ECOLI62, length=length, repeats=[]), seed) == digest


# the FASTA's sha256 of each whole configuration, as the generator gave it
# before it drew the base in chunks and took `lengths`
@pytest.mark.parametrize("name,seed,digest", [
    ("ecoli62", 1, "af23b3b7fd8c92af9ee15c1a1d6475cc4b8a346ea023c1abeaccfd751b66bd3c"),
    ("ecoli62", 3000000019, "dc71129bb8c3311e858c373f4ae7fb1b99e53dd981f4ad913215451a3266b9ca"),
    ("chr1", 1, "c981da63081baa813c0e22268eb7769b93efc456d19b876f26b93b15bbcf451e"),
    ("chr1", 3000000019, "3335993ab8a5a2a9f5ee4de1379d7db43058865f5853bb228cb57b3bf30b03b1"),
])
def test_configurations_bytes_as_before(name, seed, digest):
    config = json.loads((cells.REPO / "gpubench" / "configs" / f"{name}.json").read_text())
    h = hashlib.sha256()
    for i, s in enumerate(genome.config_genomes(config, seed)):
        h.update(f">g{i}\n".encode())
        h.update(memoryview(s))
        h.update(b"\n")
    assert h.hexdigest() == digest


def test_lengths_cut_the_genome_at_the_sequences_boundaries():
    # repeats laid in over the whole genome, then cut: two genomes of three
    # sequences each, the pieces of the whole genomes in order
    lengths = [7000, 3, 12997]
    config = dict(cells.TINY_REPEATS, genomes=2, lengths=lengths)
    whole = genome.config_genomes(cells.TINY_REPEATS, 2**31 + 7)
    got = genome.config_genomes(config, 2**31 + 7)
    assert [len(s) for s in got] == lengths * 2
    for g in range(2):
        np.testing.assert_array_equal(np.concatenate(got[3 * g : 3 * g + 3]), whole[g])
    shares = harness.input_shares(config, 5)
    assert shares == harness.input_shares(cells.TINY_REPEATS, 5) and shares["SINE"] == 0.13
    # without `length` the genome is as long as the sequences
    no_length = {k: v for k, v in config.items() if k != "length"}
    assert genome.genome_length(no_length) == 20_000
    for a, b in zip(genome.config_genomes(no_length, 2**31 + 7), got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lengths", [[], [5000, 0, 15000], [5000, 2.5, 14997.5], "20000",
                                     [10000, 10001]])
def test_malformed_lengths_raise(lengths):
    with pytest.raises(ValueError, match="lengths"):
        genome.config_genomes(dict(cells.TINY_REPEATS, lengths=lengths), 1)


def test_repeats_deterministic_and_seeded(tmp_path):
    config = dict(ECOLI62, genomes=3, length=50_000, repeats=[
        dict(HUMAN_CLASSES[0]), dict(HUMAN_CLASSES[1], fragment=[100, 5000], length=5000)])
    a = _fasta_sha256(tmp_path, config, 2**31 + 3)
    assert _fasta_sha256(tmp_path, config, 2**31 + 3) == a
    assert _fasta_sha256(tmp_path, config, 2**31 + 4) != a
    assert _fasta_sha256(tmp_path, dict(config, repeats=None), 2**31 + 3) != a
    # the variants are made from the repeat-bearing base with the same draws
    # as from the uniform one: where the bases agree, the variants do
    rep = genome.config_genomes(config, 9)
    uni = genome.config_genomes(dict(config, repeats=None), 9)
    same = rep[0] == uni[0]
    for r, u in zip(rep[1:], uni[1:]):
        np.testing.assert_array_equal(r[same], u[same])


@pytest.fixture(scope="module")
def human2m():
    seed = genome.rng_seed(2**31 + 17)
    base = genome.config_genomes(BASE, seed)[0]
    uniform = genome.config_genomes(dict(BASE, repeats=None), seed)[0]
    return base, uniform, genome.repeat_layout(HUMAN_CLASSES, BASE["length"], seed)


def _copy_mask(layout, length, pick):
    mask = np.zeros(length, dtype=bool)
    for s, n in zip(layout["start"][pick], layout["size"][pick]):
        mask[s : s + n] = True
    return mask


def test_class_shares_on_a_2_mbase_base(human2m):
    base, uniform, layout = human2m
    length = BASE["length"]
    want = {f["class"]: f["share"] for f in HUMAN_CLASSES}
    assert genome.class_shares(HUMAN_CLASSES, layout, length) == pytest.approx(want, abs=1e-6)
    # measured in the bytes: a copy's base differs from the uniform base it
    # replaced with chance 3/4, and nothing outside the copies changed
    covered = np.zeros(length, dtype=bool)
    for f, fam in enumerate(HUMAN_CLASSES):
        mask = _copy_mask(layout, length, layout["family"] == f)
        assert not (mask & covered).any()  # no two copies overlap
        covered |= mask
        measured = np.count_nonzero(base[mask] != uniform[mask]) / 0.75 / length
        assert abs(measured - fam["share"]) < 0.01, (fam["class"], measured)
    np.testing.assert_array_equal(base[~covered], uniform[~covered])


def test_copies_follow_their_consensus(human2m):
    base, _uniform, layout = human2m
    comp = np.frombuffer(b"TGCA", dtype=np.uint8)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    diverged = np.zeros(len(HUMAN_CLASSES))
    bases = np.zeros(len(HUMAN_CLASSES))
    for f, s, n, minus in zip(layout["family"], layout["start"], layout["size"],
                              layout["minus"]):
        frag = layout["consensus"][f][-n:]
        want = comp[frag[::-1]] if minus else alpha[frag]  # the 3' end, either strand
        diverged[f] += np.count_nonzero(base[s : s + n] != want)
        bases[f] += n
    for f, fam in enumerate(HUMAN_CLASSES):
        lo, hi = fam["divergence"]
        assert lo < diverged[f] / bases[f] < hi, fam["name"]
    # with no divergence each copy is its consensus's fragment exactly
    exact = dict(layout, div=np.zeros_like(layout["div"]))
    laid = np.zeros(BASE["length"], dtype=np.uint8)
    genome.insert_repeats(laid, exact)
    for f, s, n, minus in zip(*(exact[key][:300] for key in ("family", "start", "size", "minus"))):
        frag = exact["consensus"][f][-n:]
        want = comp[frag[::-1]] if minus else alpha[frag]
        np.testing.assert_array_equal(laid[s : s + n], want)
    assert layout["minus"].mean() == pytest.approx(0.5, abs=0.05)
    l1 = layout["size"][layout["family"] == 1]
    assert (l1 == 6100).mean() == pytest.approx(0.1, abs=0.05)  # the rest truncated


def test_low_divergence_family_gives_a_junction_of_high_multiplicity(tmp_path):
    # one family of at most 2% divergence: its k-mers recur in hundreds of
    # copies with differing neighbours
    config = dict(BASE, repeats=[dict(HUMAN_CLASSES[0], divergence=[0.0, 0.02])])
    fa = tmp_path / "in.fa"
    genome.write_fasta(str(fa), genome.config_genomes(config, 2**31 + 29))
    want, n_junc = reference.reference_dbg(str(fa), 31)
    occurrences, most = reference.occurrences(want, n_junc)
    assert most >= 50, (n_junc, occurrences, most)
    # the uniform base has none such
    genome.write_fasta(str(fa), genome.config_genomes(dict(config, repeats=None), 2**31 + 29))
    want, n_junc = reference.reference_dbg(str(fa), 31)
    assert reference.occurrences(want, n_junc)[1] < 5


def _family(**change):
    fam = dict(HUMAN_CLASSES[1])
    fam.update(change)
    return [dict(HUMAN_CLASSES[0]), {k: v for k, v in fam.items() if v is not None}]


@pytest.mark.parametrize("repeats,key", [
    (_family(copies=12), "'copies'"),
    ([dict(HUMAN_CLASSES[0], share=0.6), dict(HUMAN_CLASSES[1], share=0.5)], "'share'"),
    (_family(length=3_000_000, fragment=[100, 3_000_000]), "'length'"),
    (_family(share=None), "'share'"),
    (_family(share=0), "'share'"),
    (_family(divergence=[0.3, 0.1]), "'divergence'"),
    (_family(fragment=None), "'fragment'"),
    (_family(fragment=[100, 7000]), "'fragment'"),
    (_family(truncated=1.5), "'truncated'"),
    (_family(name="Alu"), "'name'"),
    (_family(**{"class": None}), "'class'"),
    ({"name": "Alu"}, "repeats"),
])
def test_malformed_repeats_raise(repeats, key):
    config = dict(BASE, repeats=repeats)
    with pytest.raises(ValueError, match=key):
        genome.config_genomes(config, 1)




@pytest.mark.parametrize("traffic", ["sort-r1", "sort-r4"])
def test_harness_on_a_repeat_bearing_cell(tmp_path, traffic):
    root, cell = cells.make_root(tmp_path, copy.deepcopy(cells.TINY_REPEATS), traffic=traffic)
    out_lines = []
    rc, result, err = cells.run_cpu(root, cell, seed=2**31 + 41, out_lines=out_lines)
    assert rc == 0, err
    assert result["correct"] is True and result["failed"] == 0
    assert result["compared"]["records_differing"] == {"value": 0, "limit": 0}
    gen = next(ln for ln in out_lines if ln.startswith("input: generated in"))
    assert gen.endswith("; SINE 13.00%; LINE 20.00%")
    checked = next(ln for ln in out_lines if ln.startswith("checked build:"))
    most = int(checked.split("the most of one junction ")[1].split(",")[0])
    assert most >= 10
