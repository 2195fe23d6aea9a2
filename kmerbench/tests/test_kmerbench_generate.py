"""The generator: the same seed gives the same bytes, at the stated sizes."""

import hashlib

import numpy as np

from kmerbench import generate


def _digest(paths):
    return [hashlib.sha256(open(p, "rb").read()).hexdigest() for p in paths]


def test_records_are_deterministic_and_sized(tmp_path):
    config = {"genome_bp": 50_000}
    mix = {"input": "records", "record_bp": 10_000, "n_reads": 8,
           "runs_per_read": 5, "max_run_bp": 40}
    big = 3_000_000_017  # above 32 signed bits, as the driver's seeds are
    a, bases = generate.write_fastas(config, mix, big, str(tmp_path))
    first = _digest(a)
    b, _ = generate.write_fastas(config, mix, big, str(tmp_path))
    assert _digest(b) == first
    c, _ = generate.write_fastas(config, mix, big + 1, str(tmp_path))
    assert _digest(c) != first
    assert bases == [50_000 + 8 * 10_000]
    lines = open(a[0], "rb").read().split(b"\n")[:-1]
    seqs = lines[1::2]
    assert all(h.startswith(b">") for h in lines[::2])
    assert len(seqs) == 5 + 8
    assert sum(s.count(b"N") for s in seqs[:5]) == 0
    assert all(s.count(b"N") > 0 for s in seqs[5:])


def test_reads_count_width_and_error_rate(tmp_path):
    config = {"genome_bp": 40_000}
    mix = {"input": "reads", "read_bp": 150, "coverage": 50,
           "error_rate": 0.001}
    (path,), (bases,) = generate.write_fastas(config, mix, 7, str(tmp_path))
    n = int(50 * 40_000 / 150)
    assert bases == n * 150
    lines = open(path, "rb").read().split(b"\n")[:-1]
    assert len(lines) == 2 * n
    assert {len(s) for s in lines[1::2]} == {150}
    assert lines[0] == b">r000000000" and lines[-2] == b">r%09d" % (n - 1)


def test_read_errors_and_strands(tmp_path):
    g = generate.genomes({"genome_bp": 5_000}, 11)[0]
    rng = generate.rng_of(11, 2)
    path = str(tmp_path / "r.fa")
    generate.write_reads(path, g, {"read_bp": 100, "coverage": 40,
                                   "error_rate": 0.01}, rng)
    text = generate.BASES[g].tobytes()
    rc = generate.BASES[3 - g[::-1]].tobytes()
    exact = fwd = 0
    reads = open(path, "rb").read().split(b"\n")[1::2]
    for r in reads:
        exact += r in text or r in rc
        fwd += r in text
    # 1% errors per base leaves (0.99)^100 = 37% of reads exact.
    assert 0.25 < exact / len(reads) < 0.5
    assert 0.3 < fwd / max(1, exact) < 0.7


def test_tree_substitutes_each_level_at_its_rate():
    config = {"genome_bp": 100_000,
              "tree": [[0.005] * 4, [0.0005, 0.001, 0.002, 0.004]]}
    leaves = generate.genomes(config, 5)
    assert len(leaves) == 16
    again = generate.genomes(config, 5)
    assert all(np.array_equal(a, b) for a, b in zip(leaves, again))
    # Strains 0 and 1 of a clade differ at about 50 + 100 sites, strain 1
    # of two clades at about 2 x (500 + 100).
    same = int(np.count_nonzero(leaves[0] != leaves[1]))
    other = int(np.count_nonzero(leaves[1] != leaves[5]))
    assert 120 <= same <= 150
    assert 1000 <= other <= 1200


def test_substitute_changes_exactly_its_share():
    rng = np.random.default_rng(1)
    g = rng.integers(0, 4, 10_000, dtype=np.uint8)
    m = generate.substitute(g, 0.01, rng)
    assert int(np.count_nonzero(m != g)) == 100
