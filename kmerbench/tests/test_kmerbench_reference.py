"""The plain reference on hand-made cases."""

import pytest
import torch

from kmerbench.reference import check, kmers



def _key(s):
    v = 0
    for ch in s:
        v = v * 4 + "ACGT".index(ch)
    return v


def _rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _canon(s):
    return min(_key(s), _key(_rc(s)))


def _write(path, text):
    path.write_bytes(text.encode())
    return str(path)


def test_keys_are_canonical_and_stop_at_breaks(tmp_path):
    fa = _write(tmp_path / "a.fa", ">x ACGTACGT\nACGTTNGGA\n>y\nCCCA\n")
    codes = kmers.fasta_codes(fa)
    got = sorted(kmers.window_keys(torch.from_numpy(codes), 3, True).tolist())
    want = sorted(_canon(w) for w in ("ACG", "CGT", "GTT", "GGA", "CCC", "CCA"))
    assert got == want
    fwd = sorted(kmers.window_keys(torch.from_numpy(codes), 3, False).tolist())
    assert fwd == sorted(_key(w) for w in ("ACG", "CGT", "GTT", "GGA", "CCC", "CCA"))


def test_counts_and_cutoff_across_blocks(tmp_path, monkeypatch):
    monkeypatch.setattr(kmers, "BLOCK", 4)  # windows across block edges
    fa = _write(tmp_path / "a.fa", ">1\nAAAAAAC\n>2\nGTTTTTT\n")
    s, stats = kmers.kmer_set(fa, 3, 2, "cpu")
    # AAA x4 and TTT x4 are one canonical k-mer: count 8; AAC|GTT: 2.
    assert s.tolist() == sorted([_canon("AAA"), _canon("AAC")])
    assert stats == {"windows": 10, "distinct": 2, "kept": 2}
    s, stats = kmers.kmer_set(fa, 3, 3, "cpu")
    assert s.tolist() == [_canon("AAA")]
    assert stats["kept"] == 1


def test_decode_counts_doubles_and_malformed(tmp_path):
    dump = _write(tmp_path / "d.txt", "AACA\nAACX\nTGT\n")
    u, doubled, malformed, strings = kmers.decode_dump(dump, 3, "cpu")
    assert u.tolist() == sorted({_canon("AAC"), _canon("ACA")})
    assert doubled == 2  # AAC once more, ACA once more (TGT is its reverse)
    assert malformed == 1
    assert strings == 3


def test_set_errors_hash_and_lines():
    a = torch.tensor([1, 2, 3])
    assert kmers.set_errors(a, torch.tensor([2, 3, 4, 5])) == 3
    assert kmers.set_errors(a, a) == 0
    assert kmers.set_errors(a, torch.tensor([], dtype=torch.int64)) == 3
    assert kmers.xor_hash(torch.tensor([1, 2, 4])) == 7
    assert kmers.to_lines(torch.tensor([_key("ACG"), _key("TTA")]), 3) == b"ACG\nTTA\n"


def test_check_build_finds_a_wrong_and_a_doubled_kmer(tmp_path):
    fa = _write(tmp_path / "a.fa", ">1\nAACAGG\n")
    right = _write(tmp_path / "r.txt", "CCTGTT\n")
    parts, numbers, stats = check.check_build([fa], right, 3, 1, "cpu")
    assert sum(parts.values()) == 0
    assert stats["unitigs"] == 1 and numbers == {"strings_per_unitig": 1.0}
    lines = _write(tmp_path / "l.txt", "AAC\nACA\nCAG\nAGG\n")
    parts, numbers, _ = check.check_build([fa], lines, 3, 1, "cpu")
    assert sum(parts.values()) == 0 and numbers == {"strings_per_unitig": 4.0}
    wrong = _write(tmp_path / "w.txt", "AACAGT\n")
    assert check.check_build([fa], wrong, 3, 1, "cpu")[0]["k-mers wrong"] == 2
    twice = _write(tmp_path / "t.txt", "AACAGG\nCCT\n")
    assert check.check_build([fa], twice, 3, 1, "cpu")[0]["k-mers doubled"] == 1
    parts, _, _ = check.check_build([fa], str(tmp_path / "none.txt"), 3, 1, "cpu")
    assert sum(parts.values()) > 0


def _directory(tmp_path, residual0):
    d = tmp_path / "dir"
    d.mkdir(exist_ok=True)
    # set 0 = 0.txt + 2.txt, set 1 = 1.txt + 2.txt
    (d / "meta.txt").write_text("2 0 1 2 1 1 2\n3\n")
    (d / "0.txt").write_text(residual0)
    (d / "1.txt").write_text("CAAA\n")
    (d / "2.txt").write_text("AACAG\n")
    (tmp_path / "g.dot").write_text("digraph G {\nv0 -> v2\nv1 -> v2\n}\n")
    return str(d)


def test_check_compress_and_decompress(tmp_path):
    f0 = _write(tmp_path / "0.fa", ">0\nAACAG\n>1\nCCCA\n")
    f1 = _write(tmp_path / "1.fa", ">0\nCTGTT\n>1\nTTTG\n")
    d = _directory(tmp_path, "TGGG\n")
    dot = str(tmp_path / "g.dot")
    parts, numbers, stats = check.check_compress([f0, f1], d, dot, 3, 1, "cpu")
    assert sum(parts.values()) == 0, parts
    assert (stats["stored"], stats["union"]) == (7, 7)
    assert numbers == {"stored_per_union": 1.0}
    (tmp_path / "g.dot").write_text("digraph G {\nv0 -> v2\n}\n")
    assert check.check_compress([f0, f1], d, dot, 3, 1, "cpu")[0]["edges wrong"] == 1
    d = _directory(tmp_path, "CCCT\n")  # CCA lost, CCT gained
    assert check.check_compress([f0, f1], d, dot, 3, 1, "cpu")[0]["k-mers wrong"] == 2

    d = _directory(tmp_path, "CCCA\n")
    sets = [torch.tensor(sorted({_canon(w) for w in ws})) for ws in
            (("AAC", "ACA", "CAG", "CCC", "CCA"), ("AAC", "ACA", "CAG", "TTT", "TTG"),
             ("AAC", "ACA", "CAG"))]
    lines = [(0.0, f"kmer_set.{n}() = {v}") for s in sets
             for n, v in (("Hash", kmers.xor_hash(s)), ("Size", s.numel()))]
    parts, _, stats = check.check_decompress([f0, f1], d, check.logged_sets(lines),
                                             3, 1, "cpu")
    assert sum(parts.values()) == 0, parts
    assert stats["sizes"] == [5, 5, 3]
    parts, _, _ = check.check_decompress([f0, f1], d, check.logged_sets(lines[:4]),
                                         3, 1, "cpu")
    assert parts["sets wrong"] == 1


def _unitigs_by_hand(strings, k):
    """Maximal unitigs (cycles left out) of the canonical k-mers of
    `strings`, walked one k-mer at a time."""
    S = {min(s[i:i + k], _rc(s[i:i + k])) for s in strings
         for i in range(len(s) - k + 1)}

    def succ(v):
        return [v[1:] + b for b in "ACGT" if min(v[1:] + b, _rc(v[1:] + b)) in S]

    inside = sum(1 for x in S for v in (x, _rc(x))
                 if len(succ(v)) == 1 and len(succ(_rc(succ(v)[0]))) == 1
                 and min(succ(v)[0], _rc(succ(v)[0])) != x)
    return len(S) - inside // 2


@pytest.mark.parametrize("k", [3, 5, 7])
def test_unitig_count_against_a_walk_by_hand(k):
    import random

    rng = random.Random(k)
    for _ in range(30):
        strings = ["".join(rng.choice("ACGT") for _ in range(rng.randint(k, 60)))
                   for _ in range(rng.randint(1, 4))]
        keys = torch.tensor(sorted({_canon(s[i:i + k]) for s in strings
                                    for i in range(len(s) - k + 1)}))
        assert kmers.unitig_count(keys, k) == _unitigs_by_hand(strings, k), strings


def test_unitigs_of_a_path_and_a_branch():
    path = torch.tensor(sorted({_canon(w) for w in ("AAC", "ACA", "CAG", "AGG")}))
    assert kmers.unitig_count(path, 3) == 1
    # AAC -> ACA and AAC -> ACT: a branch cuts the path into three.
    branch = torch.tensor(sorted({_canon(w) for w in ("AAC", "ACA", "ACT")}))
    assert kmers.unitig_count(branch, 3) == 3
    assert kmers.reverse_complement(torch.tensor([_key("AAC")]), 3).tolist() == [
        _key("GTT")]
