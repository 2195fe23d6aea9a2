"""Kernel P1's plain version and schedule (ops/parse.py, csrc/parse.cu)
against the host's FASTA parse and pack, and the count's device-stream
route against its host route.

The host's are native.parse_fasta_bytes (the C parser kmerio_parse_fasta)
and native.pack2: P1 must give the same packed codes, fragment offsets,
code total and error message on every input, malformed ones included.
The CUDA kernel runs only on the card (tests/test_torch_parse_card.py,
chip_smoke.py); here `_p1_model` repeats its schedule on the CPU: tiles
of 64-byte threads (fewer threads a tile than the kernel's 256), the
newline scan, the counts and errors of both start parities, the
look-back that folds aggregates in front of one another until it meets a
prefix (each predecessor showing its aggregate or its prefix at random),
and the writes at each tile's offsets.  Then
KmerCounter.from_fasta on the device-stream route (forced onto CPU
tensors by patching backend.parse_route) must count the host route's keys
and counts, in one shot and in halo chunks of a small chunk_windows.
"""

import os

import numpy as np
import pytest
import torch

from kmerset_tpu_torch.core import io as core_io
from kmerset_tpu_torch.core import native
from kmerset_tpu_torch.core.kmer_counter import KmerCounter
from kmerset_tpu_torch.ops import backend, parse
from kmerset_tpu_torch.utils import trace

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _seq(rng, n: int) -> bytes:
    return _BASES[rng.integers(0, 4, n)].tobytes()


def _records(rng, n: int, length: int, n_runs: int = 0) -> bytes:
    """n records of `length` bases, each with n_runs runs of 1-40 N."""
    out = []
    for i in range(n):
        s = bytearray(_seq(rng, length))
        for _ in range(n_runs):
            at = int(rng.integers(0, length))
            s[at : at + int(rng.integers(1, 41))] = b"N" * len(s[at : at + 40])
        out.append(b">rec%d description\n" % i + bytes(s[:length]) + b"\n")
    return b"".join(out)


def fasta_cases(seed: int = 24) -> dict:
    """FASTA texts by name: well formed (reads, 10 kb records with N runs,
    N at line ends, empty sequence lines, fragments shorter than k, no
    final newline, a last empty line) and malformed (odd line counts, a
    missing or empty header, '\\r', lower case, '>' in a sequence)."""
    rng = np.random.default_rng(seed)
    reads = b"".join(b">r%d\n" % i + _seq(rng, 150) + b"\n" for i in range(300))
    mutated = bytearray(reads)
    at = int(rng.integers(len(reads) // 2, len(reads)))
    mutated[at] = ord("a") if mutated[at] != ord("\n") else ord("x")
    return {
        "empty": b"",
        "reads": reads,
        "records_n_runs": _records(rng, 3, 10_000, n_runs=5),
        "n_at_line_ends": b">a\nNNACGTN\n>b\nNACGTACGGN\n>c\nN\n>d\nNNNN\n",
        "empty_sequence_lines": b">a\n\n>b\nACGTACGTACGTACGTACGT\n>c\n\n",
        "short_fragments": b">a\nACNGTNNA\n>b\nAC\n>c\nACGTNACGTACGTACGTACGTACGTAC\n",
        "no_final_newline": reads[:-1],
        "ends_in_empty_line": reads + b">last\n\n",
        "odd_lines_empty_last": reads + b"\n",
        "header_only": b">a\n",
        "header_only_no_newline": b">a",
        "odd_lines": reads + b">extra\n",
        "missing_header": b"ACGT\n>a\n",
        "empty_header": b"\nACGT\n",
        "carriage_return": b">a\r\nACGT\r\n>b\r\nACGT\r\n",
        "lower_case": reads + b">x\nACgT\n",
        "gt_in_sequence": b">a\nAC>GT\n",
        "bad_byte_then_odd": reads + b">x\nACGTQ\n>y\n",
        "mutated_reads": bytes(mutated),
        "random_bytes": bytes(rng.choice(np.frombuffer(b"ACGTN\n>", np.uint8),
                                         5_000)),
    }


CASES = fasta_cases()


def _host(data: bytes):
    """(packed codes, offsets, total, None) or (None, None, None, message)
    of the host's parse and pack."""
    try:
        codes, offsets = native.parse_fasta_bytes(data)
    except ValueError as e:
        return None, None, None, str(e)
    return native.pack2(codes), offsets, codes.shape[0], None


def _as_tensor(data: bytes) -> torch.Tensor:
    return torch.tensor(np.frombuffer(data, dtype=np.uint8))


@pytest.fixture(autouse=True)
def _native_library():
    assert native.get_lib() is not None, "the host parse under test is the native one"


@pytest.mark.parametrize("name", sorted(CASES))
def test_p1_plain_equals_the_host_parse_and_pack(name):
    data = CASES[name]
    want = _host(data)
    try:
        codes, offsets = parse.parse(_as_tensor(data))
    except ValueError as e:
        got = None, None, None, str(e)
    else:
        got = parse.pack(codes).numpy(), offsets.numpy(), codes.shape[0], None
    assert got[3] == want[3]
    if want[3] is None:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert got[1].dtype == np.int64


@pytest.mark.parametrize("start", [0, 1, 2, 3, 5])
def test_pack_of_a_slice_equals_native_pack2(start):
    codes = torch.from_numpy(np.random.default_rng(start).integers(0, 4, 1001,
                                                                   dtype=np.uint8))
    np.testing.assert_array_equal(parse.pack(codes[start:]).numpy(),
                                  native.pack2(codes[start:].numpy()))


# -- the kernel's schedule (csrc/parse.cu parse_kernel) --------------------

_NL, _GT = ord("\n"), ord(">")


def _code(c: int) -> int:
    return {65: 0, 67: 1, 71: 2, 84: 3, 78: 4}.get(c, 5)


def _p1_model(buf: bytes, threads: int, window: int, rng):
    """(codes, offsets, info) of parse_kernel at `threads` threads of 64
    bytes a tile and a look-back window of `window` lanes, tiles in order,
    each predecessor showing its aggregate or (where it has one) its
    prefix at random: the kernel's steps 1-6, in its arithmetic."""
    per, n = 64, len(buf)
    tile_bytes = threads * per
    codes = np.zeros(n, np.uint8)
    ends = np.zeros(1 + (n + 1) // 2, np.int64)
    aggregates, prefixes = {}, {}
    info = [0, 0, 0, 0]
    for tile in range(-(-n // tile_bytes)):
        th = []
        for t in range(threads):
            base = tile * tile_bytes + per * t
            m = max(0, min(per, n - base))
            b = [buf[base + j] if j < m else _NL for j in range(per)]
            th.append({"b": b, "m": m,
                       "before": buf[base - 1] if m and base else _NL,
                       "after": buf[base + per] if base + per < n else _NL,
                       "nl": sum(c == _NL for c in b[:m])})
        nl = 0
        for t in th:  # 2. the newline scan
            t["r0"], nl = nl & 1, nl + t["nl"]
        q, total, bad = nl & 1, [0] * 4, 0
        for t in th:  # 3. counts and errors by relative parity
            cnt, r, prev = [0] * 4, t["r0"], t["before"]
            for j in range(t["m"]):
                c = t["b"][j]
                if prev == _NL and c != _GT:
                    bad |= 1 << r
                if c == _NL:
                    r ^= 1
                elif _code(c) == 5:
                    bad |= 1 << (r ^ 1)
                elif _code(c) < 4:
                    cnt[r] += 1
                    nxt = t["b"][j + 1] if j + 1 < per else t["after"]
                    cnt[2 + r] += _code(nxt) >= 4
                prev = c
            t["rank"], total = total, [a + x for a, x in zip(total, cnt)]
        aggregates[tile] = (q, total)  # 4.
        P, s_codes, s_ends = 0, 0, 0
        last, acc_q, acc = tile - 1, 0, [0] * 4
        while tile:  # 5. the look-back
            seen = []
            for lane in range(window):
                i = last - lane
                if i < 0 or (i in prefixes and (i == 0 or rng.random() < 0.5)):
                    seen.append(("prefix", prefixes.get(i, (0, 0, 0))))
                else:
                    seen.append(("aggregate", aggregates[i]))
            stop = next((j for j, w in enumerate(seen) if w[0] == "prefix"), window)
            for _, (qa, a) in seen[:stop]:
                acc = [a[x] + acc[x ^ qa] for x in (0, 1)] + [
                    a[2 + x] + acc[2 + (x ^ qa)] for x in (0, 1)]
                acc_q ^= qa
            if stop < window:
                pp, c, e = seen[stop][1]
                P, s_codes, s_ends = pp ^ acc_q, c + acc[pp ^ 1], e + acc[3 - pp]
                break
            last -= window
        prefixes[tile] = (P ^ q, s_codes + total[P ^ 1], s_ends + total[3 - P])
        if tile * tile_bytes + tile_bytes >= n:
            info[:2] = prefixes[tile][1:]
            info[3] = P ^ q ^ (buf[n - 1] != _NL)
        info[2] |= (bad >> P) & 1
        want = P ^ 1
        for t in th:  # 6. the writes
            at, e_at, r = t["rank"][want], s_ends + t["rank"][2 + want], t["r0"]
            for j in range(t["m"]):
                c = t["b"][j]
                if c == _NL:
                    r ^= 1
                elif r == want and _code(c) < 4:
                    codes[s_codes + at] = _code(c)
                    at += 1
                    nxt = t["b"][j + 1] if j + 1 < per else t["after"]
                    if _code(nxt) >= 4:
                        ends[1 + e_at] = s_codes + at
                        e_at += 1
    return codes[: info[0]], ends[: info[1] + 1], info


@pytest.mark.parametrize("name", sorted(set(CASES) - {"empty", "records_n_runs"}))
@pytest.mark.parametrize("threads,window", [(1, 1), (2, 2), (4, 32)])
def test_p1_schedule_equals_the_host_parse(name, threads, window):
    data = CASES[name][:6000]
    rng = np.random.default_rng(len(data) + threads)
    try:
        codes, offsets = native.parse_fasta_bytes(data)
        message = None
    except ValueError as e:
        message = str(e)
    got_codes, got_offsets, info = _p1_model(data, threads, window, rng)
    got_message = (parse.INVALID if info[2]
                   else parse.ODD_LINES if info[3] else None)
    assert got_message == message
    if message is None:
        np.testing.assert_array_equal(got_codes, codes)
        np.testing.assert_array_equal(got_offsets, offsets)


# -- the count's device-stream route -----------------------------------------


@pytest.fixture
def fasta(tmp_path):
    path = tmp_path / "in.fa"
    rng = np.random.default_rng(7)
    path.write_bytes(CASES["reads"] + CASES["records_n_runs"]
                     + CASES["short_fragments"] + _records(rng, 40, 333, 2))
    return str(path)


def _moved(before: dict) -> dict:
    now = trace.counts()
    return {n: now.get(n, 0) - before.get(n, 0)
            for n in ("parse.device", "parse.host")}


@pytest.mark.parametrize("k", [15, 19])
@pytest.mark.parametrize("chunk_windows", [None, 97, 997, 20_000])
def test_the_device_stream_counts_what_the_host_route_counts(
        fasta, monkeypatch, k, chunk_windows):
    before = trace.counts()
    want = KmerCounter.from_fasta(k, fasta, "", True, device="cpu")
    assert _moved(before) == {"parse.device": 0, "parse.host": 1}
    monkeypatch.setattr(backend, "parse_route", lambda *a: True)
    monkeypatch.setattr(backend, "READ_PIECE_BYTES", 4099)
    if chunk_windows is not None:
        monkeypatch.setattr(backend, "count_plan", lambda *a: chunk_windows)
    before = trace.counts()
    got = KmerCounter.from_fasta(k, fasta, "", True, device="cpu")
    assert _moved(before) == {"parse.device": 1, "parse.host": 0}
    np.testing.assert_array_equal(got.kmers, want.kmers)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert (got._device is None) == (chunk_windows is not None)


@pytest.mark.parametrize("chunk_windows", [7, 50, 997, 10**9])
def test_device_chunk_slices_equal_the_host_chunks(chunk_windows):
    data = CASES["records_n_runs"] + CASES["short_fragments"]
    codes, offsets = native.parse_fasta_bytes(data)
    dev_codes, dev_offsets = parse.parse(_as_tensor(data))
    want = list(backend.chunk_slices(codes, offsets, 19, chunk_windows))
    got = list(backend.device_chunk_slices(dev_codes, dev_offsets, 19,
                                           chunk_windows))
    assert len(got) == len(want)
    for (gc, go), (wc, wo) in zip(got, want):
        np.testing.assert_array_equal(gc.numpy(), wc)
        np.testing.assert_array_equal(go.numpy(), wo)


@pytest.mark.parametrize("name", ["odd_lines", "lower_case", "missing_header"])
def test_a_malformed_file_raises_the_host_routes_error(tmp_path, monkeypatch, name):
    path = tmp_path / "bad.fa"
    path.write_bytes(CASES[name])
    with pytest.raises(core_io.IOError_) as host:
        KmerCounter.from_fasta(15, str(path), "", True, device="cpu")
    monkeypatch.setattr(backend, "parse_route", lambda *a: True)
    with pytest.raises(core_io.IOError_) as dev:
        KmerCounter.from_fasta(15, str(path), "", True, device="cpu")
    assert str(dev.value) == str(host.value)
    with pytest.raises(core_io.IOError_, match="failed to open file"):
        KmerCounter.from_fasta(15, str(tmp_path / "missing.fa"), "", True,
                               device="cpu")


def test_upload_file_reads_the_whole_file_through_the_ring(fasta, monkeypatch):
    monkeypatch.setattr(backend, "READ_PIECE_BYTES", 1000)
    monkeypatch.setattr(backend, "READ_RING", 3)
    with open(fasta, "rb") as f:
        want = f.read()
    before = trace.counts().get("h2d_copies", 0)
    got = backend.upload_file(fasta, "cpu")
    assert got.numpy().tobytes() == want
    assert trace.counts().get("h2d_copies", 0) - before == -(-len(want) // 1000)


def test_the_route_keeps_the_host_parse_off_cuda(fasta):
    assert not backend.parse_route(fasta, "", "cpu", None)
    assert not backend.parse_route(fasta, "gzip -dc", "cpu", None)
    assert not backend.parse_route(os.path.dirname(fasta), "", "cpu", None)
