"""Spans read from the port CLIs' log lines, with their times.

Two kinds of line give a span: an info pair "constructing X" ...
"constructed X", and a debug line that states its own seconds and is
logged where its phase ends ("unitigs: chain walk: 1.23s").  A span is
(name, start, end) in time.time() seconds.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

Span = Tuple[str, float, float]

_PAIR = re.compile(r"(constructing|constructed|loading|loaded) (\S+?)(?::.*)?$")
_FRONT_END = re.compile(
    r"unitigs: device [a-z -]+ upload ([\d.]+) s, device ([\d.]+) s, "
    r"download ([\d.]+) s")
_STATED = (
    ("chain walk", re.compile(r"unitigs: chain walk: ([\d.]+)s$")),
    ("emission + cycles", re.compile(r"unitigs: emission \+ cycles: ([\d.]+)s$")),
    ("path cover", re.compile(r"spss: path cover: ([\d.]+)s$")),
    ("deferred SPSS build",
     re.compile(r"kmer_set_compact: deferred SPSS build ([\d.]+) s")),
)
_SKETCH = re.compile(r"kmer_set_set: sketch table on .+? ([\d.]+) s \(")


def pairs(lines, name: str) -> List[Span]:
    """Spans from each "constructing NAME" (or "loading NAME") line to
    the next "constructed NAME" ("loaded NAME") line; a suffix such as
    ": i = 3" is part of neither name."""
    out, open_at = [], None
    for t, msg in lines:
        m = _PAIR.match(msg)
        if not m or m.group(2) != name:
            continue
        if m.group(1) in ("constructing", "loading"):
            open_at = t
        elif open_at is not None:
            out.append((name, open_at, t))
            open_at = None
    return out


def stated(lines) -> List[Span]:
    """Spans of the debug lines that state their own seconds: the
    front-end (upload + device + download) and those of _STATED."""
    out = []
    for t, msg in lines:
        m = _FRONT_END.search(msg)
        if m:
            out.append(("device front-end", t - sum(map(float, m.groups())), t))
            continue
        for name, rx in _STATED:
            m = rx.search(msg)
            if m:
                out.append((name, t - float(m.group(1)), t))
    return out


def total(spans: List[Span]) -> float:
    return sum(e - s for _, s, e in spans)


def sketch_seconds(lines) -> Optional[float]:
    """The sketch table's seconds of a compress job (its one summary
    line), or None where the job logged none."""
    for _, msg in lines:
        m = _SKETCH.search(msg)
        if m:
            return float(m.group(1))
    return None


PHASES = {"kmer_counter": "count", "kmer_set": "cutoff filter or set decode",
          "kmer_set_compact": "SPSS build", "kmer_set_set": "joint compression",
          "kmer_set_set_reader": "reader load"}


def host_phases(job) -> List[Span]:
    """Every span of one job, for naming what the host was doing: the
    info pairs (named by PHASES), the stated debug spans, and the rest of
    the CLI call."""
    out = [("CLI, other", job.start, job.end)]
    for name, phase in PHASES.items():
        out += [(phase, s, e) for _, s, e in pairs(job.lines, name)]
    return out + stated(job.lines)
