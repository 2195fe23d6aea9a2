"""Range: integer interval with balanced splitting
(reference: lib/core/range.h:17-82).

The port's copy of kmerset_tpu/utils/range.py:9-42, whole.  The original
project uses Range.Split(n_workers^2) to over-decompose every parallel
loop for load balance; here it serves API parity and host-side work
partitioning."""

from __future__ import annotations

import dataclasses
from typing import Iterator, List


@dataclasses.dataclass(frozen=True)
class Range:
    begin: int
    end: int

    def __post_init__(self):
        if self.begin > self.end:
            raise ValueError("begin must be <= end")

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.begin, self.end))

    def __len__(self) -> int:
        return self.end - self.begin

    def split(self, n: int) -> List["Range"]:
        """Splits into n contiguous chunks whose sizes differ by at most 1
        (reference: range.h:52-77)."""
        total = len(self)
        base = total // n
        rem = total % n
        out = []
        start = self.begin
        for i in range(n):
            size = base + (1 if i < rem else 0)
            out.append(Range(start, start + size))
            start += size
        return out
