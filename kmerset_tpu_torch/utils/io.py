"""App-level IO helpers (reference: lib/io.h:21-99).

The port's copy of kmerset_tpu/utils/io.py:1-56, whole, with a `device`
(and optional `mesh`) for get_kmer_set_from_file: the load's decode runs
there, through kernels B1/B2 and B3, like every decode of the port.
"""

from __future__ import annotations

import os
import shutil
import tempfile

from ..core.kmer_set import KmerSet
from ..core.kmer_set_compact import KmerSetCompact


def get_kmer_set_from_file(
    k: int, file_name: str, decompressor: str, canonical: bool, *, device,
    mesh=None,
) -> KmerSet:
    """Load a KmerSetCompact file and decode it to a KmerSet on `device`,
    or on `mesh`'s shards (reference: lib/io.h:21-49)."""
    return KmerSetCompact.load(
        k, file_name, decompressor, device=device, mesh=mesh
    ).to_kmer_set(canonical)


class TemporaryFile:
    """RAII temp file path (reference: lib/io.h:53-75)."""

    def __init__(self):
        f = tempfile.NamedTemporaryFile(delete=False)
        f.close()
        self._name = f.name

    def name(self) -> str:
        return self._name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            os.remove(self._name)
        except OSError:
            pass


class TemporaryDirectory:
    """RAII temp directory path (reference: lib/io.h:78-99)."""

    def __init__(self):
        self._name = tempfile.mkdtemp()

    def name(self) -> str:
        return self._name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        shutil.rmtree(self._name, ignore_errors=True)
