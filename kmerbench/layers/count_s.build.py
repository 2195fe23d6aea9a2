"""s per build job in the count (core/kmer_counter.py, ops/count.py,
ops/backend.py, the parse in core/native.py): the span from the CLI's
"constructing kmer_counter" line to its "constructed kmer_counter"."""

from kmerbench.readers import paired_per_job


def read(ctx):
    return paired_per_job(ctx, "kmer_counter") if ctx.kind == "build" else None
