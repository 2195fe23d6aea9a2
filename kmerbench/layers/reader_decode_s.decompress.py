"""s per decompress job in the reader's decodes (KmerSetSetReader in
core/kmer_set_set.py): the spans from each "constructing kmer_set: i"
line to its "constructed kmer_set: i", summed."""

from kmerbench.readers import paired_per_job


def read(ctx):
    return paired_per_job(ctx, "kmer_set") if ctx.kind == "decompress" else None
