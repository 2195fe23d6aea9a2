"""s per compress job in the multi-set layer's own work, from the
program's spans (kmerbench/progtrace.py): "kss.construct"
(core/kmer_set_set.py, the greedy loop) less its compact.*, spss.*,
front_end.* and copy.* descendants: sampling, packing, the sketch table's
host side, the set algebra and the splits."""

from kmerbench.progtrace import multiset_self_seconds, per_job


def read(ctx):
    return per_job(ctx, "compress", multiset_self_seconds)
