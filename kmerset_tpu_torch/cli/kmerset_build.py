"""kmerset-build on a torch device: FASTA -> counted, cutoff-filtered,
SPSS-compressed k-mer set file.

Same flags and log lines as kmerset_tpu/cli/kmerset_build.py, plus
--device (default cuda; a missing CUDA device is an error, never a quiet
CPU run).  It takes the reference's k = 15, 19, 23 and 31.  Counting and
the --check decode run on the device through the port's kernels (B1 for
k = 15, B2 for k = 19, 23 and 31, then B3), and so does the SPSS build's
unitig graph front-end, canonical or directed (--canonical=false); the
cutoff filter, the chain walk, the string emission, the path cover and
the dump run on the host, in the port's copy of the reference's code.
The counted set stays on the device for the front-end (ops/resident.py;
a cutoff above 1 filters it there too), and on a slow link
(KMERSET_TPU_LINK=slow, or a probed link under 1 GiB/s) the keys come
down gap-encoded (ops/deltas.py) and the front-end's result as 1-byte
side codes, built in the SPSS phase (the reference's count launches them
early when a build follows; the port's count computes the count alone).
A comma-separated --device list (cuda:0,cuda:0,cuda:0,cuda:0 is four
shards on one card) runs the count, the decode and every graph phase on
a mesh of those shards (parallel/), the reference's forced mesh.  With
KMERSET_TPU_DISTRIBUTED=addr:port,N,i (or auto) the process joins a
torch.distributed group of N ranks, as the reference's does, and
--device names this rank's shards of one mesh over the group; every rank
reads the same input and writes the same dump.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..core import io as core_io
from ..core.config import get_config
from ..core.kmer_counter import KmerCounter
from ..core.kmer_set_compact import KmerSetCompact
from ..parallel import driver as mesh_driver
from ..utils import flags as flag_util
from ..utils.log import enable_debug_logs, init_default_logger


def main(argv=None) -> None:
    started = time.perf_counter_ns()
    parser = argparse.ArgumentParser(
        description=(
            "Reads a FASTA file and constructs a set of k-mers. "
            "Usage: kmerset-build [options] <path to file>"
        )
    )
    flag_util.add_common_flags(parser, compressor=True)
    parser.add_argument(
        "--cutoff",
        type=int,
        default=1,
        help="ignore k-mers that appear less often than this value",
    )
    flag_util.add_bool_flag(
        parser,
        "check",
        False,
        "does compression & decompression to see if it is working correctly",
    )
    parser.add_argument("--out", default="", help="output file name")
    flag_util.add_device_flag(parser)
    parser.add_argument("file", help="path to FASTA file")
    args = flag_util.parse_args(parser, argv)

    logger = init_default_logger()
    if args.debug:
        enable_debug_logs()
    flag_util.check_k(args.k)
    # Multi-process bring-up (KMERSET_TPU_DISTRIBUTED), at the
    # reference's point: --device then names this rank's shards.
    device, mesh = flag_util.devices_or_exit(args, logger, distributed=True)
    flag_util.apply_workers(args)
    cfg = get_config(args.k)

    with flag_util.trace_context(args, device, "kmerset_build", started):
        logger.info("constructing kmer_counter")
        try:
            counter = KmerCounter.from_fasta(
                cfg.k, args.file, args.decompressor, args.canonical,
                device=device, mesh=mesh,
            )
        except core_io.IOError_ as e:
            logger.error("failed to parse FASTA file: %s", e)
            sys.exit(1)
        logger.info("constructed kmer_counter")

        logger.info("constructing kmer_set")
        kmer_set, cutoff_count = counter.to_kmer_set(args.cutoff)
        logger.info("constructed kmer_set")
        logger.info("cutoff_count = %d", cutoff_count)
        logger.info("kmer_set.Size() = %d", kmer_set.size())
        logger.info("kmer_set.Hash() = %d", kmer_set.hash())

        logger.info("constructing kmer_set_compact")
        compact = KmerSetCompact.from_kmer_set(
            kmer_set, args.canonical, fast=True, device=device, mesh=mesh
        )
        logger.info("constructed kmer_set_compact")
        logger.info("kmer_set_compact.Size() = %d", compact.size())

        if args.check:
            # Decode the SPSS strings through a fresh compact set
            # (from_kmer_set seeds the decode cache with the source k-mers,
            # so reusing it would compare the array with itself).
            decompressed = KmerSetCompact(
                compact.k, compact.spss, device=device, mesh=mesh
            ).to_kmer_set(args.canonical)
            if kmer_set.equals(decompressed):
                logger.info("kmer_set_compact -> KmerSet: ok")
            else:
                logger.error("kmer_set_compact -> KmerSet: failed")
                sys.exit(1)

        if args.out:
            try:
                compact.dump(args.out, args.compressor)
            except core_io.IOError_ as e:
                logger.error("failed to dump kmer_set_compact: %s", e)
                sys.exit(1)
    mesh_driver.end_distributed()


if __name__ == "__main__":
    main()
