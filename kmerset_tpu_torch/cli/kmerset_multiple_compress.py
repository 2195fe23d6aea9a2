"""kmerset-multiple-compress on a torch device: jointly compresses N
compact set files into a directory.

Same flags (--seed, --workers, --out, --out_graph, --extension, ...) and
log lines as kmerset_tpu/cli/kmerset_multiple_compress.py, plus --device
(default cuda; a missing CUDA device is an error, never a quiet CPU run).
Decoding and sampling the inputs, the pair weights and every deferred
SPSS build's graph front-end run on the device; the set algebra, the
chain walk, the path cover and the dumps run on the host, in the port's
copy of the reference's code.  A comma-separated --device list
(cuda:0,cuda:0,cuda:0,cuda:0 is four shards on one card) runs the
decodes, the pair weights (a key-range-sharded sketch table) and every
deferred SPSS build's graph phases on a mesh of those shards
(parallel/), the reference's forced mesh.  With
KMERSET_TPU_DISTRIBUTED=addr:port,N,i (or auto) the process joins a
torch.distributed group of N ranks, as the reference's does, and
--device names this rank's shards of one mesh over the group; every rank
reads the same inputs and writes the same directory.
The directory and the DOT file are byte-identical to the reference's for
the same inputs and seed.
"""

from __future__ import annotations

import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from ..core.config import get_config
from ..core.kmer_set_compact import KmerSetCompact
from ..core.kmer_set_set import KmerSetSet
from ..parallel import driver as mesh_driver
from ..utils import flags as flag_util
from ..utils.log import enable_debug_logs, init_default_logger


def main(argv=None) -> None:
    started = time.perf_counter_ns()
    parser = argparse.ArgumentParser(
        description=(
            "Compresses multiple k-mer sets. Usage: kmerset-multiple-compress "
            "[options] <paths to file> <path to file> ..."
        )
    )
    flag_util.add_common_flags(parser, compressor=True)
    parser.add_argument(
        "--out", default="", help="directory path to save dumped files"
    )
    parser.add_argument(
        "--extension", default="txt", help="extension for output files"
    )
    parser.add_argument(
        "--out_graph", default="", help="path to save dumped DOT file"
    )
    parser.add_argument(
        "--seed", type=int, default=0,
        help="seed for similarity-sketch bucket sampling (the reference "
        "samples nondeterministically; this build is reproducible)",
    )
    flag_util.add_device_flag(parser)
    parser.add_argument("files", nargs="+", help="paths to compact set files")
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

    def _load(item):
        i, file = item
        logger.info("reading: i = %d, file = %s", i, file)
        c = KmerSetCompact.load(cfg.k, file, args.decompressor, device=device,
                                mesh=mesh)
        logger.info("finished reading: i = %d, file = %s", i, file)
        return c

    with flag_util.trace_context(args, device, "kmerset_multiple_compress", started):
        try:
            with ThreadPoolExecutor(max_workers=max(1, args.workers)) as ex:
                compacts = list(ex.map(_load, enumerate(args.files)))
        except Exception as e:  # noqa: BLE001
            logger.error("failed to read file: %s", e)
            sys.exit(1)

        total_size = 0
        for i, c in enumerate(compacts):
            size = c.size()
            logger.info("i = %d, size = %d", i, size)
            total_size += size
        logger.info("total_size = %d", total_size)

        logger.info("constructing kmer_set_set")
        kss = KmerSetSet(
            compacts, args.canonical, cfg, seed=args.seed,
            workers=max(1, args.workers), device=device, mesh=mesh,
        )
        logger.info("constructed kmer_set_set")

        if args.out_graph:
            logger.info("dumping graph")
            try:
                kss.dump_graph(args.out_graph)
            except Exception as e:  # noqa: BLE001
                logger.error("failed to dump graph: %s", e)
            logger.info("dumped graph")

        if args.out:
            try:
                kss.dump(
                    args.out, args.compressor, args.extension,
                    workers=args.workers,
                )
            except Exception as e:  # noqa: BLE001
                logger.error("failed to dump kmer_set_set: %s", e)
                sys.exit(1)
    mesh_driver.end_distributed()


if __name__ == "__main__":
    main()
