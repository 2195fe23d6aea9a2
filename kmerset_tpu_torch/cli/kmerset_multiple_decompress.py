"""kmerset-multiple-decompress on a torch device: reconstructs and logs
each original set of a compressed directory.

Same flags and log lines as kmerset_tpu/cli/kmerset_multiple_decompress.py
(kmer_set.Hash() and kmer_set.Size() per set, which must equal
`kmerset-stat` of the original inputs), plus --device (default cuda; a
missing CUDA device is an error, never a quiet CPU run).  Every file's
decode runs on the device (kernels B1/B2 and B3), or, with a
comma-separated --device list, on a mesh of those shards (parallel/).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..core.config import get_config
from ..core.kmer_set_set import KmerSetSetReader
from ..utils import flags as flag_util
from ..utils.log import enable_debug_logs, init_default_logger


def main(argv=None) -> None:
    started = time.perf_counter_ns()
    parser = argparse.ArgumentParser(
        description=(
            'Decompresses the output of "kmerset-multiple-compress". '
            "Usage: kmerset-multiple-decompress [options] <path to directory>"
        )
    )
    flag_util.add_common_flags(parser)
    parser.add_argument(
        "--extension", default="txt", help="extension of files in folder"
    )
    flag_util.add_device_flag(parser)
    parser.add_argument("directory", help="path to directory")
    args = flag_util.parse_args(parser, argv)

    logger = init_default_logger()
    if args.debug:
        enable_debug_logs()
    flag_util.check_k(args.k)
    device, mesh = flag_util.devices_or_exit(args, logger)
    flag_util.apply_workers(args)
    cfg = get_config(args.k)

    with flag_util.trace_context(args, device, "kmerset_multiple_decompress", started):
        logger.info("loading kmer_set_set_reader")
        try:
            reader = KmerSetSetReader.from_directory(
                cfg, args.directory, args.extension, args.decompressor,
                args.canonical, device=device, mesh=mesh,
            )
        except Exception as e:  # noqa: BLE001
            logger.error("failed to load data: %s", e)
            sys.exit(1)
        logger.info("loaded kmer_set_set_reader")
        logger.info("kmer_set_set_reader.Size() = %d", reader.size())

        it = reader.get_all(workers=args.workers)
        try:
            for i in range(reader.size()):
                logger.info("constructing kmer_set: i = %d", i)
                _, kmer_set = next(it)
                logger.info("constructed kmer_set: i = %d", i)
                logger.info("kmer_set.Hash() = %d", kmer_set.hash())
                logger.info("kmer_set.Size() = %d", kmer_set.size())
        except Exception as e:  # noqa: BLE001
            logger.error("failed to construct kmer_set: %s", e)
            sys.exit(1)
        finally:
            it.close()


if __name__ == "__main__":
    main()
