"""kmerset-stat on a torch device: prints `i\\tfile\\tsize\\thash` TSV for
compact set files.

Same flags, TSV and log lines as kmerset_tpu/cli/kmerset_stat.py, plus
--device (default cuda; a missing CUDA device is an error, never a quiet
CPU run).  Each file's decode runs on the device (kernels B1/B2 and B3),
or, with a comma-separated --device list, on a mesh of those shards
(parallel/).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..core.config import get_config
from ..core.kmer_set_compact import KmerSetCompact
from ..utils import flags as flag_util
from ..utils.log import enable_debug_logs, init_default_logger


def main(argv=None) -> None:
    started = time.perf_counter_ns()
    parser = argparse.ArgumentParser(
        description=(
            "Prints the metadata of a k-mer set. "
            "Usage: kmerset-stat [options] <path to file>"
        )
    )
    flag_util.add_common_flags(parser)
    flag_util.add_device_flag(parser)
    parser.add_argument("files", nargs="+", help="paths to compact set files")
    args = flag_util.parse_args(parser, argv)

    logger = init_default_logger()
    if args.debug:
        enable_debug_logs()
    flag_util.check_k(args.k)
    device, mesh = flag_util.devices_or_exit(args, logger)
    flag_util.apply_workers(args)
    cfg = get_config(args.k)

    with flag_util.trace_context(args, device, "kmerset_stat", started):
        for i, file_name in enumerate(args.files):
            logger.info("processing: i = %d, file_name = %s", i, file_name)
            try:
                compact = KmerSetCompact.load(
                    cfg.k, file_name, args.decompressor, device=device,
                    mesh=mesh,
                )
            except Exception as e:  # noqa: BLE001
                logger.error("failed to load kmer_set_compact: %s", e)
                sys.exit(1)
            kmer_set = compact.to_kmer_set(args.canonical)
            size = kmer_set.size()
            hash_ = kmer_set.hash()
            logger.info("size = %d", size)
            logger.info("hash = %d", hash_)
            print(f"{i}\t{file_name}\t{size}\t{hash_}")


if __name__ == "__main__":
    main()
