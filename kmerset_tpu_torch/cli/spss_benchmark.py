"""spss-benchmark on a torch device: times SPSS construction, fast
(parallel matching) against slow (sequential greedy), printing
`time weight time ok` per mode per repeat.

Same flags, output and log lines as kmerset_tpu/cli/spss_benchmark.py,
plus --device (default cuda; a missing CUDA device is an error, never a
quiet CPU run).  The input's decode, the unitigs' graph front-end and each
reconstruction run on the device; the path cover of both modes runs on
the host, in the port's copy of the reference's code, so the weight and
ok columns equal the reference's, and the times are this device's.  A
comma-separated --device list runs the decodes, the unitigs and the path
cover's graph phases on a mesh of those shards (parallel/).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..core import spss as spss_mod
from ..core.config import get_config
from ..core.kmer_set_compact import KmerSetCompact
from ..utils import flags as flag_util
from ..utils.log import enable_debug_logs, init_default_logger


def main(argv=None) -> None:
    started = time.perf_counter_ns()
    parser = argparse.ArgumentParser(
        description=(
            "Runs a benchmark for SPSS construction using a single k-mer "
            "set. Usage: spss-benchmark [options] <path to file>"
        )
    )
    flag_util.add_common_flags(parser, canonical=False)
    # Accepted for reference CLI compatibility; no effect, as in the
    # reference edition (kmerset_tpu/cli/spss_benchmark.py:26-32).
    parser.add_argument(
        "--buckets", type=int, default=1, help="number of buckets for SPSS calculation"
    )
    parser.add_argument("--repeats", type=int, default=1, help="number of repeats")
    flag_util.add_device_flag(parser)
    parser.add_argument("file", help="path to compact set file")
    args = flag_util.parse_args(parser, argv)

    logger = init_default_logger()
    if args.debug:
        enable_debug_logs()
    flag_util.check_k(args.k)
    device, mesh = flag_util.devices_or_exit(args, logger)
    flag_util.apply_workers(args)
    cfg = get_config(args.k)
    if args.buckets != 1:
        logger.warning(
            "--buckets has no effect: SPSS construction is bucket-free "
            "(deterministic handshake matching); flag accepted for "
            "reference CLI compatibility"
        )

    with flag_util.trace_context(args, device, "spss_benchmark", started):
        try:
            compact = KmerSetCompact.load(
                cfg.k, args.file, args.decompressor, device=device, mesh=mesh
            )
        except Exception as e:  # noqa: BLE001
            logger.error("failed to load: %s", e)
            sys.exit(1)
        kmer_set = compact.to_kmer_set(True)

        logger.info("kmer_set.Size() = %d", kmer_set.size())
        logger.info("kmer_set.Hash() = %d", kmer_set.hash())

        logger.info("constructing unitigs")
        unitigs = spss_mod.get_unitigs_canonical(kmer_set, device=device, mesh=mesh)
        logger.info("constructed unitigs")

        for _ in range(args.repeats):
            out = []
            for fast in (False, True):
                logger.info("fast = %s", fast)

                t0 = time.monotonic()
                spss = spss_mod.get_spss_canonical_from_unitigs(
                    unitigs, cfg.k, fast, mesh
                )
                elapsed = time.monotonic() - t0
                logger.info("constructed spss: elapsed = %f", elapsed)
                out.append(f"{elapsed}")

                total_size = spss.weight()
                logger.info("total_size = %d", total_size)
                out.append(f"{total_size}")

                t0 = time.monotonic()
                reconstructed = spss_mod.get_kmer_set_from_spss(
                    spss, cfg.k, True, device=device, mesh=mesh
                )
                elapsed = time.monotonic() - t0
                logger.info("reconstructed: elapsed = %f", elapsed)
                out.append(f"{elapsed}")

                is_equal = kmer_set.equals(reconstructed)
                logger.info("is_equal = %s", is_equal)
                out.append("1" if is_equal else "0")

            print(" ".join(out))


if __name__ == "__main__":
    main()
