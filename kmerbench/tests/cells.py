"""Cells whose files the benchmark keeps, and tests here on the CPU, but
that BENCHMARK.json does not run yet (PERF.md, section 7): a later
benchmark PR adds them to BENCHMARK.json as they stand here.  with_later()
writes a checkout root whose BENCHMARK.json holds them too."""

import json
import os

from kmerbench import spec

LATER = {
    "workloads": [
        {
            "name": "ecoli-k15.reads",
            "config": "ecoli-k15",
            "traffic": "reads",
            "chips": 1,
            "why": "232 Mbp of 150 bp reads, both strands, 50x, 0.1% errors, cutoff 4, builds back to back: the count (parse, B1, sort, B3) and the cutoff filter"
        },
        {
            "name": "pan16-k23.decompress",
            "config": "pan16-k23",
            "traffic": "decompress",
            "chips": 1,
            "why": "16 sets compressed in set-up, all read back per job back to back: the reader's decodes through the count; sketch table and greedy loop bypassed"
        }
    ],
    "end_to_end": [
        {
            "name": "decompress_mkmer_per_s",
            "unit": "Mkmer/s",
            "better": "higher",
            "bound": 0.25,
            "source": "host_clock",
            "workloads": [
                "pan16-k23.decompress"
            ]
        }
    ],
    "per_layer": [
        {
            "name": "reader_decode_s.decompress",
            "unit": "s",
            "better": "lower",
            "source": "program_span",
            "layer": "reader",
            "moves": "decompress_mkmer_per_s",
            "workloads": [
                "pan16-k23.decompress"
            ]
        },
        {
            "name": "count_kernels_roofline_pct.build",
            "unit": "%",
            "better": "higher",
            "source": "device_trace",
            "layer": "kernels",
            "moves": "build_mbp_per_s",
            "workloads": [
                "ecoli-k15.reads"
            ]
        },
        {
            "name": "device_idle_pct.decompress",
            "unit": "%",
            "better": "lower",
            "source": "device_trace",
            "layer": "device",
            "moves": "decompress_mkmer_per_s",
            "workloads": [
                "pan16-k23.decompress"
            ]
        }
    ],
    "extend": {
        "build_mbp_per_s": [
            "ecoli-k15.reads"
        ],
        "count_s.build": [
            "ecoli-k15.reads"
        ],
        "front_end_s.build": [
            "ecoli-k15.reads"
        ],
        "host_spss_s.build": [
            "ecoli-k15.reads"
        ],
        "device_idle_pct.build": [
            "ecoli-k15.reads"
        ]
    }
}


def with_later(directory: str) -> str:
    """A root in `directory`: BENCHMARK.json with the later cells and
    their metrics added, and the benchmark's folder linked in."""
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    for group in ("workloads", "end_to_end", "per_layer"):
        bench[group] += LATER[group]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.get("workloads", []).extend(LATER["extend"].get(m["name"], []))
    with open(os.path.join(directory, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    os.symlink(spec.HERE, os.path.join(directory, "kmerbench"))
    return directory
