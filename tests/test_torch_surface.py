"""The inventory of the port's coverage of the reference's library surface.

Walks every module of kmerset_tpu and lists its public functions and
classes (jitted ones included) and their public methods, class methods,
static methods and properties, plus the private names that docs/API.md's
surface needs (PRIVATE) or that the table below names.  Each must have a
counterpart at the same path in kmerset_tpu_torch, or stand in NOT_PORTED
with the label "replaced by design" and a one-line reason: a part that
exists for the TPU, for JAX or for the reference's host fallbacks, whose
work the port does another way (the reason says how).  Nothing is left
to port.

An entry covers a module or a name and everything under it.  The table
is held exact both ways: each entry must name something of the
reference that the port lacks.
"""

import importlib
import inspect
import pkgutil

import pytest

import kmerset_tpu
import kmerset_tpu_torch

BY_DESIGN = "replaced by design"

NOT_PORTED = {
    "ops.backend.should_use_device": (
        BY_DESIGN, "host-or-device gate: the port runs on the device it is given"),
    "ops.backend.should_use_device_chunked": (
        BY_DESIGN, "the port chunks above backend.window_ceiling of its device"),
    "ops.backend.should_use_device_graph": (
        BY_DESIGN, "host-or-device gate: the graph front-end always runs on "
                   "the device"),
    "ops.backend.enable_compile_cache": (
        BY_DESIGN, "XLA's compile cache; the CUDA kernels are built once per "
                   "checkout by ops/_build.py"),
    "ops.backend._link_cache_path": (
        BY_DESIGN, "the disk cache of the link probe's verdict; a CUDA probe "
                   "costs milliseconds, so ops/backend._slow_link probes once "
                   "per process and device"),
    "ops.backend._note_fallback": (
        BY_DESIGN, "logs a fallback to the host; the port has no fallback"),
    "ops.backend._backend_alive": (
        BY_DESIGN, "probes the JAX backend before a fallback decision"),
    "ops.count._use_pallas": (
        BY_DESIGN, "probes for a TPU backend; the port's wrappers launch their "
                   "kernel on a CUDA tensor"),
    "ops.count.good_sort_size": (
        BY_DESIGN, "sort-friendly padding for XLA's TPU sort; torch.sort takes "
                   "any length"),
    "ops.count.pad_to": (BY_DESIGN, "the padding helper of good_sort_size"),
    "ops.neighbors.pad_pow2": (
        BY_DESIGN, "pads to power-of-two shapes for XLA's jit cache"),
    "ops.neighbors.device_side_tables": (
        BY_DESIGN, "the XLA side tables; the port's are ops/neighbors.side_tables"
                   " on torch tensors"),
    "ops.neighbors.tables_traced": (
        BY_DESIGN, "the traced body of device_side_tables; see side_tables"),
    "ops.join.lookup_join32": (
        BY_DESIGN, "an int32-lane sort-join for the TPU; the port's one "
                   "lookup_join takes int32 and int64 sets"),
    "ops.join.lookup_join_pair": (
        BY_DESIGN, "the (hi, lo) int32 pair sort-join; see lookup_join32"),
    "ops.pallas_pack": (
        BY_DESIGN, "the Pallas kernels B1 and B2: their Hopper kernels are "
                   "ops/pack.py (csrc/pack.cu)"),
    "ops.pallas_compact": (
        BY_DESIGN, "the Pallas compactor B3: its Hopper kernel is ops/compact.py"
                   " (csrc/compact.cu)"),
    "core.kmer_set_set._HostWeightOracle": (
        BY_DESIGN, "the pair-weight oracles: the port's sketch tables "
                   "(ops/sketch.py) on the device or the mesh"),
    "core.kmer_set_set._DeviceWeightOracle": (
        BY_DESIGN, "see _HostWeightOracle: ops/sketch.DeviceSketchTable"),
    "core.kmer_set_set._MeshWeightOracle": (
        BY_DESIGN, "see _HostWeightOracle: ops/sketch.MeshSketchTable"),
    "core.kmer_set_set._make_weight_oracle": (
        BY_DESIGN, "the oracle choice, folded into KmerSetSet._compress"),
    "core.native.canonical_windows32": (
        BY_DESIGN, "the host count's window keys; the port counts on its device"),
    "core.native.side_tables": (
        BY_DESIGN, "the host canonical side tables; the port's are on the "
                   "device (the directed ones are side_tables_directed)"),
    "core.native.unitig_succ_from_tables": (
        BY_DESIGN, "the host unitig successor of the host side tables; the "
                   "port's is on the device (ops/unitigs.py)"),
    "core.spss._side_tables": (
        BY_DESIGN, "the host side-table router; the port builds the canonical "
                   "ones on the device and keeps _side_tables_directed"),
    "core.spss._side_table_canonical": (
        BY_DESIGN, "the host canonical side table; see _side_tables"),
    "core.kmer_counter.KmerCounter.counts": (
        BY_DESIGN, "a property for the deferred counts download; the port's "
                   "counts are eager, a plain attribute"),
    "ops.resident.DeviceKmers.prefetch_sides": (
        BY_DESIGN, "the count's launch of the slow link's side codes; the "
                   "side codes are built in the SPSS phase on the handle's "
                   "tensor (ops/unitigs.device_unitig_sides)"),
    "ops.resident.DeviceKmers.start_sides_download": (
        BY_DESIGN, "the download of the count's side codes; see "
                   "prefetch_sides"),
    "parallel.mesh.make_mesh": (
        BY_DESIGN, "a jax.sharding mesh of the visible devices; the port's is "
                   "parallel/mesh.Mesh over a list of torch devices"),
    "parallel.mesh.sharded_count_fn": (
        BY_DESIGN, "jitted shard_map factories: the port's mesh programs are "
                   "the functions sharded_*(mesh, ...) of parallel/mesh.py"),
    "parallel.mesh.sharded_side_tables_fn": (BY_DESIGN, "see sharded_count_fn"),
    "parallel.mesh.sharded_unitig_succ_fn": (BY_DESIGN, "see sharded_count_fn"),
    "parallel.mesh.sharded_pointer_double_fn": (BY_DESIGN, "see sharded_count_fn"),
    "parallel.mesh.sharded_hash_fn": (BY_DESIGN, "see sharded_count_fn"),
    "parallel.mesh.sharded_set_algebra_fn": (BY_DESIGN, "see sharded_count_fn"),
    "parallel.mesh.sharded_sketch_weights_fn": (BY_DESIGN, "see sharded_count_fn"),
    "parallel.mesh.sharded_chain_group_fn": (BY_DESIGN, "see sharded_count_fn"),
    "parallel.mesh.sharded_emit_fn": (BY_DESIGN, "see sharded_count_fn"),
    "parallel.mesh.sharded_matching_fn": (BY_DESIGN, "see sharded_count_fn"),
    "parallel.mesh.sharded_overlap_edges_fn": (BY_DESIGN, "see sharded_count_fn"),
    "utils.flags.honor_platform_env": (
        BY_DESIGN, "re-pins JAX's platform; the port never imports JAX"),
}

# Private names of the library surface, inventoried with the public ones.
PRIVATE = [
    "core.kmer_set._isin_sorted",
    "core.kmer_set.KmerSet.__len__",
    "core.kmer_counter.KmerCounter._flush",
]

# The names that the library slice ports (docs/API.md's surface): each must
# be found in the port, never in NOT_PORTED.
LIBRARY = [
    "core.kmer_set.KmerSet." + m for m in (
        "from_kmers", "__len__", "contains", "contains_one", "add_kmers",
        "remove_kmers", "find", "union", "subtract", "intersection",
        "diff_count")
] + ["core.kmer_set._isin_sorted", "core.kmer_set.intersection_size",
     "core.kmer_counter.extract_kmers"] + [
    "core.kmer_counter.KmerCounter." + m for m in ("add", "_flush", "size", "get")
] + ["core.kmer." + f for f in (
    "last_code", "first_code", "bucket_and_key", "kmer_from_bucket_and_key",
    "kmers_from_codes", "string_to_codes", "codes_to_string", "string_to_kmer",
    "kmer_to_string")
] + ["core.strings.PackedStrings." + m for m in (
    "from_strings", "n", "get_codes", "to_strings", "all_kmers")
] + ["core.strings.complement_codes", "core.arrays.sorted_unique_counts",
     "core.native.window_pack", "core.native.count_hash",
     "core.native.intersect_size"] + ["utils.random." + f for f in (
    "get_random_kmer", "get_random_read", "get_random_kmers",
    "get_random_kmer_counter", "get_random_kmer_set",
    "get_random_kmer_set_compact", "get_random_kmer_sets_compact",
    "get_random_kmer_set_set")
] + ["utils.flags.get_flag_message", "ops.join.intersection_count",
     "ops.count.canonical_windows", "ops.count.count_kmers",
     "ops.count.count_to_set", "ops.count.window_validity",
     "core.disjoint_set.DisjointSet", "core.disjoint_set.connected_components",
     "utils.range.Range", "utils.range.Range.split", "utils.io.TemporaryFile",
     "utils.io.TemporaryDirectory", "utils.io.get_kmer_set_from_file"]


def _modules(pkg):
    return sorted(m.name.split(".", 1)[1]
                  for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))


REF_MODULES = _modules(kmerset_tpu)


def _defined_in(obj, modname: str) -> bool:
    if getattr(obj, "__module__", None) == modname:
        return True
    wrapped = getattr(obj, "__wrapped__", None)  # a jax.jit function
    return wrapped is not None and getattr(wrapped, "__module__", None) == modname


def _member(obj) -> bool:
    return callable(obj) or isinstance(obj, (classmethod, staticmethod, property))


def _inventory(rel: str):
    """The reference module's public functions and classes and their
    public members, as dotted paths under the package."""
    mod = importlib.import_module(f"kmerset_tpu.{rel}")
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("_") or not callable(obj):
            continue
        if not _defined_in(obj, mod.__name__):
            continue
        out.append(f"{rel}.{name}")
        if inspect.isclass(obj):
            out += [f"{rel}.{name}.{m}" for m, v in vars(obj).items()
                    if not m.startswith("_") and _member(v)]
    extra = [n for n in (*PRIVATE, *NOT_PORTED)
             if n.startswith(rel + ".") and n.rsplit(".", 1)[-1].startswith("_")]
    return sorted(set(out + extra))


def _resolve(root: str, path: str):
    """The object at `root`.`path` (a dotted module path, then attributes),
    or None."""
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join([root, *parts[:i]]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = (vars(obj).get(attr) if inspect.isclass(obj)
                   else getattr(obj, attr, None))
            if obj is None:
                return None
        return obj
    return None


def _listed(name: str):
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        entry = NOT_PORTED.get(".".join(parts[:i]))
        if entry is not None:
            return entry
    return None


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_reference_name_is_ported_or_listed(rel):
    missing = [n for n in _inventory(rel)
               if _resolve("kmerset_tpu_torch", n) is None and _listed(n) is None]
    assert not missing, f"neither ported nor in NOT_PORTED: {missing}"


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_every_listed_name_is_a_reference_name_the_port_lacks(name):
    label, reason = NOT_PORTED[name]
    assert label == BY_DESIGN and reason
    assert _resolve("kmerset_tpu", name) is not None, "not in the reference"
    assert _resolve("kmerset_tpu_torch", name) is None, "the port has it"


def test_the_library_surface_is_ported():
    for name in LIBRARY:
        assert _listed(name) is None, name
        assert _resolve("kmerset_tpu", name) is not None, name
        assert _resolve("kmerset_tpu_torch", name) is not None, name


def test_nothing_is_left_to_port():
    """After the link formats and the resident handle (ROADMAP A.9) no
    A.9 entry is left: every entry is a design replacement, and the only
    reference modules the port lacks are the Pallas kernels', whose
    Hopper kernels are ops/pack.py and ops/compact.py."""
    assert {label for label, _ in NOT_PORTED.values()} == {BY_DESIGN}
    ported = set(_modules(kmerset_tpu_torch))
    absent = sorted(m for m in REF_MODULES if m not in ported)
    assert absent == ["ops.pallas_compact", "ops.pallas_pack"]
