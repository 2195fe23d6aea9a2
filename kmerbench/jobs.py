"""What one job of each kind runs, and what set-up it needs.

A mix's "job" names the kind.  Every job calls a port CLI's main(argv)
in this process with its real outputs; each clears the previous job's
outputs first, so a job that writes nothing cannot pass on an old one.
After each job the harness takes a digest of what it produced; every
digest of a run has to equal that of the output the reference checks.
control() and fault(name) write the control's output, or a planted
fault's (reference/control.py), in the program's place and return it as
a job for check().

Besides the job, a mix may state:
- "flags": further arguments of every CLI call of the cell, set-up's
  too (such as ["--workers", "8"], or ["--decompressor", "gzip -dc"]);
- "input_compressor": a shell command the generated FASTA files are
  piped through before the program reads them (generate.compress_inputs);
  the reference reads the plain files;
- "output_decompressor": a shell command the reference reads the
  program's outputs through, where the flags name a --compressor.
"""

from __future__ import annotations

import hashlib
import os
import shutil

from .reference import check, control
from .window import Job, run_job


def _digest_files(paths) -> str:
    h = hashlib.blake2b(digest_size=16)
    for p in paths:
        h.update(os.path.basename(p).encode() + b"\0")
        try:
            with open(p, "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(b"\1missing")
    return h.hexdigest()


class Kind:
    """One cell's job.  inputs: the files the program reads; fastas: the
    same as plain FASTA, which the reference reads; bases: their
    sequence bases; work_dir: where outputs go."""

    FAULTS = {}  # name: the reference function that writes the fault

    def __init__(self, config, mix, inputs, fastas, bases, work_dir, device,
                 seed, debug):
        self.k = int(config["k"])
        self.cutoff = int(mix["cutoff"])
        self.clade = len(config["tree"][-1]) if config.get("tree") else 1
        self.inputs, self.fastas, self.bases = inputs, fastas, bases
        self.dir, self.device, self.seed = work_dir, device, seed
        self.flags = (["--device", device, "--k", str(self.k)]
                      + [str(a) for a in mix.get("flags", [])]
                      + (["--debug"] if debug else []))
        self.unpack = mix.get("output_decompressor", "")
        self.stats = None  # the reference's counts, after check()

    def setup(self) -> None:
        """Set-up the job needs beyond the inputs (none)."""

    def work_per_job(self) -> float:
        raise NotImplementedError


class Build(Kind):
    """kmerset-build of the one FASTA into a dump."""

    FAULTS = {"one k-mer per line": control.one_kmer_per_line}

    def __init__(self, *a):
        super().__init__(*a)
        if len(self.fastas) != 1:
            raise ValueError("a build job takes a configuration of one genome")
        self.out = os.path.join(self.dir, "out.txt")

    def run(self, annotate=None):
        from kmerset_tpu_torch.cli import kmerset_build

        if os.path.exists(self.out):
            os.remove(self.out)
        job = run_job(kmerset_build.main, self.flags + [
            "--cutoff", str(self.cutoff), "--out", self.out, self.inputs[0]],
            annotate)
        job.digest = _digest_files([self.out])
        return job

    def check(self, last_job):
        parts, numbers, self.stats = check.check_build(
            self.fastas, self.out, self.k, self.cutoff, self.device, self.unpack)
        return parts, numbers

    def control(self) -> Job:
        self.unpack = ""
        control.build_output(self.fastas, self.out, self.k, self.cutoff, self.device)
        return Job(0.0, 0.0, 0.0, True)

    def fault(self, name: str) -> Job:
        self.unpack = ""
        self.FAULTS[name](self.fastas, self.out, self.k, self.cutoff, self.device)
        return Job(0.0, 0.0, 0.0, True)

    def work_per_job(self) -> float:
        return float(sum(self.bases))  # FASTA bases in


class _Sets(Kind):
    """Set-up of the multi-set jobs: each genome's set file built by the
    port's kmerset-build."""

    def setup(self) -> None:
        from kmerset_tpu_torch.cli import kmerset_build

        self.sets = []
        for i, fa in enumerate(self.inputs):
            self.sets.append(os.path.join(self.dir, f"set{i}.txt"))
            job = run_job(kmerset_build.main, self.flags + [
                "--cutoff", str(self.cutoff), "--out", self.sets[-1], fa])
            if not job.ok:
                raise RuntimeError(f"set-up build of {fa} failed: {job.error}")

    def work_per_job(self) -> float:
        return float(sum(self.stats["sizes"]))  # input k-mers


class Compress(_Sets):
    """kmerset-multiple-compress of the set files into a directory and a
    DOT file."""

    FAULTS = {"no sharing": control.no_sharing}

    def __init__(self, *a):
        super().__init__(*a)
        self.out = os.path.join(self.dir, "compressed")
        self.dot = os.path.join(self.dir, "graph.dot")

    def _outputs(self):
        names = sorted(os.listdir(self.out)) if os.path.isdir(self.out) else []
        return [os.path.join(self.out, n) for n in names] + [self.dot]

    def _clear(self):
        shutil.rmtree(self.out, ignore_errors=True)
        if os.path.exists(self.dot):
            os.remove(self.dot)

    def run(self, annotate=None):
        from kmerset_tpu_torch.cli import kmerset_multiple_compress

        self._clear()
        job = run_job(kmerset_multiple_compress.main, self.flags + [
            "--seed", str(self.seed), "--out", self.out, "--out_graph",
            self.dot] + self.sets, annotate)
        job.digest = _digest_files(self._outputs())
        return job

    def check(self, last_job):
        parts, numbers, self.stats = check.check_compress(
            self.fastas, self.out, self.dot, self.k, self.cutoff, self.device,
            self.unpack)
        return parts, numbers

    def control(self) -> Job:
        self._clear()
        self.unpack = ""
        control.compress_output(self.fastas, self.out, self.dot, self.k,
                                self.cutoff, self.clade, self.device)
        return Job(0.0, 0.0, 0.0, True)

    def fault(self, name: str) -> Job:
        self._clear()
        self.unpack = ""
        self.FAULTS[name](self.fastas, self.out, self.dot, self.k, self.cutoff,
                          self.device)
        return Job(0.0, 0.0, 0.0, True)


class Decompress(_Sets):
    """kmerset-multiple-decompress of a directory that set-up compressed;
    its output is each set's logged size and hash."""

    def setup(self) -> None:
        from kmerset_tpu_torch.cli import kmerset_multiple_compress

        super().setup()
        self.src = os.path.join(self.dir, "compressed")
        job = run_job(kmerset_multiple_compress.main, self.flags + [
            "--seed", str(self.seed), "--out", self.src] + self.sets)
        if not job.ok:
            raise RuntimeError(f"set-up compress failed: {job.error}")

    def run(self, annotate=None):
        from kmerset_tpu_torch.cli import kmerset_multiple_decompress

        job = run_job(kmerset_multiple_decompress.main, self.flags + [self.src],
                      annotate)
        job.digest = repr(check.logged_sets(job.lines))
        return job

    def check(self, last_job):
        parts, numbers, self.stats = check.check_decompress(
            self.fastas, self.src, check.logged_sets(last_job.lines), self.k,
            self.cutoff, self.device, self.unpack)
        return parts, numbers

    def control(self) -> Job:
        return Job(0.0, 0.0, 0.0, True, control.decompress_lines(
            self.fastas, self.k, self.cutoff, self.clade, self.device))


KINDS = {"build": Build, "compress": Compress, "decompress": Decompress}
