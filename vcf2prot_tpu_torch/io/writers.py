"""Output serialization: per-sample FASTA writers, stats TSVs, int-map JSON.

File formats mirror the reference writers byte-for-byte where they are
deterministic (reference: src/data_structures/InternalRep/
personalized_genome.rs:72-210, src/writers.rs:41-150). Where the reference's
record order depends on HashMap iteration, this implementation emits records
in deterministic (compilation) order instead.
"""
from __future__ import annotations

import gzip
import json
import os
from concurrent.futures import ThreadPoolExecutor

from ..constants import SUP_TYPE


class PersonalizedProteome:
    """One sample's executed output: two haplotype tapes with annotations."""

    def __init__(self, proband, hap1_bytes, hap1_annotations, hap2_bytes, hap2_annotations):
        self.proband = proband
        self.hap1 = hap1_bytes
        self.ann1 = hap1_annotations   # list[(name, start, end)]
        self.hap2 = hap2_bytes
        self.ann2 = hap2_annotations

    def records(self, write_all=False, ref_seqs=None):
        """Yield (header, sequence) records, haplotype 1 first
        (personalized_genome.rs:90-113 for altered-only, 120-210 for all)."""
        tape1 = self.hap1.tobytes().decode("ascii")
        tape2 = self.hap2.tobytes().decode("ascii")
        for hap_idx, (tape, anns) in ((1, (tape1, self.ann1)), (2, (tape2, self.ann2))):
            altered = set()
            for name, start, end in anns:
                altered.add(name)
                yield f"{name}_{hap_idx}", tape[start:end]
            if write_all and ref_seqs:
                for name, seq in ref_seqs.items():
                    if name not in altered:
                        yield f"{name}_{hap_idx}", seq

    def write(self, outdir, write_all=False, write_compressed=False, ref_seqs=None):
        ext = ".fasta.gz" if write_compressed else ".fasta"
        path = os.path.join(outdir, self.proband + ext)
        if not write_all:
            # the altered-only path (plain or gzip) formats and writes
            # natively; gzip level 9 matches the reference's
            # Compression::best() (personalized_genome.rs:89)
            from ..native_bridge import load_native

            native = load_native()
            level = 9 if write_compressed else 0
            a1, a2 = self.ann1, self.ann2
            if (
                native is not None
                and hasattr(native, "write_fasta_arrays")
                and getattr(a1, "names_blob", None) is not None
                and getattr(a2, "names_blob", None) is not None
                and a1.names_blob is a2.names_blob
            ):
                # array-backed annotations (native bridge output): format and
                # write without creating any per-record Python objects
                native.write_fasta_arrays(
                    path, self.hap1, a1.idx, a1.starts, a1.ends,
                    self.hap2, a2.idx, a2.starts, a2.ends,
                    a1.names_blob, a1.name_offsets, level,
                )
                return path
            if native is not None and hasattr(native, "write_fasta"):
                # numpy arrays satisfy the buffer protocol; no copies needed
                native.write_fasta(
                    path, self.hap1,
                    a1 if isinstance(a1, list) else list(a1),
                    self.hap2,
                    a2 if isinstance(a2, list) else list(a2),
                    level,
                )
                return path
        opener = (
            (lambda p: gzip.open(p, "wt", compresslevel=9))
            if write_compressed
            else (lambda p: open(p, "w"))
        )
        with opener(path) as fh:
            for header, seq in self.records(write_all, ref_seqs):
                fh.write(f">{header}\n{seq}\n")
        return path


def write_personalized_proteomes(
    proteomes,
    outdir,
    write_all=False,
    write_compressed=False,
    ref_seqs=None,
    num_threads=0,
):
    """Per-sample file fan-out (reference: parts/io.rs:35-58)."""
    if num_threads and num_threads > 1:
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            list(
                pool.map(
                    lambda p: p.write(outdir, write_all, write_compressed, ref_seqs),
                    proteomes,
                )
            )
    else:
        for p in proteomes:
            p.write(outdir, write_all, write_compressed, ref_seqs)


def write_earlymap2json(path2write, early_maps):
    """One JSON per sample of the raw per-haplotype consequence strings
    (writers.rs:12-32); errors if the directory already exists."""
    os.makedirs(path2write, exist_ok=False)
    for m in early_maps:
        with open(os.path.join(path2write, m.proband + ".json"), "w") as fh:
            json.dump(
                {
                    "proband_name": m.proband,
                    "mutations1": m.mutations1,
                    "mutations2": m.mutations2,
                },
                fh,
            )


def write_intmap2json(path2write, int_maps):
    """One JSON per sample in a fresh directory (writers.rs:41-61); errors if
    the directory already exists, like the reference."""
    os.makedirs(path2write, exist_ok=False)
    for m in int_maps:
        with open(os.path.join(path2write, m.proband + ".json"), "w") as fh:
            json.dump(m.to_json_dict(), fh)


def write_num_mutation_per_proband(outdir, table):
    """TSV incl. the reference's literal header/format quirks
    (writers.rs:70-89)."""
    with open(os.path.join(outdir, "number_of_mutations_per_proband.tsv"), "w") as fh:
        fh.write("Proband Name \t Number of mutations\n")
        for key, value in table.items():
            fh.write(f"{key},\t{value}\n")


def write_type_mutations_per_patient(outdir, table):
    """TSV with one count column per supported consequence class
    (writers.rs:97-124)."""
    with open(os.path.join(outdir, "type_of_mutations_per_patient.tsv"), "w") as fh:
        fh.write("Proband Name\t")
        for mutation in SUP_TYPE:
            fh.write(f"{mutation}\t")
        for key, counts in table.items():
            fh.write(f"{key}\t")
            for c in counts:
                fh.write(f"{c}\t")


def write_number_of_mutations_per_transcript(outdir, table):
    """TSV (writers.rs:132-150)."""
    with open(
        os.path.join(outdir, "number_of_mutations_per_transcript.tsv"), "w"
    ) as fh:
        fh.write("Transcript Name \t Number of mutations\n")
        for key, value in table.items():
            fh.write(f"{key},\t{value}\n")
