"""VCF frontend: streaming reader, sample extraction, BCSQ record filter and
per-sample haplotype decode.

Capability parity with the reference frontend (reference: src/readers.rs:22-283
and src/data_structures/vcf_ds.rs:67-329) with a TPU-host-friendly design:

* the file is streamed line-by-line (the reference loads the whole file into a
  single String; readers.rs:119-139),
* the record-major -> sample-major transpose operates on column slices of each
  line instead of materializing a full string matrix,
* decode is embarrassingly parallel over samples (thread pool).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from ..constants import SUP_TYPE_SET
from . import text_parser
from ._io import open_text
from .bitmask import decode_bitmask
from .maps import EarlyMap


class VcfFormatError(ValueError):
    pass


def is_supported_csq(csq: str) -> bool:
    """True if the consequence string has six pipes and a supported type
    (reference: readers.rs:269-283)."""
    if csq.count("|") != 6:
        return False
    return csq.split("|", 1)[0] in SUP_TYPE_SET


def record_is_supported(line: str) -> bool:
    """True if a VCF body line carries at least one supported BCSQ consequence
    (reference: readers.rs:225-255)."""
    fields = line.split("\t")
    if len(fields) < 8:
        return False
    info = fields[7]
    bcsq = None
    for sub in info.split(";"):
        if sub.startswith("BCSQ="):
            bcsq = sub.split("=")[1]
            break
    if bcsq is None:
        return False
    if "," in bcsq:
        return any(is_supported_csq(e) for e in bcsq.split(","))
    return is_supported_csq(bcsq)


@dataclass
class VcfFile:
    probands: list          # sample names, in header order
    records: list           # supported body lines (raw strings)


def read_vcf(path) -> VcfFile:
    """Stream a VCF file, returning sample names and the supported records."""
    probands = None
    records = []
    with open_text(path) as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            if not line:
                continue
            if line.startswith("#"):
                if line.startswith("#CHROM"):
                    cols = line.rstrip("\t").split("\t")
                    if len(cols) < 8:
                        raise VcfFormatError(
                            "The provided file does not contain the minimum "
                            f"number of columns, expected >= 8, found {len(cols)}"
                        )
                    # drop the 9 fixed columns (CHROM..FORMAT); the rest are
                    # samples (reference: readers.rs:180)
                    probands = cols[9:]
                continue
            if record_is_supported(line):
                records.append(line)
    if probands is None:
        raise VcfFormatError("Could not find a header line")
    if not probands:
        raise VcfFormatError("The file does not contain any patients")
    if not records:
        raise VcfFormatError("Could not extract any records from the provided file")
    return VcfFile(probands, records)


def get_consequence(line: str) -> str:
    """INFO -> the BCSQ= payload of one record (reference: vcf_ds.rs:67-86)."""
    info = line.split("\t")[7]
    return info.split("BCSQ=")[1]


def _decode_mask_cached(sample_field: str, cache: dict):
    """``sample column -> (hap1 indices, hap2 indices) or None``, memoized.

    Cohort sample columns repeat heavily (genotype strings are drawn from a
    small set per record shape), so a per-run memo removes nearly all of the
    string parsing from the hot loop. Behavior is identical to
    get_bit_mask + decode_bitmask (vcf_ds.rs:215-234, MaskDecoder.rs:32-153).
    """
    hit = cache.get(sample_field, _MISS)
    if hit is not _MISS:
        return hit
    mask = text_parser.get_bit_mask(sample_field)
    decoded = decode_bitmask(mask)
    cache[sample_field] = decoded
    return decoded


_MISS = object()


def build_early_maps(vcf: VcfFile, num_threads: int = 0) -> list:
    """Per-sample EarlyMaps: bitmask decode + SUP_TYPE filter.

    Record-major single pass: each record line is split once, its consequence
    list is classified once, and only carrier sample columns are decoded (the
    reference instead materializes a records x samples string matrix and
    parses every cell; vcf_ds.rs:126-295). Cohort VCFs are sparse -- most
    sample columns are non-carriers -- so this is the asymptotic win that
    keeps the host frontend ahead of the device.
    """
    n = len(vcf.probands)
    haps1 = [[] for _ in range(n)]
    haps2 = [[] for _ in range(n)]
    mask_cache: dict = {}

    def decode_records(records, haps1, haps2):
        for line in records:
            fields = line.split("\t")
            if len(fields) < 9 + n:
                raise VcfFormatError(
                    "truncated VCF record: fewer sample columns than samples"
                )
            csq = fields[7].split("BCSQ=")[1]
            entries = None
            supported = None
            for s_idx in range(n):
                decoded = _decode_mask_cached(fields[9 + s_idx], mask_cache)
                if decoded is None:
                    continue
                idx1, idx2 = decoded
                if not idx1 and not idx2:
                    continue
                if entries is None:
                    entries = csq.split(",")
                    supported = [
                        e.split("|", 1)[0] in SUP_TYPE_SET for e in entries
                    ]
                for i in idx1:
                    if supported[i]:
                        haps1[s_idx].append(entries[i])
                for i in idx2:
                    if supported[i]:
                        haps2[s_idx].append(entries[i])

    if num_threads and num_threads > 1 and len(vcf.records) > 1024:
        # chunk records, decode in parallel, merge in record order so the
        # per-sample mutation order matches the serial pass
        chunk = (len(vcf.records) + num_threads - 1) // num_threads
        parts = []
        for c in range(0, len(vcf.records), chunk):
            parts.append(
                (
                    vcf.records[c:c + chunk],
                    [[] for _ in range(n)],
                    [[] for _ in range(n)],
                )
            )
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            list(pool.map(lambda p: decode_records(*p), parts))
        for _recs, p1, p2 in parts:
            for s_idx in range(n):
                haps1[s_idx].extend(p1[s_idx])
                haps2[s_idx].extend(p2[s_idx])
    else:
        decode_records(vcf.records, haps1, haps2)
    return [
        EarlyMap(vcf.probands[i], haps1[i], haps2[i]) for i in range(n)
    ]
