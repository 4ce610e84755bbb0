"""Checkpoint / resume at the intermediate-representation boundary.

The reference has no in-process resume; its ``-i`` int-map JSON dump is the
natural checkpoint (parse once, re-execute many) -- reference:
src/writers.rs:41-61, main.rs:26-38. This module closes the loop: a dumped
``int_maps/`` directory can be loaded back and the pipeline resumed from the
compile stage, skipping VCF parsing entirely.
"""
from __future__ import annotations

import json
import os

from ..frontend.maps import AltTranscript, IntMap
from ..frontend.mutation import Mutation, MutationInfo, MutatedString


def _mutation_from_dict(d: dict) -> Mutation:
    info = d["mut_info"]
    return Mutation(
        d["transcript_name"],
        d["mut_type"],
        MutationInfo(
            info["ref_aa_position"],
            info["mut_aa_position"],
            MutatedString.from_str(info["ref_aa"]),
            MutatedString.from_str(info["mut_aa"]),
        ),
    )


def _alt_transcript_from_dict(d: dict) -> AltTranscript:
    return AltTranscript(
        d["name"], [_mutation_from_dict(m) for m in d["alts"]]
    )


def read_intmap_json(path2read) -> list:
    """Load every per-sample JSON in an int_maps directory."""
    int_maps = []
    for fname in sorted(os.listdir(path2read)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(path2read, fname)) as fh:
            doc = json.load(fh)
        int_maps.append(
            IntMap(
                doc["proband_name"],
                [_alt_transcript_from_dict(t) for t in doc["mutations1"]],
                [_alt_transcript_from_dict(t) for t in doc["mutations2"]],
            )
        )
    if not int_maps:
        raise FileNotFoundError(f"no int-map JSON files in {path2read}")
    return int_maps
