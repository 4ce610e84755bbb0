"""The chain cells' synthetic cohort: a frozen copy of the program's test
generator (``tests/genvcf.py``: ``random_proteome``,
``random_transcript_mutations``, ``shared_cohort``, ``write_synthetic_vcf``,
``write_fasta``), so that a change to the program cannot change the
traffic, with two additions:

- :func:`shared_cohort` returns what it planted as structured data (each
  transcript's pool of bundles, and for each sample and haplotype which
  bundle it carries), which the plain reference reads in place of the VCF;
- :func:`write_vcf` writes the same bytes as the original's
  ``write_synthetic_vcf``, a whole line at a time;
- the mix is a parameter (:data:`MIX`): the edits a bundle holds at most,
  the share of bundles that end in a terminal consequence, the shares of
  missense and in-frame edits, and how a haplotype picks a bundle of a
  transcript's pool: with ``carrier_p`` and then uniformly, as the
  original does, or by each bundle's own allele frequency, drawn from
  ``af_classes`` (a share of the bundles each, log-uniform between the
  class's bounds), so that a pool holds a few common bundles and many rare
  ones. At :data:`MIX`'s defaults the draws are the original's;
- :func:`stats` counts what a cohort plants a genome and over the cohort,
  the figures a traffic file's mix is held to.

Each transcript has a pool of bundles of consequences (a bundle is one of
the gene's population haplotypes, one VCF record), and every haplotype
carries one bundle of a transcript's pool or none. With ``accept`` given,
a bundle it refuses is drawn again from the same stream (the chain cell
refuses the bundles that the program's QC rejects, :func:`qc_accepts`);
without it the draws are the original's.
"""
from __future__ import annotations

import bisect
import random
from typing import NamedTuple

import numpy as np

AA = "ACDEFGHIKLMNPQRSTVWY"
# the mix's parameters and the original's values
MIX = {"edits_max": 6, "terminal_p": 0.35, "missense_below": 0.5,
       "insertion_below": 0.75, "af_classes": None}
# the consequences that truncate a protein (a stop gained, a frameshift)
TRUNCATING = ("stop_gained", "frameshift")
# an allele count under this share of the haplotypes is rare
RARE_AF = 0.005


def random_proteome(rng: random.Random, n_transcripts=20, min_len=60,
                    max_len=800):
    ref = {}
    for i in range(n_transcripts):
        name = f"ENST{i:011d}"
        length = rng.randint(min_len, max_len)
        ref[name] = "".join(rng.choice(AA) for _ in range(length))
    return ref


def _mk_csq(mut_type, name, change):
    return f"{mut_type}|GENE|{name}|protein_coding|+|{change}|1A>1T"


def random_transcript_mutations(rng: random.Random, name: str, seq: str,
                                edits_max=6, terminal_p=0.35,
                                missense_below=0.5, insertion_below=0.75):
    """A sorted, non-overlapping mutation list for one transcript/haplotype:
    1 to ``edits_max`` edits, the last terminal with ``terminal_p``, each
    other a missense under ``missense_below``, an in-frame insertion under
    ``insertion_below``, else an in-frame deletion (one draw in [0, 1))."""
    n = len(seq)
    csqs = []
    pos = rng.randint(1, max(1, n // 4))   # 1-based
    shift = 0
    had_del = False
    n_muts = rng.randint(1, edits_max)
    for k in range(n_muts):
        if pos >= n - 6:
            break
        last = k == n_muts - 1
        ref_res = seq[pos - 1]
        mpos = pos + shift
        star = "*" if (k > 0 and rng.random() < 0.3) else ""
        kind = rng.random()
        if last and kind < terminal_p:
            # terminal mutation families
            term = rng.random()
            if term < 0.3:
                csqs.append(_mk_csq(star + "stop_gained", name,
                                    f"{pos}{ref_res}>{mpos}*"))
            elif term < 0.6:
                payload = "".join(rng.choice(AA)
                                  for _ in range(rng.randint(1, 12)))
                csqs.append(_mk_csq(star + "frameshift", name,
                                    f"{pos}{ref_res}>{mpos}{ref_res}"
                                    f"{payload}*"))
            elif term < 0.8 and not had_del:
                # stop_lost only on deletion-free haplotypes (the
                # compiler's gap copy after a deletion drops the stop slot)
                stop = n  # 1-based stop position
                payload = "".join(rng.choice(AA)
                                  for _ in range(rng.randint(1, 8)))
                csqs.append(_mk_csq("stop_lost", name,
                                    f"{stop}*>{stop + shift}{payload}"))
            else:
                payload = "".join(rng.choice(AA)
                                  for _ in range(rng.randint(2, 8)))
                csqs.append(_mk_csq(
                    star + "frameshift&stop_retained" if not star
                    else "*frameshift&stop_retained",
                    name, f"{pos}{ref_res}>{mpos}{payload}*"))
            break
        r = kind
        if r < missense_below:
            new = rng.choice(AA.replace(ref_res, ""))
            csqs.append(_mk_csq(star + "missense", name,
                                f"{pos}{ref_res}>{mpos}{new}"))
        elif r < insertion_below:
            ins = "".join(rng.choice(AA) for _ in range(rng.randint(1, 4)))
            csqs.append(_mk_csq(star + "inframe_insertion", name,
                                f"{pos}{ref_res}>{mpos}{ref_res}{ins}"))
            shift += len(ins)
        else:
            span = rng.randint(2, min(4, n - pos))
            del_seq = seq[pos - 1: pos - 1 + span]
            csqs.append(_mk_csq(star + "inframe_deletion", name,
                                f"{pos}{del_seq}>{mpos}{del_seq[0]}"))
            shift -= span - 1
            had_del = True
            pos += span  # skip past the deleted span
        pos += rng.randint(6, 40)
    return csqs


class Cohort(NamedTuple):
    """What :func:`shared_cohort` planted."""

    ref: dict          # transcript name -> reference protein
    pools: list        # per transcript (ref order): its bundles, csq lists
    carried: np.ndarray  # int16 [samples, 2, transcripts]: bundle or -1
    redrawn: int       # bundles drawn again because ``accept`` refused them

    @property
    def names(self) -> list:
        return [f"SAMPLE{s:04d}" for s in range(self.carried.shape[0])]

    def samples(self) -> dict:
        """``{sample: (hap1 csqs, hap2 csqs)}``, the original's return."""
        out = {}
        for s, name in enumerate(self.names):
            haps = []
            for h in range(2):
                csqs = []
                for t in np.nonzero(self.carried[s, h] >= 0)[0]:
                    csqs.extend(self.pools[t][self.carried[s, h, t]])
                haps.append(csqs)
            out[name] = (haps[0], haps[1])
        return out


def shared_cohort(seed=0, n_samples=32, n_transcripts=12, bundles_per_txp=3,
                  carrier_p=0.35, min_len=60, max_len=800,
                  accept=None, **mix) -> Cohort:
    """1000G-like cohort: each transcript has a small pool of population
    haplotype bundles and every sample haplotype either carries one pool
    bundle or none. ``accept(seq, bundle)``, where given, refuses a bundle,
    which is then drawn again. ``mix`` holds :data:`MIX`'s keys: the
    bundles' edits (:func:`random_transcript_mutations`) and
    ``af_classes``. Without it a haplotype carries a bundle with
    ``carrier_p``, picked uniformly, two draws a haplotype and transcript
    (the original's). With it, ``[[share, low, high], ...]``, each bundle
    draws its class by share and its allele frequency log-uniformly in
    ``[low, high)`` (a pool's frequencies scaled down to sum to 1 where
    they pass it), and one draw a haplotype and transcript picks the
    bundle whose frequency it falls in, or none; ``carrier_p`` is unused."""
    unknown = set(mix) - set(MIX)
    if unknown:
        raise TypeError(f"no mix parameter {sorted(unknown)}")
    mix = {**MIX, **mix}
    classes = mix.pop("af_classes")
    rng = random.Random(seed)
    ref = random_proteome(rng, n_transcripts, min_len, max_len)
    pools, redrawn = [], 0
    for name, seq in ref.items():
        pool = []
        for _ in range(bundles_per_txp):
            bundle = random_transcript_mutations(rng, name, seq, **mix)
            while bundle and accept is not None and not accept(seq, bundle):
                redrawn += 1
                bundle = random_transcript_mutations(rng, name, seq, **mix)
            if bundle:
                pool.append(bundle)
        pools.append(pool)
    sizes = [len(pool) for pool in pools]
    rand, below = rng.random, rng._randbelow
    picks = []  # (sample, haplotype, transcript, bundle)
    add = picks.append
    if classes:
        shares = np.cumsum([c[0] for c in classes])
        shares /= shares[-1]
        bounds = []  # per transcript: its bundles' upper ends in [0, 1)
        for size in sizes:
            freqs = []
            for _ in range(size):
                low, high = classes[min(bisect.bisect_right(shares, rand()),
                                        len(classes) - 1)][1:]
                freqs.append(low * (high / low) ** rand())
            scale = max(1.0, sum(freqs))
            bounds.append(np.cumsum(freqs).tolist() if scale == 1.0 else
                          [v / scale for v in np.cumsum(freqs).tolist()])
        for s in range(n_samples):
            for h in range(2):
                for t, ends in enumerate(bounds):
                    if ends:
                        j = bisect.bisect_right(ends, rand())
                        if j < len(ends):
                            add((s, h, t, j))
    else:
        # ``rng.choice(pool)`` is ``pool[rng._randbelow(len(pool))]``; the
        # bundle's index is drawn so directly, the same draws a third
        # faster (a test holds the cohort equal to the original's)
        for s in range(n_samples):
            for h in range(2):
                for t, size in enumerate(sizes):
                    if size and rand() < carrier_p:
                        add((s, h, t, below(size)))
    carried = np.full((n_samples, 2, len(pools)), -1, np.int16)
    if picks:
        s, h, t, b = np.asarray(picks, np.int64).T
        carried[s, h, t] = b
    return Cohort(ref, pools, carried, redrawn)


def stats(cohort: Cohort) -> dict:
    """What a cohort plants: a genome's mean peptide-altering sites (the
    edits of the bundles it carries on either haplotype, a bundle carried
    on both counted once) and truncating sites (:data:`TRUNCATING`, a
    ``*`` form included), the VCF's records (distinct carried bundles),
    the share of records carried by under :data:`RARE_AF` of the
    haplotypes, and the records a genome carries over the records."""
    carried = cohort.carried
    n_samples, _two, n_txp = carried.shape
    width = max(map(len, cohort.pools), default=0) or 1
    edits = np.zeros((n_txp, width), np.int64)
    trunc = np.zeros((n_txp, width), np.int64)
    for t, pool in enumerate(cohort.pools):
        for b, bundle in enumerate(pool):
            edits[t, b] = len(bundle)
            trunc[t, b] = sum(c.split("|")[0].lstrip("*") in TRUNCATING
                              for c in bundle)
    t = np.arange(n_txp)
    sites = truncating = per_genome = 0
    for h1, h2 in carried:
        for b, keep in ((h1, h1 >= 0), (h2, (h2 >= 0) & (h2 != h1))):
            sites += int(edits[t[keep], b[keep]].sum())
            truncating += int(trunc[t[keep], b[keep]].sum())
            per_genome += int(keep.sum())
    flat = carried.reshape(-1)
    key = np.tile(t, 2 * n_samples)[flat >= 0] * width + flat[flat >= 0]
    counts = np.bincount(key, minlength=n_txp * width)
    counts = counts[counts > 0]
    rare = float(np.mean(counts < RARE_AF * 2 * n_samples)) if len(
        counts) else 0.0
    return {"sites_per_genome": sites / n_samples,
            "truncating_per_genome": truncating / n_samples,
            "records": int(len(counts)), "rare_record_share": rare,
            "records_per_genome": per_genome / n_samples}


def parse_change(csq: str) -> tuple:
    """``(type, transcript, ref_pos, ref_side, mut_pos, mut_side)`` of one
    consequence: positions 1-based, as the record writes them."""
    fields = csq.split("|")
    change = fields[5]
    left, right = change.split(">")

    def split(side):
        i = 0
        while side[i].isdigit():
            i += 1
        return int(side[:i]), side[i:]

    (ref_pos, ref_side), (mut_pos, mut_side) = split(left), split(right)
    return fields[0], fields[2], ref_pos, ref_side, mut_pos, mut_side


def qc_accepts(seq: str, bundle: list) -> bool:
    """Whether the program's instruction-generation QC accepts a bundle of
    one transcript (``compiler/transcript.py::
    _inspect_instruction_generation``, the reference tool's overlap and
    engulfment check, which aborts the run by default): for consecutive
    consequences ``a``, ``b`` (mutated-position order), ``b``'s mutated
    position lies past ``a``'s called residues, and where ``a`` is an
    in-frame deletion, ``b``'s *reference* position lies past ``a``'s
    mutated position plus its deleted span less two. The second compares a
    reference coordinate with a mutated one (a quirk kept for parity), so
    a deletion after a net insertion of 8 or more residues, followed
    closely by another consequence, is refused."""
    parsed = [parse_change(c) for c in bundle]
    for a, b in zip(parsed, parsed[1:]):
        a_type, _t, _a_ref, a_ref_side, a_mut, a_mut_side = a
        called = len(a_mut_side.rstrip("*")) if a_mut_side != "*" else 0
        if b[4] <= a_mut + called - 1:
            return False
        if a_type.lstrip("*") == "inframe_deletion":
            span = len(a_ref_side)
            if b[2] <= a_mut + span - 2:
                return False
    return True


def _mask_words(k: int, hap_bit: int) -> list:
    """The original's per-word carriage bits of ``k`` consequences."""
    words, remaining = [], k
    while remaining > 0:
        take = min(15, remaining)
        w = 0
        for i in range(take):
            w |= 1 << (2 * i + hap_bit)
        words.append(w)
        remaining -= take
    return words


def write_vcf(path: str, cohort: Cohort) -> None:
    """The original's ``write_synthetic_vcf(path, ref, samples)``, byte for
    byte: one record a distinct bundle (in order of its first carrier:
    samples in order, haplotype 1 first, transcripts in order), each
    sample's column ``0|0:.`` or ``0|1:`` and its carriage words."""
    carried = cohort.carried
    n_samples, _two, n_txp = carried.shape
    # one id a distinct bundle; ids in order of first carrier
    index, ident = {}, np.full((n_txp, max(map(len, cohort.pools),
                                            default=0) or 1), -1, np.int64)
    for t, pool in enumerate(cohort.pools):
        for b, bundle in enumerate(pool):
            ident[t, b] = index.setdefault(tuple(bundle), len(index))
    flat = np.nonzero(carried.reshape(-1) >= 0)[0]
    t = flat % n_txp
    key = ident[t, carried.reshape(-1)[flat]]
    s, h = flat // (2 * n_txp), (flat // n_txp) % 2
    order = np.argsort(key, kind="stable")
    bounds = np.searchsorted(key[order], np.arange(len(index) + 1))
    first = np.full(len(index), len(flat), np.int64)
    np.minimum.at(first, key, np.arange(len(flat)))
    keys = list(index)
    header = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO",
              "FORMAT"] + cohort.names
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=BCSQ,Number=.,Type=String,'
                 'Description="csq">\n')
        fh.write("\t".join(header) + "\n")
        pos = 1000
        for i in np.argsort(first, kind="stable"):
            if first[i] == len(flat):
                continue  # a bundle that no one carries
            mine = order[bounds[i]:bounds[i + 1]]
            hap = np.zeros(n_samples, np.int64)
            np.bitwise_or.at(hap, s[mine], 1 << h[mine])
            k = len(keys[i])
            one = [_mask_words(k, 0), _mask_words(k, 1)]
            both = [a | b for a, b in zip(*one)]
            text = {m: "0|1:" + ",".join(str(w) for w in words)
                    for m, words in ((1, one[0]), (2, one[1]), (3, both))}
            cols = ["0|0:."] * n_samples
            for j in np.nonzero(hap)[0].tolist():
                cols[j] = text[int(hap[j])]
            fh.write("\t".join(
                ["1", str(pos), f"v{pos}", "A", "T", "100", "PASS",
                 f"AF=0.1;BCSQ={','.join(keys[i])}", "GT:BCSQ"] + cols)
                + "\n")
            pos += 10


def write_fasta(path, ref):
    with open(path, "w") as fh:
        for name, seq in ref.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i:i + 70] + "\n")
