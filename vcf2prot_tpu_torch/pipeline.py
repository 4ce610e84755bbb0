"""End-to-end pipeline of the port.

The counterpart of ``vcf2prot_tpu/pipeline.py``: parse the VCF ->
per-sample intermediate maps -> (optional dumps/stats) -> compile ->
execute -> write. The host prologue (``_compile``: parse + compile on the
native tier when it applies, stats and int-map dumps) is the port's own
copy of the reference's and is shared by every engine. Then

* the host engines (``st``/``mt``) execute and write each sample in one
  step, ``mt`` through a thread pool (the reference's host loop); with
  ``--neoantigen_device`` the cohort's candidates are scored in one batch
  by the port's head (on the card when one is present, else its plain
  version on the CPU);
* the GPU engine streams pair-aligned chunks through :class:`GpuEngine`:
  one chunk is dispatched to the device while the previous one is
  collected and its samples written (FASTAs, and the per-sample or
  cohort-batch neoantigen reports), so host memory stays bounded by the
  chunk size; or
* with ``--neoantigen_only``, the GPU engine runs the device-resident chain
  (``downstream/device_resident.py``), which fetches only per-sample rows.

With the device left at the default ``"cuda"`` and more than one local CUDA
device (``parallel.mesh.make_mesh``), the GPU engine runs sharded over every
device, as the reference does on a host with several TPU chips: FASTA chunks
of ``chunk_res_bytes`` per device through
:class:`~vcf2prot_tpu_torch.parallel.sharded.ShardedEngine`, and the chain
through :class:`~vcf2prot_tpu_torch.parallel.sharded_neoantigen.
ShardedNeoantigenEngine` with chunks of the single-device size. An explicit
``"cuda:N"`` or ``"cpu"`` keeps one device.
"""
from __future__ import annotations

import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .compiler.haplotype import RefBlob
from .compiler.qc import QcConfig, default_qc
from .frontend import fasta, vcf_reader
from .frontend.maps import build_int_map_from_early
from .io.writers import (
    PersonalizedProteome,
    write_intmap2json,
    write_num_mutation_per_proband,
    write_number_of_mutations_per_transcript,
    write_type_mutations_per_patient,
)
from .runtime import cpu_engine
from .runtime.engine import Engine, resolve_auto
from .stats.summary import compute_stats
from .utils.timers import StageTimer, torch_trace

__all__ = [
    "DEFAULT_CHUNK_RES_BYTES", "DEFAULT_NEO_CHUNK_RES_BYTES",
    "PipelineConfig", "PipelineResult", "execute_programs", "run_pipeline",
]

# Haplotype programs are executed in chunks bounded by result-tape bytes so
# device buffers stay well under device memory while still amortizing
# dispatch.
DEFAULT_CHUNK_RES_BYTES = 256 * 1024 * 1024
# The device-resident neoantigen chain's chunks, the reference's default.
DEFAULT_NEO_CHUNK_RES_BYTES = 128 * 1024 * 1024


@dataclass
class PipelineConfig:
    vcf_path: str
    fasta_path: str
    outdir: str
    engine: Engine = Engine.GPU
    verbose: bool = False
    compute_stats: bool = False
    write_int_map: bool = False
    write_all: bool = False
    write_compressed: bool = False
    single_thread_writes: bool = False
    num_threads: int = 0
    # None = per-stage default (DEFAULT_CHUNK_RES_BYTES for FASTA output,
    # DEFAULT_NEO_CHUNK_RES_BYTES for the device-resident neoantigen chain);
    # an explicit value applies to both stages
    chunk_res_bytes: int = None
    qc: QcConfig = None
    # use the C++ frontend/compiler when available; stats and int-map dumps
    # need the Python intermediate maps and route through the Python path
    use_native: bool = True
    # resume from a previously dumped int_maps/ directory (skips VCF parsing)
    resume_int_maps: str = ""
    # restrict to a subset of sample indices (multi-host shard assignment)
    sample_indices: list = None
    # write a torch.profiler trace of the execute stage to this directory
    profile_dir: str = ""
    # 0 = off; k>0 writes <proband>.neoantigens.tsv with ranked
    # mutation-overlapping k-mers per sample (downstream/report.py)
    neoantigen_k: int = 0
    # score the cohort's candidate windows in ONE batch of the port's head
    # (downstream/cohort.py) instead of per-sample host math
    neoantigen_device: bool = False
    # .npz with trained scoring-head weights (downstream/scoring.load_params);
    # empty = the deterministic scaffold initialization
    neoantigen_params: str = ""
    # skip FASTA output entirely: the run's product is the neoantigen TSVs.
    # On the GPU engine this runs the device-resident chain
    # (downstream/device_resident.py): only [samples, top] rows reach the host
    neoantigen_only: bool = False
    # ranked rows kept per sample in the neoantigen TSVs
    neoantigen_top: int = 200
    # torch device of the GPU engine; the CLI keeps the default, the CPU
    # tests set "cpu" to run the kernels' plain versions
    device: str = "cuda"


@dataclass
class PipelineResult:
    proteomes: list = field(default_factory=list)
    n_samples: int = 0
    n_haplotype_seqs: int = 0
    total_output_bytes: int = 0
    durations: dict = field(default_factory=dict)


def parse_vcf_to_int_maps(vcf_path, num_threads=0):
    vcf = vcf_reader.read_vcf(vcf_path)
    early = vcf_reader.build_early_maps(vcf, num_threads=num_threads)
    if num_threads and num_threads > 1:
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            return list(pool.map(build_int_map_from_early, early))
    return [build_int_map_from_early(e) for e in early]


def _chunk_indices(programs, chunk_res_bytes, pair_aligned=False):
    """Greedy chunking of haplotype programs by result size.

    ``pair_aligned`` keeps (hap1, hap2) pairs in the same chunk so whole
    samples complete chunk-by-chunk (needed for streaming writes).
    """
    step = 2 if pair_aligned else 1
    chunks = []
    cur = []
    cur_bytes = 0
    for i in range(0, len(programs), step):
        group = list(range(i, min(i + step, len(programs))))
        size = sum(programs[g].res_len for g in group)
        if cur and cur_bytes + size > chunk_res_bytes:
            chunks.append(cur)
            cur = []
            cur_bytes = 0
        cur.extend(group)
        cur_bytes += size
    if cur:
        chunks.append(cur)
    return chunks


def _validate_host_programs(programs):
    """Pre-execution contiguity validation of each task stream -- the
    reference's DEBUG_CPU_EXEC check (gir.rs:203-229)."""
    import numpy as np

    for idx, p in enumerate(programs):
        if p.n_tasks == 0:
            continue
        ends = p.dst + p.length
        if (
            int(p.dst[0]) != 0
            or not np.all(p.dst[1:] == ends[:-1])
            or int(ends[-1]) != p.res_len
        ):
            raise AssertionError(
                f"DEBUG_CPU_EXEC: task stream of haplotype {idx} is not "
                "contiguous with its result tape"
            )


def _write_stats_tables(outdir, per_proband, per_type, per_transcript):
    """The three -s TSVs (shared by the native and Python stats paths)."""
    write_num_mutation_per_proband(outdir, per_proband)
    write_type_mutations_per_patient(outdir, per_type)
    write_number_of_mutations_per_transcript(outdir, per_transcript)


def execute_programs(programs, blob, engine: Engine,
                     chunk_res_bytes=DEFAULT_CHUNK_RES_BYTES,
                     validate_device=False, validate_host=False,
                     device="cuda"):
    """Execute haplotype programs with the selected engine; returns one uint8
    array per program."""
    if validate_host:
        _validate_host_programs(programs)
    if engine is Engine.AUTO:
        engine = resolve_auto()
    if engine is Engine.MT:
        with ThreadPoolExecutor() as pool:
            return list(pool.map(
                lambda p: cpu_engine.execute_tasks_fast(p, blob), programs
            ))
    if engine is not Engine.GPU:
        return [cpu_engine.execute_tasks(p, blob) for p in programs]
    outputs = [None] * len(programs)
    for chunk, outs in _device_chunk_results(
        programs, blob, chunk_res_bytes, validate_device, device
    ):
        for i, o in zip(chunk, outs):
            outputs[i] = o
    return outputs


def device_mesh(device):
    """The mesh a GPU-engine run on ``device`` spreads over, or None for
    one device: ``make_mesh()`` when ``device`` is the default ``"cuda"``
    and it finds more than one device (the reference's
    ``jax.local_device_count() > 1``)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return None
    from .parallel.mesh import make_mesh

    mesh = make_mesh()
    return mesh if len(mesh) > 1 else None


def _device_chunk_results(programs, blob, chunk_res_bytes, validate_device,
                          device, pair_aligned=False):
    """Depth-2 chunk pipeline over :class:`GpuEngine`, or over
    :class:`ShardedEngine` with chunks of ``chunk_res_bytes`` per device
    when :func:`device_mesh` gives a mesh: the next chunk is dispatched
    before the previous one is collected; yields ``(chunk_indices,
    outputs)`` in order."""
    mesh = device_mesh(device)
    if mesh is not None:
        from .parallel.sharded import ShardedEngine

        dev = ShardedEngine(blob, mesh, validate_on_device=validate_device)
        chunk_res_bytes *= len(mesh)
    else:
        from .runtime.gpu_engine import GpuEngine

        dev = GpuEngine(blob, device=device,
                        validate_on_device=validate_device)
    pending = deque()
    for chunk in _chunk_indices(programs, chunk_res_bytes, pair_aligned):
        pending.append((chunk, dev.dispatch([programs[i] for i in chunk])))
        if len(pending) > 1:
            chunk_done, handle = pending.popleft()
            yield chunk_done, dev.collect(handle)
    while pending:
        chunk_done, handle = pending.popleft()
        yield chunk_done, dev.collect(handle)


def _print_warnings(warnings) -> None:
    # per-transcript skip warnings repeat across carriers; cap the spam
    seen = set()
    shown = 0
    for w in warnings:
        if w in seen:
            continue
        seen.add(w)
        if shown < 20:
            print(w, file=sys.stderr)
            shown += 1
    if len(seen) > shown:
        print(
            f"... and {len(seen) - shown} more distinct transcript "
            "warnings", file=sys.stderr,
        )


def _compile(cfg, qc, timer):
    """Host prologue of every engine: read the proteome, parse + compile
    the cohort (native tier when it applies), write the stats and int-map
    dumps. Returns ``(ref_seqs, blob, proband_names, flat_programs)``."""
    with timer.stage("Loading the Reference file"):
        ref_seqs = fasta.read_fasta(cfg.fasta_path)
        blob = RefBlob.from_ref_seqs(ref_seqs)

    # int-map dumps need the Python intermediate maps; the DEBUG_TXP trace
    # lives in the Python compiler
    native_result = None
    if (cfg.use_native and not cfg.write_int_map and not cfg.resume_int_maps
            and not qc.debug_txp):
        from .native_bridge import compile_cohort_native

        with timer.stage("Parsing and compiling (native)"):
            native_result = compile_cohort_native(
                cfg.vcf_path, ref_seqs, blob, qc, cfg.num_threads,
                collect_stats=cfg.compute_stats, alt_pool="auto",
                sample_subset=cfg.sample_indices,
            )

    if native_result is not None:
        stats_blocks = None
        if cfg.compute_stats:
            probands, flat, warnings, stats_blocks = native_result
        else:
            probands, flat, warnings = native_result
        _print_warnings(warnings)
        if stats_blocks is not None:
            from .stats.native_stats import stats_from_native

            with timer.stage("Computing and writing the stats"):
                _write_stats_tables(
                    cfg.outdir, *stats_from_native(probands, stats_blocks)
                )
        return ref_seqs, blob, probands, flat

    if cfg.resume_int_maps:
        from .io.checkpoint import read_intmap_json

        with timer.stage("Resuming from int-map checkpoint"):
            int_maps = read_intmap_json(cfg.resume_int_maps)
    else:
        with timer.stage("Reading and loading the VCF file"):
            int_maps = parse_vcf_to_int_maps(cfg.vcf_path, cfg.num_threads)
    if cfg.sample_indices is not None:
        keep = set(cfg.sample_indices)
        int_maps = [m for i, m in enumerate(int_maps) if i in keep]

    if cfg.write_int_map:
        with timer.stage("Writing the intermediate representation map"):
            write_intmap2json(os.path.join(cfg.outdir, "int_maps"), int_maps)

    if cfg.compute_stats:
        with timer.stage("Computing and writing the stats"):
            _write_stats_tables(cfg.outdir, *compute_stats(int_maps))

    with timer.stage("Generating personalized genomes (compile)"):
        from .compiler.haplotype import (
            AltPool, attach_pool, cohort_should_pool,
        )
        from .compiler.proband import compile_proband

        compile_cache: dict = {}
        alt_pool = AltPool() if cohort_should_pool(int_maps) else None
        proband_programs = [
            compile_proband(m, ref_seqs, blob, qc, compile_cache, alt_pool)
            for m in int_maps
        ]
        flat = []
        for pp in proband_programs:
            flat.append(pp.hap1)
            flat.append(pp.hap2)
        if alt_pool is not None:
            attach_pool(flat, alt_pool)
    return ref_seqs, blob, [pp.proband for pp in proband_programs], flat


def _resolve(cfg) -> Engine:
    if cfg.engine is not Engine.AUTO:
        return cfg.engine
    # a neoantigen-only run returns just top-k rows to the host, as in the
    # reference (vcf2prot_tpu/pipeline.py:323-335)
    return resolve_auto(
        workload="neoantigen_device"
        if (cfg.neoantigen_k and cfg.neoantigen_only) else "fasta",
        verbose=cfg.verbose,
    )


def run_pipeline(cfg: PipelineConfig) -> PipelineResult:
    engine = _resolve(cfg)
    neo_k = cfg.neoantigen_k
    timer = StageTimer(cfg.verbose)
    qc = cfg.qc if cfg.qc is not None else default_qc()
    result = PipelineResult()
    ref_seqs, blob, proband_names, flat = _compile(cfg, qc, timer)
    if qc.debug_cpu_exec:
        _validate_host_programs(flat)
    neo_params = None
    if neo_k and cfg.neoantigen_params:
        from .downstream.scoring import load_params

        neo_params = load_params(cfg.neoantigen_params, neo_k)

    if neo_k and cfg.neoantigen_only and engine is Engine.GPU:
        # execute, mask, score and rank on the card; only [samples, top]
        # rows come back
        from .downstream.device_resident import (
            write_device_neoantigen_reports,
        )

        with timer.stage("Neoantigen scoring (device-resident)"):
            with torch_trace(cfg.profile_dir or None):
                write_device_neoantigen_reports(
                    cfg.outdir, proband_names, flat, blob, neo_k,
                    params=neo_params, top=cfg.neoantigen_top,
                    chunk_res_bytes=(
                        cfg.chunk_res_bytes
                        if cfg.chunk_res_bytes is not None
                        else DEFAULT_NEO_CHUNK_RES_BYTES
                    ),
                    device=cfg.device, mesh=device_mesh(cfg.device),
                )
        for p in flat:
            result.n_haplotype_seqs += len(p.annotations)
            result.total_output_bytes += p.res_len
        result.n_samples = len(proband_names)
        result.durations = dict(timer.durations)
        return result

    neo_acc = None
    if neo_k and cfg.neoantigen_device:
        from .downstream.cohort import CohortCandidates

        neo_acc = CohortCandidates(neo_k)

    def finish_sample(i, h1, h2):
        hap1, hap2 = flat[2 * i], flat[2 * i + 1]
        if not cfg.neoantigen_only:
            PersonalizedProteome(
                proband_names[i], h1, hap1.annotations, h2, hap2.annotations,
            ).write(
                cfg.outdir,
                write_all=cfg.write_all,
                write_compressed=cfg.write_compressed,
                ref_seqs=ref_seqs,
            )
        if neo_acc is not None:
            neo_acc.add(i, 1, hap1, h1)
            neo_acc.add(i, 2, hap2, h2)
        elif neo_k:
            from .downstream.report import write_neoantigen_report

            write_neoantigen_report(
                cfg.outdir, proband_names[i], (hap1, hap2), (h1, h2), neo_k,
                params=neo_params, top=cfg.neoantigen_top,
            )
        return len(hap1.annotations) + len(hap2.annotations), h1.size + h2.size

    def account(stats):
        for n_seqs, n_bytes in stats:
            result.n_haplotype_seqs += n_seqs
            result.total_output_bytes += n_bytes

    chunk_bytes = (
        cfg.chunk_res_bytes
        if cfg.chunk_res_bytes is not None
        else DEFAULT_CHUNK_RES_BYTES
    )
    with timer.stage("Generating and writing personalized genomes"):
        with torch_trace(cfg.profile_dir or None):
            if engine is Engine.GPU:
                for chunk, outs in _device_chunk_results(
                    flat, blob, chunk_bytes, qc.debug_device_exec, cfg.device,
                    pair_aligned=True,
                ):
                    account(
                        finish_sample(chunk[j] // 2, outs[j], outs[j + 1])
                        for j in range(0, len(chunk), 2)
                    )
            else:
                # host path: fused execute + write per sample, streamed
                # through a thread pool -- tapes never accumulate
                run = (cpu_engine.execute_tasks_fast if engine is Engine.MT
                       else cpu_engine.execute_tasks)

                def one_sample(i):
                    return finish_sample(
                        i, run(flat[2 * i], blob), run(flat[2 * i + 1], blob)
                    )

                indices = range(len(proband_names))
                if engine is Engine.MT and not cfg.single_thread_writes:
                    with ThreadPoolExecutor(
                        max_workers=cfg.num_threads or os.cpu_count()
                    ) as pool:
                        account(pool.map(one_sample, indices))
                else:
                    account(map(one_sample, indices))

    if neo_acc is not None:
        from .downstream.cohort import write_reports_from_candidates

        if engine is Engine.GPU:
            device = cfg.device
        else:
            import torch

            device = "cuda" if torch.cuda.is_available() else "cpu"
        with timer.stage("Scoring neoantigen candidates (device batch)"):
            write_reports_from_candidates(
                cfg.outdir, proband_names, flat, neo_acc.arrays(), neo_k,
                params=neo_params, top=cfg.neoantigen_top, device=device,
            )

    result.n_samples = len(proband_names)
    result.durations = dict(timer.durations)
    return result
