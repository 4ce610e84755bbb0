"""End-to-end pipeline of the port.

The host engines (``st``/``mt``) are ``vcf2prot_tpu.pipeline.run_pipeline``
itself, whose host branches import no JAX. The GPU engine runs the same host
prologue (parse + compile, stats, int-map dumps) and then streams
pair-aligned chunks through :class:`GpuEngine`: one chunk is dispatched to
the device while the previous one is collected and its samples written, so
host memory stays bounded by the chunk size.

Not ported yet: the ``--neoantigen_*`` outputs (refused on every engine) and
the multi-device branch of the JAX pipeline.
"""
from __future__ import annotations

import os
import sys
from collections import deque
from dataclasses import dataclass, fields

from vcf2prot_tpu import pipeline as _ref
from vcf2prot_tpu.compiler.haplotype import RefBlob
from vcf2prot_tpu.compiler.qc import default_qc
from vcf2prot_tpu.frontend import fasta
from vcf2prot_tpu.io.writers import PersonalizedProteome, write_intmap2json
from vcf2prot_tpu.pipeline import (
    DEFAULT_CHUNK_RES_BYTES,
    PipelineResult,
    _chunk_indices,
    _validate_host_programs,
    _write_stats_tables,
    parse_vcf_to_int_maps,
)
from vcf2prot_tpu.runtime.engine import Engine as _RefEngine
from vcf2prot_tpu.stats.summary import compute_stats
from vcf2prot_tpu.utils.timers import StageTimer

from .runtime.engine import Engine, resolve_auto
from .utils.timers import torch_trace

__all__ = [
    "DEFAULT_CHUNK_RES_BYTES", "PipelineConfig", "PipelineResult",
    "execute_programs", "run_pipeline",
]


@dataclass
class PipelineConfig(_ref.PipelineConfig):
    engine: Engine = Engine.GPU
    # torch device of the GPU engine; the CLI keeps the default, the CPU
    # tests set "cpu" to run the kernels' plain twins
    device: str = "cuda"


def _refuse_unported(cfg) -> None:
    if (cfg.neoantigen_k or cfg.neoantigen_device or cfg.neoantigen_only
            or cfg.neoantigen_params):
        raise NotImplementedError(
            "the --neoantigen_* outputs are not yet ported to "
            "vcf2prot_tpu_torch (run them with python -m vcf2prot_tpu)"
        )


def _host_config(cfg, engine: Engine):
    """The JAX package's config for a host-engine run of ``cfg``; its
    profiler hook is left off (it would import JAX), the caller traces."""
    kw = {f.name: getattr(cfg, f.name) for f in fields(_ref.PipelineConfig)}
    kw.update(engine=_RefEngine(engine.value), profile_dir="")
    return _ref.PipelineConfig(**kw)


def execute_programs(programs, blob, engine: Engine,
                     chunk_res_bytes=DEFAULT_CHUNK_RES_BYTES,
                     validate_device=False, validate_host=False,
                     device="cuda"):
    """Execute haplotype programs with the selected engine; returns one uint8
    array per program."""
    if engine is Engine.AUTO:
        engine = resolve_auto()
    if engine is not Engine.GPU:
        return _ref.execute_programs(
            programs, blob, _RefEngine(engine.value), chunk_res_bytes,
            validate_device, validate_host,
        )
    if validate_host:
        _validate_host_programs(programs)
    outputs = [None] * len(programs)
    for chunk, outs in _device_chunk_results(
        programs, blob, chunk_res_bytes, validate_device, device
    ):
        for i, o in zip(chunk, outs):
            outputs[i] = o
    return outputs


def _device_chunk_results(programs, blob, chunk_res_bytes, validate_device,
                          device, pair_aligned=False):
    """Depth-2 chunk pipeline over :class:`GpuEngine`: the next chunk is
    dispatched before the previous one is collected; yields
    ``(chunk_indices, outputs)`` in order."""
    from .runtime.gpu_engine import GpuEngine

    dev = GpuEngine(blob, device=device, validate_on_device=validate_device)
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
    """Host prologue of ``vcf2prot_tpu.pipeline.run_pipeline``: read the
    proteome, parse + compile the cohort (native tier when it applies),
    write the stats and int-map dumps. Returns ``(ref_seqs, blob,
    proband_names, flat_programs)``."""
    with timer.stage("Loading the Reference file"):
        ref_seqs = fasta.read_fasta(cfg.fasta_path)
        blob = RefBlob.from_ref_seqs(ref_seqs)

    # int-map dumps need the Python intermediate maps; the DEBUG_TXP trace
    # lives in the Python compiler
    native_result = None
    if (cfg.use_native and not cfg.write_int_map and not cfg.resume_int_maps
            and not qc.debug_txp):
        from vcf2prot_tpu.native_bridge import compile_cohort_native

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
            from vcf2prot_tpu.stats.native_stats import stats_from_native

            with timer.stage("Computing and writing the stats"):
                _write_stats_tables(
                    cfg.outdir, *stats_from_native(probands, stats_blocks)
                )
        return ref_seqs, blob, probands, flat

    if cfg.resume_int_maps:
        from vcf2prot_tpu.io.checkpoint import read_intmap_json

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
        from vcf2prot_tpu.compiler.haplotype import (
            AltPool, attach_pool, cohort_should_pool,
        )
        from vcf2prot_tpu.compiler.proband import compile_proband

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


def run_pipeline(cfg: PipelineConfig) -> PipelineResult:
    _refuse_unported(cfg)
    engine = resolve_auto() if cfg.engine is Engine.AUTO else cfg.engine
    if engine is not Engine.GPU:
        with torch_trace(cfg.profile_dir or None):
            return _ref.run_pipeline(_host_config(cfg, engine))

    timer = StageTimer(cfg.verbose)
    qc = cfg.qc if cfg.qc is not None else default_qc()
    result = PipelineResult()
    ref_seqs, blob, proband_names, flat = _compile(cfg, qc, timer)
    if qc.debug_cpu_exec:
        _validate_host_programs(flat)

    chunk_bytes = (
        cfg.chunk_res_bytes
        if cfg.chunk_res_bytes is not None
        else DEFAULT_CHUNK_RES_BYTES
    )
    with timer.stage("Generating and writing personalized genomes"):
        with torch_trace(cfg.profile_dir or None):
            for chunk, outs in _device_chunk_results(
                flat, blob, chunk_bytes, qc.debug_device_exec, cfg.device,
                pair_aligned=True,
            ):
                for j in range(0, len(chunk), 2):
                    i = chunk[j] // 2
                    hap1, hap2 = flat[2 * i], flat[2 * i + 1]
                    h1, h2 = outs[j], outs[j + 1]
                    PersonalizedProteome(
                        proband_names[i], h1, hap1.annotations,
                        h2, hap2.annotations,
                    ).write(
                        cfg.outdir,
                        write_all=cfg.write_all,
                        write_compressed=cfg.write_compressed,
                        ref_seqs=ref_seqs,
                    )
                    result.n_haplotype_seqs += (
                        len(hap1.annotations) + len(hap2.annotations)
                    )
                    result.total_output_bytes += h1.size + h2.size

    result.n_samples = len(proband_names)
    result.durations = dict(timer.durations)
    return result
