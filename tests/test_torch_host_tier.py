"""The port's own host tier (vcf2prot_tpu_torch's copies of the JAX
package's numpy and Python modules) against the JAX package's: each case
runs the same calls on the same seeded inputs once through each package,
and the results must be equal. Tolerance: exact (bytes, arrays and
floats compared for equality)."""
import importlib
import os

import numpy as np
import pytest

from genvcf import random_cohort, write_fasta, write_synthetic_vcf

JAX_PKG, PORT_PKG = "vcf2prot_tpu", "vcf2prot_tpu_torch"


NATIVE_SO = "native/build/vcf2prot_native.so"


def retry_reference_native(monkeypatch):
    """The JAX package's native module, loaded again if this process lost
    it. Its bridge builds ``native/build/vcf2prot_native.so`` in place,
    with no lock, and remembers a failed load for the life of the process
    (``_NATIVE_TRIED``): a worker that imported it while another worker's
    linker was still writing the file keeps None. By the time a case runs,
    collection's racing builds are over, so the cached failure is cleared
    (through ``monkeypatch``, restored after) and the module loaded once
    more; if it is still absent, the case fails, naming the file."""
    from vcf2prot_tpu import native_bridge as jax_bridge

    if jax_bridge.load_native() is None:
        monkeypatch.setattr(jax_bridge, "_NATIVE_TRIED", False)
        monkeypatch.setattr(jax_bridge, "_NATIVE", None)
        if jax_bridge.load_native() is None:
            pytest.fail(f"the JAX package's native module ({NATIVE_SO}) "
                        "did not load: its native cases cannot be compared")


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    with pytest.MonkeyPatch.context() as mp:
        retry_reference_native(mp)
        yield


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_tier")
    ref, samples = random_cohort(seed=11, n_samples=6, n_transcripts=10)
    vcf, fasta = str(root / "cohort.vcf"), str(root / "ref.fasta")
    write_synthetic_vcf(vcf, ref, samples)
    write_fasta(fasta, ref)
    return vcf, fasta


def canon(x):
    """A comparable form of a result: arrays by dtype, shape and bytes,
    programs and packs by their fields, containers element-wise."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (np.generic,)):
        return canon(np.asarray(x))
    if isinstance(x, dict):
        return ("dict", [(k, canon(v)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [canon(v) for v in x])
    if hasattr(x, "exe") and hasattr(x, "annotations"):  # HaplotypeProgram
        alt = x.alt.encode("ascii") if isinstance(x.alt, str) else bytes(x.alt)
        return ("prog", [canon(np.asarray(getattr(x, f)))
                         for f in ("exe", "src", "length", "dst")],
                alt, int(x.res_len), bool(x.pooled),
                [tuple(a) for a in x.annotations])
    if hasattr(x, "src_biased") and hasattr(x, "spans"):  # PackedCohort
        return ("pack", canon(x.src_biased), canon(x.dst), canon(x.alt),
                x.total_res, canon(x.spans), x.contiguous,
                x.alt_key is not None)
    if isinstance(x, float) and x != x:
        return "nan"
    if hasattr(x, "__dict__") and not callable(x):
        return (type(x).__name__, canon(vars(x)))
    return x


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def ref_and_blob(pkg, fasta):
    seqs = mod(pkg, "frontend.fasta").read_fasta(fasta)
    return seqs, mod(pkg, "compiler.haplotype").RefBlob.from_ref_seqs(seqs)


def native_compile(pkg, vcf, fasta, **kw):
    seqs, blob = ref_and_blob(pkg, fasta)
    qc = mod(pkg, "compiler.qc").QcConfig()
    return blob, mod(pkg, "native_bridge").compile_cohort_native(
        vcf, seqs, blob, qc, **kw)


def python_compile(pkg, vcf, fasta):
    """The pipeline's Python compile path (``use_native=False``)."""
    seqs, blob = ref_and_blob(pkg, fasta)
    hap = mod(pkg, "compiler.haplotype")
    int_maps = mod(pkg, "pipeline").parse_vcf_to_int_maps(vcf)
    pool = hap.AltPool() if hap.cohort_should_pool(int_maps) else None
    cache = {}
    pps = [mod(pkg, "compiler.proband").compile_proband(
        m, seqs, blob, mod(pkg, "compiler.qc").QcConfig(), cache, pool)
        for m in int_maps]
    flat = [p for pp in pps for p in (pp.hap1, pp.hap2)]
    if pool is not None:
        hap.attach_pool(flat, pool)
    return blob, [pp.proband for pp in pps], flat


def case_read_fasta(pkg, vcf, fasta, tmp):
    return mod(pkg, "frontend.fasta").read_fasta(fasta)


def case_compile_native(pkg, vcf, fasta, tmp):
    _blob, out = native_compile(pkg, vcf, fasta, collect_stats=True,
                                alt_pool="auto")
    return out


def case_compile_native_subset(pkg, vcf, fasta, tmp):
    return native_compile(pkg, vcf, fasta, alt_pool=False,
                          sample_subset=[1, 4])[1]


def case_compile_python(pkg, vcf, fasta, tmp):
    return python_compile(pkg, vcf, fasta)[1:]


def case_pack_cohort(pkg, vcf, fasta, tmp):
    pack = mod(pkg, "runtime.pack")
    blob, _n, flat = python_compile(pkg, vcf, fasta)
    nblob, (_p, nflat, _w) = native_compile(pkg, vcf, fasta,
                                            alt_pool="auto")
    return (pack.pack_cohort(flat, blob), pack.pack_cohort(nflat[:5], nblob),
            [pack.program_is_contiguous(p) for p in flat],
            [pack.pad_to_bucket(n) for n in (0, 1, 5, 1024, 1025)])


def case_host_engines(pkg, vcf, fasta, tmp):
    cpu = mod(pkg, "runtime.cpu_engine")
    blob, (_p, flat, _w) = native_compile(pkg, vcf, fasta, alt_pool="auto")
    return ([cpu.execute_tasks(p, blob) for p in flat],
            [cpu.execute_tasks_fast(p, blob) for p in flat])


def case_intmap_roundtrip(pkg, vcf, fasta, tmp):
    pipeline = mod(pkg, "pipeline")
    writers, ckpt = mod(pkg, "io.writers"), mod(pkg, "io.checkpoint")
    int_maps = pipeline.parse_vcf_to_int_maps(vcf)
    first, second = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    writers.write_intmap2json(first, int_maps)
    writers.write_intmap2json(second, ckpt.read_intmap_json(first))
    files = []
    for d in (first, second):
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as fh:
                files.append((name, fh.read()))
    return files


def case_compute_stats(pkg, vcf, fasta, tmp):
    int_maps = mod(pkg, "pipeline").parse_vcf_to_int_maps(vcf)
    return mod(pkg, "stats.summary").compute_stats(int_maps)


def case_params(pkg, vcf, fasta, tmp):
    scoring = mod(pkg, "downstream.scoring")
    save = mod(pkg, "downstream.train").save_params
    out = []
    for k, hidden, depth, seed in ((9, 128, 1, 0), (8, [64, 32], 1, 3),
                                   (10, 16, 3, 5)):
        params = scoring.init_params(k, embed_dim=8, hidden=hidden,
                                     depth=depth, seed=seed)
        path = os.path.join(tmp, f"head_{k}.npz")
        save(path, params)
        out.append((params, scoring.load_params(path, k),
                    scoring.layer_names(params)))
    return out


def case_synth_mhc(pkg, vcf, fasta, tmp):
    synth = mod(pkg, "downstream.synth_mhc")
    windows, labels, truth = synth.make_task(n=3000, seed=4)
    return windows, labels, truth, synth.oracle_auc(truth, labels)


def case_partitions(pkg, vcf, fasta, tmp):
    _blob, (_p, flat, _w) = native_compile(pkg, vcf, fasta)
    return ([mod(pkg, "parallel.sharded").partition_programs(flat, n)
             for n in (1, 3, 4)],
            [mod(pkg, "parallel.sharded_neoantigen").partition_pairs(flat, n)
             for n in (1, 2, 4)],
            mod(pkg, "parallel.multihost").count_samples(vcf))


def case_chunk_indices(pkg, vcf, fasta, tmp):
    _blob, (_p, flat, _w) = native_compile(pkg, vcf, fasta)
    chunk = mod(pkg, "pipeline")._chunk_indices
    return [chunk(flat, size, aligned) for size in (1, 3000, 1 << 30)
            for aligned in (False, True)]


def case_candidates_and_report(pkg, vcf, fasta, tmp):
    """Candidate masks and collection, and the per-sample host report."""
    pep, cohort = mod(pkg, "downstream.peptides"), mod(pkg, "downstream.cohort")
    report = mod(pkg, "downstream.report")
    blob, (names, flat, _w) = native_compile(pkg, vcf, fasta)
    tapes = [mod(pkg, "runtime.cpu_engine").execute_tasks(p, blob)
             for p in flat]
    masks = [(pep.valid_window_starts(p.annotations, p.res_len, 9),
              pep.alt_byte_mask(p, p.res_len)) for p in flat]
    os.makedirs(os.path.join(tmp, "rep"))
    for i, name in enumerate(names):
        report.write_neoantigen_report(os.path.join(tmp, "rep"), name,
                                       flat[2 * i:2 * i + 2],
                                       tapes[2 * i:2 * i + 2], 9, top=40)
    reports = []
    for name in sorted(os.listdir(os.path.join(tmp, "rep"))):
        with open(os.path.join(tmp, "rep", name), "rb") as fh:
            reports.append((name, fh.read()))
    return (pep._alphabet_lut(), masks,
            cohort.collect_candidates(flat, tapes, 9), reports)


def case_chain_helpers(pkg, vcf, fasta, tmp):
    """The chain's host helpers: row packing and decoding, chunk
    annotation spans, the scoring block size."""
    dr = mod(pkg, "downstream.device_resident")
    scoring = mod(pkg, "downstream.scoring")
    blob, (_p, flat, _w) = native_compile(pkg, vcf, fasta)
    packed = mod(pkg, "runtime.pack").pack_cohort(flat[:4], blob)
    rng = np.random.default_rng(2)
    buf = rng.integers(0, 256, size=(3, 5, 8 + 9), dtype=np.uint8)
    buf[1, 2, :4] = np.frombuffer(np.float32(-np.inf).tobytes(), np.uint8)
    vals, gpos, wins = dr._unpack_rows(buf)
    gpos = np.abs(gpos) % 500
    return (dr._chunk_annotation_spans(flat[:4], packed.spans),
            (vals, gpos, wins),
            [dr._decode_rows(vals[i], gpos[i], wins[i], 7, 250)
             for i in range(3)],
            [dr.dense_blk(b, scoring.init_params(9, hidden=h))
             for b in (1 << 10, 1 << 22) for h in (64, 512)])


def case_train_helpers(pkg, vcf, fasta, tmp):
    train = mod(pkg, "downstream.train")
    rng = np.random.default_rng(6)
    scores = rng.standard_normal(500).astype(np.float32)
    labels = (rng.random(500) < 0.3).astype(np.float32)
    return ([train._bucket(n) for n in (0, 1, 256, 257, 5000)],
            train.auc(scores, labels), train.auc(scores, np.zeros(500)))


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_tier_matches_the_jax_package(name, cohort, tmp_path):
    vcf, fasta = cohort
    got = {}
    for pkg in (JAX_PKG, PORT_PKG):
        tmp = tmp_path / pkg
        tmp.mkdir()
        got[pkg] = canon(CASES[name](pkg, vcf, fasta, str(tmp)))
    assert got[PORT_PKG] == got[JAX_PKG]


def test_the_two_bridges_compile_the_same_programs(cohort):
    """The port's native bridge builds its own extension (its own path)
    and compiles the cohort into the JAX package's programs; both
    extensions are loaded in one process."""
    from vcf2prot_tpu import native_bridge as jax_bridge
    from vcf2prot_tpu_torch import native_bridge as port_bridge

    vcf, fasta = cohort
    port = native_compile(PORT_PKG, vcf, fasta, alt_pool=True)[1]
    ref = native_compile(JAX_PKG, vcf, fasta, alt_pool=True)[1]
    assert port_bridge.load_native() is not jax_bridge.load_native()
    assert port_bridge.library_path().startswith(port_bridge.BUILD_DIR)
    assert canon(port) == canon(ref)
    assert all(p.pooled for p in port[1])


def test_a_lost_native_build_is_loaded_again(cohort, tmp_path, monkeypatch):
    """The race of the JAX package's on-demand build, planted: its bridge
    holds a cached failure (``_NATIVE_TRIED`` set, ``_NATIVE`` None), as in
    a worker that lost the race at collection. The retry loads the module
    again, and a native case matches the port's."""
    from vcf2prot_tpu import native_bridge as jax_bridge

    monkeypatch.setattr(jax_bridge, "_NATIVE_TRIED", True)
    monkeypatch.setattr(jax_bridge, "_NATIVE", None)
    assert jax_bridge.load_native() is None
    retry_reference_native(monkeypatch)
    assert jax_bridge.load_native() is not None
    vcf, fasta = cohort
    got = {}
    for pkg in (JAX_PKG, PORT_PKG):
        got[pkg] = canon(case_compile_native(pkg, vcf, fasta,
                                             str(tmp_path)))
    assert got[JAX_PKG] is not None
    assert got[PORT_PKG] == got[JAX_PKG]
