"""The port's task-stream validator (vcf2prot_tpu_torch/runtime/kernels.py)
against the JAX Pallas validator in interpret mode: equal counts on the
cases of tests/test_kernels.py, on corruptions where the CUDA kernel's
groups of 4 tasks take the next dst from another lane, and on seeded
corruptions that straddle the Pallas kernel's 2048-task blocks (whose
cross-block pairs the JAX wrapper counts on the host). Inputs stay in int32
range, where the JAX wrapper's int32 arithmetic is exact. Tolerance: equal
counts."""
import numpy as np
import pytest
import torch

from genvcf import random_cohort
from vcf2prot_tpu.compiler.haplotype import RefBlob, compile_haplotype
from vcf2prot_tpu.compiler.qc import QcConfig
from vcf2prot_tpu.frontend.maps import group_muts_per_transcript
from vcf2prot_tpu.runtime import kernels as jax_kernels
from vcf2prot_tpu.runtime.pack import pack_cohort
from vcf2prot_tpu_torch.runtime.kernels import (
    validate_on_device,
    validate_reference,
)


def packed_cohort(seed=2):
    ref, samples = random_cohort(seed, 4, 8)
    blob = RefBlob.from_ref_seqs(ref)
    programs = []
    for _n, (h1, h2) in samples.items():
        for csqs in (h1, h2):
            programs.append(
                compile_haplotype(
                    group_muts_per_transcript(csqs), ref, blob, qc=QcConfig()
                )
            )
    return blob, pack_cohort(programs, blob)


def both_counts(dst, length, srcb, combined_len, res_len):
    """(port twin, port wrapper on CPU tensors, JAX Pallas in interpret)."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (dst, length, srcb)]
    twin = validate_reference(*t, combined_len, res_len)
    wrapped = validate_on_device(*t, combined_len, res_len)
    ref = jax_kernels.validate_on_device(
        dst, length, srcb, combined_len=combined_len, res_len=res_len,
        interpret=True,
    )
    return twin, wrapped, ref


def _cohort_case(name):
    blob, packed = packed_cohort()
    lengths = np.diff(np.append(packed.dst, packed.total_res)).astype(np.int32)
    dst, srcb = packed.dst.copy(), packed.src_biased.copy()
    combined_len = len(blob.data) + len(packed.alt)
    if name == "corrupted_dst":
        dst[len(dst) // 2] += 3  # break contiguity
    elif name == "out_of_bounds_source":
        srcb[0] = combined_len + 100
    elif name == "dst_past_result":
        dst[-1] = packed.total_res + 5
    elif name.startswith("dst_plus_3_at_"):
        # where K2's groups of 4 tasks take the next dst from the next lane
        # (3, 4), from the next set of 32 groups (127, 128), and the last
        i = name.rsplit("_", 1)[1]
        dst[len(dst) - 1 if i == "last" else int(i)] += 3
    return dst, lengths, srcb, combined_len, packed.total_res


@pytest.mark.parametrize(
    "name",
    ["valid", "corrupted_dst", "out_of_bounds_source", "dst_past_result"]
    + [f"dst_plus_3_at_{i}" for i in ("3", "4", "127", "128", "last")],
)
def test_counts_match_pallas_on_cohort(name):
    twin, wrapped, ref = both_counts(*_cohort_case(name))
    assert twin == wrapped == ref
    assert (twin == 0) == (name == "valid")


def synthetic_stream(rng, n, combined_len=50_000):
    """A valid task stream of ``n`` tasks (lengths 0..40, sources in
    bounds)."""
    length = rng.integers(0, 41, size=n).astype(np.int32)
    dst = (np.cumsum(length) - length).astype(np.int32)
    srcb = rng.integers(0, combined_len - 40, size=n).astype(np.int32)
    return dst, length, srcb, combined_len, int(length.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counts_match_pallas_across_block_boundaries(seed):
    rng = np.random.default_rng(seed)
    n = 5000 + seed * 700  # three blocks of 2048 lanes in the Pallas kernel
    dst, length, srcb, combined_len, res_len = synthetic_stream(rng, n)
    assert both_counts(dst, length, srcb, combined_len, res_len) == (0, 0, 0)
    for trial in range(6):
        d, ln, s = dst.copy(), length.copy(), srcb.copy()
        # breaks on both sides of every block boundary, plus random rows
        for i in (2047, 2048, 4095, 4096):
            if rng.random() < 0.6:
                d[i] += int(rng.integers(1, 9))
        for i in rng.integers(0, n, size=int(rng.integers(1, 8))):
            kind = int(rng.integers(3))
            if kind == 0:
                d[i] += int(rng.integers(-20, 20))
            elif kind == 1:
                s[i] = int(rng.integers(-100, combined_len + 100))
            else:
                ln[i] += int(rng.integers(-5, 50))
        twin, wrapped, ref = both_counts(d, ln, s, combined_len, res_len)
        assert twin == wrapped == ref, f"trial {trial}"


def _shifted(t, elements):
    """``t`` copied into a view ``elements`` elements past its buffer's
    start."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype)
    view = buf[elements:]
    view.copy_(t)
    return view


@pytest.mark.parametrize("layout", [(0, 0, 0), (1, 1, 1), (1, 2, 3)],
                         ids=["aligned", "offset_1", "mixed"])
def test_int64_inputs_count_the_same(layout):
    """int64 arrays count as int32 ones, and so do arrays that start past
    their buffers' starts, at one offset or at three (on the card: a scalar
    head, or every task scalar)."""
    dst, length, srcb, combined_len, res_len = _cohort_case("corrupted_dst")
    t32 = [torch.from_numpy(a) for a in (dst, length, srcb)]
    t64 = [t.long() for t in t32]
    want = validate_on_device(*t32, combined_len, res_len)
    assert want > 0
    for arrays in (t32, t64):
        views = [_shifted(a, k) if k else a for a, k in zip(arrays, layout)]
        assert validate_on_device(*views, combined_len, res_len) == want


def test_empty_stream_is_valid():
    e = torch.empty(0, dtype=torch.int32)
    assert validate_on_device(e, e, e, 10, 0) == 0


def test_validator_checks_its_arguments():
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        validate_on_device(a, a.long(), a, 10, 10)
    with pytest.raises(TypeError):
        validate_on_device(a.float(), a, a, 10, 10)
    with pytest.raises(ValueError):
        validate_on_device(a, a[:3], a, 10, 10)
    with pytest.raises(ValueError):
        validate_on_device(a.view(2, 2), a.view(2, 2), a.view(2, 2), 10, 10)


def test_kernel_ab_without_sources_prints_its_usage(capsys):
    """The K1/K2 A/B script exits 2 with its usage, and builds nothing,
    when it is given no kernel and sources to compare."""
    from vcf2prot_tpu_torch.utils import kernel_ab

    assert kernel_ab.main([]) == 2
    # K4's A/B is utils/k4_ab.py: this script takes no k4
    assert kernel_ab.main(["k4", "a.vcf", "a.fa", "a.cu"]) == 2
    err = capsys.readouterr().err
    assert "v2p_segmented_copy_i32" in err and "v2p_validate_i32" in err
