"""The port's roofline (vcf2prot_tpu_torch/utils/roofline.py): the
reference's FLOP counts (vcf2prot_tpu/utils/roofline.py) on the same heads,
the H100 peaks, the bounds PERF.md records from their recorded sizes, the
byte counts against a brute-force count, and no bound arithmetic left in
chip_smoke.py or the A/B tools. Tolerance: exact, and 4 decimals of a ms
for the recorded bounds (as PERF.md prints them)."""
import ast
import os

import numpy as np
import pytest
import torch

from vcf2prot_tpu.utils import roofline as jax_roofline
from vcf2prot_tpu_torch.downstream.scoring import init_params
from vcf2prot_tpu_torch.utils import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS = {"8x1": (8, 1), "128x1": (128, 1), "256x2": (256, 2),
         "512x3": (512, 3)}


@pytest.mark.parametrize("k", (8, 9, 11))
@pytest.mark.parametrize("head", HEADS)
def test_flops_equal_the_references(head, k):
    hidden, depth = HEADS[head]
    params = init_params(k, hidden=hidden, depth=depth, seed=k)
    got = roofline.scoring_flops_per_window(params)
    assert got == jax_roofline.scoring_flops_per_window(params)
    assert (roofline.dense_pass_flops(524_288, params)
            == jax_roofline.dense_pass_flops(524_288, params))
    # the one-hot first layer: k * 21 inputs, not k * 32
    assert got > 2.0 * k * 21 * hidden


def test_peaks_are_the_h100_sxm5s(monkeypatch):
    assert roofline.PEAK_HBM_BPS == 3.35e12
    assert roofline.PEAK_FP32_FLOPS == 67e12
    assert roofline.PEAK_BF16_FLOPS == 989.4e12
    flops, nbytes, s = 1.2345e12, 6.789e11, 0.37
    assert roofline.mfu(flops, s) == flops / s / 989.4e12
    assert roofline.hbm_fraction(nbytes, s) == nbytes / s / 3.35e12
    assert roofline.mfu(989.4e12, 1.0) == roofline.hbm_fraction(
        3.35e12, 1.0) == 1.0
    # the environment does not move the yardstick
    monkeypatch.setenv("GPU_PEAK_HBM_BPS", "2e12")
    monkeypatch.setenv("GPU_PEAK_FP32_FLOPS", "5e13")
    assert roofline.hbm_fraction(3.35e12, 1.0) == 1.0
    assert roofline.bound_ms(0, 67e9) == (1.0, "operations")


@pytest.mark.parametrize("what,n_bytes,ms", [
    # K1 on the main cohort's first 256 MiB chunk: 268,295,943 tape bytes
    # from 6,035,439 int32 tasks
    ("K1", roofline.executor_bytes(268_295_943, 6_035_439), 0.1746),
    # K2 on the same tasks
    ("K2", roofline.validator_bytes(6_035_439), 0.0216),
])
def test_recorded_bounds(what, n_bytes, ms):
    assert n_bytes == {"K1": 584_875_398, "K2": 72_425_276}[what]
    bound, by = roofline.bound_ms(n_bytes)
    assert (round(bound, 4), by) == (ms, "bytes")
    assert roofline.executor_bytes(10, 3, 8) == 2 * 10 + 2 * 3 * 8


def test_bound_takes_the_larger_side():
    assert roofline.bound_ms(3.35e9) == (1.0, "bytes")
    assert roofline.bound_ms(3.35e9, 67e9) == (1.0, "bytes")
    assert roofline.bound_ms(3.35e9, 134e9) == (2.0, "operations")


@pytest.mark.parametrize("k", (1, 9, 30))
def test_covered_bytes_counts_each_byte_once(k):
    rng = np.random.default_rng(k)
    pos = rng.integers(0, 5_000, 700)
    brute = np.zeros(5_000 + k, bool)
    for p in pos:
        brute[p:p + k] = True
    for dt in (torch.int32, torch.int64):
        assert roofline.covered_bytes(torch.from_numpy(pos).to(dt), k) == \
            int(brute.sum())
    assert roofline.covered_bytes(torch.zeros(0, dtype=torch.int64), k) == 0


def test_scorer_counts():
    m, k, h, idx, cov = 4096, 9, 128, 8, 20_000
    table = (k * 21 + 1) * h
    assert roofline.scorer_bytes(m, h, idx, cov, table) == (
        m * h * 2 + m * idx + cov + table * 2 + h * 4)
    assert roofline.scorer_grad_bytes(m, k, h, idx, cov) == (
        2 * m * h * 2 + m * idx + cov + table * 4)
    assert roofline.scorer_ops(m, k, h) == m * k * h
    stages = roofline.chain_stage_bytes(1000, 40, 4, 6, 8, 300, 128, 900)
    assert stages == {
        "candidate mask": (2 * 1000 + 2 * 40 * 4 + 2 * 6 * 8, 0),
        "compaction (nonzero)": (1000 + 300 * 8, 0),
        "fp32 products, layers 2..N": (300 * 128 * 2 + 300 * 4,
                                       2 * 300 * 128),
        "rank: 2 stable sorts + select + pack": (300 * 12 + 900, 0),
    }


def defined_names(path):
    """Module-level function names and assigned names of a source."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.FunctionDef):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    return names


@pytest.mark.parametrize("path", [
    "chip_smoke.py", "vcf2prot_tpu_torch/utils/kernel_ab.py",
    "vcf2prot_tpu_torch/utils/k4_ab.py"])
def test_no_bound_arithmetic_of_its_own(path):
    names = defined_names(os.path.join(ROOT, path))
    assert not names & {"_bound", "_covered_bytes", "HBM_RATE", "FP32_RATE"}
    assert "roofline" in open(os.path.join(ROOT, path)).read()
