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


# K5's bytes and one training step's bound at 4,096 rows, as PERF.md
# records them (K5 with the step's jobs, which took K9's per-step work: the
# next batch, the zeroed gradient and the casts, now written from the
# updated parameters, so the hidden weights' fp32 reads left the step: 0.0392
# ms at 512x3 with K9 in the step, 0.0028 and 0.0374 before K9)
STEP_BOUNDS = {
    "128x1": (37_793, 1_058_204, 0.0003, (0.0029, "bytes"),
              {"K8": (198_528, 1_548_288, 0),
               "K3": (1_167_104, 4_718_592, 0), "K7": (0, 0, 0),
               "K7's gradients": (0, 0, 0),
               "products": (1_065_472, 1_048_576, 0),
               "products' gradients": (3_163_136, 2_097_152, 0),
               "K4": (2_264_064, 4_718_592, 0),
               "K8's gradient": (548_736, 3_096_704, 0),
               "K5": (1_348_640, 529_102, 0)}),
    # K7's products on the tensor cores: bytes bound the step, where the
    # same products at the fp32 peak gave 0.1932 ms
    "512x3": (674_465, 18_885_020, 0.0056, (0.0386, "bytes"), None),
}


@pytest.mark.parametrize("head", STEP_BOUNDS)
def test_adam_and_training_step_bounds(head):
    n_params, adam, adam_ms, step, parts = STEP_BOUNDS[head]
    hidden, depth = HEADS[head]
    params = init_params(9, hidden=hidden, depth=depth, seed=0)
    assert sum(v.size for v in params.values()) == n_params
    assert roofline.adam_bytes(n_params) == adam == 28 * n_params
    bound, by = roofline.bound_ms(adam, roofline.adam_ops(n_params))
    assert (round(bound, 4), by) == (adam_ms, "bytes")
    costs = roofline.train_step_costs(params, 4096)
    assert list(costs) == ["K8", "K3", "K7", "K7's gradients",
                           "products", "products' gradients", "K4",
                           "K8's gradient", "K5"]
    if parts is not None:
        assert costs == parts
    step5 = roofline.adam_step_bytes(params, 4096)
    assert costs["K5"] == (step5, roofline.adam_ops(n_params), 0)
    # K5's jobs move K9's bytes but the hidden weights' fp32 reads
    n_hidden = sum(params[f"w{i}"].size for i in range(2, depth + 1))
    assert step5 == adam + roofline.step_prologue_bytes(
        params, 4096) - 4 * n_hidden
    bound, by = roofline.train_step_bound_ms(params, 4096)
    assert (round(bound, 4), by) == step
    assert bound == roofline.bound_ms(
        sum(b for b, _, _ in costs.values()),
        sum(o for _, o, _ in costs.values()),
        sum(t for _, _, t in costs.values()))[0]
    # the hidden layers' products: 2 rows n_in n_out on the tensor cores,
    # three times a layer (forward, input and weight gradients)
    hidden = [params[f"w{i}"].shape for i in range(2, depth + 1)]
    assert costs["K7"][2] + costs["K7's gradients"][2] == sum(
        3 * 2 * 4096 * a * b for a, b in hidden)


@pytest.mark.parametrize("rows,k,n", [(4096, 512, 512), (131_072, 512, 512),
                                      (300, 12, 20)])
def test_dense_counts(rows, k, n):
    """K7's bytes (bf16 operands and outputs, fp32 bias and gradients)
    and operations, and its bounds at the training and serving shapes as
    PERF.md records them."""
    x, w, y = rows * k * 2, k * n * 2, rows * n * 2
    assert roofline.dense_bytes(rows, k, n, "forward") == x + w + 4 * n + y
    assert roofline.dense_bytes(rows, k, n, "input") == w + 2 * y + x
    assert roofline.dense_bytes(rows, k, n, "weight") == (
        x + 2 * y + 8 * (k * n + n))
    for part in roofline.DENSE_PARTS:
        fp32, tensor = roofline.dense_ops(rows, k, n, part)
        assert tensor == 2 * rows * k * n
        assert roofline.dense_bound_ms(rows, k, n, part) == roofline.bound_ms(
            roofline.dense_bytes(rows, k, n, part), fp32, tensor)
    want = {(4096, 512, 512): (0.0027, 0.0039, 0.0044),
            (131_072, 512, 512): (0.0803, 0.1204, 0.1208)}.get((rows, k, n))
    if want is not None:
        assert tuple(round(roofline.dense_bound_ms(rows, k, n, part)[0], 4)
                     for part in roofline.DENSE_PARTS) == want
    # at a training batch the tensor cores would take 0.0022 ms
    assert roofline.bound_ms(0, 0, 2 * 4096 * 512 * 512)[0] == pytest.approx(
        2 * 4096 * 512 * 512 / 989.4e12 * 1e3)


@pytest.mark.parametrize("k,e_dim,h_dim", [(9, 32, 128), (9, 32, 512),
                                           (3121, 4, 8)])
def test_fold_counts(k, e_dim, h_dim):
    """K8's bytes (fp32 embed, w1 and gradients, the bf16 table) and
    operations, counted element by element, and its bounds at the 128x1
    and 512x3 heads as PERF.md records them."""
    embed, w1, b1 = 21 * e_dim, k * e_dim * h_dim, h_dim
    table = k * 21 * h_dim
    assert roofline.fold_bytes(k, e_dim, h_dim, "forward") == (
        4 * (embed + w1) + 2 * table)
    assert roofline.fold_bytes(k, e_dim, h_dim, "backward") == (
        4 * (table + h_dim) + 4 * (embed + w1) + 8 * (embed + w1 + b1))
    assert roofline.fold_ops(k, e_dim, h_dim, "forward") == 2 * table * e_dim
    assert roofline.fold_ops(k, e_dim, h_dim, "backward") == (
        4 * table * e_dim + h_dim)
    for part in roofline.FOLD_PARTS:
        assert roofline.fold_bound_ms(k, e_dim, h_dim, part) == (
            roofline.bound_ms(roofline.fold_bytes(k, e_dim, h_dim, part),
                              roofline.fold_ops(k, e_dim, h_dim, part)))
    want = {(9, 32, 128): ((0.00006, "bytes"), (0.00016, "bytes")),
            (9, 32, 512): ((0.00023, "bytes"), (0.00065, "bytes"))}.get(
                (k, e_dim, h_dim))
    if want is not None:
        assert tuple((round(ms, 5), by) for ms, by in (
            roofline.fold_bound_ms(k, e_dim, h_dim, part)
            for part in roofline.FOLD_PARTS)) == want


def test_tensor_operations_use_the_bf16_peak():
    assert roofline.bound_ms(0, 0, 989.4e9) == (1.0, "operations")
    assert roofline.bound_ms(0, 67e9, 989.4e9) == (1.0, "operations")
    assert roofline.bound_ms(3.35e9, 67e9, 2 * 989.4e9) == (2.0,
                                                            "operations")
    assert roofline.bound_ms(6.7e9, 67e9, 989.4e9) == (2.0, "bytes")


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


@pytest.mark.parametrize("head", ["128x1", "512x3"])
def test_cohort_score_costs(head):
    """The cohort batch's scoring (``cohort.score_cohort``): the windows
    read and the scores written once, the folded bf16 table and the later
    layers read once; K3's adds and the output product in fp32, the hidden
    layers' products on the tensor cores."""
    hidden, depth = HEADS[head]
    params = init_params(9, hidden=hidden, depth=depth, seed=0)
    m = 1000
    later = sum(params[f"{p}{i}"].size for i in range(2, depth + 2)
                for p in "wb")
    n_bytes, fp32, tensor = roofline.cohort_score_costs(m, params)
    assert n_bytes == m * (9 + 4) + 9 * 21 * hidden * 2 + hidden * 4 + (
        4 * later)
    assert fp32 == m * 9 * hidden + 2 * m * hidden
    assert tensor == 2 * m * hidden * hidden * (depth - 1)
