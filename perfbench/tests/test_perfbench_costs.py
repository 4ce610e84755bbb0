"""The yardstick's counts: the frozen copies of the program's per-kernel
counts still agree with the program's, and the whole step's least work
comes from the configuration's shapes alone."""
import json
import os

import pytest

from perfbench import run
from perfbench.lib import costs


def _config(name):
    with open(os.path.join(run.HERE, "configs", name + ".json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("part", ["forward", "input", "weight"])
def test_frozen_dense_counts_agree_with_the_program(part):
    from vcf2prot_tpu_torch.utils import roofline

    for shape in ((4096, 512, 512), (131072, 128, 512), (7, 24, 40)):
        assert costs.dense_bytes(*shape, part) == roofline.dense_bytes(
            *shape, part)
        assert costs.dense_ops(*shape, part) == roofline.dense_ops(
            *shape, part)


def test_frozen_scorer_grad_counts_agree_with_the_program():
    from vcf2prot_tpu_torch.utils import roofline

    for m, k, h in ((4096, 9, 128), (4096, 9, 512), (33, 11, 40)):
        assert costs.scorer_grad_bytes(m, k, h, 8, m * k) == \
            roofline.scorer_grad_bytes(m, k, h, 8, m * k)
        assert costs.scorer_ops(m, k, h) == roofline.scorer_ops(m, k, h)
    assert costs.PEAK_BF16_FLOPS == roofline.PEAK_BF16_FLOPS
    assert costs.PEAK_HBM_BPS == roofline.PEAK_HBM_BPS
    assert costs.PEAK_FP32_FLOPS == roofline.PEAK_FP32_FLOPS


def test_step_costs_by_hand():
    cfg = _config("mhc_head_512x3")
    n_bytes, fp32, bf16 = costs.step_costs(cfg, 4096)
    assert n_bytes == 4096 * 17 + 24 * 674465
    assert bf16 == 2 * 6 * 4096 * 512 * 512
    fold = 2 * 9 * 21 * 32 * 512
    assert fp32 == (3 * fold + 2 * 4096 * 9 * 512 + 14 * 674465
                    + 3 * 3 * 4096 * 512 + 6 * 4096 * 512)
    # operations bound at 512x3, bytes at 128x1
    assert costs.step_least_ms(cfg, 4096) == pytest.approx(
        bf16 / costs.PEAK_BF16_FLOPS * 1e3)
    small = _config("mhc_head_128x1")
    assert costs.step_least_ms(small, 4096) == pytest.approx(
        (4096 * 17 + 24 * 37793) / costs.PEAK_HBM_BPS * 1e3)


def test_no_activation_between_layers_is_counted():
    wide = dict(_config("mhc_head_512x3"))
    a = costs.step_costs(wide, 4096)[0]
    b = costs.step_costs(wide, 8192)[0]
    # doubling the rows adds only the batch's own bytes
    assert b - a == 4096 * 17
