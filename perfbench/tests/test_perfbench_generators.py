"""The benchmark's inputs repeat from a seed, and its frozen copies still
agree with the program's originals."""
import json
import os

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.kinds import fit
from perfbench.lib.synth_mhc import make_task


def _config(name):
    with open(os.path.join(run.HERE, "configs", name + ".json")) as fh:
        return json.load(fh)


def test_task_repeats_from_a_seed():
    a = make_task(2000, 2 ** 31 + 17)
    b = make_task(2000, 2 ** 31 + 17)
    c = make_task(2000, 2 ** 31 + 18)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.uint8 and a[1].dtype == np.float32


def test_task_is_the_programs_task():
    from vcf2prot_tpu_torch.downstream.synth_mhc import make_task as theirs

    w, y = make_task(5000, 7)
    tw, ty, _truth = theirs(5000, 7)
    np.testing.assert_array_equal(w, tw)
    np.testing.assert_array_equal(y, ty)


@pytest.mark.parametrize("name", ["mhc_head_512x3", "mhc_head_128x1"])
def test_weights_repeat_and_have_the_heads_shapes(name):
    from vcf2prot_tpu_torch.downstream.scoring import init_params

    cfg = _config(name)
    a = fit.make_weights(cfg, 3_000_000_001, "cpu")
    b = fit.make_weights(cfg, 3_000_000_001, "cpu")
    c = fit.make_weights(cfg, 3_000_000_002, "cpu")
    ref = init_params(cfg["k"], cfg["embed_dim"], cfg["hidden"],
                      cfg["depth"])
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert sum(v.size for v in a.values()) == cfg["parameters"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == np.float32
    assert not np.array_equal(a["w1"], c["w1"])


def test_seed_streams_take_large_seeds():
    s = fit.streams(2 ** 31 + 5)
    assert len(set(s)) == 3 and all(0 <= x < 2 ** 63 for x in s)
    assert s == fit.streams(2 ** 31 + 5) != fit.streams(2 ** 31 + 6)
    g = torch.Generator()
    g.manual_seed(s[0])
