"""K3's launch plans (csrc/scorer.cu): the host code that picks the
persistent or the batch plan, compiled from the kernel's own source with
the host compiler (no CUDA), the entry that reports a launch's plan, the
count of batch-plan launches, and utils/kernel_ab.py's k3 mode without a
card."""
import os
import re
import shutil
import subprocess

import pytest

from vcf2prot_tpu_torch.downstream import scoring as sc
from vcf2prot_tpu_torch.downstream import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(ROOT, "vcf2prot_tpu_torch", "csrc", "scorer.cu")
# the H100's SMs
SMS = 132

MAIN = r"""
#include <cstdio>
#include <cstdlib>
int main(int argc, char** argv) {
  const int k = atoi(argv[1]);
  const long h = atol(argv[2]);
  const long m = atol(argv[3]);
  const int sms = atoi(argv[4]);
  const int per_sm = atoi(argv[5]);
  const Plan p = plan(k, h);
  const Choice c = choose(k, h, m, p, sms, per_sm);
  const Plan b = batch_plan(k, h, m, sms, p);
  printf("%d %d %d %ld %d %d %d %ld %ld %ld %d %ld %ld %d %d\n", p.hs,
         p.slices, p.tile, (long)p.smem, (int)p.stage, (int)c.kind, c.p.hs,
         (long)c.p.slices, (long)c.p.tile, (long)c.ctas, (int)c.p.stage,
         (long)c.p.smem, (long)plan_ctas(c.p, m), b.hs, b.tile);
  return 0;
}
"""


def host_source() -> str:
    """The plan's host code of scorer.cu: its constants, ``Plan`` and the
    functions from ``make_plan`` to ``choose``, with a ``main`` that prints
    a launch's plans."""
    text = open(CU).read()
    consts = text[text.index("constexpr int kVocab"):
                  text.index("// acc (+)=")]
    funcs = text[text.index("// A plan of column slices"):
                 text.index("// The kernel's opt-in")]
    return "#include <cstdint>\n#include <algorithm>\n" + consts + funcs + MAIN


@pytest.fixture(scope="module")
def planner(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    root = tmp_path_factory.mktemp("k3_plan")
    src, exe = root / "plan.cpp", root / "plan"
    src.write_text(host_source())
    subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)

    def run(k, h, m, per_sm):
        out = subprocess.run([str(exe), str(k), str(h), str(m), str(SMS),
                              str(per_sm)], check=True, capture_output=True,
                             text=True).stdout.split()
        v = [int(x) for x in out]
        return {"persistent": dict(hs=v[0], slices=v[1], tile=v[2],
                                   smem=v[3], stage=v[4]),
                "kind": v[5], "hs": v[6], "slices": v[7], "tile": v[8],
                "ctas": v[9], "stage": v[10], "smem": v[11],
                "tiles_x_slices": v[12],
                "batch": dict(hs=v[13], tile=v[14])}

    return run


def consts() -> dict:
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", open(CU).read())}


# (k, H, per_sm): the persistent plan the serving chain has always run
# (hs, slices, tile), and the resident CTAs a SM of it on the H100
PERSISTENT = {(9, 128): (128, 1, 256, 3), (9, 512): (256, 2, 256, 2),
              (30, 128): (64, 2, 64, 2), (11, 512): (128, 4, 128, 3),
              (8, 8): (8, 1, 256, 3), (9, 100): (128, 1, 256, 3),
              (9, 16): (16, 1, 256, 3), (9, 64): (64, 1, 256, 3)}


@pytest.mark.parametrize("k,h", sorted(PERSISTENT))
def test_the_persistent_plan_is_kept(planner, k, h):
    """Past one wave of the persistent plan's tiles (524,288 rows, the
    chain's block) the launch is the persistent grid of the serving
    chain: the same slices and tiles, the card full, no more CTAs than
    tiles."""
    hs, slices, tile, per_sm = PERSISTENT[(k, h)]
    got = planner(k, h, 524288, per_sm)
    assert (got["persistent"]["hs"], got["persistent"]["slices"],
            got["persistent"]["tile"]) == (hs, slices, tile)
    assert got["kind"] == sc.PERSISTENT_PLAN
    assert (got["hs"], got["slices"], got["tile"]) == (hs, slices, tile)
    tiles = -(-524288 // tile)
    assert got["ctas"] == min(SMS * per_sm // slices, tiles)


def last_batch_rows(planner, k, h) -> int:
    """The most windows that take the batch plan at k and H on the H100,
    by bisection (0 where none does)."""
    per_sm = PERSISTENT[(k, h)][3]
    lo, hi = 0, 524288
    assert planner(k, h, hi, per_sm)["kind"] == sc.PERSISTENT_PLAN
    while hi - lo > 1:
        mid = (lo + hi) // 2
        batch = planner(k, h, mid, per_sm)["kind"] == sc.BATCH_PLAN
        lo, hi = (mid, hi) if batch else (lo, mid)
    return lo


def windows_a_thread(got) -> int:
    return got["tile"] // (256 // (got["hs"] // 8))


@pytest.mark.parametrize("k,h,m", [(9, 128, 4096), (9, 512, 4096),
                                   (9, 128, 2048), (9, 512, 2048),
                                   (11, 512, 127), (30, 128, 2048),
                                   (9, 16, 4096), (9, 100, 1),
                                   (9, 128, 50688), (9, 512, 12544)])
def test_the_batch_plan_fills_the_card(planner, k, h, m):
    """Where the persistent plan spreads the windows over too few SMs the
    batch plan takes the launch: one CTA a tile; slices no wider than the
    persistent plan's, its CTAs within one wave of kMinBlocks a SM unless
    its slices are the persistent plan's; every SM given a CTA unless a
    tile is one window a thread; at most kBatchMaxWindows windows a
    thread; no row indices staged."""
    limits = consts()
    per_sm = PERSISTENT[(k, h)][3]
    got = planner(k, h, m, per_sm)
    p = got["persistent"]
    assert got["kind"] == sc.BATCH_PLAN
    tiles = -(-m // got["tile"])
    assert got["ctas"] == tiles and got["tiles_x_slices"] == tiles * (
        got["slices"])
    per_pass = 256 // (got["hs"] // 8)
    reps = got["tile"] // per_pass
    assert got["tile"] == per_pass * reps <= 256
    assert reps & (reps - 1) == 0
    assert got["hs"] <= p["hs"] and got["smem"] <= p["smem"]
    assert got["tiles_x_slices"] <= SMS * limits["kMinBlocks"] or (
        got["hs"] == p["hs"])
    assert got["tiles_x_slices"] >= SMS or reps == 1 or tiles == 1
    assert reps == windows_a_thread(got) <= limits["kBatchMaxWindows"]
    assert reps < windows_a_thread(p)
    assert got["stage"] == 0


# (k, H): the last row count on the batch plan on the H100
LAST_BATCH = {(9, 128): 50688, (9, 512): 12544, (30, 128): 4096,
              (11, 512): 6144, (8, 8): 0, (9, 100): 50688, (9, 16): 33536,
              (9, 64): 50688}


@pytest.mark.parametrize("k,h", sorted(PERSISTENT))
def test_the_switch_is_where_the_batch_plan_stops_winning(planner, k, h):
    """Every row count up to the switch takes the batch plan and every
    larger one the persistent plan, the chain's blocks of 131,072 and
    524,288 windows among them; past the switch the persistent plan's
    tiles fill a wave, or the batch plan's threads would take as many
    windows each as the persistent plan's, or more than kBatchMaxWindows."""
    limits = consts()
    per_sm = PERSISTENT[(k, h)][3]
    last = last_batch_rows(planner, k, h)
    assert last == LAST_BATCH[(k, h)]
    for m in (1, last // 3, last) if last else ():
        assert planner(k, h, m, per_sm)["kind"] == sc.BATCH_PLAN, m
    for m in (last + 1, 2 * last + 1, 131072, 524288):
        assert planner(k, h, m, per_sm)["kind"] == sc.PERSISTENT_PLAN, m
    nxt = planner(k, h, last + 1, per_sm)
    wave = SMS * per_sm
    w = windows_a_thread(nxt["batch"])
    assert nxt["persistent"]["slices"] * -(-(last + 1) // (
        nxt["persistent"]["tile"])) >= wave or w > limits[
            "kBatchMaxWindows"] or w >= windows_a_thread(nxt["persistent"])


def test_the_last_plan_entry_is_the_kernels():
    """The entry that reports a launch's plan is bound with no arguments,
    and its plan numbers are the source's."""
    from vcf2prot_tpu_torch.runtime.build import SIGNATURES

    text = open(CU).read()
    assert 'extern "C" int v2p_window_layer1_last_plan()' in text
    assert SIGNATURES["v2p_window_layer1_last_plan"] == ()
    assert ("enum PlanKind { kPersistentPlan = %d, kBatchPlan = %d, "
            "kGlobalPlan = %d };"
            % (sc.PERSISTENT_PLAN, sc.BATCH_PLAN, sc.GLOBAL_PLAN)) in text


class _Graph:
    def replay(self):
        pass


def test_batch_plan_launches_count_each_replay():
    """The batch-plan count is a step kernel's count: a captured step's
    batch-plan launches times its replays, beside K3's own, and the
    plain version on the CPU counts none."""
    assert sc.window_layer1_batch in train.STEP_KERNELS
    kernels = (sc.window_layer1, sc.window_layer1_batch)
    before = {f: train.launches(f) for f in kernels}
    step = train.CapturedStep.__new__(train.CapturedStep)
    step.replays, step.graph = 0, _Graph()
    step.launches = [1 if f in kernels else 0 for f in train.STEP_KERNELS]
    train._CAPTURED.add(step)
    for _ in range(4):
        step()
    assert {f: train.launches(f) - before[f] for f in kernels} == {
        sc.window_layer1: 4, sc.window_layer1_batch: 4}
    del step
    assert {f: train.launches(f) - before[f] for f in kernels} == {
        sc.window_layer1: 4, sc.window_layer1_batch: 4}
    import numpy as np
    import torch

    buf = torch.from_numpy(np.frombuffer(b"ACDEFGHIKL" * 4, np.uint8).copy())
    head = sc.ScoringHead.from_params(sc.init_params(9, seed=0, hidden=16))
    sc.window_layer1(buf, torch.arange(3) * 9, 9, head.table, head.b1)
    assert {f: train.launches(f) - before[f] for f in kernels} == {
        sc.window_layer1: 4, sc.window_layer1_batch: 4}


def test_kernel_ab_k3_without_a_card(capsys):
    """utils/kernel_ab.py k3 builds each source's int64 entry of K3 and
    needs no cohort; without a card, or without its sources, it prints
    its usage and exits 2."""
    from vcf2prot_tpu_torch.runtime.build import SIGNATURES
    from vcf2prot_tpu_torch.utils import kernel_ab

    assert kernel_ab.ENTRIES["k3"] == "v2p_window_layer1_i64"
    assert 'extern "C" int v2p_window_layer1_i64(' in open(CU).read()
    assert "v2p_window_layer1_i64" in SIGNATURES
    assert {(h, m) for h, m, _k in kernel_ab.K3_SHAPES} == {
        (h, m) for h in (128, 512) for m in (4096, 2048, 524288)}
    assert kernel_ab.main(["k3"]) == 2
    assert kernel_ab.main(["k3", "OLD.cu", "NEW.cu"]) == 2
    assert "kernel_ab k3 OLD.cu NEW.cu" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["k1", "k2", "k3", "k5", "k6", "k7", "k8"])
def test_kernel_ab_refuses_a_missing_file(mode, tmp_path, capsys):
    """Each mode given a file that is not there prints its usage and exits
    2 before it builds anything, on a machine with a card too."""
    from vcf2prot_tpu_torch.utils import kernel_ab

    missing = str(tmp_path / "missing.cu")
    files = [CU, missing] if mode not in ("k1", "k2") else [
        CU, CU, CU, missing]
    assert kernel_ab.main([mode, *files]) == 2
    assert "OLD.cu NEW.cu" in capsys.readouterr().err
