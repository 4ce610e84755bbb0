"""Where K3's batch plan stops beating its persistent plan: each shape
timed with the plan forced both ways (a hooked copy of csrc/scorer.cu),
and as the rule chooses, each launch held bit for bit to the plain version.

    python3 chip_archive/k3_switch.py vcf2prot_tpu_torch/csrc/scorer.cu
"""
import ctypes
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vcf2prot_tpu_torch.downstream import scoring as sc  # noqa: E402
from vcf2prot_tpu_torch.utils import kernel_ab as ab  # noqa: E402

# around the switch at 128 and 512 columns (k 9: 50,688 / 12,544 rows),
# and the widths whose batch plan never reaches 16 windows a thread
SHAPES = [(128, m, 9) for m in (4096, 50688, 50944)]
SHAPES += [(512, m, 9) for m in (4096, 12544, 12800)]
SHAPES += [(64, m, 9) for m in (4096, 16384, 32768, 65536)]
SHAPES += [(8, m, 9) for m in (4096, 65536)]
SHAPES += [(16, m, 9) for m in (4096, 65536)]
SHAPES += [(128, m, 30) for m in (2048, 4096, 8384)]


def hooked(src):
    old = ("  if (plan_ctas(persistent, m) < wave) {",
           "    if (w < windows_a_thread(persistent) && w <= kBatchMaxWindows) {")
    assert src.count(old[0]) == 1 and src.count(old[1]) == 1
    s = src.replace("namespace {\n", "namespace {\nint g_force = 0;\n", 1)
    s = s.replace(old[0], "  if (g_force == 2 || (g_force == 0 && "
                  "plan_ctas(persistent, m) < wave)) {")
    s = s.replace(old[1], "    if (g_force == 2 || (w < windows_a_thread("
                  "persistent) && w <= kBatchMaxWindows)) {")
    return s + ('extern "C" int v2p_k3_force(int64_t f) '
                '{ g_force = f; return 0; }\n')


def main(source):
    out = os.path.join(ROOT, "chip_archive", "k3_variants", "switch.cu")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        fh.write(hooked(open(source).read()))
    print(ab.card())
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        fn, = ab.build_all([out], "v2p_window_layer1_i64", tmp)
        lib = ctypes.CDLL(os.path.join(tmp, "ab_0.so"))
        lib.v2p_k3_force.argtypes = (ctypes.c_int64,)
        rng = np.random.default_rng(5)
        alphabet = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX.", np.uint8)
        for h_dim, m, k in SHAPES:
            head = sc.ScoringHead.from_params(
                sc.init_params(k, seed=h_dim, hidden=h_dim)).to("cuda")
            buf = torch.from_numpy(
                alphabet[rng.integers(0, len(alphabet), m * k)]).to("cuda")
            pos = torch.arange(m, dtype=torch.int64, device="cuda") * k
            want = sc.window_layer1_reference(buf, pos, k, head.table,
                                              head.b1)
            got = torch.empty_like(want)

            def launch():
                return fn(buf.data_ptr(), pos.data_ptr(), m, k,
                          head.table.data_ptr(), head.b1.data_ptr(), h_dim,
                          got.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)

            row = []
            for label, force in (("rule", 0), ("persistent", 1),
                                 ("batch", 2), ("persistent", 1),
                                 ("batch", 2)):
                lib.v2p_k3_force(force)
                got.zero_()
                rc = launch()
                torch.cuda.synchronize()
                ok = rc == 0 and torch.equal(got.view(torch.int16),
                                             want.view(torch.int16))
                row.append(f"{label} {ab.graph_ms(launch) * 1e3:.2f}"
                           + ("" if ok else " DIFFERS"))
            print(f"H {h_dim} M {m} k {k} (us in a graph): "
                  + "; ".join(row), flush=True)
            del head, buf, pos, want, got
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1])
