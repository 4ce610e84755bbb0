"""Compare versions of K4, the window-scorer gradient, on one card.

    python3 -m vcf2prot_tpu_torch.utils.k4_ab OLD.cu NEW.cu [...]

Each argument is a CUDA source with K4's C entry point
(``v2p_window_layer1_grad_i64``, the ABI of ``csrc/scorer_grad.cu``),
for example the source of an earlier commit unpacked with ``git archive``.
Each is built with the port's nvcc flags into a library of its own (the
build, timing and order of ``utils/kernel_ab.py``, which compares K1 and
K2 the same way), and every version runs on the same inputs (k = 9 and
int64 positions unless a shape says otherwise). It checks each result bit for bit against
``scoring.window_layer1_backward_tiled_reference``, K4's summation order.
Then it times the versions in the order A, B, ..., B, A: each time is the
median of 10 CUDA-event timings of 10 back-to-back launches on output and
scratch allocated once, with its share of ``utils/roofline.py``'s bound.
It prints the card's name and power limit first, and exits non-zero if a
version differs from the plain version.
"""
from __future__ import annotations

import sys
import tempfile

import torch

from ..downstream import scoring as sc
from . import roofline
from .kernel_ab import build_all, card, compare

# (H, M, k): a training batch and the chain's block for the 128x1 and the
# 512x3 heads, then long windows (the positions split over the grid)
SHAPES = ((128, 4096, 9), (512, 4096, 9), (128, 524288, 9),
          (512, 524288, 9), (128, 4096, 600))
TAPE_BYTES = 1 << 23
ENTRY = "v2p_window_layer1_grad_i64"


def main(paths) -> int:
    if not torch.cuda.is_available() or len(paths) < 1:
        print(__doc__, file=sys.stderr)
        return 2
    print(card())
    with tempfile.TemporaryDirectory(prefix="k4_ab_") as outdir:
        fns = build_all(paths, ENTRY, outdir)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        alphabet = torch.frombuffer(bytearray(b"ACDEFGHIKLMNPQRSTVWYX."),
                                    dtype=torch.uint8).cuda()
        tape = alphabet[torch.randint(0, alphabet.numel(), (TAPE_BYTES,),
                                      generator=gen, device="cuda")]
        bad = 0
        for h_dim, m, k in SHAPES:
            head = sc.ScoringHead.from_params(
                sc.init_params(k, seed=k, hidden=h_dim)).cuda()
            pos = torch.randint(0, TAPE_BYTES - k, (m,), generator=gen,
                                device="cuda")
            h1 = sc.window_layer1(tape, pos, k, head.table, head.b1)
            g = torch.randn(h1.shape, generator=gen,
                            device="cuda").to(torch.bfloat16)
            want = torch.cat([t.reshape(-1, h_dim) for t in
                              sc.window_layer1_backward_tiled_reference(
                                  tape, pos, k, h1, g)])
            tiles, _rows = sc._k4_tiles(m)
            out = torch.empty_like(want)
            partial = torch.empty(tiles * want.numel(), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            bad += compare(
                paths, fns, f"H={h_dim} M={m} k={k} (bit for bit, K4's order)",
                lambda fn: fn(tape.data_ptr(), pos.data_ptr(), m, k,
                              h1.data_ptr(), g.data_ptr(), h_dim, tiles,
                              partial.data_ptr(), out.data_ptr(), stream),
                lambda: out.fill_(float("nan")),
                lambda: torch.equal(out, want),
                roofline.bound_ms(
                    roofline.scorer_grad_bytes(
                        m, k, h_dim, pos.element_size(),
                        roofline.covered_bytes(pos, k)),
                    roofline.scorer_ops(m, k, h_dim)))
            del head, pos, h1, g, want, out, partial
            torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
