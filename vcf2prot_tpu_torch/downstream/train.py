"""Training of the peptide scoring head on one device: the port of
``vcf2prot_tpu/downstream/train.py`` (``fit``, ``:46-231``).

Closes the ``--neoantigen_params`` loop: fit the head on labelled peptide
windows and save an ``.npz`` in ``load_params``' schema, which the port's
neoantigen paths serve. The forward is the serving forward
(:class:`~vcf2prot_tpu_torch.downstream.scoring.TrainableHead`: K3 for
layer 1 with K4 as its gradient, then fp32 products of bf16 values), so
training and serving cannot skew.

What follows the reference exactly: the input checks, the batch size
(``min(_bucket(batch_size), _bucket(n))``), zero windows padding the rows
to whole batches under a mask, BCE-with-logits for binary labels and MSE
for any other, the loss ``sum(per * mask) / max(sum(mask), 1)`` per batch
plus ``l2 * sum(w * w)`` over the ``w*`` weights, adam (``torch.optim.Adam``
with optax.adam's defaults: the same update), and an epoch shuffle of all
padded rows. The shuffle is a ``torch.Generator`` on the device, seeded by
``seed``: a run is reproducible, but its permutations are not JAX's, so the
tests feed both the same ones (:func:`_epoch_orders`).

The reference ran the whole fit as one jitted program. Here it is an eager
loop on the device: the data is uploaded once, each step's loss is kept in
a device tensor and fetched once at the end. The one wait per step is K3's
wrapper checking its windows' bounds.

    python -m vcf2prot_tpu_torch.downstream.train data.tsv out.npz \\
        [--epochs 30] [--lr 1e-3] [--batch 4096] [--seed 0] [--l2 0] \\
        [--holdout 0.2] [--embed_dim 32] [--hidden 128] [--depth 1] \\
        [--device cuda]

reads ``peptide<TAB>label`` rows (no header, one peptide length), trains,
writes the ``.npz`` and reports the holdout AUC (binary labels) or MSE.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from vcf2prot_tpu.downstream.train import (  # noqa: F401 (re-exported)
    _bucket,
    auc,
    save_params,
)

from .scoring import ScoringHead, TrainableHead, init_params, score_windows


def _epoch_orders(seed: int, padded: int, epochs: int, device):
    """Each epoch's order of the padded rows: a permutation from one
    ``torch.Generator`` on ``device``, seeded by ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for _ in range(epochs):
        yield torch.randperm(padded, generator=gen, device=device)


def batch_loss(scores, y, m, binary: bool) -> torch.Tensor:
    """The masked mean loss of one batch: optax's
    ``sigmoid_binary_cross_entropy`` when ``binary``, else the squared
    error, summed over the rows with ``m`` = 1 and divided by their count
    (at least 1)."""
    if binary:
        per = -y * F.logsigmoid(scores) - (1.0 - y) * F.logsigmoid(-scores)
    else:
        per = (scores - y) ** 2
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def train_step(head: TrainableHead, opt, w, y, m, binary: bool,
               l2: float = 0.0) -> torch.Tensor:
    """One adam step on the batch ``w`` (u8 ``[B, k]``), ``y``, ``m``;
    returns the batch's loss as a device tensor (no wait)."""
    opt.zero_grad(set_to_none=True)
    loss = batch_loss(head(w), y, m, binary)
    if l2:
        loss = loss + l2 * sum((p * p).sum() for name, p in
                               head.named_parameters() if name[0] == "w")
    loss.backward()
    opt.step()
    return loss.detach()


def fit(windows: np.ndarray, labels: np.ndarray, k: int = None,
        epochs: int = 30, batch_size: int = 4096, learning_rate: float = 1e-3,
        seed: int = 0, params: dict = None, l2: float = 0.0,
        verbose: bool = False, device="cuda") -> dict:
    """Fit the scoring head on ``windows u8[N, k]`` / ``labels f32[N]`` on
    ``device`` (CUDA by default; ``"cpu"`` runs every kernel's plain
    version). Binary labels train with sigmoid cross-entropy, any other
    labels with the squared error, both on the raw score the ranking paths
    sort by. Returns the trained weights, a dict of fp32 numpy arrays ready
    for ``save_params`` / ``load_params``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on "
                           "the CPU")
    windows = np.asarray(windows, np.uint8)
    labels = np.asarray(labels, np.float32)
    n, wk = windows.shape
    if n == 0:
        raise ValueError(
            "no training rows: windows is empty (e.g. --holdout 1.0 leaves "
            "nothing to fit on)"
        )
    if k is None:
        k = wk
    if wk != k:
        raise ValueError(f"windows are {wk}-mers but k={k}")
    if labels.shape != (n,):
        raise ValueError("labels must be f32[N] aligned with windows")
    if params is None:
        params = init_params(k, seed=seed)
    head = TrainableHead.from_params(params)
    if head.k != k:
        raise ValueError(f"the head scores {head.k}-mers, not {k}-mers")
    binary = bool(np.isin(labels, (0.0, 1.0)).all())

    batch_size = min(_bucket(batch_size), _bucket(max(n, 1)))
    n_batches = (n + batch_size - 1) // batch_size
    padded = n_batches * batch_size
    win_p = np.zeros((padded, k), np.uint8)
    win_p[:n] = windows
    lab_p = np.zeros(padded, np.float32)
    lab_p[:n] = labels
    mask_p = np.zeros(padded, np.float32)
    mask_p[:n] = 1.0

    head = head.to(device)
    opt = torch.optim.Adam(head.parameters(), lr=learning_rate)
    wd, yd, md = (torch.from_numpy(a).to(device)
                  for a in (win_p, lab_p, mask_p))
    losses = torch.empty((epochs, n_batches), dtype=torch.float32,
                         device=device)
    for e, order in enumerate(_epoch_orders(seed, padded, epochs, device)):
        wb = wd[order].view(n_batches, batch_size, k)
        yb = yd[order].view(n_batches, batch_size)
        mb = md[order].view(n_batches, batch_size)
        for b in range(n_batches):
            losses[e, b] = train_step(head, opt, wb[b], yb[b], mb[b], binary,
                                      l2)
    out = head.to_params()
    if verbose:
        for e, row in enumerate(losses.cpu().numpy()):
            print(f"epoch {e + 1}/{epochs}: loss {row.mean():.5f}")
    return {name: out[name] for name in sorted(out)}


def read_tsv(path):
    """``(windows u8[N, k], labels f32[N], k)`` of a ``peptide<TAB>label``
    file; exits with a message on a malformed one."""
    peptides, labels = [], []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            try:
                pep, lab = line.split("\t")
            except ValueError:
                raise SystemExit(f"{path}:{ln}: expected 'peptide<TAB>label'")
            peptides.append(pep.encode("ascii"))
            labels.append(float(lab))
    if not peptides:
        raise SystemExit(f"{path}: no rows")
    k = len(peptides[0])
    if any(len(p) != k for p in peptides):
        raise SystemExit(f"{path}: peptides must all be the same length")
    windows = np.frombuffer(b"".join(peptides), np.uint8).reshape(-1, k)
    return windows, np.asarray(labels, np.float32), k


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vcf2prot_tpu_torch.downstream.train",
        description="Train the neoantigen scoring head and write a "
                    "--neoantigen_params .npz.",
    )
    ap.add_argument("tsv")
    ap.add_argument("out_npz")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--l2", type=float, default=0.0)
    ap.add_argument("--holdout", type=float, default=0.2,
                    help="fraction held out for the final AUC report")
    ap.add_argument("--embed_dim", type=int, default=32,
                    help="per-position embedding width")
    ap.add_argument("--hidden", type=int, default=128,
                    help="hidden-layer width")
    ap.add_argument("--depth", type=int, default=1,
                    help="number of hidden layers")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        log("error: no CUDA device (--device cpu trains on the CPU)")
        return 1

    windows, labels, k = read_tsv(args.tsv)
    log(f"{len(windows)} peptides, k={k}; head "
        f"E={args.embed_dim} H={args.hidden} depth={args.depth}")
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(windows))
    n_hold = int(len(windows) * args.holdout)
    hold, tr = order[:n_hold], order[n_hold:]
    params = fit(
        windows[tr], labels[tr], k=k, epochs=args.epochs,
        batch_size=args.batch, learning_rate=args.lr, seed=args.seed,
        l2=args.l2, verbose=True, device=args.device,
        params=init_params(k, embed_dim=args.embed_dim, hidden=args.hidden,
                           depth=args.depth, seed=args.seed),
    )
    save_params(args.out_npz, params)
    log(f"saved {args.out_npz}")
    if n_hold:
        head = ScoringHead.from_params(params).to(args.device)
        scores = score_windows(windows[hold], head).cpu().numpy()
        binary = bool(np.isin(labels, (0.0, 1.0)).all())
        if binary:
            log(f"holdout AUC: {auc(scores, labels[hold]):.4f} "
                f"({n_hold} rows)")
        else:
            mse = float(np.mean((scores - labels[hold]) ** 2))
            log(f"holdout MSE: {mse:.5f} ({n_hold} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
