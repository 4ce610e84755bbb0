"""The plain reference of the scoring head's training step: PyTorch ops
in float32, TF32 off, no kernel of the program and nothing it made.

The head: residues one-hot over 21 letters, a per-position embedding
folded into the first layer (``T[i*21 + v] = sum_e embed[v, e] w1[i*E +
e]``), ``h1 = relu(sum_i T[i*21 + x_i] + b1)``, hidden layers ``h =
relu(h w + b)``, the output ``s = h w_out + b_out``; the loss the masked
mean of the sigmoid cross-entropy; Adam as optax writes it. The
precision is the configuration's: the folded table, every hidden
activation that enters a product and every product's weight rounded to
bf16, each product summed in fp32, and the gradient of each rounded
value rounded to bf16 as it flows back (autograd of the cast). The
control (:func:`fp8`) rounds the same values to fp8 instead, scaled per
tensor, E4M3 forward and E5M2 for the gradients: the step down that a
faster path would take.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
VOCAB = len(ALPHABET) + 1
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def fp32_products() -> None:
    """Keep fp32 products in full fp32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def bf16(x):
    """``x`` rounded to bf16 and back; its gradient is rounded likewise."""
    return x.to(torch.bfloat16).to(torch.float32)


def _scaled(x, dtype, top: float):
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2, 57344.0)


def fp8(x):
    """``x`` rounded to fp8 E4M3 under a per-tensor scale; its gradient to
    fp8 E5M2 under its own."""
    return _Fp8.apply(x)


ROUNDINGS = {"bf16": bf16, "fp8": fp8}


def residue_ids(windows) -> torch.Tensor:
    """int64 ``[B, k]`` letter indices of u8 windows (20 for any byte
    outside the alphabet)."""
    lut = torch.full((256,), VOCAB - 1, dtype=torch.int64)
    for i, c in enumerate(ALPHABET):
        lut[ord(c)] = i
    return lut.to(windows.device)[windows.long()]


def layer_names(params: dict) -> list:
    """``w1 .. wN`` in order."""
    return sorted((n for n in params if n[0] == "w" and n[1:].isdigit()),
                  key=lambda n: int(n[1:]))


def scores(params: dict, windows, q=bf16) -> torch.Tensor:
    """fp32 scores ``[B]`` of u8 windows ``[B, k]``; ``q`` rounds the
    values that the configuration holds in bf16."""
    names = layer_names(params)
    embed, w1 = params["embed"], params[names[0]]
    b, k = windows.shape
    e, h = embed.shape[1], w1.shape[1]
    table = q(torch.einsum("ve,keh->kvh", embed, w1.view(k, e, h))
              .reshape(k * VOCAB, h))
    rows = residue_ids(windows) + torch.arange(k, device=windows.device) \
        * VOCAB
    act = F.relu(table[rows].sum(1) + params["b1"])
    for name in names[1:-1]:
        act = F.relu(q(act) @ q(params[name]) + params["b" + name[1:]])
    out = names[-1]
    return (q(act) @ q(params[out]))[:, 0] + params["b" + out[1:]][0]


def loss(params: dict, windows, y, m, q=bf16, half: bool = False):
    """The batch's masked mean sigmoid cross-entropy. ``half`` plants a
    fault: the second half of the rows left out, the mean taken over the
    rest."""
    if half:
        cut = windows.shape[0] // 2
        windows, y, m = windows[:cut], y[:cut], m[:cut]
    s = scores(params, windows, q)
    per = -y * F.logsigmoid(s) - (1.0 - y) * F.logsigmoid(-s)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def first_steps(params: dict, batches, lr: float, q=bf16,
                fault: str = None, change_after: int = None) -> dict:
    """Adam's first steps over ``batches`` (an iterable of ``(windows, y,
    m)`` on one device) from the fp32 weights ``params``: ``{"losses":
    [each step's], "grad": {leaf: the first step's gradient}, "change":
    {leaf: the weights after step ``change_after`` (default the last) less
    the first}}``. ``fault`` plants one: ``"unchanged"`` (every step
    returns its state unchanged), ``"half"`` (each batch's second half left
    out), ``"answer"`` (the first loss altered by one part in a
    hundred)."""
    start = {n: t.detach().clone().float() for n, t in params.items()}
    p = {n: t.clone().requires_grad_(True) for n, t in start.items()}
    mu = {n: torch.zeros_like(t) for n, t in start.items()}
    nu = {n: torch.zeros_like(t) for n, t in start.items()}
    losses, grad, change = [], None, None
    for count, (w, y, m) in enumerate(batches, start=1):
        value = loss(p, w, y, m, q, half=fault == "half")
        g = torch.autograd.grad(value, [p[n] for n in p])
        g = dict(zip(p, g))
        losses.append(float(value.detach()) * (1.01 if fault == "answer"
                                      and count == 1 else 1.0))
        if fault == "unchanged":
            g = {n: torch.zeros_like(t) for n, t in g.items()}
        if grad is None:
            grad = {n: t.detach().clone() for n, t in g.items()}
        if fault != "unchanged":
            with torch.no_grad():
                for n in p:
                    mu[n] = (1 - ADAM_B1) * g[n] + ADAM_B1 * mu[n]
                    nu[n] = (1 - ADAM_B2) * g[n] * g[n] + ADAM_B2 * nu[n]
                    mu_hat = mu[n] / (1 - ADAM_B1 ** count)
                    nu_hat = nu[n] / (1 - ADAM_B2 ** count)
                    p[n] -= lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        if count == change_after:
            change = {n: (p[n].detach() - start[n]) for n in p}
    if change is None:
        change = {n: (p[n].detach() - start[n]) for n in p}
    return {"losses": losses, "grad": grad, "change": change}
