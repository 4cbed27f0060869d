"""The plain reference: the configuration's first training steps in
float32, with TF32 off, from the benchmark's own weights and batches.

It imports nothing of the program: the model is `reference.model`, the
optimizer below is AdamW as the traffic states it (global-norm clipping,
bias-corrected moments in float32, decoupled weight decay), and each
parameter is kept in the type the configuration stores it in (the new
value rounded to it after every update, as the program stores it).
"""
from __future__ import annotations

from perfbench import data, weights
from perfbench.reference.model import nll_sum


def _adam(opt: dict, P: dict, grads: dict, mu: dict, nu: dict, step: int,
          dtypes: dict):
    """One AdamW update of the float32 values `P` in place; each new value
    rounded to its stored type. -> the clipped gradients."""
    import torch
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    clip = min(1.0, opt["grad_clip"] / (float(gnorm) + 1e-9))
    bc1 = 1 - opt["b1"] ** step
    bc2 = 1 - opt["b2"] ** step
    clipped = {}
    for k, g in grads.items():
        g = g * clip
        clipped[k] = g
        mu[k] = opt["b1"] * mu[k] + (1 - opt["b1"]) * g
        nu[k] = opt["b2"] * nu[k] + (1 - opt["b2"]) * g.square()
        delta = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + opt["eps"]) \
            + opt["weight_decay"] * P[k]
        P[k] = (P[k] - opt["lr"] * delta).to(dtypes[k]).float()
    return clipped


def train(c: dict, tr: dict, seed: int, device, *, steps: int = 3,
          low: bool = False) -> dict:
    """-> {"losses": [step 1.., ], "grads": {path: clipped g_1}, "params":
    {path: p_steps} (float32 tensors on `device`), "change_norms": {path:
    ||p_steps - p_0||}}."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, seq = tr["batch"], tr["seq"]
    block = tr.get("reference_rows", rows)
    W0 = weights.make(c, seed, device)
    dtypes = {k: v.dtype for k, v in W0.items()}
    P = {k: v.float() for k, v in W0.items()}
    del W0
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, first = [], None
    for step in range(1, steps + 1):
        b = data.batch_numpy(c["vocab_size"], rows, seq, seed, step - 1)
        leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
        loss = 0.0
        for r0 in range(0, rows, block):
            tok = torch.from_numpy(b["tokens"][r0:r0 + block]).to(device)
            lab = torch.from_numpy(b["labels"][r0:r0 + block]).to(device)
            part = nll_sum(c, leaves, tok, lab, low) / (rows * seq)
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        grads = {k: v.grad for k, v in leaves.items()}
        del leaves
        clipped = _adam(tr["optimizer"], P, grads, mu, nu, step, dtypes)
        if step == 1:
            first = {"/".join(k): g for k, g in clipped.items()}
        del grads, clipped
    W0 = weights.make(c, seed, device)
    change = {"/".join(k): float(torch.linalg.vector_norm(
        (P[k] - W0[k].float()).double())) for k in P}
    return {"losses": losses, "grads": first, "change_norms": change,
            "params": {"/".join(k): v for k, v in P.items()}}

