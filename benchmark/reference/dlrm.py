"""Plain DLRM training in float32 torch ops: the reference that decides a
training cell's ``correct``.  It imports nothing of the port and no JAX.

The model is the port's DLRM as its configuration states it (Naumov et
al. 2019, with the port's two departures from the published scripts: the
bottom MLP's last layer is linear, and the loss is BCE on logits):

    z      = bottom MLP over the dense features         (B, D), relu between layers
    E      = one row of each field's table               (B, F, D)
    X      = [z, E]                                      (B, F + 1, D)
    I      = X·Xᵀ's strict lower triangle, row-major     (B, P), pairs (1,0), (2,0), (2,1), ...
    logit  = top MLP over [z, I]                         (B,)
    loss   = mean BCE with logits

Gradients come from autograd; every leaf (each MLP weight and bias, and
each table) trains with dense Adam with bias correction.  Matmuls run in
full float32: TF32 is off for the length of a call.

The tables handed in may be compact: only the rows the batches touch, with
the batches' ids mapped onto them.  Dense Adam leaves a row that no step
touched exactly where it was (its moments stay 0), so over the steps
given the compact tables train exactly as the whole ones, and every norm
of a gradient or a change is the whole table's.

``quant='fp8'`` is the check's control: the same model with the inputs of
every matmul, of the interaction and the gathered rows rounded to float8
e4m3 by a per-tensor scale, and their gradients to e5m2.
``half_batch=True`` is a planted fault: the loss is the mean over the
first half of the batch only.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def _quantizer(quant):
    if quant is None:
        return lambda x: x
    if quant == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown quant {quant!r}")


@contextlib.contextmanager
def full_f32():
    """TF32 off for float32 matmuls and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def mlp(x, layers, q):
    """Relu between layers, none after the last; ``layers`` = [(W (out,
    in), b (out,))]."""
    for i, (w, b) in enumerate(layers):
        x = q(x) @ q(w).t() + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def forward(params: dict, tables: list, sparse: torch.Tensor, dense: torch.Tensor,
            quant=None) -> torch.Tensor:
    """(B,) f32 logits.  ``params`` holds ``bottom.{i}.weight``/``bias``
    and ``top.{i}.weight``/``bias``; ``tables[t]`` is field t's table and
    ``sparse[:, t]`` its rows."""
    q = _quantizer(quant)

    def layers(tower):
        n = sum(1 for k in params if k.startswith(f"{tower}.") and k.endswith(".weight"))
        return [(params[f"{tower}.{i}.weight"], params[f"{tower}.{i}.bias"]) for i in range(n)]

    z = mlp(dense, layers("bottom"), q)
    emb = torch.stack([t[sparse[:, j]] for j, t in enumerate(tables)], 1)
    x = q(torch.cat([z[:, None, :], q(emb)], 1))
    f = x.shape[1]
    rows, cols = torch.tril_indices(f, f, -1, device=x.device)
    inter = torch.bmm(x, x.transpose(1, 2))[:, rows, cols]
    return mlp(torch.cat([z, inter], 1), layers("top"), q)[:, 0]


def train(params: dict, tables: list, batches: list, *, lr: float, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, quant=None, half_batch: bool = False) -> dict:
    """Adam over ``len(batches)`` steps from the given start (copied, not
    changed).  Each batch is ``{'sparse': (B, F) int64 rows of the tables
    given, 'dense': (B, num_dense) f32, 'label': (B,) f32}`` on the
    tables' device.  Returns ``{'loss': [each step's loss], 'grad_norm':
    {leaf: norm of step 1's gradient}, 'change_norm': {leaf: norm of the
    change over all the steps}}``, the tables' leaves named ``table.{t}``."""
    leaves = {k: v.detach().clone().float().requires_grad_() for k, v in params.items()}
    leaves.update({f"table.{t}": v.detach().clone().float().requires_grad_()
                   for t, v in enumerate(tables)})
    start = {k: v.detach().clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    s = {k: torch.zeros_like(v) for k, v in leaves.items()}
    dense_keys = list(params)
    out = {"loss": [], "grad_norm": {}, "change_norm": {}}
    with full_f32():
        for step, b in enumerate(batches, 1):
            sparse, dense, label = b["sparse"], b["dense"], b["label"]
            if half_batch:
                n = sparse.shape[0] // 2
                sparse, dense, label = sparse[:n], dense[:n], label[:n]
            tabs = [leaves[f"table.{t}"] for t in range(len(tables))]
            logits = forward({k: leaves[k] for k in dense_keys}, tabs, sparse, dense, quant)
            loss = F.binary_cross_entropy_with_logits(logits, label.float())
            grads = torch.autograd.grad(loss, list(leaves.values()))
            out["loss"].append(float(loss.detach()))
            with torch.no_grad():
                c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
                for (k, p), g in zip(leaves.items(), grads):
                    if step == 1:
                        out["grad_norm"][k] = float(torch.linalg.vector_norm(g))
                    m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                    s[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    p.sub_(lr * (m[k] / c1) / ((s[k] / c2).sqrt() + eps))
    with torch.no_grad():
        for k, p in leaves.items():
            out["change_norm"][k] = float(torch.linalg.vector_norm(p - start[k]))
    return out
