"""Batched anchored least-squares, the fusion solver.

Port of mixofshow_tpu/ops/solve.py (XLA linear algebra there, torch.linalg
and torch.matmul here: no hand-written kernel is owed). Every fusion target
is the concept-merged layer applied to that concept's inputs, so a layer's
least-squares problem needs only input Grams G_c = X_cᵀX_c:

    min_W Σ_c ‖X_c W − X_c Wm_c‖²  ⇔  (Σ_c G_c) ΔW = Σ_c G_c (Wm_c − W₀),

W = W₀ + ΔW in the (in, out) kernel layout. `anchored_spectral_solve` takes
the minimiser closest to W₀: eigendirections of G below rank_tol·e_max are
unobserved and stay at the anchor.

Everything here is fp32 and must stay so: the grams feed an eigh with
rank_tol 1e-6. Callers run under `utils.device.fp32_matmuls()` so that no
product on the card rounds to TF32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def gram(x: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """XᵀX over all leading dims: x (..., N, F) -> (F, F) fp32. `mask`
    (..., N) zeroes rows (tokenizer padding)."""
    xf = x.float()
    if mask is not None:
        xf = xf * mask.float()[..., None]
    xf = xf.reshape(-1, xf.shape[-1])
    return xf.T @ xf


def anchored_spectral_solve(g_sum, d_sum, w0, lam: float,
                            rank_tol: float):
    """W = W₀ + V ((VᵀD) / (e + λ·e_max)) over the directions e > tol·e_max,
    batched over a leading dim: g_sum (B, F, F), d_sum and w0 (B, F, O)."""
    e, v = torch.linalg.eigh(g_sum)
    emax = torch.clamp(e[..., -1:], min=1e-30)
    keep = e > rank_tol * emax
    inv = torch.where(keep, 1.0 / (e + lam * emax), torch.zeros_like(e))
    dw = v @ (inv[..., :, None] * (v.transpose(-1, -2) @ d_sum))
    return w0 + dw


def _lbfgs(g, d, w0, iters: int):
    """The reference's own optimizer (torch.optim.LBFGS with a strong-Wolfe
    line search, gradient_fusion.py:78-85) on ½tr(ΔᵀGΔ) − tr(ΔᵀD) in delta
    space, one layer at a time: the iterative parity path of the exact
    solve."""
    out = []
    for g1, d1, w1 in zip(g, d, w0):
        dw = torch.zeros_like(d1, requires_grad=True)
        opt = torch.optim.LBFGS([dw], max_iter=iters,
                                line_search_fn='strong_wolfe')

        def closure():
            opt.zero_grad()
            loss = 0.5 * (dw * (g1 @ dw)).sum() - (dw * d1).sum()
            loss.backward()
            return loss

        with torch.enable_grad():
            opt.step(closure)
        out.append(w1 + dw.detach())
    return torch.stack(out)


def _residual_core_batch(g, d, wn, w0):
    """tr(ΔᵀGΔ) − 2tr(ΔᵀD) per layer of a stacked group: the
    Wn-dependent part of Σ_c‖X_c(Wn − Wm_c)‖², the diagnostic the reference
    logs after LBFGS (gradient_fusion.py:87-95)."""
    dw = (wn - w0).float()
    return (dw * (g.float() @ dw)).sum((-2, -1)) \
        - 2.0 * (dw * d.float()).sum((-2, -1))


def solve_layer_group(grams: List[torch.Tensor], deltas: List[torch.Tensor],
                      anchors: List[torch.Tensor], lam: float = 1e-4,
                      rank_tol: float = 1e-6, method: str = 'exact',
                      iters: int = 50, with_residuals: bool = False):
    """Solve many layers, one batched solve per (F, O) shape (the JAX
    package groups the same way). All in the (in, out) kernel layout;
    `deltas[i]` = Σ_c G_c (Wm_c − W₀) of layer i. Returns the solved
    kernels in input order, and with `with_residuals` also each layer's
    residual core as a float.

    method: 'exact' (spectral) or 'lbfgs' (torch.optim.LBFGS, `iters` a
    layer)."""
    if method not in ('exact', 'lbfgs'):
        raise ValueError(f"method must be 'exact' or 'lbfgs', got {method!r}")
    order: Dict[Tuple[int, int], List[int]] = {}
    for i, (g, t) in enumerate(zip(grams, deltas)):
        order.setdefault((g.shape[0], t.shape[1]), []).append(i)

    out: List[torch.Tensor] = [None] * len(grams)  # type: ignore
    res: List[float] = [0.0] * len(grams)
    for idxs in order.values():
        g = torch.stack([grams[i].float() for i in idxs])
        d = torch.stack([deltas[i].float() for i in idxs])
        w = torch.stack([anchors[i].float() for i in idxs])
        if method == 'lbfgs':
            solved = _lbfgs(g, d, w, iters)
        else:
            solved = anchored_spectral_solve(g, d, w, lam, rank_tol)
        if with_residuals:
            r = _residual_core_batch(g, d, solved, w).tolist()
            for j, i in enumerate(idxs):
                res[i] = r[j]
        for j, i in enumerate(idxs):
            out[i] = solved[j]
    return (out, res) if with_residuals else out



def output_difference(w, w_ref, w0, g) -> float:
    """How far two solutions of one layer differ on the data they were fit
    to: ‖X(w − w_ref)‖ / ‖X(w_ref − w0)‖ over the captured rows X, from
    their Gram g = XᵀX (float64): the relative RMS difference of the fused
    layer's outputs, against the RMS of what the fusion changed.

    Two correct solves agree in this norm to the accuracy of their Grams.
    Kernel entries may differ more: eigenvalues within an fp32 ulp of e_max
    of the rank cutoff are kept by one eigensolver and dropped by another
    (LAPACK vs cuSOLVER, XLA vs torch), which moves the kernel along
    directions the data hardly sees."""
    gd = g.double()
    d = (w.double() - w_ref.double()).to(gd.device)
    dw = (w_ref.double() - w0.double()).to(gd.device)
    return ((d * (gd @ d)).sum() / (dw * (gd @ dw)).sum()).sqrt().item()
