"""Theorem-1 machinery: constants, bound evaluation, and an exactly-solvable
quadratic PFL testbed used to validate the convergence analysis.

Counterpart of ``repro/core/theory.py``, in float64 on an explicit device.

Quadratic testbed: F_k(w) = 0.5 (w - c_k)^T A_k (w - c_k) + d_k with
mu I <= A_k <= L I. Then
    F(w)   = sum_{k in P} p_k F_k(w)          (priority objective)
    w*     = (sum p_k A_k)^{-1} sum p_k A_k c_k
    F_k^*  = d_k,   Gamma  = F(w*) - sum p_k d_k,   Gamma_k = F_k(w*) - d_k
— every quantity in the theorem is computable in closed form.

``make_quadratic_pfl`` draws in numpy, in the reference's order, so an
instance holds the reference's bytes; its tensors then move to the device.
``run_fedalign_gd`` batches the clients: each round is one batched
quadratic form for the C losses, the gates, E batched [C, m, m] matvecs
and the weighted mean, with no host sync until the histories are read
once at the end. The constants and the bound are scalar maths and take
floats, numpy values or 0-d tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.utils import resolve_device

F64 = torch.float64


@dataclass
class QuadraticPFL:
    A: torch.Tensor              # [C, m, m]
    c: torch.Tensor              # [C, m]
    d: torch.Tensor              # [C]
    priority_mask: torch.Tensor  # [C] bool
    weights: torch.Tensor        # p_k (priority mass sums to 1)

    # ---- closed-form quantities -------------------------------------------
    def w_star(self):
        pw = self.weights * self.priority_mask
        Aw = torch.einsum("k,kij->ij", pw, self.A)
        bw = torch.einsum("k,kij,kj->i", pw, self.A, self.c)
        return torch.linalg.solve(Aw, bw)

    def losses(self, w):
        """[C] F_k(w) of every client: one batched quadratic form."""
        r = w - self.c
        return 0.5 * torch.einsum("ki,kij,kj->k", r, self.A, r) + self.d

    def excess(self, w):
        """F(w) - F(w*), computed as 0.5 (w - w*)^T (sum_P p_k A_k) (w - w*):
        the same value (F is quadratic and its gradient vanishes at w*)
        without subtracting two close losses, whose rounding would swamp
        an excess of 1e-5 by ~1e-11 relative."""
        pw = self.weights * self.priority_mask
        r = w - self.w_star()
        return 0.5 * r @ torch.einsum("k,kij->ij", pw, self.A) @ r

    def F_k(self, w, k):
        r = w - self.c[k]
        return 0.5 * r @ self.A[k] @ r + self.d[k]

    def F(self, w):
        return torch.sum(self.weights * self.priority_mask * self.losses(w))

    def gamma(self):
        return self.F(self.w_star()) - torch.sum(
            self.weights * self.priority_mask * self.d)

    def gammas(self):
        """[C] Gamma_k, w* solved once."""
        return self.losses(self.w_star()) - self.d

    def gamma_k(self, k):
        return self.F_k(self.w_star(), k) - self.d[k]

    def smoothness(self):
        eig = torch.linalg.eigvalsh(self.A)
        return float(eig.max()), float(eig.min())


def make_quadratic_pfl(seed=0, n_priority=4, n_nonpriority=8, dim=10,
                       mu=0.5, L=4.0, priority_spread=1.0,
                       nonpriority_align=None, device="cuda"):
    """nonpriority_align: [n_nonpriority] in [0,1]; 1 = centered at w*
    (perfectly aligned), 0 = far away (misaligned). Drawn on the host in
    numpy, then moved to ``device`` (default the card; raises if there is
    none)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    C = n_priority + n_nonpriority
    if nonpriority_align is None:
        nonpriority_align = np.linspace(1.0, 0.0, n_nonpriority)

    def rand_spd():
        q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
        eig = rng.uniform(mu, L, dim)
        return q @ np.diag(eig) @ q.T

    A = np.stack([rand_spd() for _ in range(C)])
    c = np.zeros((C, dim))
    c[:n_priority] = rng.normal(0, priority_spread, (n_priority, dim))
    d = rng.uniform(0, 0.1, C)

    pm = np.zeros(C, bool)
    pm[:n_priority] = True
    w = np.full(C, 1.0 / n_priority)
    # w* of the priority rows, in numpy as the reference solves it, so the
    # non-priority centres below are its bytes
    pw = w * pm
    ws = np.linalg.solve(np.einsum("k,kij->ij", pw, A),
                         np.einsum("k,kij,kj->i", pw, A, c))
    for i, a in enumerate(nonpriority_align):
        k = n_priority + i
        offset = rng.normal(0, 1, dim)
        offset /= np.linalg.norm(offset)
        c[k] = ws + (1.0 - a) * 4.0 * offset       # aligned => minimum near w*

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return QuadraticPFL(put(A), put(c), put(d), put(pm), put(w))


def run_fedalign_gd(q: QuadraticPFL, T_rounds, E, eps, lr_fn, *,
                    record=None):
    """Full-batch deterministic FedALIGN on the quadratic testbed, all
    clients batched, on ``q``'s device. ``lr_fn(t)`` gives the step size
    of local iteration t (a python float). Returns (w_T on the device,
    theta_round_history, rho_core_history), the histories as float64
    numpy arrays read from the device once. A dict passed as ``record``
    receives, read in the same transfer, each round's ``gates`` [T, C] and
    ``margin`` [T]: min over the non-priority clients of
    | |F_k(w) - F(w)| - eps |, how far the round's gates were from
    flipping."""
    C, m = q.c.shape
    dev = q.c.device
    pm = q.priority_mask
    nonpri = q.weights * ~pm
    rho_w = nonpri * q.gammas()                   # p_k Gamma_k, k not in P
    w = torch.zeros(m, dtype=F64, device=dev)
    hist = torch.empty(T_rounds, 3 + C, dtype=F64, device=dev)
    t = 0
    for r in range(T_rounds):
        losses = q.losses(w)
        gap = torch.abs(losses - torch.sum(q.weights * pm * losses))
        gates = torch.where(pm, 1.0, (gap < eps).to(F64))
        wk = w.expand(C, m)
        for e in range(E):
            step = torch.bmm(q.A, (wk - q.c).unsqueeze(-1)).squeeze(-1)
            wk = wk - lr_fn(t + e) * step
        t += E
        wg = q.weights * gates
        w = (wg @ wk) / wg.sum()
        inc = torch.sum(nonpri * gates)
        hist[r, 0] = 1.0 / (1.0 + inc)
        hist[r, 1] = torch.sum(rho_w * gates) / (1.0 + inc)
        hist[r, 2] = torch.min(torch.where(pm, torch.inf,
                                           torch.abs(gap - eps)))
        hist[r, 3:] = gates
    out = hist.cpu().numpy()
    if record is not None:
        record["gates"] = out[:, 3:]
        record["margin"] = out[:, 2]
    return w, out[:, 0].copy(), out[:, 1].copy()


# ------------------------------------------------------------- Theorem 1 bound
def theorem1_constants(L, mu, sigma, G, E, w0_dist_sq):
    C1 = 2 * L / mu**2 * (sigma**2 + 8 * (E - 1) ** 2 * G**2) + 4 * L**2 / mu * w0_dist_sq
    C2 = 12 * L**2 / mu**2
    gamma = max(8 * L / mu, E)
    return C1, C2, gamma


def theorem1_bound(T, *, C1, C2, gamma, Gamma, theta_T, rho_T):
    """E[F(w_T)] - F* <= (C1 + C2 theta_T Gamma)/(T + gamma) + rho_T."""
    return (C1 + C2 * theta_T * Gamma) / (T + gamma) + rho_T


def _host64(x):
    if torch.is_tensor(x):
        return x.detach().cpu().to(F64).numpy()
    return np.asarray(x, np.float64)


def empirical_theta_rho(theta_rounds, included_stats, gamma, E):
    """Aggregate per-round stats into theta_T (eq. 7) and the rho_T numerator
    structure (eq. 8). theta_rounds: per-round 1/(1+sum p_k I_k).
    included_stats: per-round sum(p_k I_k Gamma_k)/(1+sum p_k I_k). Lists,
    numpy arrays or tensors."""
    theta_rounds = _host64(theta_rounds)
    T = len(theta_rounds) * E
    # each communication round covers E local iterations with the same gate
    theta_T = float(np.sum(np.repeat(theta_rounds, E)) / (T + gamma - 2))
    rho_core = _host64(included_stats)
    rho_T_unscaled = float(np.sum(np.repeat(rho_core, E)) / (T + gamma - 2))
    return theta_T, rho_T_unscaled   # multiply by 2L/mu for the bound's rho_T
