"""Plain reference of two-flavour lattice Schwinger-model HMC.

Written from the physics, in plain PyTorch on full-lattice fields, in one
working precision (float64 for the reference; for its control one step
below each precision the configuration states), independent of the
program under test:

- angles theta [C, 2, Nx, Nt] (direction 0 is t, along the last axis;
  direction 1 is x), links U = exp(i theta);
- the Wilson operator D = (m0 + 2) - H / 2 with the hopping term
  H psi(n) = sum_mu [U_mu(n) (1 - g_mu) psi(n + mu)
                     + conj(U_mu(n - mu)) (1 + g_mu) psi(n - mu)],
  g_0 = sigma_x, g_1 = sigma_y, and antiperiodic time boundaries (the
  t-links of the last time slice negated in D only);
- the even-odd Schur operator on the even sites,
  Dhat = m - H_eo H_oe / (4 m), m = m0 + 2, and the action
  S = beta sum_n (1 - cos theta_P(n)) + phi^+ (Dhat Dhat^+)^-1 phi,
  theta_P(n) = theta_0(n) + theta_1(n + t) - theta_0(n + x) - theta_1(n);
- or, under Hasenbusch mass preconditioning (hep-lat/0107019) with the
  heavy mass m1 = m0 + dm, two pseudofermions: phi1 = Dhat1 chi1 and
  phi2 = Dhat1^-1 Dhat0 chi2 (solved as Dhat1^+ (Dhat1 Dhat1^+)^-1 Dhat0
  chi2), and the fermion action
  phi1^+ (Dhat1 Dhat1^+)^-1 phi1 + (Dhat1 phi2)^+ (Dhat0 Dhat0^+)^-1 (Dhat1 phi2),
  which is |chi1|^2 + |chi2|^2 at the heat bath's theta;
- forces F = -dS/dtheta by automatic differentiation, at the exact solve;
- the leapfrog of the reference code (positions first, md_steps - 1 force
  evaluations, step tau / md_steps) and the Metropolis test r <= exp(-dH);
- the observables: mean plaquette, action density beta (1 - P), geometric
  charge (1 / 2 pi) sum_n arg P(n), and the chiral condensate
  mean_k Re(z_k^+ D^-1 z_k) / V over Z2xZ2 noise vectors z_k;
- the true relative residual ||b - Dhat Dhat^+ x|| / ||b|| of a given
  solve, in float64.

Every solve is of Dhat Dhat^+ to a relative residual `tol`, in the
working precision: plain conjugate gradient from x = 0, or with `direct`
the LU factors of each chain's Dhat as a dense matrix followed by passes
of refinement on the true residual (near the critical mass a CG to 1e-12
takes thousands of iterations a solve; the dense factors of a 32x32
lattice take a fixed time whatever the conditioning). A solve that does
not reach `tol` is flagged per chain, not raised.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class Precision(NamedTuple):
    real: torch.dtype           # the arithmetic, the Hamiltonian, the observables
    complex: torch.dtype
    tol: float                  # relative residual of every solve
    max_iter: int
    fields: torch.dtype         # what the angles and momenta are stored in


# the reference: float64 throughout, solves to 1e-12 (the harness gives
# max_iter the configuration's)
F64 = Precision(torch.float64, torch.complex128, 1e-12, 20000, torch.float64)
# its controls, one step below what the configuration states: F32 computes
# the float64 parts (Hamiltonian, observables, solves) in float32, the
# solves to the 1e-6 an f32 CG reaches, and keeps the float32 angles and
# momenta; LOW also stores those in bfloat16
F32 = Precision(torch.float32, torch.complex64, 1e-6, 20000, torch.float32)
LOW = F32._replace(fields=torch.bfloat16)
CONTROLS = {"f32": F32, "bf16_fields": LOW}


def wrap(a: torch.Tensor) -> torch.Tensor:
    """Angles folded to [-pi, pi]."""
    return a - 2.0 * math.pi * torch.round(a / (2.0 * math.pi))


def even_mask(Nx: int, Nt: int, device) -> torch.Tensor:
    x = torch.arange(Nx, device=device).reshape(Nx, 1)
    t = torch.arange(Nt, device=device).reshape(1, Nt)
    return (x + t) % 2 == 0


def from_packed(v: torch.Tensor, Nt: int, parity: int = 0) -> torch.Tensor:
    """[..., Nx, Nt/2] values of the sites of one parity (0 even, 1 odd), in
    the order of the noise stream and of the program's packed fields (row
    x, its k-th site at t = 2k + (x + parity) mod 2), placed on the full
    lattice [..., Nx, Nt] with zeros at the other parity."""
    *lead, Nx, Nth = v.shape
    full = torch.zeros((*lead, Nx, Nt), dtype=v.dtype, device=v.device)
    x = torch.arange(Nx, device=v.device).reshape(Nx, 1)
    t = 2 * torch.arange(Nth, device=v.device).reshape(1, Nth) + (x + parity) % 2
    full[..., x, t] = v
    return full


def even_from_packed(chi: torch.Tensor, Nt: int) -> torch.Tensor:
    """The even sites' values [..., 2, Nx, Nt/2] on the full lattice."""
    return from_packed(chi, Nt, 0)


def plaquette_angle(theta: torch.Tensor) -> torch.Tensor:
    t0, t1 = theta[..., 0, :, :], theta[..., 1, :, :]
    return t0 + torch.roll(t1, -1, -1) - torch.roll(t0, -1, -2) - t1


def gauge_action(theta, beta) -> torch.Tensor:
    return beta * (1.0 - torch.cos(plaquette_angle(theta))).sum(dim=(-2, -1))


def observables(theta: torch.Tensor, beta: float) -> dict:
    """Per-chain plaquette, action density and charge of theta [C, 2, Nx, Nt]."""
    tp = plaquette_angle(theta)
    P = torch.cos(tp).mean(dim=(-2, -1))
    return {"plaquette": P, "gauge_action_density": beta * (1.0 - P),
            "top_charge": wrap(tp).sum(dim=(-2, -1)) / (2.0 * math.pi)}


def fermion_links(theta: torch.Tensor, cdtype) -> torch.Tensor:
    """exp(i theta) [..., 2, Nx, Nt] with the last time slice's t-links
    negated (antiperiodic fermions in time)."""
    U = torch.polar(torch.ones_like(theta), theta).to(cdtype)
    sign = torch.ones(theta.shape[-1], dtype=theta.dtype, device=theta.device)
    sign[-1] = -1.0
    return torch.stack([U[..., 0, :, :] * sign, U[..., 1, :, :]], dim=-3)


def _project(psi, mu: int, s: float):
    """(1 + s g_mu) psi, psi [..., 2(spin), Nx, Nt]."""
    p0, p1 = psi[..., 0, :, :], psi[..., 1, :, :]
    if mu == 0:
        return torch.stack([p0 + s * p1, p1 + s * p0], dim=-3)
    return torch.stack([p0 - 1j * s * p1, p1 + 1j * s * p0], dim=-3)


def hop(U: torch.Tensor, psi: torch.Tensor, dagger: bool) -> torch.Tensor:
    """H psi, or H^+ psi (the projectors' signs swapped). U [..., 2, Nx, Nt]
    broadcasts against psi [..., 2(spin), Nx, Nt]."""
    s = 1.0 if dagger else -1.0
    out = 0
    for mu, axis in ((0, -1), (1, -2)):
        u = U[..., mu, :, :].unsqueeze(-3)
        out = out + u * torch.roll(_project(psi, mu, s), -1, axis)
        out = out + torch.roll(torch.conj(u) * _project(psi, mu, -s), 1, axis)
    return out


class Dirac:
    """D and its Schur operator on one configuration per chain (links U)."""

    def __init__(self, U: torch.Tensor, m0: float):
        self.U, self.m0, self.m = U, float(m0), float(m0) + 2.0
        self.c = 1.0 / (4.0 * self.m)

    def dhat(self, v):
        return self.m * v - self.c * hop(self.U, hop(self.U, v, False), False)

    def dhat_dag(self, v):
        return self.m * v - self.c * hop(self.U, hop(self.U, v, True), True)

    def normal(self, v):
        return self.dhat(self.dhat_dag(v))


def _dot(a, b):
    """Re <a, b> per system, over the last three axes."""
    return (torch.conj(a) * b).real.sum(dim=(-3, -2, -1))


def cg(A, b: torch.Tensor, prec: Precision):
    """(x, converged): x with ||b - A x|| < tol ||b|| per system (the last
    three axes), from x = 0; systems stop one by one. converged is False
    for a system that has not met tol in prec.max_iter iterations, whose x
    is the last iterate."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = _dot(r, r)
    stop = prec.tol ** 2 * rr
    shape = rr.shape + (1, 1, 1)
    for _ in range(prec.max_iter):
        active = ~(rr <= stop)
        if not bool(active.any()):
            break
        Ap = A(p)
        pAp = _dot(p, Ap)
        alpha = torch.where(active, rr / torch.where(active, pAp, 1.0), 0.0)
        x = x + alpha.reshape(shape) * p
        r = r - alpha.reshape(shape) * Ap
        rr_new = _dot(r, r)
        beta = torch.where(active, rr_new / torch.where(active, rr, 1.0), 0.0)
        p = torch.where(active.reshape(shape), r + beta.reshape(shape) * p, p)
        rr = torch.where(active, rr_new, rr)
    return x, rr <= stop


def even_sites(Nx: int, Nt: int, device) -> torch.Tensor:
    """Flat indices (x Nt + t) of the even sites, in row-major order."""
    return even_mask(Nx, Nt, device).reshape(-1).nonzero().squeeze(1)


def dense_dhat(op: Dirac, block: int = 8) -> torch.Tensor:
    """Dhat of each chain (op.U [C, 2, Nx, Nt]) as a matrix [C, n, n] on the
    even sites' spinors, n = Nx Nt: entry s V2 + k is spin s at the k-th
    even site (V2 of them); column j is Dhat of the j-th unit vector,
    applied to `block` chains at a time."""
    C, _, Nx, Nt = op.U.shape
    sites = even_sites(Nx, Nt, op.U.device)
    V2 = sites.numel()
    n = 2 * V2
    j = torch.arange(n, device=op.U.device)
    E = torch.zeros((n, 2, Nx * Nt), dtype=op.U.dtype, device=op.U.device)
    E[j, j // V2, sites.repeat(2)] = 1.0
    E = E.reshape(n, 2, Nx, Nt)
    out = []
    for c0 in range(0, C, block):
        sub = Dirac(op.U[c0:c0 + block].unsqueeze(1), op.m0)
        cols = sub.dhat(E).reshape(-1, n, 2, Nx * Nt)[..., sites]
        out.append(cols.reshape(-1, n, n).transpose(-1, -2))
    return torch.cat(out)


REFINE_PASSES = 8      # a Dhat whose LU leaves more is singular to rounding


def direct_solve(op: Dirac, b: torch.Tensor, prec: Precision):
    """(x, converged) of Dhat Dhat^+ x = b per chain, b [C, 2, Nx, Nt] on
    the even sites: x = Dhat^-+ Dhat^-1 b by the LU factors of each
    chain's dense Dhat, then up to REFINE_PASSES passes x += (the same
    factors) (b - Dhat Dhat^+ x), the residual taken by the stencil. A
    chain stops once its true residual is under tol ||b||; converged is
    False for one whose residual stays above 100 tol ||b||, for the true
    residual of a solve that near the critical mass carries a rounding
    floor above tol (1e-10, the configuration's contract, for F64)."""
    C, _, Nx, Nt = b.shape
    sites = even_sites(Nx, Nt, b.device)
    LU, piv = torch.linalg.lu_factor(dense_dhat(op))

    def inverse(v):
        w = v.reshape(C, 2, Nx * Nt)[..., sites].reshape(C, -1, 1)
        w = torch.linalg.lu_solve(LU, piv, torch.linalg.lu_solve(LU, piv, w),
                                  adjoint=True)
        out = torch.zeros_like(v).reshape(C, 2, Nx * Nt)
        out[..., sites] = w.reshape(C, 2, -1)
        return out.reshape(v.shape)

    bb = _dot(b, b)
    x = inverse(b)
    for k in range(REFINE_PASSES + 1):
        r = b - op.normal(x)
        rr = _dot(r, r)
        done = rr <= prec.tol ** 2 * bb
        if k == REFINE_PASSES or bool(done.all()):
            break
        x = torch.where(done.reshape(-1, 1, 1, 1), x, x + inverse(r))
    return x, rr <= (100.0 * prec.tol) ** 2 * bb


class Solver:
    """Solves of Dhat Dhat^+ on one configuration per chain (links U), at
    any mass: ``solve(m0, b) -> (x, converged)``."""

    def __init__(self, U: torch.Tensor, prec: Precision, direct: bool):
        self.U, self.prec, self.direct = U, prec, direct

    def op(self, m0: float) -> Dirac:
        return Dirac(self.U, m0)

    def solve(self, m0: float, b: torch.Tensor):
        op = self.op(m0)
        if self.direct:
            return direct_solve(op, b, self.prec)
        return cg(op.normal, b, self.prec)


class Pseudofermions(NamedTuple):
    """The heat bath's fields: phi at mass m0 (one pseudofermion), or phi1
    at m1 and phi2 (Hasenbusch, m1 set)."""
    m0: float
    m1: Optional[float]
    phi: torch.Tensor
    phi2: Optional[torch.Tensor]


def _force(theta, pf: Pseudofermions, beta, prec, direct):
    """(F = -dS/dtheta at theta, the fermion part at the exact solves; the
    solves' convergence [C]). With psi = (Dhat Dhat^+)^-1 phi and
    chi = Dhat^+ psi held fixed, -dS_f/dtheta of one pseudofermion is the
    derivative of 2 Re <psi, Dhat chi>; of the Hasenbusch ratio term, with
    y = (Dhat0 Dhat0^+)^-1 Dhat1 phi2 and chi0 = Dhat0^+ y, that of
    2 Re <y, Dhat0 chi0> - 2 Re <y, Dhat1 phi2>."""
    with torch.no_grad():
        sv = Solver(fermion_links(theta, prec.complex), prec, direct)
        if pf.m1 is None:
            psi, conv = sv.solve(pf.m0, pf.phi)
            terms = [(2.0, psi, pf.m0, sv.op(pf.m0).dhat_dag(psi))]
        else:
            psi, conv = sv.solve(pf.m1, pf.phi)
            y, conv2 = sv.solve(pf.m0, sv.op(pf.m1).dhat(pf.phi2))
            conv = conv & conv2
            terms = [(2.0, psi, pf.m1, sv.op(pf.m1).dhat_dag(psi)),
                     (2.0, y, pf.m0, sv.op(pf.m0).dhat_dag(y)),
                     (-2.0, y, pf.m1, pf.phi2)]
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        U = fermion_links(th, prec.complex)
        f = 0
        for coef, a, m, v in terms:
            f = f + coef * _dot(a, Dirac(U, m).dhat(v))
        f = f - gauge_action(th, beta)
        (grad,) = torch.autograd.grad(f.sum(), th)
    return grad, conv


class Solve(NamedTuple):
    """A solve of Dhat Dhat^+ x = b on the full lattice at mass m0: the
    angles of its operator and b, x on the even sites (zeros at the odd)."""
    theta: torch.Tensor
    b: torch.Tensor
    x: torch.Tensor
    m0: float


class Trajectory(NamedTuple):
    theta: torch.Tensor     # the proposal after the MD, folded [C, 2, Nx, Nt]
    dH: torch.Tensor        # [C]
    accept: torch.Tensor    # bool [C]
    action_solves: tuple    # the Metropolis action solves (Solve) at the proposal
    converged: torch.Tensor  # bool [C]: every solve of the chain met tol


def trajectory(theta, pi, chi_full, r, *, beta, m0, md_steps, tau, dm=None,
               prec: Precision = F64, direct: bool = False) -> Trajectory:
    """One HMC trajectory of every chain from theta with the momenta pi,
    the even-site pseudofermion noise chi_full (zeros at the odd sites;
    [C, 2, Nx, Nt], or under Hasenbusch, dm set, [C, 2 (chi1, chi2), 2,
    Nx, Nt]) and the Metropolis draw r, all given."""
    def store(x):
        return x.to(prec.fields).to(prec.real)

    th = store(theta.to(prec.real))
    p = store(pi.to(prec.real))
    chi = chi_full.to(prec.complex)
    sv = Solver(fermion_links(th, prec.complex), prec, direct)
    if dm is None:
        pf = Pseudofermions(m0, None, sv.op(m0).dhat(chi), None)
        conv = torch.ones(chi.shape[0], dtype=torch.bool, device=chi.device)
        S_old = _dot(chi, chi)
    else:
        m1 = m0 + dm
        x, conv = sv.solve(m1, sv.op(m0).dhat(chi[:, 1]))
        pf = Pseudofermions(m0, m1, sv.op(m1).dhat(chi[:, 0]),
                            sv.op(m1).dhat_dag(x))
        S_old = _dot(chi, chi).sum(dim=-1)
    H_old = 0.5 * (p ** 2).sum(dim=(1, 2, 3)) + gauge_action(th, beta) + S_old
    dt = tau / md_steps
    th = store(th + 0.5 * dt * p)
    F, ok = _force(th, pf, beta, prec, direct)
    conv = conv & ok
    for _ in range(md_steps - 2):
        p = store(p + dt * F)
        th = store(th + dt * p)
        F, ok = _force(th, pf, beta, prec, direct)
        conv = conv & ok
    p = store(p + dt * F)
    th = store(th + 0.5 * dt * p)
    sv = Solver(fermion_links(th, prec.complex), prec, direct)
    if dm is None:
        x, ok = sv.solve(m0, pf.phi)
        solves = (Solve(th, pf.phi, x, m0),)
        sf = _dot(pf.phi, x)
    else:
        x1, ok1 = sv.solve(pf.m1, pf.phi)
        b2 = sv.op(pf.m1).dhat(pf.phi2)
        x2, ok = sv.solve(m0, b2)
        ok = ok & ok1
        solves = (Solve(th, pf.phi, x1, pf.m1), Solve(th, b2, x2, m0))
        sf = _dot(pf.phi, x1) + _dot(b2, x2)
    conv = conv & ok
    H_new = 0.5 * (p ** 2).sum(dim=(1, 2, 3)) + gauge_action(th, beta) + sf
    dH = (H_new - H_old).double()
    return Trajectory(wrap(th), dH, r.double() <= torch.exp(-dH), solves, conv)


def residual(s: Solve) -> torch.Tensor:
    """Per chain, the true relative residual ||b - Dhat Dhat^+ x|| / ||b||
    of the solve `s`, worked out in float64 from its angles, b and x as
    they are."""
    op = Dirac(fermion_links(s.theta.double(), torch.complex128), s.m0)
    b = s.b.to(torch.complex128)
    r = b - op.normal(s.x.to(torch.complex128))
    return torch.sqrt(_dot(r, r) / _dot(b, b))


def packed_solve(thE, thO, b, x, m0: float) -> Solve:
    """A solve at mass m0 as the program passes it, on the full lattice:
    the angles of the even and the odd sites thE, thO [C, 2, Nx, Nt/2]; b
    and x planar [C, 2 (spin), 2 (re, im), Nx, Nt/2] on the even sites."""
    Nt = 2 * thE.shape[-1]

    def spinor(p):
        return from_packed(torch.complex(p[..., 0, :, :].double(),
                                         p[..., 1, :, :].double()), Nt)
    theta = from_packed(thE.double(), Nt, 0) + from_packed(thO.double(), Nt, 1)
    return Solve(theta, spinor(b), spinor(x), float(m0))


def dirac_inverse(U: torch.Tensor, z: torch.Tensor, m0: float,
                  prec: Precision) -> torch.Tensor:
    """D^-1 z by the Schur complement: Dhat x_e = z_e + H_eo z_o / (2m)
    solved as Dhat Dhat^+ y = b, x_e = Dhat^+ y; x_o = (z_o + H_oe x_e / 2)
    / m. U [..., 2, Nx, Nt] broadcasts against z [..., 2, Nx, Nt]."""
    op = Dirac(U, m0)
    Nx, Nt = z.shape[-2:]
    ev = even_mask(Nx, Nt, z.device)
    z_e, z_o = z * ev, z * ~ev
    b = z_e + (hop(U, z_o, False) * ev) / (2.0 * op.m)
    y, converged = cg(op.normal, b, prec)
    if not bool(converged.all()):
        raise RuntimeError(f"reference CG: no convergence in {prec.max_iter} "
                           "iterations")
    x_e = op.dhat_dag(y) * ev
    x_o = (z_o + 0.5 * hop(U, x_e, False) * ~ev) / op.m
    return x_e + x_o


def condensate(theta, z, m0, prec: Precision = F64, block: int = 256):
    """Per-chain (1/V) mean_k Re(z_k^+ D^-1 z_k) of theta [C, 2, Nx, Nt] and
    noise z [C, n_noise, 2, Nx, Nt], solved `block` systems at a time."""
    C, B = z.shape[:2]
    V = z.shape[-2] * z.shape[-1]
    U = fermion_links(theta.to(prec.real), prec.complex)
    per = max(1, block // B)
    out = []
    for c0 in range(0, C, per):
        zb = z[c0:c0 + per].to(prec.complex)
        w = dirac_inverse(U[c0:c0 + per].unsqueeze(1), zb, m0, prec)
        out.append(_dot(zb, w).mean(dim=1) / V)
    return torch.cat(out).double()
