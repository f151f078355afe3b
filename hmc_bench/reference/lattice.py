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
- forces F = -dS/dtheta by automatic differentiation, at the exact solve;
- the leapfrog of the reference code (positions first, md_steps - 1 force
  evaluations, step tau / md_steps) and the Metropolis test r <= exp(-dH);
- the observables: mean plaquette, action density beta (1 - P), geometric
  charge (1 / 2 pi) sum_n arg P(n), and the chiral condensate
  mean_k Re(z_k^+ D^-1 z_k) / V over Z2xZ2 noise vectors z_k;
- the true relative residual ||b - Dhat Dhat^+ x|| / ||b|| of a given
  solve, in float64.

Every solve is plain conjugate gradient on Dhat Dhat^+ to a relative
residual `tol`, in the working precision.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Precision(NamedTuple):
    real: torch.dtype           # the arithmetic, the Hamiltonian, the observables
    complex: torch.dtype
    tol: float                  # relative residual of every solve
    max_iter: int
    fields: torch.dtype         # what the angles and momenta are stored in


# the reference: float64 throughout, solves to 1e-12
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
        self.U, self.m = U, float(m0) + 2.0
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


def cg(A, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """x with ||b - A x|| < tol ||b|| per system (the last three axes), from
    x = 0; systems stop one by one. Raises where one has not converged."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = _dot(r, r)
    stop = prec.tol ** 2 * rr
    shape = rr.shape + (1, 1, 1)
    for _ in range(prec.max_iter):
        active = rr > stop
        if not bool(active.any()):
            return x
        Ap = A(p)
        pAp = _dot(p, Ap)
        alpha = torch.where(active, rr / torch.where(active, pAp, 1.0), 0.0)
        x = x + alpha.reshape(shape) * p
        r = r - alpha.reshape(shape) * Ap
        rr_new = _dot(r, r)
        beta = torch.where(active, rr_new / torch.where(active, rr, 1.0), 0.0)
        p = torch.where(active.reshape(shape), r + beta.reshape(shape) * p, p)
        rr = torch.where(active, rr_new, rr)
    raise RuntimeError(f"reference CG: no convergence in {prec.max_iter} iterations")


def _force(theta, phi, beta, m0, prec):
    """F = -dS/dtheta at theta, the fermion part at the exact solve."""
    with torch.no_grad():
        op = Dirac(fermion_links(theta, prec.complex), m0)
        psi = cg(op.normal, phi, prec)
        chi = op.dhat_dag(psi)
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        op = Dirac(fermion_links(th, prec.complex), m0)
        f = 2.0 * _dot(psi, op.dhat(chi)) - gauge_action(th, beta)
        (grad,) = torch.autograd.grad(f.sum(), th)
    return grad


class Solve(NamedTuple):
    """A solve of Dhat Dhat^+ x = b on the full lattice: the angles of its
    operator and b, x on the even sites (zeros at the odd)."""
    theta: torch.Tensor
    b: torch.Tensor
    x: torch.Tensor


class Trajectory(NamedTuple):
    theta: torch.Tensor     # the proposal after the MD, folded [C, 2, Nx, Nt]
    dH: torch.Tensor        # [C]
    accept: torch.Tensor    # bool [C]
    action_solve: Solve     # the Metropolis action solve at the proposal


def trajectory(theta, pi, chi_full, r, *, beta, m0, md_steps, tau,
               prec: Precision = F64) -> Trajectory:
    """One HMC trajectory of every chain from theta with the momenta pi,
    the even-site pseudofermion noise chi_full (zeros at the odd sites) and
    the Metropolis draw r, all given."""
    def store(x):
        return x.to(prec.fields).to(prec.real)

    th = store(theta.to(prec.real))
    p = store(pi.to(prec.real))
    chi = chi_full.to(prec.complex)
    op = Dirac(fermion_links(th, prec.complex), m0)
    phi = op.dhat(chi)
    H_old = 0.5 * (p ** 2).sum(dim=(1, 2, 3)) + gauge_action(th, beta) \
        + _dot(chi, chi)
    dt = tau / md_steps
    th = store(th + 0.5 * dt * p)
    F = _force(th, phi, beta, m0, prec)
    for _ in range(md_steps - 2):
        p = store(p + dt * F)
        th = store(th + dt * p)
        F = _force(th, phi, beta, m0, prec)
    p = store(p + dt * F)
    th = store(th + 0.5 * dt * p)
    op = Dirac(fermion_links(th, prec.complex), m0)
    x = cg(op.normal, phi, prec)
    sf = _dot(phi, x)
    H_new = 0.5 * (p ** 2).sum(dim=(1, 2, 3)) + gauge_action(th, beta) + sf
    dH = (H_new - H_old).double()
    return Trajectory(wrap(th), dH, r.double() <= torch.exp(-dH),
                      Solve(th, phi, x))


def residual(s: Solve, m0: float) -> torch.Tensor:
    """Per chain, the true relative residual ||b - Dhat Dhat^+ x|| / ||b||
    of the solve `s`, worked out in float64 from its angles, b and x as
    they are."""
    op = Dirac(fermion_links(s.theta.double(), torch.complex128), m0)
    b = s.b.to(torch.complex128)
    r = b - op.normal(s.x.to(torch.complex128))
    return torch.sqrt(_dot(r, r) / _dot(b, b))


def packed_solve(thE, thO, b, x) -> Solve:
    """A solve as the program passes it, on the full lattice: the angles of
    the even and the odd sites thE, thO [C, 2, Nx, Nt/2]; b and x planar
    [C, 2 (spin), 2 (re, im), Nx, Nt/2] on the even sites."""
    Nt = 2 * thE.shape[-1]

    def spinor(p):
        return from_packed(torch.complex(p[..., 0, :, :].double(),
                                         p[..., 1, :, :].double()), Nt)
    theta = from_packed(thE.double(), Nt, 0) + from_packed(thO.double(), Nt, 1)
    return Solve(theta, spinor(b), spinor(x))


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
    x_e = op.dhat_dag(cg(op.normal, b, prec)) * ev
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
