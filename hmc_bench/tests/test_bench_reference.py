"""The plain reference against the port at 8x8 on the CPU, and its
independence: it imports nothing of the program."""

import ast
import math
from pathlib import Path

import pytest
import torch

from hmc_bench.reference import lattice as ref
from hmc_bench.reference import philox

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


def _port(**physics):
    from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel

    kw = dict(beta=4.0, m0=0.2, md_steps=10, trajectory_length=0.1)
    kw.update(physics)
    h = HMCParams(**kw, even_odd=True, cg=CGParams(tol=1e-10, refine=True))
    return SchwingerModel(lattice=LatticeParams(Nx=8, Nt=8), hmc=h)


NEARCRIT = dict(beta=2.0, m0=-0.19, md_steps=26, trajectory_length=1.0,
                hasenbusch_dm=0.4)


def _theta(C, seed=0):
    g = torch.Generator().manual_seed(seed)
    return ((2 * torch.rand((C, 2, 8, 8), generator=g) - 1) * 0.3 * math.pi).float()


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] in {"torch", "math", "typing", "__future__"}, \
                    f"{path.name} imports {n}"


@pytest.mark.parametrize("seed,traj", [(5, 0), (2**31 + 11, 37), (2**40 + 3, 2**33 + 1)])
def test_noise_streams_equal_the_ports(seed, traj):
    from schwingermodel_tpu_torch.hmc.sampler import draw_chain_noise
    from schwingermodel_tpu_torch.observables import condensate_noise

    model = _port()
    pi, chi, r = draw_chain_noise(model, seed, traj, 3, "cpu")
    rpi, rchi, rr = philox.trajectory_noise(seed, traj, 3, 128, 64, "cpu")
    assert torch.equal(pi.reshape(3, -1), rpi)
    assert torch.equal(chi.reshape(3, -1), rchi)
    assert torch.equal(r, rr)
    z = condensate_noise(seed, traj % 1000, 3, (3, 2, 8, 8), 4, "cpu")
    assert torch.equal(z, philox.z2_noise(seed, traj % 1000, 3, 4, 128, "cpu")
                       .reshape(3, 4, 2, 8, 8))


def test_schur_operator_adjoint_and_inverse():
    g = torch.Generator().manual_seed(1)
    th = _theta(2).double()
    U = ref.fermion_links(th, torch.complex128)
    op = ref.Dirac(U, 0.2)
    ev = ref.even_mask(8, 8, "cpu")
    a = torch.complex(torch.randn(2, 2, 8, 8, generator=g, dtype=torch.float64),
                      torch.randn(2, 2, 8, 8, generator=g, dtype=torch.float64)) * ev
    b = torch.complex(torch.randn(2, 2, 8, 8, generator=g, dtype=torch.float64),
                      torch.randn(2, 2, 8, 8, generator=g, dtype=torch.float64)) * ev
    lhs = (a.conj() * op.dhat(b)).sum(dim=(1, 2, 3))
    rhs = (op.dhat_dag(a).conj() * b).sum(dim=(1, 2, 3))
    assert torch.allclose(lhs, rhs, rtol=1e-12, atol=1e-12)
    # D^-1 by the Schur complement against the full-lattice D
    z = torch.complex(torch.randn(2, 2, 8, 8, generator=g, dtype=torch.float64),
                      torch.randn(2, 2, 8, 8, generator=g, dtype=torch.float64))
    x = ref.dirac_inverse(U, z, 0.2, ref.F64)
    Dx = (0.2 + 2.0) * x - 0.5 * ref.hop(U, x, False)
    assert float((Dx - z).abs().max()) < 1e-9


def test_trajectory_and_measurements_agree_with_the_port():
    from schwingermodel_tpu_torch import observables as obs
    from schwingermodel_tpu_torch.hmc import packed as hp
    from schwingermodel_tpu_torch.hmc.sampler import draw_chain_noise

    model = _port()
    C, seed, traj = 3, 123456789012, 37
    theta = _theta(C)
    pi, chi, r = draw_chain_noise(model, seed, traj, C, "cpu")
    th_new, st = hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
    out = ref.trajectory(theta, pi, ref.even_from_packed(chi, 8), r, beta=4.0,
                         m0=0.2, md_steps=10, tau=0.1)
    assert torch.equal(out.accept, st.accepted)
    assert float((out.dH - st.delta_H).abs().max()) < 1e-4
    kept = torch.where(out.accept.reshape(-1, 1, 1, 1), out.theta, theta.double())
    assert float(ref.wrap(th_new.double() - kept).abs().max()) < 1e-5
    got = obs.measure_all(model, th_new)
    for k, v in ref.observables(th_new.double(), 4.0).items():
        assert float((got[k] - v).abs().max()) < 1e-12, k
    cc = obs.chiral_condensate(model, th_new, seed, 5, 4).value
    z = philox.z2_noise(seed, 5, C, 4, 128, "cpu").reshape(C, 4, 2, 8, 8)
    assert float(((cc - ref.condensate(th_new.double(), z, 0.2)) / cc).abs().max()) < 1e-7


def test_control_reads_above_the_reference():
    """The control's observables (in float32) depart from the float64
    reference by more than the program does, on the observables."""
    th = _theta(2)
    exact = ref.observables(th.double(), 4.0)
    low = ref.observables(th, 4.0)
    assert max(float((low[k].double() - exact[k]).abs().max()) for k in exact) > 1e-9


def test_control_trajectory_departs_in_theta_and_dH():
    """The control stores angles and momenta in bfloat16 and computes in
    float32: its trajectory departs from the float64 one far beyond the
    float32 program's rounding."""
    from schwingermodel_tpu_torch.hmc.sampler import draw_chain_noise

    C, seed, traj = 2, 99, 4
    theta = _theta(C)
    pi, chi, r = draw_chain_noise(_port(), seed, traj, C, "cpu")
    kw = dict(beta=4.0, m0=0.2, md_steps=10, tau=0.1)
    chi_full = ref.even_from_packed(chi, 8)
    exact = ref.trajectory(theta, pi, chi_full, r, **kw)
    low = ref.trajectory(theta, pi, chi_full, r, prec=ref.LOW, **kw)
    assert float(ref.wrap(low.theta.double() - exact.theta).abs().max()) > 1e-4
    assert float((low.dH - exact.dH).abs().max()) > 1e-4


def test_packed_fields_land_on_their_sites():
    from schwingermodel_tpu_torch.ops import eo
    from schwingermodel_tpu_torch.ops import traj as tr

    th = _theta(2).double()
    E, O = tr.pack_planes(th)
    assert torch.equal(ref.from_packed(E, 8, 0) + ref.from_packed(O, 8, 1), th)
    assert torch.equal(eo.unpack(E, O), th)


@pytest.mark.parametrize("refined", [True, False])
def test_residual_reads_the_ports_contract(refined):
    """The true residual of the port's action solve at 8x8: under 1e-10
    on the refined contract, far above it on the loose f32 one at 1e-6."""
    from schwingermodel_tpu_torch.ops import refined as rs
    from schwingermodel_tpu_torch.ops import traj as tr

    th = _theta(3, seed=4)
    thE, thO = tr.pack_planes(th)
    g = torch.Generator().manual_seed(2)
    b = torch.randn((3, 2, 2, 8, 4), generator=g)
    if refined:
        x = rs.solve_refined(thE, thO, b, b, m0=0.2, tol=1e-10).x64
    else:
        x = tr.solve_fused(thE, thO, b, b, m0=0.2, tol=1e-6, max_iter=1000).x
    res = ref.residual(ref.packed_solve(thE, thO, b, x, 0.2))
    if refined:
        assert float(res.max()) < 1e-10
    else:
        assert 1e-8 < float(res.max()) < 1e-5


def test_the_reference_without_hasenbusch_is_as_before():
    """The one-pseudofermion trajectory, bit for bit the float64 reference's
    before the Hasenbusch split was added (its dH and sums of the proposal
    as then computed on this fixed input)."""
    C = 3
    pi, chi, r = philox.trajectory_noise(123456789012, 37, C, 128, 64, "cpu")
    out = ref.trajectory(_theta(C), pi.reshape(C, 2, 8, 8),
                         ref.even_from_packed(chi.reshape(C, 2, 8, 4), 8), r,
                         beta=4.0, m0=0.2, md_steps=10, tau=0.1,
                         prec=ref.F64._replace(max_iter=10000))
    assert [v.hex() for v in out.dH.tolist()] == [
        "0x1.2b962e7be0000p-9", "0x1.3033614120000p-10", "0x1.ab5ed35db0000p-9"]
    assert out.theta.sum().item().hex() == "-0x1.e8c946a17ad1cp+2"
    assert out.theta.abs().sum().item().hex() == "0x1.6377b57c69f77p+7"
    assert out.converged.all()
    assert [s.m0 for s in out.action_solves] == [0.2]


@pytest.mark.parametrize("seed,traj", [(5, 0), (2**40 + 3, 2**33 + 1)])
def test_hasenbusch_noise_layout_equals_the_ports(seed, traj):
    """Under Hasenbusch chi is [C, 2 (chi1, chi2), 2 (spin), Nx, Nt/2] of
    twice the elements, in the order of the port's noise draw."""
    from schwingermodel_tpu_torch.hmc.sampler import draw_chain_noise

    model = _port(**NEARCRIT)
    shape = model.chi_shape((2, 8, 8))
    assert shape == (2, 2, 8, 4)
    pi, chi, r = draw_chain_noise(model, seed, traj, 3, "cpu")
    rpi, rchi, rr = philox.trajectory_noise(seed, traj, 3, 128, 128, "cpu")
    assert torch.equal(chi, rchi.reshape(3, *shape))
    assert torch.equal(pi.reshape(3, -1), rpi)
    assert torch.equal(r, rr)


@pytest.mark.parametrize("direct", [False, True])
def test_hasenbusch_trajectory_agrees_with_the_port(direct):
    """The reference's Hasenbusch trajectory (CG or the dense direct solve)
    against the port's packed one with the same noise, near the critical
    mass: dH to the float32 MD's rounding, the same decisions, theta."""
    from schwingermodel_tpu_torch.hmc import packed as hp
    from schwingermodel_tpu_torch.hmc.sampler import draw_chain_noise

    model = _port(**NEARCRIT)
    C = 3
    theta = _theta(C)
    pi, chi, r = draw_chain_noise(model, 12345, 7, C, "cpu")
    th_new, st = hp.trajectory_packed_given_noise(model, theta, pi, chi, r)
    out = ref.trajectory(theta, pi, ref.even_from_packed(chi, 8), r, beta=2.0,
                         m0=-0.19, md_steps=26, tau=1.0, dm=0.4, direct=direct)
    assert st.cg_converged.all() and out.converged.all()
    assert torch.equal(out.accept, st.accepted)
    assert float((out.dH - st.delta_H).abs().max()) < 1e-4
    kept = torch.where(out.accept.reshape(-1, 1, 1, 1), out.theta, theta.double())
    assert float(ref.wrap(th_new.double() - kept).abs().max()) < 1e-5
    assert [s.m0 for s in out.action_solves] == [pytest.approx(0.21), -0.19]
    assert max(float(ref.residual(s).max()) for s in out.action_solves) < 1e-12


def test_hasenbusch_force_is_minus_the_action_gradient():
    """The force of both Hasenbusch terms against central differences of
    the action phi1^+ (D1 D1^+)^-1 phi1 + (D1 phi2)^+ (D0 D0^+)^-1 (D1 phi2)
    plus the gauge action, at 4x4; and the action at the heat bath's theta
    is |chi1|^2 + |chi2|^2 plus the gauge action."""
    g = torch.Generator().manual_seed(3)
    n, m0, m1, beta = 4, -0.19, 0.21, 2.0
    th = (2 * torch.rand((1, 2, n, n), generator=g, dtype=torch.float64) - 1) * 0.5
    chi = torch.complex(torch.randn(1, 2, 2, n, n, generator=g, dtype=torch.float64),
                        torch.randn(1, 2, 2, n, n, generator=g, dtype=torch.float64))
    chi = chi * ref.even_mask(n, n, "cpu")
    sv = ref.Solver(ref.fermion_links(th, torch.complex128), ref.F64, True)
    x, _ = sv.solve(m1, sv.op(m0).dhat(chi[:, 1]))
    pf = ref.Pseudofermions(m0, m1, sv.op(m1).dhat(chi[:, 0]), sv.op(m1).dhat_dag(x))

    def action(t):
        s = ref.Solver(ref.fermion_links(t, torch.complex128), ref.F64, False)
        x1, _ = s.solve(m1, pf.phi)
        b2 = s.op(m1).dhat(pf.phi2)
        x2, _ = s.solve(m0, b2)
        return float(ref.gauge_action(t, beta).sum()
                     + (torch.conj(pf.phi) * x1).real.sum()
                     + (torch.conj(b2) * x2).real.sum())

    exact = float(ref.gauge_action(th, beta).sum() + (chi.abs() ** 2).sum())
    assert action(th) == pytest.approx(exact, rel=1e-12)
    F, conv = ref._force(th, pf, beta, ref.F64, False)
    assert conv.all()
    e = 1e-6
    for idx in [(0, 0, 1, 2), (0, 1, 3, 0), (0, 0, 0, 0), (0, 1, 2, 3)]:
        up, down = th.clone(), th.clone()
        up[idx] += e
        down[idx] -= e
        assert float(F[idx]) == pytest.approx(-(action(up) - action(down)) / (2 * e),
                                               rel=1e-6, abs=1e-8)


def test_solves_flag_what_they_do_not_converge():
    """A CG out of iterations and a direct solve of a singular Dhat flag
    their chains and return; the direct solve meets the CG's answer."""
    th = _theta(2, seed=6).double()
    U = ref.fermion_links(th, torch.complex128)
    g = torch.Generator().manual_seed(8)
    b = torch.complex(torch.randn(2, 2, 8, 8, generator=g, dtype=torch.float64),
                      torch.randn(2, 2, 8, 8, generator=g, dtype=torch.float64))
    b = b * ref.even_mask(8, 8, "cpu")
    x, conv = ref.Solver(U, ref.F64, False).solve(-0.1, b)
    xd, convd = ref.Solver(U, ref.F64, True).solve(-0.1, b)
    assert conv.all() and convd.all()
    assert float(((x - xd).abs() ** 2).sum().sqrt() / (x.abs() ** 2).sum().sqrt()) < 1e-9
    short, conv = ref.Solver(U, ref.F64._replace(max_iter=3), False).solve(-0.1, b)
    assert not conv.any()
    # a chain whose links are not finite (an MD blow-up's end) is flagged
    # alone, by either solve
    bad = th.clone()
    bad[0, 0, 3, 3] = float("nan")
    U = ref.fermion_links(bad, torch.complex128)
    for direct in (False, True):
        x, conv = ref.Solver(U, ref.F64._replace(max_iter=200), direct).solve(-0.1, b)
        assert conv.tolist() == [False, True]
