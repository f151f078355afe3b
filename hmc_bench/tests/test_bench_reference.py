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


def _port():
    from schwingermodel_tpu_torch.config import CGParams, HMCParams, LatticeParams
    from schwingermodel_tpu_torch.models.schwinger import SchwingerModel

    h = HMCParams(beta=4.0, m0=0.2, md_steps=10, trajectory_length=0.1,
                  even_odd=True, cg=CGParams(tol=1e-10, refine=True))
    return SchwingerModel(lattice=LatticeParams(Nx=8, Nt=8), hmc=h)


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
    res = ref.residual(ref.packed_solve(thE, thO, b, x), 0.2)
    if refined:
        assert float(res.max()) < 1e-10
    else:
        assert 1e-8 < float(res.max()) < 1e-5
