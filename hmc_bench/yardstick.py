"""The yardstick: the card's peaks, the work of the algorithm, rooflines.

Operations and bytes are counted from the lattice, the chains and the
iterations a run reports, whatever kernel carries the work out. Per-site
counts are of the even-odd stencil: a hop to one target site is 7 complex
products and 12 complex sums (66 flops); Dhat or Dhat^+ on an even site is
two hops and the a v + b h (140); the normal operator Dhat Dhat^+ 280; a
CG iteration is a normal apply, two dots and three axpys on 4 reals (320
a half-lattice site, 160 a lattice site).

How many solves and force evaluations a trajectory makes follows from the
configuration's physics (``solves_per_traj``, ``force_steps_per_traj``).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 rate, f32 and f64 outside the tensor cores
PEAK_BYTES, PEAK_F32, PEAK_F64 = 3.35e12, 67e12, 34e12

F_HOP, F_DHAT, F_NORMAL, F_CG_ITER = 66, 140, 280, 320
F_FORCE = 2 * 60          # the force stencil at one even and one odd site
F_PLAQ = 2 * 30 + 2 * 8   # both plaquette angles and the staple differences
F_LINKS = 4 * 20          # sincos of the four angles of an even/odd site pair
F_RESIDUAL = F_NORMAL + 8  # an f64 true residual b - A x and its norm


class Work:
    """Bytes and operations, summed; ``seconds()`` is the least time the
    card could take for them: the larger of bytes over the memory rate and
    f32 plus f64 operations over their peaks."""

    def __init__(self, bytes_=0.0, f32=0.0, f64=0.0):
        self.bytes, self.f32, self.f64 = float(bytes_), float(f32), float(f64)

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.f32 + other.f32,
                    self.f64 + other.f64)

    def __mul__(self, n: float) -> "Work":
        return Work(self.bytes * n, self.f32 * n, self.f64 * n)

    def seconds(self) -> float:
        return max(self.bytes / PEAK_BYTES,
                   self.f32 / PEAK_F32 + self.f64 / PEAK_F64)

    def compute_seconds(self) -> float:
        return self.f32 / PEAK_F32 + self.f64 / PEAK_F64


def refined_solves(C: int, V2: int, n_solves: int, iters: int) -> Work:
    """n_solves refined solves of C chains (each: its fields once, the f64
    links and two f64 normal applies for the true residuals) and `iters`
    f32 CG iterations summed over the chains."""
    per = Work(C * 96 * V2, 0.0, C * V2 * (F_LINKS + 2 * F_NORMAL))
    return per * n_solves + Work(0.0, V2 * F_CG_ITER * iters)


def hasenbusch(physics: dict) -> bool:
    """Whether the configuration splits the determinant (hasenbusch_dm set)."""
    return bool(physics.get("hasenbusch_dm"))


def force_steps_per_traj(physics: dict) -> int:
    """Force evaluations a trajectory: md_steps - 1 of the reference's
    leapfrog (positions first), 2 md_steps of Omelyan's 2MN."""
    md = int(physics["md_steps"])
    return md - 1 if physics.get("integrator", "leapfrog") == "leapfrog" else 2 * md


def solves_per_traj(physics: dict) -> int:
    """Refined solves a trajectory: one a force evaluation and the action
    solve; under Hasenbusch two a force evaluation (the heavy system and
    the ratio's light one), the heat bath's at m1 and two action solves
    (2 md_steps + 1 for the leapfrog)."""
    n = force_steps_per_traj(physics)
    return 2 * n + 3 if hasenbusch(physics) else n + 1


def force_steps(C: int, V2: int, n_steps: int, split: bool = False) -> Work:
    """n_steps force evaluations of C chains at given solutions: links,
    Dhat^+ psi, a hop, the force stencil and the staples. With `split`
    (Hasenbusch) each is that without the staples at m1 (K1), the ratio
    force with the staples (K5: the same stencil, its two bilinears folded
    into one) and the Dhat1 phi2 of the light system's right-hand side."""
    one = F_LINKS + F_DHAT + F_HOP + F_FORCE
    if split:
        return Work(C * 3 * 48 * V2,
                    C * V2 * (2 * one + F_PLAQ + F_DHAT)) * n_steps
    return Work(C * 48 * V2, C * V2 * (one + F_PLAQ)) * n_steps


def condensate_inner(C: int, B: int, V2: int, n_meas: int, iters: int) -> Work:
    """The f32 inner solves of n_meas condensate measurements of C chains and
    B noise vectors: each entry's fields and one normal apply a measurement,
    and `iters` CG iterations summed over the entries."""
    E = C * B
    per = Work(V2 * (E * 48 + C * 32), V2 * E * F_NORMAL)
    return per * n_meas + Work(0.0, V2 * F_CG_ITER * iters)


def condensate_residuals(C: int, B: int, V2: int, n_meas: int) -> Work:
    """The two f64 true residuals every entry needs a measurement (of x = 0
    and of the first pass's x)."""
    E = C * B
    per = Work(V2 * (E * 80 + C * 16), 0.0,
               V2 * (E * F_RESIDUAL + C * F_LINKS))
    return per * (2 * n_meas)
