"""Full-fidelity checkpoint and resume.

Counterpart of ``schwingermodel_tpu/io/checkpoint.py``: one portable
``.npz`` per checkpoint with the gauge angles, the random-number root, the
trajectory counter, the accumulated observable chains and the run
configuration, in the JAX package's layout and ``FORMAT_VERSION``, so that
either package loads the other's file.

The port's noise is a function of (seed, stream, trajectory, chain)
(utils/prng.py), so the ``key`` array holds the root seed, as the two
32-bit words a threefry root key of that seed holds, and ``traj_index``
resumes the streams exactly. A key written by the JAX package is kept as
the opaque array it is: the port's streams start from ``run.seed``.

In a multi-process run (parallel/multihost.py) the primary writes the one
file, with every process's chains gathered into ``theta``; on resume every
process reads it and the runner takes the process's chains.

Fields that only the port's configuration has (``CGParams.cert_k``) are
stored under ``extra["torch_port"]``, not among the dataclass fields, which
the JAX loader passes to its own constructors; fields only JAX has
(``CGParams.refine_impl``) are dropped on load.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

from schwingermodel_tpu_torch.config import (
    CGParams, HMCParams, LatticeParams, RunParams,
)

FORMAT_VERSION = 1
_PORT_ONLY_CG = ("cert_k",)


def seed_key(seed: int) -> np.ndarray:
    """The root seed as a uint32[2] key array."""
    seed = int(seed)
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                      dtype=np.uint32)


def _known(cls, kw: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kw.items() if k in names}


def save_checkpoint(
    path: str,
    *,
    theta,
    key,
    traj_index: int,
    lattice: LatticeParams,
    hmc: HMCParams,
    run: RunParams,
    chains: dict | None = None,
    extra: dict | None = None,
) -> None:
    hmc_d = dataclasses.asdict(hmc)
    port_cg = {k: hmc_d["cg"].pop(k) for k in _PORT_ONLY_CG}
    meta = {
        "format_version": FORMAT_VERSION,
        "traj_index": int(traj_index),
        "lattice": dataclasses.asdict(lattice),
        "hmc": hmc_d,
        "run": dataclasses.asdict(run),
        "extra": {**(extra or {}), "torch_port": {"cg": port_cg}},
    }
    arrays: dict[str, Any] = {
        "theta": np.asarray(theta),
        "key": np.asarray(key),
        "meta_json": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    }
    for name, chain in (chains or {}).items():
        arrays[f"chain_{name}"] = np.asarray(chain, dtype=np.float64)
    # through a file object, so that the name is taken as given
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(path: str) -> dict:
    """Returns dict with theta, key, traj_index, lattice, hmc, run, chains,
    extra."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint from a newer format ({meta['format_version']})")
        extra = meta.get("extra", {})
        hmc_kw = dict(meta["hmc"])
        cg_kw = {**hmc_kw.pop("cg"), **extra.get("torch_port", {}).get("cg", {})}
        hmc_kw["cg"] = CGParams(**_known(CGParams, cg_kw))
        run_kw = dict(meta["run"])
        if run_kw.get("mesh_shape") is not None:
            run_kw["mesh_shape"] = tuple(run_kw["mesh_shape"])
        return {
            "theta": z["theta"],
            "key": z["key"],
            "traj_index": meta["traj_index"],
            "lattice": LatticeParams(**_known(LatticeParams, meta["lattice"])),
            "hmc": HMCParams(**_known(HMCParams, hmc_kw)),
            "run": RunParams(**_known(RunParams, run_kw)),
            "chains": {k[len("chain_"):]: z[k] for k in z.files
                       if k.startswith("chain_")},
            "extra": extra,
        }
