"""PyTorch + CUDA port of the Schwinger-model HMC (``schwingermodel_tpu``).

The port runs the main path of the JAX package -- even-odd pseudofermions,
f32 working precision under the refined 1e-10 solver contract, leapfrog,
chronological forecasting -- on an NVIDIA H100 through three hand-written
CUDA kernels (``csrc/``): the MD force step (K1), the reliable-update solve
(K3) and its f64 CG fallback (K4). Each has a plain PyTorch twin, which
runs on CPU tensors. The package imports torch and numpy, never jax.

Entry points: ``runner.run_hmc`` and the CLI, ``python -m
schwingermodel_tpu_torch``.
"""
