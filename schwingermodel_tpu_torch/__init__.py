"""PyTorch + CUDA port of the Schwinger-model HMC (``schwingermodel_tpu``).

The port runs the JAX package's packed trajectory -- even-odd
pseudofermions, f32 working precision under the refined 1e-10 or the loose
solver contract, leapfrog or Omelyan, the Hasenbusch split, chronological
forecasting -- and the condensate and meson measurements on an NVIDIA H100
through hand-written CUDA kernels (``csrc/``, K1-K6 and K9). Each has a
plain PyTorch twin, which runs on CPU tensors. The package imports torch
and numpy, never jax.

Entry points: ``runner.run_hmc`` and the CLI, ``python -m
schwingermodel_tpu_torch``.
"""
