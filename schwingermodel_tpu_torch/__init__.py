"""PyTorch + CUDA port of the Schwinger-model HMC (``schwingermodel_tpu``).

The port runs the JAX package's packed trajectory -- even-odd
pseudofermions, f32 working precision under the refined 1e-10 or the loose
solver contract, leapfrog or Omelyan, the Hasenbusch split, chronological
forecasting -- the condensate and meson measurements, and the
lattice-sharded trajectory on a mesh of shards, on an NVIDIA H100 through
hand-written CUDA kernels (``csrc/``, K1-K10). Each has a plain PyTorch
twin, which runs on CPU tensors. Off the packed path the unpacked sampler
(plain PyTorch around K6 and K7) runs full-D pseudofermions, quenched mode
and f64 working precision; step-size autotuning, the beta scan and
checkpoint/resume complete what the JAX sampler does on one device. The
package imports torch and numpy, never jax.

Entry points: ``runner.run_hmc`` and the CLI, ``python -m
schwingermodel_tpu_torch``; ``scan.run_beta_scan``; the tools ``python -m
schwingermodel_tpu_torch.tools.betascan`` and ``.bench_mxu_stencil``.
"""
