"""nbodyhpc_tpu_torch — the PyTorch/CUDA port of :mod:`nbodyhpc_tpu`.

Runs the sphere-splat volume render on one NVIDIA Hopper GPU (H100) with
hand-written CUDA kernels, and on the CPU through their plain PyTorch
versions. The JAX package beside it is the reference every module here is
tested against; this package never imports JAX.

- :mod:`nbodyhpc_tpu_torch.rasterizer` — ``render_points`` /
  ``render_points_volume`` with the reference's API.
- :mod:`nbodyhpc_tpu_torch.ops` — the splat oracle, periodic ghosts, the
  dense large-radius pass and the tile engine (``ops/splat_cuda.py``).
"""

__version__ = "0.1.0"
