"""nbodyhpc_tpu_torch — the PyTorch/CUDA port of :mod:`nbodyhpc_tpu`.

Runs the sphere-splat volume render on one NVIDIA Hopper GPU (H100) with
hand-written CUDA kernels, and on the CPU through their plain PyTorch
versions. The JAX package beside it is the reference every module here is
tested against; this package never imports JAX.

- :mod:`nbodyhpc_tpu_torch.rasterizer` — ``render_points`` /
  ``render_points_volume`` with the reference's API.
- :mod:`nbodyhpc_tpu_torch.ops` — the splat oracle, periodic ghosts, the
  dense large-radius pass and the tile engine (``ops/splat_cuda.py``).
- :mod:`nbodyhpc_tpu_torch.kdtree` — the periodic k-NN engine.

The entry points (``rasterizer.Container``, ``kdtree.KDTree``) run on the
card unless the caller names another device: a CPU run passes
``device="cpu"``.
"""

__version__ = "0.1.0"


def default_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means the card. Raises
    ``RuntimeError`` for ``None`` when no CUDA device is present, never
    falling back to the CPU on its own."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            'device="cpu" to run on the CPU')
    return torch.device("cuda")
