"""Input generator ``uniform``: points uniform in the periodic box.

``make(config, role, seed, device)``: ``config[role]`` points (``role`` is
"particles" for a render, "points" for a k-NN tree), float32 in
``[0, box)``, made on the device from the seed (the upstream harnesses'
uniform sets, kdtree/src/cpp/main.cpp:130-136 and bench.py's render set).
"""
from __future__ import annotations

import torch


def make(config: dict, role: str, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand((int(config[role]), 3), generator=gen,
                      device=device) * float(config["box"])
