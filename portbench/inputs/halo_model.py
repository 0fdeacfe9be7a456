"""Input generator ``halo_model``: a CAMELS-size dark-matter snapshot with
halos, and each particle's 32-neighbour smoothing length.

``snapshot(config, seed, device)`` makes, on the device from the seed:

- Background: a truncated Zel'dovich displacement (Coles, Melott &
  Shandarin 1993) of the ``particles`` lattice in a periodic box of ``box``
  Mpc/h. Linear power ``A k^n_s T^2(k)`` with the BBKS transfer function
  (Bardeen et al. 1986, shape ``Gamma = omega_m * hubble``), normalised to
  ``sigma_8`` at z = 0; the density modes times ``exp(-k^2 R_s^2 / 2)``,
  ``R_s = smoothing_mpc``. A seeded ``1 - halo_fraction`` of the lattice
  particles is kept.
- Halos: the other particles. Sizes ``n`` from ``dN/dn ~ n^-halo_slope`` on
  [``halo_n_min``, ``halo_n_max``], drawn until the total is reached, the last
  one trimmed; each centred on a seeded background particle, NFW to r200c
  with ``c200c = c0 (M / M_pivot)^slope`` (``concentration``: Duffy et al.
  2008), particle mass ``omega_m rho_crit box^3 / particles``, isotropic
  directions.
- Smoothing lengths ``h = (3 k / (4 pi n))^(1/3)``, ``k = neighbours``, with
  ``n`` the generator's own number density at the particle: for a halo
  particle its halo's NFW density plus the background; for a background
  particle a cloud-in-cell deposit of the background on a
  ``background_mesh``^3 mesh, interpolated back. The mesh is summed in fixed
  point, so a seed gives the same bits on every run.

Weights are unit (the step kind's). ``make(config, role, seed, device)``
returns the positions alone, as every generator does. Plain torch only.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

RHO_CRIT = 2.775e11  # critical density, (M_sun/h) / (Mpc/h)^3
DELTA_C = 200.0      # halo boundary: 200 times the critical density
CIC_ONE = float(1 << 24)  # fixed-point unit of a mesh weight


class Snapshot(NamedTuple):
    pos: torch.Tensor      # [N, 3] float32 in [0, box)
    hsml: torch.Tensor     # [N] float32 smoothing lengths, box units
    centres: torch.Tensor  # [H, 3] float32 halo centres, largest halo first
    sizes: torch.Tensor    # [H] int64 particles per halo, descending


def _bbks(q):
    return (torch.log1p(2.34 * q) / (2.34 * q)
            * (1 + 3.89 * q + (16.1 * q) ** 2 + (5.46 * q) ** 3
               + (6.71 * q) ** 4) ** -0.25)


def power_amplitude(config: dict) -> float:
    """``A`` of ``P(k) = A k^n_s T^2(k)`` giving ``sigma_8`` (k in h/Mpc)."""
    gamma = config["omega_m"] * config["hubble"]
    k = torch.logspace(-5, 3, 200_001, dtype=torch.float64)
    x = 8.0 * k
    win = 3 * (torch.sin(x) - x * torch.cos(x)) / x ** 3
    f = k ** 3 * k ** config["n_s"] * _bbks(k / gamma) ** 2 * win ** 2
    lnk = torch.log(k)
    integral = float(torch.trapezoid(f, lnk)) / (2 * math.pi ** 2)
    return config["sigma_8"] ** 2 / integral


def zeldovich(config: dict, n: int, gen, device) -> torch.Tensor:
    """[n^3, 3] float64 positions of the displaced lattice, in [0, box)."""
    L = float(config["box"])
    gamma = config["omega_m"] * config["hubble"]
    rs = float(config["smoothing_mpc"])
    noise = torch.randn((n, n, n), generator=gen, device=device)
    wk = torch.fft.rfftn(noise)
    kf = 2 * math.pi * torch.fft.fftfreq(n, d=L / n, device=device,
                                         dtype=torch.float64)
    kr = 2 * math.pi * torch.fft.rfftfreq(n, d=L / n, device=device,
                                          dtype=torch.float64)
    kx, ky, kz = kf[:, None, None], kf[None, :, None], kr[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    k = torch.sqrt(k2).clamp_min(1e-30)
    power = (power_amplitude(config) * k ** config["n_s"]
             * _bbks(k / gamma) ** 2)
    # <|delta_k|^2> = n^3 P / V for the DFT of a field with spectrum P
    amp = torch.sqrt(power * n ** 3 / L ** 3) * torch.exp(-0.5 * k2 * rs * rs)
    amp = torch.where(k2 > 0, amp / k2, 0.0)
    delta = wk.to(torch.complex128) * amp   # delta_k / k^2
    q = torch.arange(n, device=device, dtype=torch.float64) * (L / n)
    grid = torch.meshgrid(q, q, q, indexing="ij")
    out = torch.empty((n ** 3, 3), dtype=torch.float64, device=device)
    for a, ka in enumerate((kx, ky, kz)):
        # psi_k = i k delta_k / k^2, so that delta = -div psi
        psi = torch.fft.irfftn(1j * ka * delta, s=(n, n, n))
        out[:, a] = (grid[a] + psi).reshape(-1)
    return torch.remainder(out, L)


def halo_sizes(config: dict, total: int, gen, device) -> torch.Tensor:
    """Sizes from ``dN/dn ~ n^-slope`` on [n_min, n_max], drawn until they
    hold ``total`` particles, the last trimmed; int64 on ``device``."""
    a, b = float(config["halo_n_min"]), float(config["halo_n_max"])
    e = 1.0 - float(config["halo_slope"])
    mean = (e / (e + 1.0) * (b ** (e + 1) - a ** (e + 1))
            / (b ** e - a ** e))
    draws = []
    have = 0
    while have < total:
        u = torch.rand(int(2 * total / mean) + 64, generator=gen,
                       device=device, dtype=torch.float64)
        n = torch.floor((a ** e + u * (b ** e - a ** e)) ** (1.0 / e))
        draws.append(n.clamp(a, b).long())
        have += int(draws[-1].sum())
    sizes = torch.cat(draws)
    cum = torch.cumsum(sizes, 0)
    h = int(torch.searchsorted(cum, torch.tensor([total], device=device)))
    sizes = sizes[:h + 1].clone()
    sizes[h] -= int(cum[h]) - total
    return sizes


def _nfw_mass(x):
    return torch.log1p(x) - x / (1 + x)


def _cic(pos, L: float, m: int):
    """(flat cell indices [N, 8], fixed-point weights [N, 8]) of the
    cloud-in-cell assignment of ``pos`` to a periodic m^3 mesh."""
    g = pos * (m / L) - 0.5
    i0 = torch.floor(g)
    d = g - i0
    i0 = i0.long()
    idx, wts = [], []
    for corner in range(8):
        bits = [(corner >> a) & 1 for a in range(3)]
        w = torch.ones(pos.shape[0], dtype=pos.dtype, device=pos.device)
        flat = torch.zeros(pos.shape[0], dtype=torch.long, device=pos.device)
        for a, bit in enumerate(bits):
            w = w * (d[:, a] if bit else 1 - d[:, a])
            flat = flat * m + torch.remainder(i0[:, a] + bit, m)
        idx.append(flat)
        wts.append(torch.round(w * CIC_ONE).long())
    return torch.stack(idx, 1), torch.stack(wts, 1)


def background_density(bg, at, L: float, m: int):
    """Number density of the particles ``bg`` ((Mpc/h)^-3) by a CIC deposit
    on an m^3 mesh, interpolated back at the points ``at``."""
    idx, wts = _cic(bg, L, m)
    mesh = torch.zeros(m ** 3, dtype=torch.long, device=bg.device)
    mesh.index_add_(0, idx.reshape(-1), wts.reshape(-1))
    dens = mesh.double() / CIC_ONE / (L / m) ** 3
    idx, wts = _cic(at, L, m)
    return (dens[idx] * (wts.double() / CIC_ONE)).sum(1)


def snapshot(config: dict, seed: int, device) -> Snapshot:
    device = torch.device(device)
    L = float(config["box"])
    N = int(config["particles"])
    n = round(N ** (1.0 / 3.0))
    if n ** 3 != N:
        raise ValueError(f"halo_model: {N} particles are not a cubic lattice")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    lattice = zeldovich(config, n, gen, device)
    nh = round(N * float(config["halo_fraction"]))
    nb = N - nh
    bg = lattice[torch.randperm(N, generator=gen, device=device)[:nb]]
    del lattice

    sizes = halo_sizes(config, nh, gen, device)
    nhalo = sizes.shape[0]
    centres = bg[torch.randint(nb, (nhalo,), generator=gen, device=device)]
    m_p = config["omega_m"] * RHO_CRIT * L ** 3 / N
    mass = sizes.double() * m_p
    r200 = (3 * mass / (4 * math.pi * DELTA_C * RHO_CRIT)) ** (1.0 / 3.0)
    c0, slope, pivot = config["concentration"]
    conc = c0 * (mass / pivot) ** slope
    rscale = r200 / conc
    hid = torch.repeat_interleave(
        torch.arange(nhalo, device=device), sizes, output_size=nh)
    # radii: the NFW enclosed mass inverted by bisection on [0, c]
    target = torch.rand(nh, generator=gen, device=device,
                        dtype=torch.float64) * _nfw_mass(conc)[hid]
    lo = torch.zeros(nh, dtype=torch.float64, device=device)
    hi = conc[hid]
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        below = _nfw_mass(mid) < target
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    x = (0.5 * (lo + hi)).clamp_min(1e-6)
    direction = torch.randn((nh, 3), generator=gen, device=device,
                            dtype=torch.float64)
    direction = direction / direction.norm(dim=1, keepdim=True)
    halo = torch.remainder(
        centres[hid] + (x * rscale[hid])[:, None] * direction, L)

    k = float(config["neighbours"])
    m = int(config["background_mesh"])
    nfw = (sizes.double()[hid]
           / (4 * math.pi * rscale[hid] ** 3 * _nfw_mass(conc)[hid])
           / (x * (1 + x) ** 2))
    dens = background_density(bg, torch.cat([bg, halo]), L, m)
    dens[nb:] += nfw
    hsml = (3 * k / (4 * math.pi * dens)) ** (1.0 / 3.0)

    pos = torch.cat([bg, halo]).float()
    pos = torch.where(pos >= L, pos - L, pos)
    order = torch.argsort(sizes, descending=True, stable=True)
    return Snapshot(pos, hsml.float(), centres[order].float(), sizes[order])


def make(config: dict, role: str, seed: int, device) -> torch.Tensor:
    if role != "particles":
        raise ValueError(f"halo_model: no {role!r}, only particles")
    return snapshot(config, seed, device).pos

