"""Particle snapshots made on the device from a seed.

A snapshot is a cube of Lagrangian lattice sites, taken in Morton order,
displaced by a Gaussian random field (the gradient of Gaussian-smoothed
white noise, scaled to a stated rms), with clumped halos (a seeded share of
coarse cells pulled in towards their centre) and wrapped into the periodic
box.  Velocities are a bulk flow, a linear term along the displacement and
a Gaussian dispersion that is larger in the halos.  IDs are the sites'
indices on the whole simulation's lattice: ``x + L*(y + L*z)``.

Every number comes from the configuration's ``generator`` group, and the
same seed gives the same particles: one ``torch.Generator`` on the device,
drawn from in a fixed order, in a few large calls."""

from __future__ import annotations

import math

import torch


def morton_sites(side: int, count: int, device) -> torch.Tensor:
    """The first ``count`` sites of a ``side``^3 cube in Morton order, as
    (3, count) int64 local coordinates (x, y, z)."""
    bits = max(1, (side - 1).bit_length())
    idx = torch.arange(side ** 3, dtype=torch.int64, device=device)
    x, y, z = idx % side, (idx // side) % side, idx // (side * side)
    del idx
    code = torch.zeros_like(x)
    for b in range(bits):
        code |= ((x >> b) & 1) << (3 * b)
        code |= ((y >> b) & 1) << (3 * b + 1)
        code |= ((z >> b) & 1) << (3 * b + 2)
    order = torch.argsort(code)[:count]
    del code
    return torch.stack([x[order], y[order], z[order]])


def _displacement(side: int, spacing: float, g: dict, gen, device):
    """(3, side, side, side) f32 displacement field in box units: the
    gradient of white noise smoothed by a Gaussian of radius
    ``smoothing``, each component scaled to rms ``rms_displacement``."""
    noise = torch.randn((side, side, side), generator=gen, device=device,
                        dtype=torch.float32)
    wk = torch.fft.rfftn(noise)
    del noise
    k_full = 2 * math.pi * torch.fft.fftfreq(side, device=device)
    k_half = 2 * math.pi * torch.fft.rfftfreq(side, device=device)
    r = float(g["smoothing"]) / spacing               # in sites
    kz, ky, kx = (k_full[:, None, None], k_full[None, :, None],
                  k_half[None, None, :])
    smooth = torch.exp(-0.5 * r * r * (kx * kx + ky * ky + kz * kz))
    wk *= smooth
    del smooth
    out = torch.empty((3, side, side, side), dtype=torch.float32,
                      device=device)
    for d, kd in enumerate((kx, ky, kz)):
        comp = torch.fft.irfftn(wk * (1j * kd), s=(side, side, side))
        comp *= float(g["rms_displacement"]) / comp.pow(2).mean().sqrt()
        out[d] = comp
        del comp
    return out


def make_particles(cfg: dict, seed: int, device) -> dict:
    """The configuration's particles: ``pos`` and ``vel`` (3, n) f32,
    ``ids`` (n,) int64 (u64 bits) on ``device``; n = cfg["particles"]
    plus cfg["padding"] (the client's padding to whole blocks)."""
    g = cfg["generator"]
    side = int(g["side"])
    lattice = int(g["lattice"])
    box = float(cfg["box"])
    spacing = box / lattice
    origin = [int(v) for v in g["origin_sites"]]
    n = int(cfg["particles"]) + int(cfg.get("padding", 0))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    disp = _displacement(side, spacing, g, gen, device).reshape(3, -1)
    sites = morton_sites(side, n, device)                   # (3, n) local
    psi = disp[:, sites[0] + side * (sites[1] + side * sites[2])]

    # halos: a seeded share of coarse cells, each pulled in towards its
    # centre, displaced as the cell's corner site is
    cell = int(g["halo_cell_sites"])
    cells_side = -(-side // cell)
    halo_cells = torch.rand(cells_side ** 3, generator=gen, device=device) \
        < float(g["halo_cell_share"])
    csite = sites // cell
    in_halo = halo_cells[csite[0] + cells_side * (csite[1] + cells_side *
                                                  csite[2])]
    corner = csite * cell
    psi_corner = disp[:, corner[0] + side * (corner[1] + side * corner[2])]
    del disp, corner, halo_cells
    q = (sites.to(torch.float32) + 0.5) * spacing
    qc = ((csite * cell + cell // 2).clamp_(max=side - 1).to(torch.float32)
          + 0.5) * spacing
    del csite

    noise = torch.randn((3, n), generator=gen, device=device)
    pos = q + psi
    halo_pos = qc + psi_corner + (q - qc) * float(g["halo_shrink"]) \
        + noise * float(g["halo_noise"])
    pos = torch.where(in_halo, halo_pos, pos)
    del halo_pos, psi_corner, qc, q
    pos += torch.tensor([float(v) * spacing for v in origin],
                        device=device)[:, None]
    pos = torch.remainder(pos, box)
    pos = torch.where(pos >= box, pos - box, pos)

    torch.randn((3, n), generator=gen, device=device, out=noise)
    bulk = torch.randn(3, generator=gen, device=device)
    bulk = bulk / bulk.norm() * float(g["bulk_flow"])
    sigma = torch.where(in_halo, float(g["halo_dispersion"]),
                        float(g["field_dispersion"]))
    vel = bulk[:, None] + psi * float(g["velocity_per_displacement"]) \
        + noise * sigma
    del noise, sigma, psi, in_halo

    gs = sites + torch.tensor(origin, dtype=torch.int64,
                              device=device)[:, None]
    ids = gs[0] + lattice * (gs[1] + lattice * gs[2])
    return {"pos": pos.contiguous(), "vel": vel.to(torch.float32)
            .contiguous(), "ids": ids.contiguous()}
