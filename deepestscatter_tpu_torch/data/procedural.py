"""Procedural cloud density grids for tests and the chip smoke run.

A copy of the JAX package's numpy generator (same seeds give the same
grids): a union of soft ellipsoidal puffs modulated by value-noise fBm,
faded near the box boundary.
"""

from __future__ import annotations

import numpy as np


def _value_noise(shape, res, rng):
    """Trilinearly-interpolated lattice value noise with lattice size `res`."""
    lattice = rng.standard_normal((res + 1, res + 1, res + 1)).astype(np.float32)
    zs = np.linspace(0, res, shape[0], endpoint=False)
    ys = np.linspace(0, res, shape[1], endpoint=False)
    xs = np.linspace(0, res, shape[2], endpoint=False)
    z0, y0, x0 = np.floor(zs).astype(int), np.floor(ys).astype(int), np.floor(xs).astype(int)
    fz, fy, fx = zs - z0, ys - y0, xs - x0
    fz = fz[:, None, None]
    fy = fy[None, :, None]
    fx = fx[None, None, :]

    def g(dz, dy, dx):
        return lattice[np.ix_(z0 + dz, y0 + dy, x0 + dx)]

    c0 = g(0, 0, 0) * (1 - fx) + g(0, 0, 1) * fx
    c1 = g(0, 1, 0) * (1 - fx) + g(0, 1, 1) * fx
    c2 = g(1, 0, 0) * (1 - fx) + g(1, 0, 1) * fx
    c3 = g(1, 1, 0) * (1 - fx) + g(1, 1, 1) * fx
    d0 = c0 * (1 - fy) + c1 * fy
    d1 = c2 * (1 - fy) + c3 * fy
    return d0 * (1 - fz) + d1 * fz


def fbm(shape, rng, octaves: int = 4, base_res: int = 4) -> np.ndarray:
    out = np.zeros(shape, np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        res = min(base_res * (2**o), min(shape) // 2)
        out += amp * _value_noise(shape, max(res, 2), rng)
        total += amp
        amp *= 0.5
    return out / total


def cumulus(resolution: int = 128, seed: int = 0, n_puffs: int = 6) -> np.ndarray:
    """A cumulus-like [R, R, R] density grid in [0, 1]."""
    rng = np.random.default_rng(seed)
    shape = (resolution,) * 3
    zs, ys, xs = np.meshgrid(
        *(np.linspace(0, 1, resolution, dtype=np.float32),) * 3, indexing="ij"
    )
    density = np.zeros(shape, np.float32)
    for _ in range(n_puffs):
        center = rng.uniform(0.3, 0.7, 3).astype(np.float32)
        radii = rng.uniform(0.12, 0.28, 3).astype(np.float32)
        d2 = (
            ((zs - center[0]) / radii[0]) ** 2
            + ((ys - center[1]) / radii[1]) ** 2
            + ((xs - center[2]) / radii[2]) ** 2
        )
        density = np.maximum(density, np.exp(-1.5 * d2).astype(np.float32))
    noise = fbm(shape, rng, octaves=4)
    density *= np.clip(0.7 + 0.6 * noise, 0.0, 1.5)
    # Fade near the domain boundary so the cloud does not touch the box.
    edge = np.minimum.reduce(
        [zs, ys, xs, 1 - zs, 1 - ys, 1 - xs]
    )
    density *= np.clip(edge / 0.12, 0.0, 1.0) ** 2
    density = np.clip(density - 0.15, 0.0, None)
    m = density.max()
    return density / m if m > 0 else density
