"""Shared test helpers: tiny synthetic scenes + dense NumPy oracles.

The reference has no test suite (SURVEY.md §4); its de-facto oracle is the
CPU backend (`SCN/CPU/*.cpp` index_select + mm + index_add). These NumPy
oracles play the same role for this build.
"""

from __future__ import annotations

import numpy as np


def random_points(rng, num_points=500, extent=24, batch_size=2, pad_to=None):
    """Padded int32 point coords [P,4] (b,z,y,x) with duplicates."""
    b = rng.integers(0, batch_size, size=num_points)
    xyz = rng.integers(0, extent, size=(num_points, 3))
    pts = np.concatenate([b[:, None], xyz], axis=1).astype(np.int32)
    if pad_to is not None and pad_to > num_points:
        pad = -np.ones((pad_to - num_points, 4), np.int32)
        pts = np.concatenate([pts, pad], axis=0)
    return pts


def dense_from_sparse(coords, feats, extent, batch_size, channels):
    """Scatter sparse rows into a dense [B, E, E, E, C] float64 grid."""
    d = np.zeros((batch_size, extent, extent, extent, channels), np.float64)
    for r in range(coords.shape[0]):
        b, z, y, x = coords[r]
        if b < 0:
            continue
        d[b, z, y, x] = feats[r]
    return d


def dense_submanifold_conv(dense, active, weight):
    """Oracle submanifold conv: dense 3^3 conv evaluated ONLY at active sites
    (reference semantics, `SubmanifoldConvolutionRules.h:114-150`).

    dense [B,E,E,E,Cin], active bool [B,E,E,E], weight [27,Cin,Cout]
    (z-major offset order, offsets -1..1).
    """
    B, E = dense.shape[0], dense.shape[1]
    cout = weight.shape[2]
    out = np.zeros(dense.shape[:4] + (cout,), np.float64)
    k = 0
    acc = np.zeros_like(out)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                shifted = np.zeros_like(dense)
                zs = slice(max(0, -dz), E - max(0, dz))
                zd = slice(max(0, dz), E - max(0, -dz))
                ys = slice(max(0, -dy), E - max(0, dy))
                yd = slice(max(0, dy), E - max(0, -dy))
                xs = slice(max(0, -dx), E - max(0, dx))
                xd = slice(max(0, dx), E - max(0, -dx))
                shifted[:, zs, ys, xs] = dense[:, zd, yd, xd]
                acc += shifted @ weight[k]
                k += 1
    out = acc * active[..., None]
    return out


def dense_strided_conv(dense, weight, size=2, stride=2):
    """Oracle strided conv over the dense grid, output at every coarse cell
    that covers >= 1 active input (reference `ConvolutionRules.h:18-128`)."""
    B, E = dense.shape[0], dense.shape[1]
    cout = weight.shape[2]
    Eo = (E - 1) // stride + 1  # last output may have a partial window
    out = np.zeros((B, Eo, Eo, Eo, cout), np.float64)
    for jz in range(Eo):
        for jy in range(Eo):
            for jx in range(Eo):
                k = 0
                for dz in range(size):
                    for dy in range(size):
                        for dx in range(size):
                            z, y, x = (jz * stride + dz, jy * stride + dy,
                                       jx * stride + dx)
                            if z < E and y < E and x < E:
                                out[:, jz, jy, jx] += dense[:, z, y, x] @ weight[k]
                            k += 1
    return out
