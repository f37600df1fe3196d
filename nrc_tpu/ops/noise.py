"""Procedural 3D noise fields evaluated AT SHADE TIME (pure elementwise math).

The reference's ``noise_*_glossy.mdl`` materials drive their diffuse tint
(and a bump) through the MDL base module's procedural noises —
``base::perlin_noise_texture`` / ``flow_noise_texture`` /
``worley_noise_texture`` over WORLD-space coordinates
(``data/mdl/noise_perlin_glossy.mdl``; evaluated by MDL-JIT-generated
device code in the reference). Here: evaluate the noise
directly in the wavefront shader — position-driven elementwise math, no
tables, no gathers.

These are faithful re-implementations of the standard algorithms (Perlin
gradient noise with fBm octaves, Worley cellular F1), not bit-level ports
of the MDL SDK's ``libbsdf`` internals — the pattern statistics match, the
exact lattice hashes differ (documented in PARITY.md).
"""

from __future__ import annotations

import jax.numpy as jnp


def _hash3(ix, iy, iz):
    """Lattice hash -> u32 (TEA-flavored integer mix, cheap + uniform)."""
    h = (
        ix.astype(jnp.uint32) * jnp.uint32(0x8DA6B343)
        + iy.astype(jnp.uint32) * jnp.uint32(0xD8163841)
        + iz.astype(jnp.uint32) * jnp.uint32(0xCB1AB31F)
    )
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0x9E3779B1)
    h = h ^ (h >> 16)
    return h


def _grad_dot(ix, iy, iz, fx, fy, fz):
    """dot(gradient(corner), offset) with 12 cube-edge gradients."""
    h = _hash3(ix, iy, iz) % jnp.uint32(12)
    # 12 edge gradients of the cube (Perlin's set)
    gx = jnp.where(h < 8, jnp.where((h & 1) == 0, 1.0, -1.0), 0.0)
    gy = jnp.where(
        h < 4, jnp.where((h & 2) == 0, 1.0, -1.0),
        jnp.where(h >= 8, jnp.where((h & 1) == 0, 1.0, -1.0), 0.0),
    )
    gz = jnp.where(
        (h >= 4) & (h < 8), jnp.where((h & 2) == 0, 1.0, -1.0),
        jnp.where(h >= 8, jnp.where((h & 2) == 0, 1.0, -1.0), 0.0),
    )
    return gx * fx + gy * fy + gz * fz


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin3(p: jnp.ndarray) -> jnp.ndarray:
    """Classic Perlin gradient noise, p [..., 3] -> [...] in ~[-1, 1]."""
    pf = jnp.floor(p)
    ix = pf[..., 0].astype(jnp.int32)
    iy = pf[..., 1].astype(jnp.int32)
    iz = pf[..., 2].astype(jnp.int32)
    fx = p[..., 0] - pf[..., 0]
    fy = p[..., 1] - pf[..., 1]
    fz = p[..., 2] - pf[..., 2]
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def corner(dx, dy, dz):
        return _grad_dot(ix + dx, iy + dy, iz + dz,
                         fx - dx, fy - dy, fz - dz)

    n000 = corner(0, 0, 0)
    n100 = corner(1, 0, 0)
    n010 = corner(0, 1, 0)
    n110 = corner(1, 1, 0)
    n001 = corner(0, 0, 1)
    n101 = corner(1, 0, 1)
    n011 = corner(0, 1, 1)
    n111 = corner(1, 1, 1)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return nxy0 + w * (nxy1 - nxy0)


def fbm3(p: jnp.ndarray, levels: int, absolute: bool,
         phase: float = 0.0) -> jnp.ndarray:
    """Summed-octave Perlin (fBm), normalized to ~[0, 1].

    ``absolute`` sums |octave| (turbulence — the MDL ``absolute_noise``
    flag); ``phase`` offsets the field (the flow noise's phase input; a
    static scene renders phase 0)."""
    total = jnp.zeros(p.shape[:-1])
    amp = 1.0
    norm = 0.0
    q = p + phase
    for _ in range(max(int(levels), 1)):
        n = perlin3(q)
        total = total + amp * (jnp.abs(n) if absolute else n)
        norm += amp
        amp *= 0.5
        q = q * 2.0 + 13.7
    total = total / norm
    return total if absolute else total * 0.5 + 0.5


def worley3(p: jnp.ndarray) -> jnp.ndarray:
    """Worley (cellular) F1 distance, p [..., 3] -> [...] in ~[0, 1]."""
    pf = jnp.floor(p)
    ix = pf[..., 0].astype(jnp.int32)
    iy = pf[..., 1].astype(jnp.int32)
    iz = pf[..., 2].astype(jnp.int32)
    fx = p[..., 0] - pf[..., 0]
    fy = p[..., 1] - pf[..., 1]
    fz = p[..., 2] - pf[..., 2]
    best = jnp.full(p.shape[:-1], 1e30)
    inv = 1.0 / jnp.float32(jnp.iinfo(jnp.uint32).max)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                h = _hash3(ix + dx, iy + dy, iz + dz)
                cx = dx + (h.astype(jnp.float32) * inv)
                h2 = h * jnp.uint32(0x85EBCA6B) ^ (h >> 15)
                cy = dy + (h2.astype(jnp.float32) * inv)
                h3 = h2 * jnp.uint32(0xC2B2AE35) ^ (h2 >> 13)
                cz = dz + (h3.astype(jnp.float32) * inv)
                d2 = (cx - fx) ** 2 + (cy - fy) ** 2 + (cz - fz) ** 2
                best = jnp.minimum(best, d2)
    return jnp.clip(jnp.sqrt(best), 0.0, 1.0)


# noise_mode values stored in the material row
NOISE_NONE = 0
NOISE_PERLIN = 1
NOISE_FLOW = 2
NOISE_WORLEY = 3


def noise_scalar(mode, q, levels: int, absolute, thr_low, thr_high,
                 apply_marble):
    """Post-threshold scalar noise field in [0, 1] at pre-scaled ``q``."""
    n_per = fbm3(q, levels, False)
    n_abs = fbm3(q, levels, True)
    n_wor = worley3(q)
    absolute_b = absolute != 0
    base = jnp.where(
        mode == NOISE_WORLEY, n_wor, jnp.where(absolute_b, n_abs, n_per)
    )
    # marble: sin banding along x modulated by the noise (base module's
    # apply_marble), remapped to [0, 1]
    marble = 0.5 + 0.5 * jnp.sin((q[..., 0] + base * 5.0) * 3.14159265)
    val = jnp.where(apply_marble != 0, marble, base)
    # threshold window remap (noise_threshold_low/high)
    lo = thr_low
    hi = jnp.maximum(thr_high, lo + 1e-6)
    return jnp.clip((val - lo) / (hi - lo), 0.0, 1.0)


def noise_tint(mode, pos, color1, color2, scale, levels: int,
               absolute, thr_low, thr_high, apply_marble):
    """MDL base::*_noise_texture color output at world position ``pos``.

    mode/levels are per-lane values but the compiled variants are fixed by
    the scene's static max level count; the select between modes is masked
    math. Returns [N, 3] (mode 0 lanes return color1 — callers mask)."""
    val = noise_scalar(
        mode, pos * scale, levels, absolute, thr_low, thr_high, apply_marble
    )
    return color1 + val[..., None] * (color2 - color1)


def noise_bump_normal(mode, pos, ns, scale, levels: int, absolute,
                      thr_low, thr_high, apply_marble, factor,
                      h: float = 1e-2):
    """MDL base::*_noise_bump_texture: perturb the shading normal by the
    tangential gradient of the noise field (forward differences in the
    scaled noise domain). Returns a unit normal; lanes with factor == 0
    get ``ns`` back unchanged."""
    q = pos * scale

    def f(qq):
        return noise_scalar(
            mode, qq, levels, absolute, thr_low, thr_high, apply_marble
        )

    f0 = f(q)
    ex = jnp.asarray([h, 0.0, 0.0])
    ey = jnp.asarray([0.0, h, 0.0])
    ez = jnp.asarray([0.0, 0.0, h])
    g = jnp.stack(
        [(f(q + ex) - f0) / h, (f(q + ey) - f0) / h, (f(q + ez) - f0) / h],
        axis=-1,
    ) * scale  # chain rule back to world units
    # tangential component only (bump never changes the mean surface)
    g_t = g - jnp.sum(g * ns, axis=-1, keepdims=True) * ns
    n2 = ns - factor[..., None] * g_t
    n2 = n2 / jnp.maximum(
        jnp.linalg.norm(n2, axis=-1, keepdims=True), 1e-8
    )
    return jnp.where((factor != 0.0)[..., None], n2, ns)
