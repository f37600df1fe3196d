"""Tonemapper: batched JAX replica of the reference's CPU/GLSL tone pipeline.

The reference implements the same formula twice — a GLSL fragment shader
(``nrc/src/Rasterizer.cpp:548-577``) and a CPU loop for screenshots
(``nrc/src/Application.cpp:2596-2645``). Here it is once, vectorized over
the whole HDR image; runs on any JAX device under jit.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import TonemapperConfig
from .math import luminance


def tonemap(hdr: jnp.ndarray, cfg: TonemapperConfig) -> jnp.ndarray:
    """HDR [..., 3] float -> LDR [..., 3] float in [0, 1]."""
    inv_gamma = 1.0 / cfg.gamma
    color_balance = jnp.asarray(cfg.color_balance, dtype=hdr.dtype)
    inv_white_point = cfg.brightness / cfg.white_point
    burn = cfg.burn_highlights
    crush = cfg.crush_blacks + cfg.crush_blacks + 1.0
    saturation = cfg.saturation

    ldr = inv_white_point * color_balance * hdr
    ldr = ldr * ((ldr * burn) + 1.0) / (ldr + 1.0)

    lum = luminance(ldr)[..., None]
    ldr = lum + saturation * (ldr - lum)
    ldr = jnp.maximum(ldr, 0.0)

    lum = luminance(ldr)[..., None]
    crushed = jnp.power(jnp.maximum(ldr, 0.0), crush)
    t = jnp.sqrt(jnp.maximum(lum, 0.0))
    ldr = jnp.where(lum < 1.0, crushed + t * (ldr - crushed), ldr)
    ldr = jnp.maximum(ldr, 0.0)

    return jnp.clip(jnp.power(ldr, inv_gamma), 0.0, 1.0)


def tonemap_to_u8(hdr: jnp.ndarray, cfg: TonemapperConfig) -> jnp.ndarray:
    return (tonemap(hdr, cfg) * 255.0).astype(jnp.uint8)


# Cold-to-hot ramp of the reference's USE_TIME_VIEW display path
# (``Rasterizer.cpp:306-345``): blue, green, red, yellow, white at
# u = 0, .25, .5, .75, 1.
_RAMP_U = (0.0, 0.25, 0.5, 0.75, 1.0)
_RAMP_C = (
    (0.0, 0.0, 1.0),
    (0.0, 1.0, 0.0),
    (1.0, 0.0, 0.0),
    (1.0, 1.0, 0.0),
    (1.0, 1.0, 1.0),
)


def time_view_ramp(x: jnp.ndarray) -> jnp.ndarray:
    """[...,] in [0, 1] -> [..., 3] through the cold-to-hot color ramp."""
    x = jnp.clip(x, 0.0, 1.0)
    out = jnp.zeros((*x.shape, 3), x.dtype)
    for i in range(len(_RAMP_U) - 1):
        u0, u1 = _RAMP_U[i], _RAMP_U[i + 1]
        c0 = jnp.asarray(_RAMP_C[i], x.dtype)
        c1 = jnp.asarray(_RAMP_C[i + 1], x.dtype)
        t = jnp.clip((x - u0) / (u1 - u0), 0.0, 1.0)[..., None]
        seg = c0 + t * (c1 - c0)
        lo = (x >= u0) if i else (x >= -1.0)
        hi = (x < u1) if i + 2 < len(_RAMP_U) else (x <= 1.0)
        out = jnp.where((lo & hi)[..., None], seg, out)
    return out
