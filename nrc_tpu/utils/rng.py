"""Counter-based per-ray RNG: TEA seeding + LCG stream.

Bit-exact, vectorized port of the reference's per-thread generator
(``nrc/shaders/random_number_generators.h:38-131``): a TEA<4> hash of
(pixel_index, subframe_index) seeds a 32-bit LCG whose upper 24 bits give
uniform floats in [0, 1).

This runs as pure uint32 elementwise arithmetic over the whole ray batch —
each ray carries its ``seed`` as part of the SoA wavefront state, exactly
like ``PerRayData::seed`` in the reference, so sample streams match the
reference's consumption order per ray.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_LCG_A = np.uint32(1664525)
_LCG_C = np.uint32(1013904223)


def tea(val0: jnp.ndarray, val1: jnp.ndarray, rounds: int = 4) -> jnp.ndarray:
    """Tiny Encryption Algorithm hash, vectorized (reference ``tea<N>``)."""
    v0 = jnp.asarray(val0, dtype=jnp.uint32)
    v1 = jnp.asarray(val1, dtype=jnp.uint32)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & 0xFFFFFFFF
        k = np.uint32(s0)
        v0 = v0 + (
            ((v1 << 4) + np.uint32(0xA341316C))
            ^ (v1 + k)
            ^ ((v1 >> 5) + np.uint32(0xC8013EA4))
        )
        v1 = v1 + (
            ((v0 << 4) + np.uint32(0xAD90777D))
            ^ (v0 + k)
            ^ ((v0 >> 5) + np.uint32(0x7E95761E))
        )
    return v0


def lcg_step(seed: jnp.ndarray) -> jnp.ndarray:
    return seed * _LCG_A + _LCG_C


def rng(seed: jnp.ndarray):
    """One LCG step; returns (new_seed, float in [0,1) from the upper 24 bits)."""
    seed = lcg_step(seed)
    return seed, (seed >> np.uint32(8)).astype(jnp.float32) * (1.0 / 16777216.0)


def rng2(seed: jnp.ndarray):
    seed, a = rng(seed)
    seed, b = rng(seed)
    return seed, jnp.stack([a, b], axis=-1)


def rng3(seed: jnp.ndarray):
    seed, a = rng(seed)
    seed, b = rng(seed)
    seed, c = rng(seed)
    return seed, jnp.stack([a, b, c], axis=-1)


def rng4(seed: jnp.ndarray):
    seed, a = rng(seed)
    seed, b = rng(seed)
    seed, c = rng(seed)
    seed, d = rng(seed)
    return seed, jnp.stack([a, b, c, d], axis=-1)
