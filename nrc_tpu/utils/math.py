"""Vector math, orthonormal bases, spherical mappings, MIS heuristics.

Batched ( SoA ``jnp`` arrays of shape [..., 3]) equivalents of the
reference's scalar device helpers:
- ``nrc/shaders/shader_common.h`` (TBN, alignVector, unitSquare mappings,
  balance/power heuristics, cartesianToSphericalUnitVector)
- ``nrc/shaders/vector_math.h`` (float3 operator library — subsumed by jnp)

All functions are shape-polymorphic over leading batch dims and jit-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

M_PI = float(jnp.pi)
# f32 mat-vecs keep full precision on the GPU, where a plain f32 product
# may round its operands to TF32
HIGHEST = jax.lax.Precision.HIGHEST


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis, keepdims dropped."""
    return jnp.sum(a * b, axis=-1)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def normalize(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    return v * jnp.reciprocal(jnp.maximum(length(v), eps))[..., None]


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def safe_div(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise a/b with 0 where b == 0 (reference ``raygeneration.cu:44-51``)."""
    return jnp.where(b != 0.0, a / jnp.where(b != 0.0, b, 1.0), 0.0)


def luminance(rgb: jnp.ndarray) -> jnp.ndarray:
    """NTSC luminance as used by the reference tonemapper (``Application.cpp:2620``)."""
    w = jnp.asarray([0.3, 0.59, 0.11], dtype=rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


def balance_heuristic(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """MIS balance heuristic a/(a+b) (reference ``shader_common.h:246-249``)."""
    return safe_div(a, a + b)


def power_heuristic(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    t = a * a
    return safe_div(t, t + b * b)


def align_vector(axis: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Rotate w (defined about +z) to be about ``axis``.

    Branchless Frisvad-style frame via the reference's ``alignVector``
    (``shader_common.h:251-259``). Batched over leading dims.
    """
    s = jnp.where(axis[..., 2] >= 0.0, 1.0, -1.0)
    wz = w[..., 2] * s
    w = jnp.stack([w[..., 0], w[..., 1], wz], axis=-1)
    h = jnp.stack([axis[..., 0], axis[..., 1], axis[..., 2] + s], axis=-1)
    k = dot(w, h) / (1.0 + jnp.abs(axis[..., 2]))
    return k[..., None] * h - w


def build_onb(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Orthonormal basis (t, b) around unit normal n, batched.

    Duff et al. branchless ONB — the branch-free replacement for the
    reference's ``TBN`` constructor (``shader_common.h``).
    """
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        axis=-1,
    )
    bi = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bi


def to_world(t: jnp.ndarray, b: jnp.ndarray, n: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Transform local-frame v=(x,y,z) into world space given ONB (t,b,n)."""
    return (
        v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n
    )


def unit_square_to_cosine_hemisphere(sample: jnp.ndarray, axis: jnp.ndarray):
    """Cosine-weighted hemisphere sample about ``axis``.

    Returns (w, pdf). Mirrors ``shader_common.h:261-276``.
    """
    theta = 2.0 * M_PI * sample[..., 0]
    r = jnp.sqrt(jnp.clip(sample[..., 1], 0.0, 1.0))
    x = r * jnp.cos(theta)
    y = r * jnp.sin(theta)
    z2 = 1.0 - x * x - y * y
    z = jnp.sqrt(jnp.maximum(z2, 0.0))
    w = jnp.stack([x, y, z], axis=-1)
    pdf = z / M_PI
    return align_vector(axis, w), pdf


def unit_square_to_sphere(u: jnp.ndarray, v: jnp.ndarray):
    """Uniform sphere sample; returns (p, pdf) (``shader_common.h:278-290``)."""
    z = 1.0 - 2.0 * u
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = v * 2.0 * M_PI
    p = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    pdf = jnp.full_like(u, 0.25 / M_PI)
    return p, pdf


def elevation(d: jnp.ndarray) -> jnp.ndarray:
    """Numerically stable elevation of a unit vector (``shader_common.h:316-325``)."""
    zm1 = d[..., 2] - 1.0
    dist = jnp.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + zm1 * zm1)
    return 2.0 * jnp.arcsin(jnp.clip(0.5 * dist, -1.0, 1.0))


def cartesian_to_spherical_unit(d: jnp.ndarray) -> jnp.ndarray:
    """(theta, phi) of a unit vector — network input param (``shader_common.h:328-334``)."""
    theta = elevation(d)
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    return jnp.stack([theta, phi], axis=-1)


def spherical_to_cartesian(theta: jnp.ndarray, phi: jnp.ndarray) -> jnp.ndarray:
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], axis=-1)


def reflect(wi: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of incoming direction ``wi`` (pointing at surface)."""
    return wi - 2.0 * dot(wi, n)[..., None] * n


def transform_point(mat: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply affine 3x4 (or 4x4) matrix rows to points, batched."""
    r = mat[..., :3, :3]
    t = mat[..., :3, 3]
    return jnp.einsum("...ij,...j->...i", r, p, precision=HIGHEST) + t


def transform_vector(mat: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    r = mat[..., :3, :3]
    return jnp.einsum("...ij,...j->...i", r, v, precision=HIGHEST)


# ---------------------------------------------------------------------------
# One-hot per-lane pick/put over a SMALL minor axis.
#
# ``x[rows, idx]`` / ``x.at[rows, idx].set(v)`` lower to XLA gather/scatter.
# For a minor axis of K <= ~16 entries (medium stacks, record slots, blend
# curve knots) a one-hot select/sum is exact (one selected term + exact
# zeros) and pure full-width elementwise math: K*[N,C] ops. It was far
# cheaper than the gather on an earlier accelerator; not yet re-measured on
# the GPU.
# ---------------------------------------------------------------------------


def pick1(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """x [N, K] or [N, K, C], idx [N] -> x[arange(N), idx] without a gather."""
    k = x.shape[1]
    oh = idx[:, None] == jnp.arange(k, dtype=idx.dtype)
    if x.ndim == 3:
        return jnp.sum(jnp.where(oh[..., None], x, 0), axis=1)
    return jnp.sum(jnp.where(oh, x, 0), axis=1)


def put1(x: jnp.ndarray, idx: jnp.ndarray, v: jnp.ndarray,
         mask: jnp.ndarray) -> jnp.ndarray:
    """x[arange(N), idx] = v where mask, without a scatter."""
    k = x.shape[1]
    oh = (idx[:, None] == jnp.arange(k, dtype=idx.dtype)) & mask[:, None]
    if x.ndim == 3:
        return jnp.where(oh[..., None], v[:, None, :], x)
    return jnp.where(oh, v[:, None], x)


def add1(x: jnp.ndarray, idx: jnp.ndarray, v: jnp.ndarray,
         mask: jnp.ndarray) -> jnp.ndarray:
    """x[arange(N), idx] += v where mask, without a scatter (exact: the
    unselected lanes add 0.0)."""
    k = x.shape[1]
    oh = (idx[:, None] == jnp.arange(k, dtype=idx.dtype)) & mask[:, None]
    if x.ndim == 3:
        return x + jnp.where(oh[..., None], v[:, None, :], 0.0)
    return x + jnp.where(oh, v[:, None], 0.0)
