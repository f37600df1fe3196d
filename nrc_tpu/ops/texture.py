"""Device texture lookups: software bilinear/trilinear fetch from the atlas.

Replacement for CUDA texture objects + the MDL texture runtime's
``tex_lookup_float4_2d`` (``nrc/shaders/texture_lookup.h``): wrap-repeat
addressing, bilinear filtering, optional mip level — implemented as masked
gathers from the flat atlas (``nrc_tpu/scene/texture.py``); for wavefront
batches the corner fetches fuse into the surrounding shading code under jit.

``tex_id`` rows with -1 return white (1,1,1,1), which lets material code
multiply unconditionally instead of branching (no divergence)."""

from __future__ import annotations

import jax.numpy as jnp


def _wrap(i: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    # wrap_repeat (MDL default): floored modulo
    return jnp.remainder(i, jnp.maximum(n, 1))


def sample_bilinear(atlas: dict, tex_id: jnp.ndarray, uv: jnp.ndarray,
                    lod: jnp.ndarray | None = None) -> jnp.ndarray:
    """Bilinear RGBA fetch. tex_id [N] i32 (-1 = none), uv [N, 2], optional
    integer lod [N] (clamped to the texture's chain). Returns [N, 4]."""
    has = tex_id >= 0
    tid = jnp.maximum(tex_id, 0)
    base = atlas["tex_level_base"][tid]
    nlev = atlas["tex_num_levels"][tid]
    if lod is None:
        li = base
    else:
        li = base + jnp.clip(lod, 0, nlev - 1)
    w = atlas["level_w"][li]
    h = atlas["level_h"][li]
    off = atlas["level_offset"][li]

    x = uv[..., 0] * w.astype(jnp.float32) - 0.5
    y = uv[..., 1] * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    ix0 = _wrap(x0.astype(jnp.int32), w)
    iy0 = _wrap(y0.astype(jnp.int32), h)
    ix1 = _wrap(ix0 + 1, w)
    iy1 = _wrap(iy0 + 1, h)

    if "texels_quad" in atlas:
        # production path: each row holds the texel's own wrap-neighbor
        # quad (scene/texture.py::_quad_maps), so ALL four bilinear corners
        # ride ONE row gather instead of four
        idx = jnp.where(has, off + iy0 * w + ix0, 0)  # texel 0 = white
        q = atlas["texels_quad"][idx]                 # [N, 16]
        c00 = q[..., 0:4]
        c01 = q[..., 4:8]
        c10 = q[..., 8:12]
        c11 = q[..., 12:16]
        del ix1, iy1
    else:
        # raw host atlas dicts (unit tests) keep the 4-corner fetch
        tx = atlas["texels"]

        def fetch(iy, ix):
            idx = jnp.where(has, off + iy * w + ix, 0)  # texel 0 = white
            return tx[idx]

        c00 = fetch(iy0, ix0)
        c01 = fetch(iy0, ix1)
        c10 = fetch(iy1, ix0)
        c11 = fetch(iy1, ix1)
    out = (
        c00 * (1.0 - fx) * (1.0 - fy)
        + c01 * fx * (1.0 - fy)
        + c10 * (1.0 - fx) * fy
        + c11 * fx * fy
    )
    return jnp.where(has[..., None], out, 1.0)


def cube_face_uv(direction: jnp.ndarray):
    """Direction -> (face, u, v) cube lookup, D3D/CUDA convention (the
    reference samples cube maps through cudaTextureCubemap objects,
    ``Device.cpp:3014-3283`` + ``texture_lookup.h``): faces ordered
    +X -X +Y -Y +Z -Z; for major axis m with |m| = max component,
      +X: u=-z/|x|, v=-y/|x|    -X: u= z/|x|, v=-y/|x|
      +Y: u= x/|y|, v= z/|y|    -Y: u= x/|y|, v=-z/|y|
      +Z: u= x/|z|, v=-y/|z|    -Z: u=-x/|z|, v=-y/|z|
    mapped to [0,1]^2 (v runs top-down like image rows). Returns
    (face [N] i32, u [N], v [N])."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    # per-face (sc, tc, ma): s/t coordinates and the major-axis magnitude
    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))
    ma = jnp.maximum(ma, 1e-20)
    sc = jnp.where(
        is_x, jnp.where(x >= 0, -z, z),
        jnp.where(is_y, x, jnp.where(z >= 0, x, -x)),
    )
    tc = jnp.where(
        is_x, -y,
        jnp.where(is_y, jnp.where(y >= 0, z, -z), -y),
    )
    face = jnp.where(
        is_x, jnp.where(x >= 0, 0, 1),
        jnp.where(is_y, jnp.where(y >= 0, 2, 3), jnp.where(z >= 0, 4, 5)),
    ).astype(jnp.int32)
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5
    return face, u, v


def cube_dir_from_face_uv(face: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Inverse of ``cube_face_uv``: (face [N] i32, u, v in [0,1]) -> unit
    direction [N, 3] (same D3D face convention). Used by cube-env
    importance sampling to turn a sampled face texel into a ray."""
    sc = u * 2.0 - 1.0
    tc = v * 2.0 - 1.0
    one = jnp.ones_like(sc)
    # per-face (x, y, z) as functions of (sc, tc); rows match faces 0..5
    xs = jnp.stack([one, -one, sc, sc, sc, -sc], axis=-1)
    ys = jnp.stack([-tc, -tc, one, -one, -tc, -tc], axis=-1)
    zs = jnp.stack([-sc, sc, tc, -tc, one, -one], axis=-1)
    oh = face[..., None] == jnp.arange(6, dtype=jnp.int32)
    d = jnp.stack(
        [
            jnp.sum(jnp.where(oh, xs, 0.0), axis=-1),
            jnp.sum(jnp.where(oh, ys, 0.0), axis=-1),
            jnp.sum(jnp.where(oh, zs, 0.0), axis=-1),
        ],
        axis=-1,
    )
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def sample_cube_env(cube: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """Bilinear cube-map fetch from a dense [6, H, W, C] face stack by
    direction [N, 3] -> [N, C]. Filtering clamps within the face (no
    cross-face bleeding — matches clamped CUarray layers)."""
    _, h, w, _ = cube.shape
    face, u, v = cube_face_uv(direction)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    ix0 = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    iy0 = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    ix1 = jnp.clip(ix0 + 1, 0, w - 1)
    iy1 = jnp.clip(iy0 + 1, 0, h - 1)
    flat = cube.reshape(-1, cube.shape[-1])
    base = face * (h * w)

    def fetch(iy, ix):
        return flat[base + iy * w + ix]

    return (
        fetch(iy0, ix0) * (1.0 - fx) * (1.0 - fy)
        + fetch(iy0, ix1) * fx * (1.0 - fy)
        + fetch(iy1, ix0) * (1.0 - fx) * fy
        + fetch(iy1, ix1) * fx * fy
    )


def apply_uv_transform(uv: jnp.ndarray, xf: jnp.ndarray) -> jnp.ndarray:
    """MDL ``base::rotation_translation_scale`` restricted to the uv plane
    (rotation about w): uv' = R(rot_z) @ (uv * scale) + translation.
    xf rows: [scale_u, scale_v, trans_u, trans_v, cos_rz, sin_rz]."""
    s = uv * xf[..., 0:2]
    c, sn = xf[..., 4], xf[..., 5]
    u = c * s[..., 0] - sn * s[..., 1]
    v = sn * s[..., 0] + c * s[..., 1]
    return jnp.stack([u, v], axis=-1) + xf[..., 2:4]
