"""Network input encodings: TriangleWave + OneBlob + Identity, and the
multiresolution hash grid.

Equivalents of tiny-cuda-nn's composite encoding configured in
``nrc/inc/NRCNetworkConfigs.h:49-127``:

- frequency path: TriangleWave(3 position dims x 12 frequencies -> 36)
  + OneBlob(6 dims [dir2, normal2, roughness2] x 4 bins -> 24)
  + Identity(6 dims [diffuse3, specular3]) = 66 features
- hash path: HashGrid(3 dims, 16 levels, 2 features/level, 2^15 table,
  base res 16, per-level scale 2.0 -> 32) + OneBlob(24) + Identity(6) = 62

The raw query layout ([15]) comes from ``integrator.make_query``. Spherical
angles are normalized into [0,1] before OneBlob (a deviation — tcnn feeds
radians straight in; the blob kernel works best on a unit domain). All
outputs are padded to the MLP's input width by the MLP, not here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import NetworkConfig

M_PI = float(jnp.pi)

# raw query column layout (integrator.make_query)
POS = slice(0, 3)
DIR = slice(3, 5)       # (theta [0,pi], phi [-pi,pi])
NORMAL = slice(5, 7)
ROUGH = slice(7, 9)
DIFFUSE = slice(9, 12)
SPECULAR = slice(12, 15)


def triangle_wave(x: jnp.ndarray, n_frequencies: int) -> jnp.ndarray:
    """tcnn-style triangle wave over octave frequencies.

    x: [..., D] -> [..., D * n_frequencies]; tri_j(x) = tri(x * 2^j) with a
    unit-period triangle wave in [0, 1]. Column order d*F + j (dim-major,
    matching the original [..., D, F] reshape — checkpoint layout).

    Computed column-planar: repeating to [..., D*F] first keeps all math
    on one wide minor axis instead of a small [..., D, F] intermediate.
    """
    d = x.shape[-1]
    freqs = jnp.tile(
        jnp.asarray([2.0 ** j for j in range(n_frequencies)], x.dtype), d
    )
    xs = jnp.repeat(x, n_frequencies, axis=-1) * freqs  # [..., D*F]
    return jnp.abs(2.0 * (xs - jnp.floor(xs + 0.5)))


def one_blob(x: jnp.ndarray, n_bins: int) -> jnp.ndarray:
    """One-blob encoding (Gaussian kernel over bin centers), domain [0, 1].

    x: [..., D] -> [..., D * n_bins]; column order d*K + k. Column-planar
    like ``triangle_wave`` (no small-minor-dim intermediate).
    """
    d = x.shape[-1]
    centers = jnp.tile(
        (jnp.arange(n_bins, dtype=x.dtype) + 0.5) / n_bins, d
    )
    sigma = 1.0 / n_bins
    diff = jnp.repeat(x, n_bins, axis=-1) - centers  # [..., D*K]
    return jnp.exp(-0.5 * (diff / sigma) ** 2)


def _normalized_blob_inputs(query: jnp.ndarray) -> jnp.ndarray:
    """dir/normal/roughness -> [0, 1] domain for OneBlob."""
    theta_d = query[..., 3] / M_PI
    phi_d = (query[..., 4] + M_PI) / (2.0 * M_PI)
    theta_n = query[..., 5] / M_PI
    phi_n = (query[..., 6] + M_PI) / (2.0 * M_PI)
    return jnp.stack(
        [theta_d, phi_d, theta_n, phi_n, query[..., 7], query[..., 8]], axis=-1
    )


def encode_frequency(query: jnp.ndarray, cfg: NetworkConfig) -> jnp.ndarray:
    """Frequency-path composite encoding: [.., 15] -> [.., 66].

    Positions are re-scaled by ``freq_domain_scale`` so the triangle-wave
    octaves cover the scene the way the reference's 0.005-scaled
    MDL-state positions do (see NetworkConfig.freq_domain_scale)."""
    tri = triangle_wave(
        query[..., POS] * cfg.freq_domain_scale, cfg.freq_n_frequencies
    )
    blob = one_blob(_normalized_blob_inputs(query), cfg.oneblob_n_bins)
    ident = query[..., 9:15]
    return jnp.concatenate([tri, blob, ident], axis=-1)


def frequency_encoded_dims(cfg: NetworkConfig) -> int:
    return 3 * cfg.freq_n_frequencies + 6 * cfg.oneblob_n_bins + 6


# ---------------------------------------------------------------------------
# Multiresolution hash grid (Instant-NGP style; tcnn HashGrid)
# ---------------------------------------------------------------------------

_PRIMES = (1, 2654435761, 805459861)


class HashGridParams(NamedTuple):
    """Trainable hash tables: [n_levels, 2^log2_size, n_features]."""

    table: jnp.ndarray


def init_hash_grid(key: jax.Array, cfg: NetworkConfig) -> HashGridParams:
    size = 2 ** cfg.hash_log2_size
    # tcnn initializes U(-1e-4, 1e-4)
    table = jax.random.uniform(
        key,
        (cfg.hash_n_levels, size, cfg.hash_n_features_per_level),
        minval=-1e-4,
        maxval=1e-4,
        dtype=jnp.float32,
    )
    return HashGridParams(table=table)


def _level_resolutions(cfg: NetworkConfig) -> tuple:
    return tuple(
        int(cfg.hash_base_resolution * (cfg.hash_per_level_scale ** level))
        for level in range(cfg.hash_n_levels)
    )


def _dense_levels(cfg: NetworkConfig) -> tuple:
    """tcnn grid semantics (tiny-cuda-nn grid.h grid_index; configured by
    ``NRCNetworkConfigs.h:96-105``): a level whose full vertex grid
    (res+1)^3 fits the table is indexed DIRECTLY by stride — zero hash
    collisions at coarse levels. Only levels that overflow the table hash.
    """
    size = 2 ** cfg.hash_log2_size
    return tuple((r + 1) ** 3 <= size for r in _level_resolutions(cfg))


def _corner_index_weight_all_levels(pos: jnp.ndarray, corner: int,
                                    cfg: NetworkConfig,
                                    level_offset=None, n_levels=None):
    """Table row + trilinear weight of one voxel corner, all levels at once.

    pos: [..., 3] -> (idx [..., L] int32 global row in [0, 2^log2),
    w [..., L] f32). Vectorizing the level axis keeps the gathers few and
    wide (8 gathers of [B, L, F] instead of 8*L of [B, F]). Coarse levels
    with (res+1)^3 <= 2^log2_size index densely (collision-free, clamped
    to the vertex grid); fine levels spatial-hash (Instant-NGP primes).

    ``level_offset``/``n_levels`` restrict to the level block
    [offset, offset + n_levels) — the level-sharded lookup's per-chip
    slice (offset may be traced; the per-level constants are
    dynamic-sliced from the static [L] tables).
    """
    res_all = jnp.asarray(_level_resolutions(cfg), pos.dtype)   # [L]
    verts_all = jnp.asarray(
        [r + 1 for r in _level_resolutions(cfg)], jnp.int32
    )
    dense_all = jnp.asarray(_dense_levels(cfg), bool)
    if level_offset is not None:
        res = jax.lax.dynamic_slice_in_dim(res_all, level_offset, n_levels)
        verts = jax.lax.dynamic_slice_in_dim(verts_all, level_offset, n_levels)
        dense = jax.lax.dynamic_slice_in_dim(dense_all, level_offset, n_levels)
    else:
        res, verts, dense = res_all, verts_all, dense_all
    p = pos[..., None, :] * res[:, None]                   # [..., L, 3]
    p0 = jnp.floor(p)
    frac = p - p0
    p0 = p0.astype(jnp.int32)
    dx, dy, dz = (corner & 1), ((corner >> 1) & 1), ((corner >> 2) & 1)
    vx = p0[..., 0] + dx
    vy = p0[..., 1] + dy
    vz = p0[..., 2] + dz
    h = (
        vx.astype(jnp.uint32) * jnp.uint32(_PRIMES[0])
        ^ vy.astype(jnp.uint32) * jnp.uint32(_PRIMES[1])
        ^ vz.astype(jnp.uint32) * jnp.uint32(_PRIMES[2])
    )
    idx_hash = (h & jnp.uint32(2 ** cfg.hash_log2_size - 1)).astype(jnp.int32)
    # dense stride index over the (res+1)^3 vertex grid, clamped in-range
    # (inputs can stray outside [0,1]; hashed levels wrap via the hash)
    cx = jnp.clip(vx, 0, verts - 1)
    cy = jnp.clip(vy, 0, verts - 1)
    cz = jnp.clip(vz, 0, verts - 1)
    idx_dense = cx + verts * (cy + verts * cz)
    idx = jnp.where(dense, idx_dense, idx_hash)
    w = (
        jnp.where(dx, frac[..., 0], 1.0 - frac[..., 0])
        * jnp.where(dy, frac[..., 1], 1.0 - frac[..., 1])
        * jnp.where(dz, frac[..., 2], 1.0 - frac[..., 2])
    )
    return idx, w


def hash_grid_lookup(
    pos: jnp.ndarray, params: HashGridParams, cfg: NetworkConfig
) -> jnp.ndarray:
    """Trilinear hash-grid features. pos: [..., 3] in roughly [0, 1]^3.

    -> [..., n_levels * n_features]. Eight row gathers forward; autodiff
    gives the adjoint as a scatter-add into the table. The sharded variant
    (SURVEY P6) is ``sharded_hash_grid_lookup`` below.
    """
    n_levels, size, n_feat = params.table.shape
    lead = pos.shape[:-1]
    p2 = pos.reshape(-1, 3)
    flat = params.table.reshape(n_levels * size, n_feat)
    level_ofs = jnp.arange(n_levels, dtype=jnp.int32) * size
    acc = jnp.zeros((p2.shape[0], n_levels, n_feat), flat.dtype)
    for corner in range(8):
        idx, w = _corner_index_weight_all_levels(p2, corner, cfg)
        acc = acc + w[..., None] * flat[idx + level_ofs]
    return acc.reshape(*lead, n_levels * n_feat)


def sharded_hash_grid_lookup(
    pos: jnp.ndarray, params: HashGridParams, cfg: NetworkConfig,
    axis_name: str,
) -> jnp.ndarray:
    """Hash-grid lookup with tables SHARDED over a mesh axis (SURVEY P6 —
    the capability the reference lacks: tcnn's table is single-GPU HBM,
    ``NRCNetworkConfigs.h:96-105``).

    Runs inside ``shard_map``. ``params.table`` is this device's LEVEL
    block [L/D, S, F] of the global [L, S, F] table (global level =
    shard_id * L/D + local level; requires D | L). Owner-routed exchange,
    two collectives total:

    1. one ``all_gather`` of everyone's query positions — [D*B, 3] of f32
       (positions, not per-corner indices: recomputing the hashes locally
       is cheap elementwise work and far less traffic);
    2. each device gathers features of ITS OWN levels for all D*B queries —
       dense unmasked gathers, perfectly balanced by construction (every
       chip does exactly D*B*8*(L/D) row gathers), O(B*8*L) global work.
       An earlier row-sharded design made every chip scan ALL D*B queries
       x 8 corners x L levels against its row shard (O(D*B) per chip)
       and concentrated dense-level traffic on the
       low-row owners; whole-level ownership removes both;
    3. one ``all_to_all`` transposes (owner-levels x all-queries) into
       (all-levels x own-queries) — [B, L*F] per chip, 4x less traffic
       than the old psum_scatter because each feature is computed exactly
       once (no D partial copies to sum).

    The whole dance is differentiable: the adjoint of ``all_to_all`` is the
    reverse ``all_to_all``, of ``all_gather`` a ``psum_scatter``, and of
    the gather a scatter-add into the local level block — autodiff derives
    the distributed embedding-gradient exchange for free.
    """
    lpd, size, n_feat = params.table.shape  # levels per device
    d = jax.lax.axis_size(axis_name)
    assert lpd * d == cfg.hash_n_levels, (
        f"level sharding needs devices ({d}) to divide hash_n_levels "
        f"({cfg.hash_n_levels}); got a [{lpd}, {size}, {n_feat}] shard"
    )
    my = jax.lax.axis_index(axis_name)
    b = pos.shape[0]
    gpos = jax.lax.all_gather(pos, axis_name, tiled=True)  # [D*B, 3]
    n = gpos.shape[0]
    flat = params.table.reshape(lpd * size, n_feat)
    level_ofs = jnp.arange(lpd, dtype=jnp.int32) * size
    acc = jnp.zeros((n, lpd, n_feat), flat.dtype)           # [D*B, lpd, F]
    for corner in range(8):
        idx, w = _corner_index_weight_all_levels(
            gpos, corner, cfg, level_offset=my * lpd, n_levels=lpd
        )
        acc = acc + w[..., None] * flat[idx + level_ofs]
    # route: [D, B, lpd*F] blocks — send chip j its queries' features for
    # my levels; receive my queries' features for chip j's levels
    blocks = acc.reshape(d, b, lpd * n_feat)
    swapped = jax.lax.all_to_all(
        blocks, axis_name, split_axis=0, concat_axis=0, tiled=False
    )  # [D, B, lpd*F]; row s = my queries' features for chip-s levels
    out = jnp.moveaxis(swapped, 0, 1).reshape(b, d * lpd * n_feat)
    return out  # level order = global: level = s * lpd + local


def encode_hash(
    query: jnp.ndarray, params: HashGridParams, cfg: NetworkConfig
) -> jnp.ndarray:
    """Hash-path composite encoding: [.., 15] -> [.., 62].

    Positions arrive pre-scaled by ``FrameConfig.position_scale`` (roughly
    [-0.05, 0.05] for Cornell); re-center into [0,1]^3 for the grid.
    """
    pos01 = query[..., POS] * 5.0 + 0.5
    if cfg.hash_shard_axis is not None:
        grid = sharded_hash_grid_lookup(pos01, params, cfg, cfg.hash_shard_axis)
    else:
        grid = hash_grid_lookup(pos01, params, cfg)
    blob = one_blob(_normalized_blob_inputs(query), cfg.oneblob_n_bins)
    ident = query[..., 9:15]
    return jnp.concatenate([grid, blob, ident], axis=-1)


def hash_encoded_dims(cfg: NetworkConfig) -> int:
    return (
        cfg.hash_n_levels * cfg.hash_n_features_per_level
        + 6 * cfg.oneblob_n_bins
        + 6
    )
