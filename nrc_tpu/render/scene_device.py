"""Device-resident scene: host Scene -> pytree of jnp arrays.

The upload boundary that replaces ``Device::initScene/initLights/
initCameras`` + per-island resource distribution (``Device.cpp:1515-1646``,
``Raytracer.cpp:574-621``). Under ``shard_map`` these arrays get replicated
(scene data) per chip, mirroring the reference's per-island replication
policy (P3 in SURVEY.md §2.5).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.intersect import TriSoA
from ..ops.light_sampling import DeviceLights, upload_lights
from ..ops.mbsdf import MBSDFTables
from ..scene.materials import EmissionMode
from ..scene.scene_builder import Scene

M_PI = float(np.pi)


def _h(x, dt=None):
    """Host-staging array: numpy with jnp's dtype canonicalization (f64 ->
    f32, i64 -> i32). All upload paths stage in numpy and transfer ONCE via
    ``utils.device_pack.device_put_packed`` instead of one ``jnp.asarray``
    per array."""
    a = np.asarray(x, dt)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return np.ascontiguousarray(a)


def mat_row_layout(curve_k: int):
    """Column layout of the merged per-material shade row (``mat_row``).

    Every per-material field the bounce body needs rides ONE row fetch
    instead of up to ~17 separate per-field gathers by the same material id
    per bounce. Integer fields are stored as f32
    (all values << 2^24, exact round trip)."""
    layout = [
        ("albedo", 3), ("roughness", 2), ("ior", 1),
        ("emission_radiance", 3),
        ("archetype", 1), ("thin_walled", 1),
        ("uv_xf", 6),
        ("albedo_tex", 1), ("cutout_tex", 1), ("emission_tex", 1),
        ("cutout_opacity", 1),
        ("sigma_a", 3), ("sigma_s", 3), ("volume_bias", 1),
        ("mbsdf_index", 1), ("mbsdf_multiplier", 1),
        ("archetype2", 1), ("albedo2", 3), ("roughness2", 2),
        ("blend_mode", 1), ("blend_w1", 3), ("blend_w2", 3),
        ("blend_ior", 1),
        ("mod_mode", 1), ("mod_a", 3), ("mod_b", 3), ("mod_exp", 1),
        ("curve", 3 * curve_k),
        ("hair_roughness", 6), ("hair_absorption", 3),
        ("hair_cuticle", 1), ("hair_diffuse_weight", 1),
        ("noise_mode", 1), ("noise_color1", 3), ("noise_color2", 3),
        ("noise_scale", 3), ("noise_levels", 1), ("noise_absolute", 1),
        ("noise_thr", 2), ("noise_marble", 1), ("noise_target", 1),
        ("noise_bump_factor", 1),
    ]
    offs = {}
    o = 0
    for nm, w in layout:
        offs[nm] = (o, o + w)
        o += w
    return offs, o


class DeviceScene(NamedTuple):
    tris: TriSoA
    n0: jnp.ndarray  # [T, 3] shading normals per vertex
    n1: jnp.ndarray
    n2: jnp.ndarray
    tri_material: jnp.ndarray  # [T] i32
    tri_light: jnp.ndarray     # [T] i32 (-1 when not emissive)
    uv0: jnp.ndarray  # [T, 2] texcoords per vertex
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    # Packed hot-path gather tables: the integrator fetches each hit's
    # shading inputs with ONE row gather per table instead of ~12 single-
    # field gathers.
    tri_pack: jnp.ndarray   # [T, 9]  = n0 | n1 | n2
    tri_uvpack: jnp.ndarray  # [T, 6] = uv0 | uv1 | uv2
    tri_meta: jnp.ndarray   # [T, 2] i32 = material | light
    mat_pack: jnp.ndarray   # [M, 9]  = albedo | roughness | ior | emission
    mat_meta: jnp.ndarray   # [M, 2] i32 = archetype | thin_walled
    # merged rows: the bounce body's whole per-hit fetch is ONE
    # triangle row gather + ONE material row fetch (see mat_row_layout)
    tri_shade: jnp.ndarray  # [T, 26] = p0|e1|e2 | n0|n1|n2 | uv0..2 | meta(2, i32 bits)
    mat_row: jnp.ndarray    # [M, mat_row_layout(K)[1]] f32

    # material table (SoA)
    mat_archetype: jnp.ndarray          # [M] i32
    mat_albedo: jnp.ndarray             # [M, 3]
    mat_roughness: jnp.ndarray          # [M, 2]
    mat_ior: jnp.ndarray                # [M]
    mat_thin_walled: jnp.ndarray        # [M] i32
    mat_emission_radiance: jnp.ndarray  # [M, 3] radiance of the diffuse EDF
    mat_sigma_a: jnp.ndarray            # [M, 3]
    mat_sigma_s: jnp.ndarray            # [M, 3]
    mat_volume_bias: jnp.ndarray        # [M]
    # chiang hair parameters (curve primitives)
    mat_hair_roughness: jnp.ndarray     # [M, 3, 2]
    mat_hair_absorption: jnp.ndarray    # [M, 3]
    mat_hair_cuticle: jnp.ndarray       # [M]
    mat_hair_diffuse_weight: jnp.ndarray  # [M]
    # texture bindings (-1 = none) + uv placement; atlas = flat texel pool
    # (replaces CUDA texture objects, Device.cpp:3014-3283)
    mat_albedo_tex: jnp.ndarray         # [M] i32
    mat_cutout_tex: jnp.ndarray         # [M] i32
    mat_emission_tex: jnp.ndarray       # [M] i32
    mat_cutout_opacity: jnp.ndarray     # [M] f32
    mat_uv_xf: jnp.ndarray              # [M, 6]
    atlas: dict
    # second lobe + blend/modifier descriptor (ops/layered.py)
    mat_archetype2: jnp.ndarray         # [M] i32
    mat_albedo2: jnp.ndarray            # [M, 3]
    mat_roughness2: jnp.ndarray         # [M, 2]
    mat_blend_mode: jnp.ndarray         # [M] i32
    mat_blend_w1: jnp.ndarray           # [M, 3]
    mat_blend_w2: jnp.ndarray           # [M, 3]
    mat_blend_ior: jnp.ndarray          # [M]
    mat_curve: jnp.ndarray              # [M, K, 3]
    mat_mod_mode: jnp.ndarray           # [M] i32
    mat_mod_a: jnp.ndarray              # [M, 3]
    mat_mod_b: jnp.ndarray              # [M, 3]
    mat_mod_exp: jnp.ndarray            # [M]
    # measured BSDFs (ops/mbsdf.py; Device.cpp:3347-3663)
    mat_mbsdf_index: jnp.ndarray        # [M] i32 (-1 = none)
    mat_mbsdf_multiplier: jnp.ndarray   # [M]
    mbsdf: object                       # ops.mbsdf.MBSDFTables

    lights: DeviceLights
    bvh: Optional[dict]
    curves: Optional[object] = None     # ops.curve_intersect.CurveSoA
    curve_bvh: Optional[dict] = None

    @property
    def num_triangles(self) -> int:
        return self.tris.num



def _material_arrays(scene: Scene) -> dict:
    """Material-derived DeviceScene fields (shared by ``upload_scene`` and
    ``patch_materials``). Everything here is cheap per-material numpy ->
    device upload; geometry/BVH/curves are untouched."""
    mt = scene.materials

    # Emitted radiance of each material's diffuse EDF: intensity * edf(1/pi)
    # * factor, where factor = 1 for radiant-exitance mode and 1/area for
    # power mode (hit.cu:792-806). Power mode needs the owning light's area.
    m = mt.archetype.shape[0]
    emission_radiance = np.zeros((m, 3), np.float32)
    light_area_by_mat = {}
    for li in range(scene.lights.num_lights):
        mid = int(scene.lights.material_id[li])
        if mid >= 0:
            light_area_by_mat[mid] = float(scene.lights.area[li])
    for i in range(m):
        if mt.emission_mode[i] == int(EmissionMode.RADIANT_EXITANCE):
            emission_radiance[i] = mt.emission_intensity[i] / M_PI
        elif mt.emission_mode[i] == int(EmissionMode.POWER):
            area = light_area_by_mat.get(i, 1.0)
            emission_radiance[i] = mt.emission_intensity[i] / (M_PI * max(area, 1e-9))

    # Per-light emitted radiance for NEE sampling of mesh lights
    lr = np.zeros((max(scene.lights.num_lights, 1), 3), np.float32)
    for li in range(scene.lights.num_lights):
        mid = int(scene.lights.material_id[li])
        if mid >= 0:
            lr[li] = emission_radiance[mid]

    # merged per-material shade row (mat_row_layout order; ints as f32)
    k_curve = mt.curve.shape[1]
    _, row_w = mat_row_layout(k_curve)
    f32 = lambda x: np.asarray(x, np.float32).reshape(m, -1)
    mat_row = np.concatenate(
        [
            f32(mt.albedo), f32(mt.roughness), f32(mt.ior),
            f32(emission_radiance),
            f32(mt.archetype), f32(mt.thin_walled),
            f32(mt.uv_xf),
            f32(mt.albedo_tex), f32(mt.cutout_tex), f32(mt.emission_tex),
            f32(mt.cutout_opacity),
            f32(mt.sigma_a), f32(mt.sigma_s), f32(mt.volume_bias),
            f32(mt.mbsdf_index), f32(mt.mbsdf_multiplier),
            f32(mt.archetype2), f32(mt.albedo2), f32(mt.roughness2),
            f32(mt.blend_mode), f32(mt.blend_w1), f32(mt.blend_w2),
            f32(mt.blend_ior),
            f32(mt.mod_mode), f32(mt.mod_a), f32(mt.mod_b), f32(mt.mod_exp),
            f32(mt.curve),
            f32(mt.hair_roughness), f32(mt.hair_absorption),
            f32(mt.hair_cuticle_angle), f32(mt.hair_diffuse_weight),
            f32(mt.noise_mode), f32(mt.noise_color1), f32(mt.noise_color2),
            f32(mt.noise_scale), f32(mt.noise_levels),
            f32(mt.noise_absolute), f32(mt.noise_thr), f32(mt.noise_marble),
            f32(mt.noise_target), f32(mt.noise_bump_factor),
        ],
        axis=-1,
    )
    assert mat_row.shape[1] == row_w, (mat_row.shape, row_w)

    return dict(
        mat_row=_h(mat_row),
        mat_pack=_h(
            np.concatenate(
                [
                    np.asarray(mt.albedo, np.float32).reshape(m, 3),
                    np.asarray(mt.roughness, np.float32).reshape(m, 2),
                    np.asarray(mt.ior, np.float32).reshape(m, 1),
                    emission_radiance,
                ],
                axis=-1,
            )
        ),
        mat_meta=_h(
            np.stack([mt.archetype, mt.thin_walled], axis=-1), jnp.int32
        ),
        mat_archetype=_h(mt.archetype, jnp.int32),
        mat_albedo=_h(mt.albedo),
        mat_roughness=_h(mt.roughness),
        mat_ior=_h(mt.ior),
        mat_thin_walled=_h(mt.thin_walled, jnp.int32),
        mat_emission_radiance=_h(emission_radiance),
        mat_sigma_a=_h(mt.sigma_a),
        mat_sigma_s=_h(mt.sigma_s),
        mat_volume_bias=_h(mt.volume_bias),
        mat_hair_roughness=_h(mt.hair_roughness),
        mat_hair_absorption=_h(mt.hair_absorption),
        mat_hair_cuticle=_h(mt.hair_cuticle_angle),
        mat_hair_diffuse_weight=_h(mt.hair_diffuse_weight),
        mat_albedo_tex=_h(mt.albedo_tex, jnp.int32),
        mat_cutout_tex=_h(mt.cutout_tex, jnp.int32),
        mat_emission_tex=_h(mt.emission_tex, jnp.int32),
        mat_cutout_opacity=_h(mt.cutout_opacity),
        mat_uv_xf=_h(mt.uv_xf),
        atlas=mt.atlas.device_arrays(),
        mat_archetype2=_h(mt.archetype2, jnp.int32),
        mat_albedo2=_h(mt.albedo2),
        mat_roughness2=_h(mt.roughness2),
        mat_blend_mode=_h(mt.blend_mode, jnp.int32),
        mat_blend_w1=_h(mt.blend_w1),
        mat_blend_w2=_h(mt.blend_w2),
        mat_blend_ior=_h(mt.blend_ior),
        mat_curve=_h(mt.curve),
        mat_mod_mode=_h(mt.mod_mode, jnp.int32),
        mat_mod_a=_h(mt.mod_a),
        mat_mod_b=_h(mt.mod_b),
        mat_mod_exp=_h(mt.mod_exp),
        mat_mbsdf_index=_h(mt.mbsdf_index, jnp.int32),
        mat_mbsdf_multiplier=_h(mt.mbsdf_multiplier),
        mbsdf=MBSDFTables(
            eval_data=_h(mt.mbsdf.eval),
            cdf_theta=_h(mt.mbsdf.cdf_theta),
            cdf_phi=_h(mt.mbsdf.cdf_phi),
            albedo=_h(mt.mbsdf.albedo),
            max_albedo=_h(mt.mbsdf.max_albedo),
            has_part=_h(mt.mbsdf.has_part),
        ),
        lights=upload_lights(scene.lights, lr),
    )


def patch_materials(dev: DeviceScene, scene: Scene) -> DeviceScene:
    """Re-derive the material-dependent device arrays after a live material
    edit (the analog of the reference GUI editing an MDL argument block and
    re-uploading it, ``Device::updateMaterial``, ``Device.cpp:1700-1722``)
    WITHOUT rebuilding geometry, BVH, or curve tables."""
    from ..utils.device_pack import device_put_packed

    return dev._replace(**device_put_packed(_material_arrays(scene)))


def upload_scene(scene: Scene, use_bvh: Optional[bool] = None) -> DeviceScene:
    bvh = None
    if use_bvh is None:
        use_bvh = scene.num_triangles > 16384
    if use_bvh and scene.num_triangles > 0:
        # wide BVH (ops/bvh_wide.py): one gathered row box-tests all of a
        # node's subtrees (identical hits to the binary skip-link walk)
        from ..ops.bvh_wide import build_wide_bvh

        # 16-wide nodes + 16-prim leaves: the best of an 8/16/32 sweep on
        # an earlier accelerator, where wider rows that halve the row count
        # won twice (fewer steps, smaller table); not yet re-measured on
        # the GPU.
        wide = build_wide_bvh(
            scene.p0, scene.p1, scene.p2, branch=16, leaf_size=16
        )
        # NOTE: split_rows_u16 (two u16 half-table gathers) was faster in
        # isolation but slower inside the walk's while body (the second
        # gather defeats XLA's fusion schedule), so the f32 table stays the
        # production layout; the split path remains parity-tested.
        bvh = {k: _h(v) for k, v in wide.items()}

    curves = curve_bvh = None
    if scene.curves is not None and scene.curves.num > 0:
        from ..ops.curve_intersect import (
            CurveSoA, build_curve_bvh, build_wide_curve_bvh,
        )

        curves = CurveSoA.build(scene.curves)
        # same policy as triangles: the 8-wide walk is the production
        # traversal for large primitive counts;
        # small strand sets keep the binary skip-link walk
        build = (
            build_wide_curve_bvh if scene.curves.num > 16384
            else build_curve_bvh
        )
        curve_bvh = {
            k: _h(v) for k, v in build(scene.curves).items()
        }

    from ..utils.device_pack import device_put_packed

    p0 = _h(scene.p0)
    e1 = _h(scene.p1) - p0
    e2 = _h(scene.p2) - p0
    dev = DeviceScene(
        tris=TriSoA(p0=p0, e1=e1, e2=e2, packed=None),
        n0=_h(scene.n0),
        n1=_h(scene.n1),
        n2=_h(scene.n2),
        tri_material=_h(scene.material_id, jnp.int32),
        tri_light=_h(scene.light_id, jnp.int32),
        uv0=_h(scene.uv0),
        uv1=_h(scene.uv1),
        uv2=_h(scene.uv2),
        tri_pack=None,
        tri_uvpack=None,
        tri_meta=None,
        tri_shade=None,
        **_material_arrays(scene),
        bvh=bvh,
        curves=curves,
        curve_bvh=curve_bvh,
    )
    # Everything above is host numpy; ONE packed transfer per dtype + one
    # unpack program instead of ~100 per-array round trips. The packed
    # gather variants (tris.packed / tri_pack / tri_uvpack / tri_meta) are
    # pure concatenations of arrays already shipped, so they are DERIVED on
    # device in one extra program instead of transferred.
    dev = device_put_packed(dev)
    packed, tri_pack, tri_uvpack, tri_meta, tri_shade = _derive_packed(
        dev.tris.p0, dev.tris.e1, dev.tris.e2,
        dev.n0, dev.n1, dev.n2, dev.uv0, dev.uv1, dev.uv2,
        dev.tri_material, dev.tri_light,
    )
    return dev._replace(
        tris=dev.tris._replace(packed=packed),
        tri_pack=tri_pack,
        tri_uvpack=tri_uvpack,
        tri_meta=tri_meta,
        tri_shade=tri_shade,
    )


@jax.jit
def _derive_packed(p0, e1, e2, n0, n1, n2, uv0, uv1, uv2, mat, light):
    packed = jnp.concatenate([p0, e1, e2], axis=-1)
    tri_pack = jnp.concatenate([n0, n1, n2], axis=-1)
    tri_uvpack = jnp.concatenate([uv0, uv1, uv2], axis=-1)
    tri_meta = jnp.stack([mat, light], axis=-1)
    # tri_shade: everything the bounce body needs per hit in ONE row —
    # geometry | shading normals | texcoords | meta (i32 bits as f32)
    tri_shade = jnp.concatenate(
        [
            packed, tri_pack, tri_uvpack,
            jax.lax.bitcast_convert_type(tri_meta, jnp.float32),
        ],
        axis=-1,
    )
    return packed, tri_pack, tri_uvpack, tri_meta, tri_shade

