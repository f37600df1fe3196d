"""Scene assembly: parsed description -> flat SoA device-ready arrays.

The equivalent of the reference's scene upload path:
``Raytracer::initScene`` -> ``traverseNode`` geometry dedup/flatten
(``nrc/src/Raytracer.cpp:574-621,883-1025``) + ``Device::createGeometry`` /
``createTLAS`` / ``createGeometryInstanceData`` (``Device.cpp:1845-2253``)
+ ``Application::createMeshLights`` (``Application.cpp:2079-2238``).

Rather than a two-level BVH with per-instance GAS sharing, the builder
bakes instance transforms into one flat world-space triangle soup (what
the brute-force intersector and the single-level BVH take); instancing-aware
traversal can layer on later without changing this interface.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import SystemConfig
from . import geometry as geo
from .camera import Camera
from .lights import (
    TYPE_LIGHT_ENV_CONST,
    TYPE_LIGHT_ENV_SPHERE,
    TYPE_LIGHT_IES,
    TYPE_LIGHT_MESH,
    TYPE_LIGHT_POINT,
    TYPE_LIGHT_SPOT,
    LightTable,
    build_env_cdf,
    build_mesh_light,
    empty_light_table,
)
from .materials import Material, MaterialTable
from .mdl import load_material
from .parser import SceneDescription, parse_scene_description, parse_system_description


@dataclasses.dataclass
class Scene:
    """Flat world-space triangle scene + materials + lights + camera."""

    # triangles (world space, per-vertex attributes)
    p0: np.ndarray  # [T, 3] f32
    p1: np.ndarray
    p2: np.ndarray
    n0: np.ndarray  # [T, 3] f32 shading normals
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray  # [T, 2] f32
    uv1: np.ndarray
    uv2: np.ndarray
    material_id: np.ndarray  # [T] int32
    light_id: np.ndarray     # [T] int32, -1 if not emissive

    materials: MaterialTable
    material_rows: List[Material]
    lights: LightTable
    camera: Camera
    lens_shader: int = 0
    # curve primitives (hair strands as rounded-cone soup; scene/hair.py)
    curves: object = None  # Optional[CurveSegments]
    # per-material load report (mdl.load_material): status / archetype /
    # fallback reasons — the loud-failure analog of the reference's MDL
    # message relay (Raytracer.cpp:1655-1669)
    material_report: Optional[List[dict]] = None

    def material_load_warnings(self) -> List[dict]:
        return [
            e for e in (self.material_report or []) if e["status"] != "ok"
        ]

    @property
    def num_triangles(self) -> int:
        return int(self.p0.shape[0])

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        if self.num_triangles == 0 and self.curves is not None:
            lo = (self.curves.pa - self.curves.ra[:, None]).min(0)
            hi = (self.curves.pa + self.curves.ra[:, None]).max(0)
            return lo.astype(np.float32), hi.astype(np.float32)
        lo = np.minimum(np.minimum(self.p0.min(0), self.p1.min(0)), self.p2.min(0))
        hi = np.maximum(np.maximum(self.p0.max(0), self.p1.max(0)), self.p2.max(0))
        if self.curves is not None and self.curves.num:
            lo = np.minimum(lo, (self.curves.pa - self.curves.ra[:, None]).min(0))
            hi = np.maximum(hi, (self.curves.pa + self.curves.ra[:, None]).max(0))
        return lo, hi


def _make_mesh(decl) -> geo.Mesh:
    if decl.kind == "plane":
        tu, tv, up = decl.args
        return geo.create_plane(tu, tv, up)
    if decl.kind == "box":
        return geo.create_box()
    if decl.kind == "sphere":
        tu, tv, theta = decl.args
        return geo.create_sphere(tu, tv, 1.0, theta * np.pi)
    if decl.kind == "torus":
        tu, tv, inner, outer = decl.args
        return geo.create_torus(tu, tv, inner, outer)
    if decl.kind == "assimp":
        # mesh import by extension (Assimp stand-in, Assimp.cpp:54-239)
        ext = os.path.splitext(decl.path)[1].lower()
        if ext == ".ply":
            from .ply_loader import load_ply

            return load_ply(decl.path)
        if ext in (".gltf", ".glb"):
            from .gltf_loader import load_gltf

            return load_gltf(decl.path)
        if ext == ".stl":
            from .stl_loader import load_stl

            return load_stl(decl.path)
        if ext == ".fbx":
            from .fbx_loader import load_fbx

            return load_fbx(decl.path)
        if ext == ".dae":
            from .dae_loader import load_dae

            return load_dae(decl.path)
        if ext == ".3ds":
            from .tds_loader import load_3ds

            return load_3ds(decl.path)
        from .obj_loader import load_obj  # lazy: optional subsystem

        return load_obj(decl.path)
    raise ValueError(f"unsupported model kind {decl.kind!r}")


def build_scene(
    desc: SceneDescription,
    system: SystemConfig,
    base_dir: str = "",
) -> Scene:
    search_paths = tuple(
        os.path.join(base_dir, sp) if not os.path.isabs(sp) else sp
        for sp in (system.search_paths or ("",))
    ) + (base_dir,)

    # ---- materials ----------------------------------------------------
    mat_rows: List[Material] = []
    mat_index: Dict[str, int] = {}
    mat_report: List[dict] = []
    for mdecl in desc.materials:
        mat = load_material(
            search_paths, mdecl.path, mdecl.reference, report=mat_report
        )
        mat_index[mdecl.reference] = len(mat_rows)
        mat_rows.append(mat)
    if not mat_rows:
        mat_rows.append(Material(name="default"))
    default_mat = 0

    # ---- geometry -----------------------------------------------------
    meshes: List[geo.Mesh] = []
    mesh_material: List[int] = []
    curve_parts = []
    for mdl in desc.models:
        if mdl.kind == "hair":
            # model hair <thickness_scale> <mat> "<file.hair>"
            # (sg::Curves::createHair, Curves.cpp:104-315)
            from .hair import hair_to_segments, load_hair, transform_segments

            path = None
            for sp in search_paths:
                p = os.path.join(sp, mdl.path) if sp else mdl.path
                if os.path.isfile(p):
                    path = p
                    break
            if path is None:
                continue
            seg = hair_to_segments(
                load_hair(path),
                material_id=mat_index.get(mdl.material_ref, default_mat),
                thickness_scale=float(mdl.args[0]) if mdl.args else 1.0,
            )
            curve_parts.append(transform_segments(seg, mdl.matrix))
            continue
        try:
            mesh = _make_mesh(mdl)
        except Exception:
            continue
        mesh = geo.transform_mesh(mesh, mdl.matrix)
        meshes.append(mesh)
        mesh_material.append(mat_index.get(mdl.material_ref, default_mat))

    curves = None
    if curve_parts:
        import dataclasses as _dc

        first = curve_parts[0]
        if len(curve_parts) > 1:
            merged = {}
            for f in _dc.fields(first):
                merged[f.name] = np.concatenate(
                    [getattr(cp, f.name) for cp in curve_parts]
                )
            curves = type(first)(**merged)
        else:
            curves = first

    tri_p, tri_n, tri_uv, tri_mat = [], [], [], []
    for mesh, mid in zip(meshes, mesh_material):
        idx = mesh.indices.astype(np.int64)
        tri_p.append(
            (mesh.vertices[idx[:, 0]], mesh.vertices[idx[:, 1]], mesh.vertices[idx[:, 2]])
        )
        tri_n.append(
            (mesh.normals[idx[:, 0]], mesh.normals[idx[:, 1]], mesh.normals[idx[:, 2]])
        )
        tri_uv.append(
            (mesh.texcoords[idx[:, 0]], mesh.texcoords[idx[:, 1]], mesh.texcoords[idx[:, 2]])
        )
        tri_mat.append(np.full(idx.shape[0], mid, np.int32))

    if tri_p:
        p0 = np.concatenate([t[0] for t in tri_p])
        p1 = np.concatenate([t[1] for t in tri_p])
        p2 = np.concatenate([t[2] for t in tri_p])
        n0 = np.concatenate([t[0] for t in tri_n])
        n1 = np.concatenate([t[1] for t in tri_n])
        n2 = np.concatenate([t[2] for t in tri_n])
        uv0 = np.concatenate([t[0] for t in tri_uv])
        uv1 = np.concatenate([t[1] for t in tri_uv])
        uv2 = np.concatenate([t[2] for t in tri_uv])
        material_id = np.concatenate(tri_mat)
    else:
        p0 = p1 = p2 = n0 = n1 = n2 = np.zeros((0, 3), np.float32)
        uv0 = uv1 = uv2 = np.zeros((0, 2), np.float32)
        material_id = np.zeros((0,), np.int32)

    # ---- lights -------------------------------------------------------
    lt = _build_lights(
        desc, search_paths, mat_rows, p0, p1, p2, n0, n1, n2,
        uv0, uv1, uv2, material_id,
    )
    light_table, light_id = lt

    # ---- camera -------------------------------------------------------
    center = desc.center if desc.center is not None else system.center
    cam_params = desc.camera if desc.camera is not None else system.camera
    camera = Camera(
        center=tuple(center),
        phi=cam_params[0],
        theta=cam_params[1],
        fov=cam_params[2],
        distance=cam_params[3],
        aspect=system.resolution[0] / max(system.resolution[1], 1),
    )
    lens = desc.lens_shader if desc.lens_shader is not None else system.lens_shader

    return Scene(
        p0=p0, p1=p1, p2=p2,
        n0=n0, n1=n1, n2=n2,
        uv0=uv0, uv1=uv1, uv2=uv2,
        material_id=material_id,
        light_id=light_id,
        materials=MaterialTable.build(mat_rows),
        material_rows=mat_rows,
        lights=light_table,
        camera=camera,
        lens_shader=lens,
        curves=curves,
        material_report=mat_report,
    )


def _build_lights(
    desc: SceneDescription,
    search_paths,
    mat_rows: List[Material],
    p0, p1, p2, n0, n1, n2,
    uv0, uv1, uv2,
    material_id: np.ndarray,
) -> tuple[LightTable, np.ndarray]:
    """Declared lights + implicit mesh lights from emissive materials."""
    types: List[int] = []
    matrices: List[np.ndarray] = []
    emissions: List[Tuple[float, float, float]] = []
    areas: List[float] = []
    inv_integrals: List[float] = []
    spot_half: List[float] = []
    spot_exp: List[float] = []
    mat_ids: List[int] = []
    tri_start: List[int] = []
    tri_count: List[int] = []
    mesh_tris: List[tuple] = []
    env_texture = env_cdf_u = env_cdf_v = env_cube = None
    ies_textures: List[np.ndarray] = []
    ies_index: List[int] = []

    def add(ltype, matrix, emission, area=0.0, inv_integral=0.0, sa=45.0, se=0.0, mid=-1,
            ts=0, tc=0, ies=-1):
        types.append(ltype)
        ies_index.append(ies)
        matrices.append(np.asarray(matrix, np.float32))
        emissions.append(emission)
        areas.append(area)
        inv_integrals.append(inv_integral)
        spot_half.append(np.radians(min(sa, 180.0) * 0.5))
        spot_exp.append(se)
        mat_ids.append(mid)
        tri_start.append(ts)
        tri_count.append(tc)

    # Declared lights. Env lights must come first (reference Device.cpp:1544).
    decls = sorted(desc.lights, key=lambda l: 0 if l.light_type == "env" else 1)
    for ld in decls:
        emission = tuple(c * ld.multiplier for c in ld.emission)
        if ld.light_type == "env":
            if ld.texture:
                tex, cube = _load_env_texture(search_paths, ld.texture)
                if tex is not None:
                    env_texture = tex
                    env_cube = cube
                    env_cdf_u, env_cdf_v, integral = build_env_cdf(tex)
                    if cube is not None:
                        # cube maps: integral over the ACTUAL face texels
                        # (intensity x exact texel solid angle) so the MIS
                        # pdf convention matches the cube-built importance
                        # tables (ops/light_sampling.py) — the equirect
                        # proxy is display/fallback only
                        from .lights import build_cube_env_weights

                        _, integral = build_cube_env_weights(cube)
                    add(
                        TYPE_LIGHT_ENV_SPHERE, ld.matrix,
                        emission if any(emission) else (1.0, 1.0, 1.0),
                        inv_integral=1.0 / integral,
                    )
                    continue
            add(TYPE_LIGHT_ENV_CONST, ld.matrix, emission if any(emission) else (1.0, 1.0, 1.0))
        elif ld.light_type == "point":
            add(TYPE_LIGHT_POINT, ld.matrix, emission)
        elif ld.light_type == "spot":
            add(TYPE_LIGHT_SPOT, ld.matrix, emission, sa=ld.spot_angle, se=ld.spot_exponent)
        elif ld.light_type == "ies":
            # emissionProfile "<file.ies>" -> goniometric candela texture
            # (Application.cpp:2042-2052 LoaderIES -> Picture::createIES)
            prof = -1
            if ld.profile:
                from .ies import ies_to_texture, load_ies

                for sp in search_paths:
                    p = os.path.join(sp, ld.profile) if sp else ld.profile
                    if os.path.isfile(p):
                        ies_textures.append(ies_to_texture(load_ies(p)))
                        prof = len(ies_textures) - 1
                        break
            add(TYPE_LIGHT_IES, ld.matrix, emission, ies=prof)

    # Implicit mesh lights: one light per emissive material's triangle set
    # (reference groups per Instance; with a flattened scene, per material
    # gives identical sampling density because the CDF is area-weighted).
    light_id = np.full(material_id.shape[0], -1, np.int32)
    for mid, mat in enumerate(mat_rows):
        if not mat.is_emissive:
            continue
        mask = material_id == mid
        if not np.any(mask):
            continue
        sel = np.nonzero(mask)[0]
        cdf, area = build_mesh_light(p0[sel], p1[sel], p2[sel])
        start = len(mesh_tris and np.concatenate([m[0] for m in mesh_tris])) if mesh_tris else 0
        start = sum(m[0].shape[0] for m in mesh_tris)
        mesh_tris.append(
            (p0[sel], p1[sel], p2[sel], n0[sel], n1[sel], n2[sel], cdf,
             uv0[sel], uv1[sel], uv2[sel])
        )
        light_id[sel] = len(types)
        add(
            TYPE_LIGHT_MESH, np.eye(4), (1.0, 1.0, 1.0),
            area=area, mid=mid, ts=start, tc=sel.shape[0],
        )

    if not types:
        table = empty_light_table()
        return table, light_id

    if mesh_tris:
        mp0 = np.concatenate([m[0] for m in mesh_tris])
        mp1 = np.concatenate([m[1] for m in mesh_tris])
        mp2 = np.concatenate([m[2] for m in mesh_tris])
        mn0 = np.concatenate([m[3] for m in mesh_tris])
        mn1 = np.concatenate([m[4] for m in mesh_tris])
        mn2 = np.concatenate([m[5] for m in mesh_tris])
        mcdf = np.concatenate([m[6] for m in mesh_tris])
        muv0 = np.concatenate([m[7] for m in mesh_tris])
        muv1 = np.concatenate([m[8] for m in mesh_tris])
        muv2 = np.concatenate([m[9] for m in mesh_tris])
    else:
        mp0 = mp1 = mp2 = mn0 = mn1 = mn2 = np.zeros((0, 3), np.float32)
        mcdf = np.zeros((0,), np.float32)
        muv0 = muv1 = muv2 = np.zeros((0, 2), np.float32)

    mats = np.stack(matrices)
    table = LightTable(
        type=np.asarray(types, np.int32),
        matrix=mats,
        matrix_inv=np.stack([np.linalg.inv(m) for m in mats]).astype(np.float32),
        emission=np.asarray(emissions, np.float32),
        area=np.asarray(areas, np.float32),
        inv_integral=np.asarray(inv_integrals, np.float32),
        spot_angle_half=np.asarray(spot_half, np.float32),
        spot_exponent=np.asarray(spot_exp, np.float32),
        material_id=np.asarray(mat_ids, np.int32),
        tri_start=np.asarray(tri_start, np.int32),
        tri_count=np.asarray(tri_count, np.int32),
        mesh_p0=mp0, mesh_p1=mp1, mesh_p2=mp2,
        mesh_n0=mn0, mesh_n1=mn1, mesh_n2=mn2,
        mesh_cdf=mcdf,
        mesh_uv0=muv0, mesh_uv1=muv1, mesh_uv2=muv2,
        env_texture=env_texture,
        env_cdf_u=env_cdf_u,
        env_cdf_v=env_cdf_v,
        env_cube=env_cube,
        ies_texture=np.stack(ies_textures) if ies_textures else None,
        ies_index=np.asarray(ies_index, np.int32),
    )
    return table, light_id


def _load_env_texture(search_paths, filename: str):
    """Env map file -> (equirect [H, W, 3], cube [6, Hc, Wc, 3] | None).

    Radiance .hdr loads as the usual lat-long map. A DDS CUBE map loads all
    six faces (``Picture.cpp`` cube path); an equirect PROXY is resampled
    from the faces for the importance-sampling tables while radiance
    evaluation uses true cube lookups (``ops/texture.py::sample_cube_env``,
    the analog of the reference's cudaTextureCubemap objects,
    ``Device.cpp:3014-3283``)."""
    from ..utils.hdr_loader import load_radiance_hdr

    for sp in search_paths + ("",):
        p = os.path.join(sp, filename) if sp else filename
        if not os.path.isfile(p):
            continue
        try:
            if p.lower().endswith(".dds"):
                from .dds_loader import load_dds

                img = load_dds(p)
                if img.ndim == 4:  # cube: [6, H, W, 4]
                    cube = np.ascontiguousarray(
                        img[..., :3], dtype=np.float32
                    )
                    return _equirect_from_cube(cube), cube
                return np.ascontiguousarray(img[..., :3], np.float32), None
            return load_radiance_hdr(p), None
        except Exception:
            return None, None
    return None, None


def _equirect_from_cube(cube: np.ndarray, height: int = 0) -> np.ndarray:
    """Nearest-sampled lat-long proxy of a cube map (importance tables)."""
    fh = cube.shape[1]
    h = height or max(2 * fh, 8)
    w = 2 * h
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = u * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    # same object-space mapping as the env sampler (light_sample.cu:95-106)
    d = np.stack(
        [
            np.sin(phi)[None, :] * st,
            np.broadcast_to(-np.cos(theta)[:, None], (h, w)),
            -np.cos(phi)[None, :] * st,
        ],
        axis=-1,
    ).reshape(-1, 3)
    from ..ops.texture import sample_cube_env

    out = np.asarray(sample_cube_env(cube, d.astype(np.float32)))
    return out.reshape(h, w, 3).astype(np.float32)


def load_scene(
    system_path: str, scene_path: str
) -> tuple[Scene, SystemConfig]:
    """Load a reference-format (system.txt, scene.txt) pair."""
    system = parse_system_description(system_path)
    desc = parse_scene_description(scene_path)
    if desc.tonemapper is not None:
        system.tonemapper = desc.tonemapper
    scene = build_scene(desc, system, base_dir=os.path.dirname(scene_path))
    return scene, system
