"""Scene layer tests: parser, MDL reader, geometry, scene build on the
repository's Cornell data files (data/cornell/)."""

import os
import numpy as np
import pytest

from nrc_tpu.config import SystemConfig
from nrc_tpu.scene import geometry as geo
from nrc_tpu.scene.materials import Archetype, EmissionMode
from nrc_tpu.scene.mdl import parse_mdl_material
from nrc_tpu.scene.parser import (
    parse_scene_description,
    parse_system_description,
    tokenize,
)
from nrc_tpu.scene.scene_builder import load_scene

REF = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "cornell"
)

# MDL in the grammar of the reference's sample materials
GGX_MDL = """mdl 1.7;
import ::df::*;
export material bsdf_microfacet_ggx_smith_reflect(
  uniform color parTint = color(1.0),
  uniform float parRoughness = 0.1
)
= material(
  surface: material_surface(
    scattering: df::microfacet_ggx_smith_bsdf(
      roughness_u: parRoughness,
      roughness_v: parRoughness,
      tint: parTint,
      mode: df::scatter_reflect
    )
  ),
  ior: color(1.5)
);
"""
GLASS_MDL = """mdl 1.7;
import ::df::*;
export material bsdf_specular_reflect_transmit(
  uniform color parTint = color(1.0),
  uniform bool parThinWalled = false
)
= material(
  thin_walled: parThinWalled,
  surface: material_surface(
    scattering: df::specular_bsdf(
      tint: parTint,
      mode: df::scatter_reflect_transmit
    )
  ),
  ior: color(1.5)
);
"""


class TestTokenizer:
    def test_comments_and_strings(self):
        toks = tokenize('a 1 2 # comment\n"quoted string" b')
        assert toks == ["a", "1", "2", "quoted string", "b"]


class TestSystemParser:
    def test_cornell_system(self):
        cfg = parse_system_description(f"{REF}/system_mdl_cornell.txt")
        assert cfg.resolution == (320, 320)
        assert cfg.samples_sqrt == 16
        assert cfg.path_lengths == (2, 6)
        assert cfg.walk_length == 2
        assert cfg.tile_size == (16, 16)
        assert cfg.tonemapper.gamma == pytest.approx(2.2)
        assert cfg.tonemapper.brightness == pytest.approx(0.8)
        assert cfg.camera == pytest.approx((0.75, 0.5, 60.0, 8.0))


class TestSceneParser:
    def test_cornell_scene(self):
        desc = parse_scene_description(f"{REF}/scene_mdl_cornell.txt")
        assert len(desc.models) == 8  # 6 planes + 2 boxes
        kinds = [m.kind for m in desc.models]
        assert kinds.count("plane") == 6 and kinds.count("box") == 2
        assert len(desc.materials) == 6
        assert desc.camera == pytest.approx((0.75, 0.5, 55.0, 20.0))
        assert desc.center == pytest.approx((0.0, 0.0, 15.0))
        # no declared lights: the ceiling quad's EDF is the only emitter
        assert len(desc.lights) == 0

    def test_big_variant_adds_one_sphere(self):
        base = parse_scene_description(f"{REF}/scene_mdl_cornell.txt")
        big = parse_scene_description(f"{REF}/scene_mdl_cornell_big.txt")
        assert len(big.models) == len(base.models) + 1
        sphere = big.models[-1]
        assert sphere.kind == "sphere" and sphere.args[:2] == (180, 90)

    def test_transform_stack(self):
        desc = parse_scene_description(f"{REF}/scene_mdl_cornell.txt")
        # floor: scale 10, translate y=-10
        floor = desc.models[0]
        v = floor.matrix @ np.array([0.0, 0.0, 0.0, 1.0])
        np.testing.assert_allclose(v[:3], [0.0, -10.0, 0.0], atol=1e-6)
        v = floor.matrix @ np.array([1.0, 0.0, 0.0, 1.0])
        np.testing.assert_allclose(v[:3], [10.0, -10.0, 0.0], atol=1e-6)
        # ceiling light: scale 2, rotate z 180, translate y=9.9
        light = desc.models[2]
        v = light.matrix @ np.array([0.0, 1.0, 0.0, 1.0])  # local +y
        np.testing.assert_allclose(v[:3], [0.0, 9.9 - 2.0, 0.0], atol=1e-5)


class TestMDL:
    def test_diffuse_red(self):
        m = parse_mdl_material(f"{REF}/mdl/bsdf_diffuse_reflection_c_red.mdl")
        assert m.archetype == Archetype.DIFFUSE_REFLECTION
        assert m.albedo == pytest.approx((0.63, 0.065, 0.05))
        assert not m.is_emissive

    def test_cornell_edf(self):
        m = parse_mdl_material(f"{REF}/mdl/edf_diffuse_cornell.mdl")
        assert m.emission_mode == EmissionMode.RADIANT_EXITANCE
        assert m.emission_intensity == pytest.approx((100.0, 100.0, 100.0))

    def test_ggx(self, tmp_path):
        p = tmp_path / "ggx.mdl"
        p.write_text(GGX_MDL)
        m = parse_mdl_material(str(p))
        assert m.archetype == Archetype.GGX_REFLECT
        assert m.roughness == pytest.approx((0.1, 0.1))
        assert m.ior == pytest.approx(1.5)

    def test_specular_glass(self, tmp_path):
        p = tmp_path / "glass.mdl"
        p.write_text(GLASS_MDL)
        m = parse_mdl_material(str(p))
        assert m.archetype == Archetype.SPECULAR_REFLECT_TRANSMIT
        assert not m.thin_walled


class TestGeometry:
    def test_plane(self):
        mesh = geo.create_plane(10, 10, 1)
        assert mesh.num_triangles == 200
        assert np.all(mesh.normals == [0.0, 1.0, 0.0])
        assert mesh.vertices[:, 1].max() == 0.0
        assert mesh.vertices[:, 0].min() == -1.0 and mesh.vertices[:, 0].max() == 1.0

    def test_box(self):
        mesh = geo.create_box()
        assert mesh.num_triangles == 12
        # outward normals: vertex . normal == 1 on the face plane
        idx = mesh.indices.astype(int)
        for f in range(12):
            n = mesh.normals[idx[f, 0]]
            for k in range(3):
                v = mesh.vertices[idx[f, k]]
                assert np.dot(v, n) == pytest.approx(1.0)
        # CCW winding consistent with normals
        p0, p1, p2 = (mesh.vertices[idx[:, k]] for k in range(3))
        gn = np.cross(p1 - p0, p2 - p0)
        sn = mesh.normals[idx[:, 0]]
        assert np.all(np.sum(gn * sn, axis=-1) > 0)

    def test_sphere_radius(self):
        mesh = geo.create_sphere(32, 16)
        r = np.linalg.norm(mesh.vertices, axis=-1)
        np.testing.assert_allclose(r, 1.0, atol=1e-5)
        # normals point outward
        d = np.sum(mesh.vertices * mesh.normals, axis=-1)
        np.testing.assert_allclose(d, 1.0, atol=1e-5)

    def test_torus(self):
        mesh = geo.create_torus(32, 16, 0.5, 2.0)
        ring = np.sqrt(mesh.vertices[:, 0] ** 2 + mesh.vertices[:, 2] ** 2)
        tube = np.sqrt((ring - 2.0) ** 2 + mesh.vertices[:, 1] ** 2)
        np.testing.assert_allclose(tube, 0.5, atol=1e-5)


class TestSceneBuild:
    def test_cornell_builds(self):
        scene, system = load_scene(
            f"{REF}/system_mdl_cornell.txt", f"{REF}/scene_mdl_cornell.txt"
        )
        # every material resolves from the repository, none degraded
        assert len(scene.material_report) == 6
        assert scene.material_load_warnings() == []
        assert system.resolution == (320, 320)
        assert system.path_lengths == (2, 6)
        assert sum(m.is_emissive for m in scene.material_rows) == 1
        # 6 planes x 200 tris + 2 boxes x 12 tris
        assert scene.num_triangles == 6 * 200 + 2 * 12
        lo, hi = scene.aabb()
        np.testing.assert_allclose(lo, [-10, -10, -10], atol=1e-4)
        np.testing.assert_allclose(hi, [10, 10, 10], atol=1e-4)
        # one implicit mesh light from the emissive ceiling plane
        assert scene.lights.num_lights == 1
        # light area: plane is [-1,1]^2 scaled by 2 -> 4x4 = 16
        assert scene.lights.area[0] == pytest.approx(16.0, rel=1e-3)
        # emissive tris tagged
        n_emissive = int(np.sum(scene.light_id >= 0))
        assert n_emissive == 200
        # camera from scene overrides
        assert scene.camera.distance == pytest.approx(20.0)
        assert scene.camera.fov == pytest.approx(55.0)
