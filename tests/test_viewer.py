"""HTTP live viewer (interactive presentation path)."""

import os
import io
import json
import urllib.request

import numpy as np
from PIL import Image

from nrc_tpu.app.viewer import Viewer
from nrc_tpu.scene.camera import Camera

CORNELL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "cornell"
)


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read()


def test_viewer_serves_frames_and_controls():
    v = Viewer(port=0)
    try:
        # page
        page = _get(v.url).decode()
        assert "frame.png" in page and "orbit" in page
        assert "lossplot" in page  # loss sparkline (Stats-window plot)

        # publish a frame, read it back
        img = np.zeros((8, 8, 3), np.uint8)
        img[:, :, 0] = 255
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        v.publish(buf.getvalue(), iteration=3, fps=1.5, loss=0.25,
                  loss_history=[1.0, 0.5, 0.25])

        back = np.asarray(Image.open(io.BytesIO(_get(v.url + "frame.png"))))
        assert back.shape[:2] == (8, 8) and back[0, 0, 0] == 255

        stats = json.loads(_get(v.url + "stats"))
        assert stats == {"iteration": 3, "fps": 1.5, "loss": 0.25,
                         "loss_history": [1.0, 0.5, 0.25]}

        # camera verbs round-trip through the event queue
        _get(v.url + "control?op=orbit&dx=0.25&dy=0.1")
        _get(v.url + "control?op=dolly&d=1")
        _get(v.url + "control?op=pan&dx=0.1&dy=0.0")
        _get(v.url + "control?op=zoom&d=-1")
        cam = Camera(distance=10.0, fov=60.0)
        phi0, d0, c0, fov0 = cam.phi, cam.distance, cam.center, cam.fov
        assert v.apply_events(cam) is True
        assert cam.phi != phi0 and cam.distance != d0
        assert cam.center != c0 and cam.fov != fov0
        assert v.apply_events(cam) is False  # queue drained
    finally:
        v.close()


def test_camera_verbs():
    cam = Camera(center=(0.0, 1.0, 0.0), distance=5.0)
    p0, _, _, w0 = cam.frustum()
    cam.pan(0.5, 0.0)
    assert not np.allclose(cam.center, (0.0, 1.0, 0.0))
    cam.zoom(200.0)
    assert cam.fov == 179.0
    cam.focus((2.0, 0.0, 1.0))
    assert np.allclose(cam.center, (2.0, 0.0, 1.0))
    assert cam.distance > 0.0


def test_action_endpoint():
    """P/H/S key-handler parity + cache reset route through /action."""
    from nrc_tpu.app.viewer import Viewer

    v = Viewer(port=0)
    try:
        for op in ("screenshot_png", "screenshot_hdr", "save_system",
                   "reset_cache", "bogus_op"):
            _get(v.url + f"action?op={op}")
        acts = v.drain_actions()
        assert acts == ["screenshot_png", "screenshot_hdr", "save_system",
                        "reset_cache"]  # bogus filtered
        assert v.drain_actions() == []
        # page advertises the buttons/keys
        page = _get(v.url)
        assert b"screenshot_png" in page and b"keydown" in page
    finally:
        v.close()


def test_params_and_set_endpoints():
    """Control-panel endpoints: /params serves the GUI state (render-mode
    radio, encoding combo, sliders, material Param_info analog) and /set
    queues edits for the render loop."""
    import json
    import urllib.request

    from nrc_tpu.app.viewer import Viewer

    v = Viewer(port=0)
    try:
        v.params_provider = lambda: {
            "render_mode": "FULL",
            "render_modes": ["FULL", "NO_CACHE"],
            "encoding": "frequency",
            "learning_rate": 1e-3,
            "train_unbiased_ratio": 1 / 16,
            "area_spread_factor": 0.01,
            "tonemapper": {"gamma": 2.2},
            "materials": [{"index": 0, "name": "m", "albedo": [1, 1, 1],
                           "roughness": [0, 0], "ior": 1.5,
                           "thin_walled": False,
                           "emission_intensity": [0, 0, 0]}],
        }
        got = json.loads(
            urllib.request.urlopen(v.url + "params", timeout=5).read()
        )
        assert got["render_mode"] == "FULL"
        assert got["materials"][0]["name"] == "m"

        urllib.request.urlopen(
            v.url + "set?key=learning_rate&value=0.01", timeout=5
        ).read()
        urllib.request.urlopen(
            v.url + "set?material=0&key=albedo&value=0.9%2C0.1%2C0.1",
            timeout=5,
        ).read()
        edits = v.drain_settings()
        assert edits[0] == {
            "key": "learning_rate", "value": "0.01", "material": None
        }
        assert edits[1]["material"] == 0 and edits[1]["key"] == "albedo"
    finally:
        v.close()


def test_apply_setting_roundtrip():
    """_apply_setting drives the real renderer methods (encoding re-init,
    hyperparams, tonemapper, material edit)."""
    from nrc_tpu.app.cli import _apply_setting, _gui_params
    from nrc_tpu.config import RenderMode
    from nrc_tpu.render.renderer import Renderer
    from nrc_tpu.scene.scene_builder import load_scene

    scene, system = load_scene(
        f"{CORNELL}/system_mdl_cornell.txt",
        f"{CORNELL}/scene_mdl_cornell.txt",
    )
    system.resolution = (32, 32)
    r = Renderer(scene, system, train=False, adaptive_tiles=False)

    _apply_setting(r, {"key": "render_mode", "value": "NO_CACHE",
                       "material": None})
    assert r.cfg.render_mode == RenderMode.NO_CACHE
    _apply_setting(r, {"key": "learning_rate", "value": "0.005",
                       "material": None})
    assert abs(r.hyper.learning_rate - 0.005) < 1e-9
    _apply_setting(r, {"key": "tm_gamma", "value": "1.8", "material": None})
    assert abs(r.system.tonemapper.gamma - 1.8) < 1e-9
    _apply_setting(r, {"key": "albedo", "value": "0.9,0.1,0.1",
                       "material": 0})
    import numpy as np

    np.testing.assert_allclose(
        np.asarray(r.device_scene.mat_albedo[0]), [0.9, 0.1, 0.1], rtol=1e-6
    )
    # encoding switch re-creates the network (Device.cpp:2409-2421)
    w_before = r.net_state.params
    _apply_setting(r, {"key": "encoding", "value": "hash", "material": None})
    from nrc_tpu.config import InputEncoding

    assert r.net_cfg.encoding == InputEncoding.HASH
    assert abs(r.hyper.learning_rate - 1e-2) < 1e-12
    assert type(r.net_state.params) is not type(None)
    assert r.net_state.params is not w_before
    p = _gui_params(r)
    assert p["encoding"] == "hash"
    assert p["materials"][0]["albedo"] == [0.9, 0.1, 0.1]
