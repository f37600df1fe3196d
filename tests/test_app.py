"""App-shell tests: CLI option parity (reference ``Options.cpp:45-157``) and
network checkpoint/resume round-trip (a capability the reference lacks,
SURVEY.md §5)."""

import os
import jax
import numpy as np

from nrc_tpu.app.cli import build_parser
from nrc_tpu.config import InputEncoding, NetworkConfig
from nrc_tpu.models import network as N
from nrc_tpu.models.checkpoint import load_checkpoint, save_checkpoint

CORNELL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "cornell"
)


class TestCLIParser:
    def test_reference_option_parity(self):
        args = build_parser().parse_args(
            ["-w", "640", "-h", "480", "-m", "1", "-s", "sys.txt", "-d", "scn.txt", "-o"]
        )
        assert args.width == 640 and args.height == 480
        assert args.mode == 1
        assert args.system == "sys.txt" and args.scene == "scn.txt"
        assert args.optimize

    def test_extensions(self):
        args = build_parser().parse_args(
            ["-s", "a", "-d", "b", "--encoding", "hash", "--render-mode", "no_cache",
             "--devices", "4", "--spp", "64"]
        )
        assert args.encoding == "hash" and args.devices == 4 and args.spp == 64


def _roundtrip(cfg: NetworkConfig, tmp_path):
    state = N.init_network(jax.random.PRNGKey(3), cfg)
    # train a step so optimizer moments are non-trivial
    q = jax.random.uniform(jax.random.PRNGKey(4), (128, 15))
    t = jax.random.uniform(jax.random.PRNGKey(5), (128, 3))
    state, _ = N.train_step(state, q, t, cfg, cfg.learning_rate)
    p = save_checkpoint(str(tmp_path / "ck"), state)
    loaded = load_checkpoint(p, cfg)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(loaded)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # resumed state is usable
    out = N.infer(loaded, q, cfg)
    assert np.all(np.isfinite(np.asarray(out)))


class TestCheckpoint:
    def test_roundtrip_frequency(self, tmp_path):
        _roundtrip(NetworkConfig(encoding=InputEncoding.FREQUENCY), tmp_path)

    def test_roundtrip_hash(self, tmp_path):
        _roundtrip(NetworkConfig(encoding=InputEncoding.HASH), tmp_path)

    def test_encoding_mismatch_raises(self, tmp_path):
        state = N.init_network(jax.random.PRNGKey(0), NetworkConfig())
        p = save_checkpoint(str(tmp_path / "ck"), state)
        import pytest

        with pytest.raises(ValueError):
            load_checkpoint(p, NetworkConfig(encoding=InputEncoding.HASH))


class TestRenderStateCheckpoint:
    def test_roundtrip_resumes_mid_accumulation(self, tmp_path):
        from nrc_tpu.config import RenderMode
        from nrc_tpu.models.checkpoint import (
            is_render_state,
            load_render_state,
            save_render_state,
        )
        from nrc_tpu.render.renderer import Renderer
        from nrc_tpu.scene.scene_builder import load_scene

        scene, system = load_scene(
            f"{CORNELL}/system_mdl_cornell.txt",
            f"{CORNELL}/scene_mdl_cornell.txt",
        )
        system.resolution = (16, 16)
        system.tile_size = (8, 8)
        r = Renderer(scene, system, render_mode=RenderMode.FULL, train=True,
                     adaptive_tiles=False)
        for _ in range(3):
            r.render_frame()
        p = save_render_state(str(tmp_path / "state"), r)
        assert is_render_state(p)

        # continue the original 2 more frames -> ground truth
        for _ in range(2):
            r.render_frame()
        img_truth = np.asarray(r.image)

        # fresh renderer resumes from the checkpoint and replays the tail
        r2 = Renderer(scene, system, render_mode=RenderMode.FULL, train=True,
                      adaptive_tiles=False)
        load_render_state(p, r2)
        assert r2.iteration == 3 and r2.total_subframe == 3
        for _ in range(2):
            r2.render_frame()
        np.testing.assert_allclose(np.asarray(r2.image), img_truth,
                                   rtol=1e-5, atol=1e-6)

    def test_network_only_detection(self, tmp_path):
        from nrc_tpu.models.checkpoint import is_render_state, save_checkpoint
        from nrc_tpu.models.network import init_network

        cfg = NetworkConfig()
        p = save_checkpoint(str(tmp_path / "net"), init_network(jax.random.PRNGKey(0), cfg))
        assert not is_render_state(p)


class TestLiveEncodingSwitch:
    def test_hyperparams_reresolved(self):
        """A live encoding switch must re-resolve the per-encoding EMA decay
        and Adam eps (round-3 advisor: dataclasses.replace carried the OLD
        encoding's resolved values — FREQ->HASH kept 0.95/1e-8 instead of
        tcnn's 0.99/1e-15, ``NRCNetworkConfigs.h:96-117``)."""
        from nrc_tpu.config import RenderMode, default_ema_decay, train_lr
        from nrc_tpu.render.renderer import Renderer
        from nrc_tpu.scene.scene_builder import load_scene

        ref = CORNELL
        scene, system = load_scene(
            f"{ref}/system_mdl_cornell.txt", f"{ref}/scene_mdl_cornell.txt"
        )
        system.resolution = (16, 16)
        system.tile_size = (8, 8)
        r = Renderer(scene, system, render_mode=RenderMode.FULL, train=True,
                     adaptive_tiles=False)
        for enc in (InputEncoding.HASH, InputEncoding.FREQUENCY):
            r.set_encoding(enc)
            assert r.net_cfg.ema_decay == default_ema_decay(enc)
            assert r.net_cfg.adam_eps == (
                1e-15 if enc == InputEncoding.HASH else 1e-8
            )
            assert r.hyper.learning_rate == train_lr(enc)
