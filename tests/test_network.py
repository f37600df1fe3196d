"""NRC network tests: encodings, MLP shapes, optimizer convergence on a toy
radiance field, EMA semantics, hash-grid path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrc_tpu.config import InputEncoding, NetworkConfig
from nrc_tpu.models import network as N
from nrc_tpu.ops import encodings as E


def make_queries(key, n):
    """Random plausible radiance queries [n, 15]."""
    ks = jax.random.split(key, 6)
    pos = jax.random.uniform(ks[0], (n, 3), minval=-0.05, maxval=0.05)
    theta = jax.random.uniform(ks[1], (n, 2), minval=0.0, maxval=np.pi)
    phi = jax.random.uniform(ks[2], (n, 2), minval=-np.pi, maxval=np.pi)
    rough = jax.random.uniform(ks[3], (n, 2))
    diff = jax.random.uniform(ks[4], (n, 3))
    spec = jax.random.uniform(ks[5], (n, 3))
    return jnp.concatenate(
        [pos, theta[:, :1], phi[:, :1], theta[:, 1:], phi[:, 1:], rough, diff, spec],
        axis=-1,
    )


class TestEncodings:
    def test_frequency_dims(self):
        cfg = NetworkConfig()
        q = make_queries(jax.random.PRNGKey(0), 32)
        enc = E.encode_frequency(q, cfg)
        assert enc.shape == (32, 66)
        assert E.frequency_encoded_dims(cfg) == 66
        assert np.all(np.isfinite(np.asarray(enc)))

    def test_triangle_wave_periodic(self):
        x = jnp.asarray([[0.0], [1.0], [0.25], [0.75]])
        tw = E.triangle_wave(x, 1)
        # period-1 triangle: tri(0) == tri(1), tri(0.25) == tri(0.75)
        np.testing.assert_allclose(float(tw[0, 0]), float(tw[1, 0]), atol=1e-6)
        np.testing.assert_allclose(float(tw[2, 0]), float(tw[3, 0]), atol=1e-6)
        assert float(tw[2, 0]) != float(tw[0, 0])

    def test_oneblob_peak(self):
        x = jnp.asarray([[0.125]])  # center of bin 0 (4 bins)
        blob = np.asarray(E.one_blob(x, 4))[0]
        assert blob.argmax() == 0
        assert blob[0] == pytest.approx(1.0, abs=1e-6)

    def test_hash_dims_and_grad(self):
        cfg = NetworkConfig(encoding=InputEncoding.HASH)
        grid = E.init_hash_grid(jax.random.PRNGKey(1), cfg)
        assert grid.table.shape == (16, 2 ** 15, 2)
        q = make_queries(jax.random.PRNGKey(2), 16)
        enc = E.encode_hash(q, grid, cfg)
        assert enc.shape == (16, E.hash_encoded_dims(cfg))
        # gradient flows to the tables
        g = jax.grad(lambda t: jnp.sum(E.encode_hash(q, E.HashGridParams(t), cfg) ** 2))(
            grid.table
        )
        assert float(jnp.sum(jnp.abs(g))) > 0.0


class TestNetwork:
    def test_init_shapes(self):
        cfg = NetworkConfig()
        st = N.init_network(jax.random.PRNGKey(0), cfg)
        assert st.params.w_in.shape == (128, 64)
        assert st.params.w_hidden.shape == (4, 64, 64)
        assert st.params.w_out.shape == (64, 16)
        # unused input rows are zero (padding beyond 66+1)
        assert np.all(np.asarray(st.params.w_in[68:]) == 0.0)

    def test_infer_shape_nonnegative(self):
        cfg = NetworkConfig()
        st = N.init_network(jax.random.PRNGKey(0), cfg)
        q = make_queries(jax.random.PRNGKey(1), 256)
        out = N.infer(st, q, cfg)
        assert out.shape == (256, 3)
        assert np.all(np.asarray(out) >= 0.0)  # output ReLU

    def test_loss_decreases_frequency(self):
        cfg = NetworkConfig()
        st = N.init_network(jax.random.PRNGKey(0), cfg)
        q = make_queries(jax.random.PRNGKey(1), 2048)
        # toy radiance: smooth positive function of the query
        target = jnp.stack(
            [
                1.0 + jnp.sin(q[:, 0] * 50) ** 2,
                0.5 + q[:, 9],
                jnp.exp(-q[:, 3]),
            ],
            axis=-1,
        )
        step = jax.jit(lambda s: N.train_step(s, q, target, cfg))
        losses = []
        for _ in range(60):
            st, loss = step(st)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.35, f"{losses[0]} -> {losses[-1]}"
        assert np.isfinite(losses).all()

    def test_loss_decreases_hash(self):
        cfg = NetworkConfig(encoding=InputEncoding.HASH)
        assert cfg.adam_eps == 1e-15
        st = N.init_network(jax.random.PRNGKey(0), cfg)
        q = make_queries(jax.random.PRNGKey(1), 2048)
        target = jnp.stack(
            [1.0 + jnp.sin(q[:, 0] * 80) ** 2, 0.3 + 0.0 * q[:, 0], q[:, 12]],
            axis=-1,
        )
        step = jax.jit(lambda s: N.train_step(s, q, target, cfg))
        losses = []
        for _ in range(40):
            st, loss = step(st)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.5, f"{losses[0]} -> {losses[-1]}"

    def test_ema_lags_params(self):
        cfg = NetworkConfig()
        st = N.init_network(jax.random.PRNGKey(0), cfg)
        q = make_queries(jax.random.PRNGKey(1), 512)
        target = jnp.ones((512, 3))
        st2, _ = N.train_step(st, q, target, cfg)
        # params moved, ema moved (1-decay)x less
        dp = float(jnp.mean(jnp.abs(st2.params.w_in - st.params.w_in)))
        de = float(jnp.mean(jnp.abs(st2.ema.w_in - st.ema.w_in)))
        assert dp > 0
        assert de == pytest.approx(dp * (1.0 - cfg.ema_decay), rel=1e-3)

    def test_relative_l2_luminance(self):
        pred = jnp.asarray([[1.0, 1.0, 1.0]])
        target = jnp.asarray([[0.0, 0.0, 0.0]])
        # lum(pred) = 1 -> denom = 1.01
        loss = float(N.relative_l2_luminance(pred, target))
        assert loss == pytest.approx(1.0 / 1.01, rel=1e-5)


class TestOrbaxCheckpoint:
    def test_orbax_roundtrip(self, tmp_path):
        """Network state round-trips through the orbax PyTree container
        bit-exactly; loading auto-detects the directory format."""
        import jax

        from nrc_tpu.config import NetworkConfig
        from nrc_tpu.models import network as N
        from nrc_tpu.models.checkpoint import load_checkpoint, save_checkpoint

        cfg = NetworkConfig()
        ns = N.init_network(jax.random.PRNGKey(7), cfg)
        p = save_checkpoint(str(tmp_path / "ckpt_orbax"), ns, format="orbax")
        import os

        assert os.path.isdir(p)
        ns2 = load_checkpoint(p, cfg)
        for a, b in zip(jax.tree.leaves(ns), jax.tree.leaves(ns2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestDenseCoarseLevels:
    """tcnn grid semantics: levels whose (res+1)^3 vertex grid fits the
    table index densely — zero collisions (tiny-cuda-nn grid.h;
    NRCNetworkConfigs.h:96-105 configures base_res 16 / log2_size 15, so
    level 0 is dense, finer levels hash)."""

    def test_default_config_level0_dense(self):
        from nrc_tpu.ops.encodings import _dense_levels

        cfg = NetworkConfig()
        dense = _dense_levels(cfg)
        assert dense[0] is True          # 17^3 = 4913 <= 32768
        assert not any(dense[1:])        # 33^3 = 35937 > 32768

    def test_dense_level_collision_free(self):
        from nrc_tpu.ops.encodings import (
            _corner_index_weight_all_levels,
            _level_resolutions,
        )

        cfg = NetworkConfig()
        res0 = _level_resolutions(cfg)[0]
        # every vertex of level 0's grid through corner 0 at voxel (i,j,k)
        g = jnp.stack(
            jnp.meshgrid(*([jnp.arange(res0 + 1, dtype=jnp.float32)] * 3),
                         indexing="ij"),
            axis=-1,
        ).reshape(-1, 3) / res0
        # res is a power of two, so k/res*res reproduces k exactly
        idx, _ = _corner_index_weight_all_levels(g, 0, cfg)
        lvl0 = np.asarray(idx[:, 0])
        # distinct vertices -> distinct rows, all in range
        assert len(np.unique(lvl0)) == (res0 + 1) ** 3
        assert lvl0.min() >= 0 and lvl0.max() < 2 ** cfg.hash_log2_size

    def test_lookup_still_trains(self):
        from nrc_tpu.ops import encodings as E

        cfg = NetworkConfig()
        key = jax.random.PRNGKey(0)
        params = E.init_hash_grid(key, cfg)
        pos = jax.random.uniform(jax.random.PRNGKey(1), (64, 3))

        def loss(p):
            return jnp.sum(E.hash_grid_lookup(pos, p, cfg) ** 2)

        g = jax.grad(loss)(params)
        assert bool(jnp.any(g.table != 0.0))
        out = E.hash_grid_lookup(pos, params, cfg)
        assert out.shape == (64, cfg.hash_n_levels * cfg.hash_n_features_per_level)
        assert bool(jnp.all(jnp.isfinite(out)))


class TestHashAdjoint:
    def test_matches_numpy_scatter(self):
        """The hash-table gradient (plain autodiff through the row gathers)
        equals a NumPy scatter-add of weight x cotangent at every corner
        row of every level."""
        cfg = NetworkConfig(
            encoding=InputEncoding.HASH, hash_log2_size=9, hash_n_levels=4
        )
        grid = E.init_hash_grid(jax.random.PRNGKey(0), cfg)
        pos = jax.random.uniform(jax.random.PRNGKey(1), (300, 3))
        coef = jax.random.normal(
            jax.random.PRNGKey(2),
            (300, cfg.hash_n_levels * cfg.hash_n_features_per_level),
        )

        def loss(table):
            out = E.hash_grid_lookup(pos, E.HashGridParams(table), cfg)
            return jnp.mean(jnp.sum(out * coef, -1))

        g = np.asarray(jax.grad(loss)(grid.table))
        L, S, F = grid.table.shape
        c = np.asarray(coef).reshape(300, L, F) / 300.0
        want = np.zeros((L, S, F), np.float64)
        for corner in range(8):
            idx, w = E._corner_index_weight_all_levels(pos, corner, cfg)
            idx, w = np.asarray(idx), np.asarray(w)
            for lvl in range(L):
                np.add.at(want[lvl], idx[:, lvl], w[:, lvl, None] * c[:, lvl])
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-7)
