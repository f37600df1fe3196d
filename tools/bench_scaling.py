"""Multi-chip scaling-shape evidence on a virtual CPU mesh (BASELINE.md's
">=80% scaling efficiency" target; real multi-chip hardware is unavailable,
so this measures the SHAPE of the scaling curve + the exact collective
traffic, not absolute chip throughput).

Measures, at 1/2/4/8 shards on a forced-host-device CPU mesh:
- frame throughput (frames/s) and records-trained/s for the replicated-table
  config (P5) and the row-sharded hash-table config (P6),
- per-step collective bytes of the P6 exchange, computed analytically from
  the program: one all_gather of positions (D*B*3*4 bytes per chip) + one
  psum_scatter of features (D*B*L*F*4), plus the pmean of dense grads.

Usage (run from repo root):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
  python tools/bench_scaling.py [--res 128] [--frames 6]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

CORNELL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "cornell",
)

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--tile", type=int, default=8)
    ap.add_argument("--log2-size", type=int, default=None,
                    help="hash_log2_size override (e.g. 19: 16 levels x "
                         "2^19 x 2 f32 = 64 MB of tables — the "
                         "beyond-one-chip-HBM capability P6 exists for)")
    args = ap.parse_args()

    import dataclasses

    from nrc_tpu.config import (
        BATCH_SIZE,
        NUM_BATCHES,
        InputEncoding,
        NetworkConfig,
        RenderMode,
    )
    from nrc_tpu.models import network as N
    from nrc_tpu.parallel.shard import (
        DATA_AXIS,
        make_mesh,
        net_state_specs,
        sharded_frame_step,
    )
    from nrc_tpu.render.frame import CameraArrays
    from nrc_tpu.render.renderer import Renderer
    from nrc_tpu.scene.scene_builder import load_scene

    n_dev = len(jax.devices())
    shard_counts = [d for d in (1, 2, 4, 8) if d <= n_dev]

    scene, system = load_scene(
        os.path.join(CORNELL, "system_mdl_cornell.txt"),
        os.path.join(CORNELL, "scene_mdl_cornell.txt"),
    )
    system.resolution = (args.res, args.res)
    scene.camera.aspect = 1.0
    system.tile_size = (args.tile, args.tile)

    for mode in ("replicated", "sharded_tables"):
        enc = InputEncoding.HASH
        results = []
        for d in shard_counts:
            kw = {}
            if args.log2_size is not None:
                kw["hash_log2_size"] = args.log2_size
            net_cfg = NetworkConfig(
                encoding=enc,
                hash_shard_axis=DATA_AXIS if mode == "sharded_tables" else None,
                **kw,
            )
            r = Renderer(
                scene, system, net_cfg=net_cfg, render_mode=RenderMode.FULL,
                train=True, adaptive_tiles=False,
            )
            mesh = make_mesh(d)
            step = sharded_frame_step(
                mesh, r.cfg, net_cfg,
                net_state_example=r.net_state,
            )
            from jax.sharding import NamedSharding, PartitionSpec as P

            img = jax.device_put(
                jnp.zeros((args.res * args.res, 3)),
                NamedSharding(mesh, P(DATA_AXIS, None)),
            )
            specs = net_state_specs(
                r.net_state, mode == "sharded_tables"
            )
            ns = jax.device_put(
                r.net_state,
                jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, P)),
            )
            cam = CameraArrays(*map(jnp.asarray, scene.camera.frustum()))
            scene_dev = r.device_scene

            # warmup/compile
            img2, ns2, stats = step(
                scene_dev, ns, img, cam, jnp.int32(0), jnp.uint32(0)
            )
            jax.block_until_ready(img2)
            t0 = time.perf_counter()
            records = 0
            for i in range(args.frames):
                img2, ns2, stats = step(
                    scene_dev, ns2, img2, cam,
                    jnp.int32(i + 1), jnp.uint32(i + 1),
                )
            jax.block_until_ready(img2)
            dt = time.perf_counter() - t0
            fps = args.frames / dt
            # trained examples/s: NUM_BATCHES * BATCH_SIZE per frame when
            # records > 0 (modulo-duplicated to full batches)
            ex_s = fps * NUM_BATCHES * BATCH_SIZE
            results.append((d, fps, ex_s, int(stats.num_train_records)))
            del step

        base = results[0]
        rows = []
        for d, fps, ex_s, rec in results:
            eff = fps / (base[1])  # same global work -> ideal flat time
            rows.append({
                "shards": d, "fps": round(fps, 3),
                "examples_per_s": int(ex_s),
                "records_last_frame": rec,
                "time_vs_1shard": round(base[1] / fps, 3),
            })
        # P6 collective bytes per frame-step (analytic, per chip), for the
        # level-sharded owner-routed exchange: one all_gather of positions
        # + one all_to_all of completed features (each feature computed
        # exactly once — no D partial copies to sum, unlike the retired
        # psum_scatter design)
        ncfg = NetworkConfig(encoding=enc)
        L, F = ncfg.hash_n_levels, ncfg.hash_n_features_per_level
        per_batch = BATCH_SIZE  # positions gathered per train batch
        coll = {
            "all_gather_positions_bytes_per_chip": int(
                per_batch * 3 * 4 * NUM_BATCHES
            ),
            "all_to_all_features_bytes_per_chip": int(
                per_batch * L * F * 4 * NUM_BATCHES
            ),
            "note": (
                "per training step; inference adds the same pair over "
                "the query batch; dense-grad pmean adds ~2*|params|*4"
            ),
        }
        print(json.dumps({
            "config": mode, "encoding": "hash", "res": args.res,
            "scaling": rows,
            "p6_collectives": coll if mode == "sharded_tables" else None,
        }), flush=True)


if __name__ == "__main__":
    main()
