"""Smoke test of the NRC frame on an NVIDIA GPU, end to end.

Runs the renderer's main path once through the entry points a user calls,
at the shipped Cornell configuration (320x320, 64-wide 5-hidden-layer cache
MLP, FULL render mode with online training), and checks what comes out:

1. device gate: the first JAX device must be a GPU (no CPU fallback);
2. Cornell, frequency encoding, through ``nrc_tpu.app.cli.main``;
3. Cornell, hash-grid encoding, the same way;
4. the generated big Cornell scene (32k-triangle sphere added): wide BVH
   walk, compact-once wavefront, tiled primary raster and the native BVH
   builder, with raster-vs-walk primary-hit parity on the card;
5. card vs the plain reference on the host CPU, in this process: a
   NO_CACHE frame, one MLP train step at real widths and the brute-force
   intersector.

``--multi`` runs only the four-GPU path instead: ``ParallelRenderer`` over a
4-device mesh with level-sharded hash tables, compared with the one-GPU
render at the same seed.

Every line names the card and its power limit; the last line is one JSON
object, printed only when every phase passed. Times printed here are
informational, not a benchmark (``bench.py`` is the benchmark).

Usage: python chip_smoke.py [--multi]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(ROOT, "data", "cornell")
SYSTEM = os.path.join(CORNELL, "system_mdl_cornell.txt")
SCENE = os.path.join(CORNELL, "scene_mdl_cornell.txt")
SCENE_BIG = os.path.join(CORNELL, "scene_mdl_cornell_big.txt")

# --- tolerances of the card-vs-reference checks (phase 5 and --multi) ---
# A path tracer is chaotic: one float that rounds differently (fused
# multiply-add, transcendental implementations) can flip a Russian-roulette
# or BSDF-sampling decision and send that pixel down another path. So an
# image check asks that almost every pixel agrees closely and bounds the
# mean absolute error of the rest, instead of asking for a bitwise match.
# On an H100 against the host CPU, 99.3% of a 64x64 NO_CACHE frame's
# pixels agreed within 1e-3 and the relative MAE was 3.8e-4.
IMAGE_PIXEL_RTOL = 1e-3      # per-pixel relative agreement (f32 math)
IMAGE_MIN_FRACTION = 0.97    # share of pixels that must agree that closely
IMAGE_REL_MAE = 0.02         # mean |a - b| over the image mean radiance
# Same device kind, same program, only split over a mesh: divergence is
# no more likely than across devices.
MULTI_MIN_FRACTION = 0.98
MULTI_REL_MAE = 0.01
# The MLP runs bf16 operands with f32 accumulation on both devices; the
# accumulation order differs, so a value near a bf16 rounding boundary can
# round the other way (2^-8 relative) and carry through six layers.
MLP_LOSS_RTOL = 1e-3
MLP_GRAD_REL_L2 = 1e-2       # ||g_card - g_ref|| / ||g_ref|| per matrix
# Möller-Trumbore in f32 elementwise math on both devices: the winners
# must be the same triangle; a different winner is allowed only as a tie
# (equal distance: a shared edge, or a box resting on the floor). The f32
# solve for t loses accuracy as 1/|cos| for grazing rays, so the card-vs-cpu
# bound widens by GRAZING_COS / |cos| for rays within ~3 degrees of the
# surface (cos < GRAZING_COS).
HIT_T_RTOL = 1e-5
GRAZING_COS = 0.05
RASTER_T_RTOL = 1e-6


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_label():
    """'name, power limit' of the first GPU, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def device_gate():
    """The first JAX device; exits non-zero unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke needs a GPU; JAX found {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        raise SystemExit(1)
    return dev


# ---------------------------------------------------------------------------
# Phases 2-3: the CLI entry point
# ---------------------------------------------------------------------------

def cli_phase(encoding, workdir, width=320, height=320, spp=32):
    """Render Cornell through ``nrc_tpu.app.cli.main`` (FULL, training on)
    and check the image, the loss and the training records."""
    from nrc_tpu.app import cli
    from nrc_tpu.utils.image_io import read_hdr
    import numpy as np

    out = os.path.join(workdir, f"cornell_{encoding}")
    log = out + "_stats.jsonl"
    t0 = time.perf_counter()
    rc = cli.main([
        "-s", SYSTEM, "-d", SCENE, "-m", "1", "-w", str(width),
        "-h", str(height), "--spp", str(spp), "--encoding", encoding,
        "--stats-log", log, "--output", out, "--hdr",
    ])
    cold = time.perf_counter() - t0
    check(rc == 0, f"cli returned {rc}")
    rows = [json.loads(x) for x in open(log)]
    check(len(rows) == spp, f"{len(rows)} stats rows for {spp} frames")
    losses = [r["loss"] for r in rows]
    secs = [r["seconds"] for r in rows]
    img = read_hdr(f"{out}_{spp}spp.hdr")
    check(img.shape == (height, width, 3), f"image shape {img.shape}")
    check(bool(np.all(np.isfinite(img))), "image has non-finite values")
    check(float(img.std()) > 1e-3, f"image is flat (std {img.std():.2e})")
    tail = float(np.mean(losses[-max(spp // 4, 1):]))
    check(np.all(np.isfinite(losses)), "non-finite loss")
    check(tail < 0.5 * losses[0],
          f"loss did not fall: first {losses[0]:.4f}, tail {tail:.4f}")
    check(rows[-1]["num_train_records"] > 0, "no training records")
    # per-frame completion times; the median step ignores the compile of
    # the first frame and of any adapted tile size
    warm_ms = 1e3 * float(np.median(np.diff(secs[1:])))
    return {
        "cold_s": cold, "warm_ms_per_frame": warm_ms,
        "loss_first": losses[0], "loss_tail": tail,
        "records": rows[-1]["num_train_records"],
        "image_mean": float(img.mean()),
    }


def frame_memory_analysis(encoding, width=320, height=320):
    """``compiled.memory_analysis()`` of the FULL+train frame step."""
    import jax.numpy as jnp

    r = _renderer(SCENE, encoding, width, height)
    step = r._compiled_step(r.cfg)
    compiled = step.lower(
        r.device_scene, r.net_state, r.image, r._camera_arrays(),
        jnp.int32(0), jnp.uint32(0),
        learning_rate=jnp.float32(r.hyper.learning_rate),
        raster_data=r._raster_data,
    ).compile()
    return compiled.memory_analysis()


def _renderer(scene_file, encoding, width, height, tile=(4, 4), **kw):
    from nrc_tpu.config import InputEncoding, NetworkConfig, RenderMode
    from nrc_tpu.render.renderer import Renderer
    from nrc_tpu.scene.scene_builder import load_scene

    scene, system = load_scene(SYSTEM, scene_file)
    system.resolution = (width, height)
    system.tile_size = tile
    scene.camera.aspect = width / height
    net_cfg = kw.pop("net_cfg", None) or NetworkConfig(
        encoding=InputEncoding[encoding.upper()]
    )
    kw.setdefault("render_mode", RenderMode.FULL)
    kw.setdefault("train", True)
    return Renderer(scene, system, net_cfg=net_cfg, adaptive_tiles=False,
                    **kw)


def mlp_chain_timing(n_query=320 * 320, batch=16384, reps=20):
    """Device time of the plain XLA cache MLP (frequency encoding):
    inference over ``n_query`` queries and the frame's 4 train steps of
    ``batch`` records each -> (infer_ms, train4_ms)."""
    import jax
    import numpy as np

    from nrc_tpu.config import NUM_BATCHES, NetworkConfig
    from nrc_tpu.models import network as N

    cfg = NetworkConfig()
    state = N.init_network(jax.random.PRNGKey(0), cfg)
    q = jax.numpy.asarray(_queries(n_query, 1))
    qb = jax.numpy.asarray(_queries(NUM_BATCHES * batch, 2)).reshape(
        NUM_BATCHES, batch, -1)
    tb = jax.numpy.asarray(
        np.random.default_rng(3).uniform(0.0, 2.0, (NUM_BATCHES, batch, 3)),
        jax.numpy.float32)
    infer = jax.jit(lambda s, q: N.infer(s, q, cfg))

    @jax.jit
    def train4(s, qb, tb):
        def body(s, x):
            s, loss = N.train_step(s, x[0], x[1], cfg)
            return s, loss
        return jax.lax.scan(body, s, (qb, tb))

    def time_ms(fn):
        jax.block_until_ready(fn())
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(ts))

    return (time_ms(lambda: infer(state, q)),
            time_ms(lambda: train4(state, qb, tb)))


def _queries(n, seed):
    """Radiance queries in the layout of ``integrator.make_query``:
    position (scaled into ~[-0.05, 0.05]), direction and normal as
    (theta, phi), roughness, diffuse and specular albedo."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = np.empty((n, 15), np.float32)
    q[:, 0:3] = rng.uniform(-0.05, 0.05, (n, 3))
    q[:, 3] = rng.uniform(0.0, np.pi, n)
    q[:, 4] = rng.uniform(-np.pi, np.pi, n)
    q[:, 5] = rng.uniform(0.0, np.pi, n)
    q[:, 6] = rng.uniform(-np.pi, np.pi, n)
    q[:, 7:9] = rng.uniform(0.0, 1.0, (n, 2))
    q[:, 9:15] = rng.uniform(0.0, 1.0, (n, 6))
    return q


# ---------------------------------------------------------------------------
# Phase 4: the big scene (wide walk, compact-once, raster, native builder)
# ---------------------------------------------------------------------------

def big_scene_phase(width=320, height=320, frames=4):
    import jax
    import numpy as np

    from nrc_tpu import native
    from nrc_tpu.render import integrator

    t0 = time.perf_counter()
    r = _renderer(SCENE_BIG, "frequency", width, height)
    build_s = time.perf_counter() - t0
    check(native.get_lib() is not None, "native BVH builder did not load")
    check(r.device_scene.bvh is not None and "rows" in r.device_scene.bvh,
          "big scene did not get the wide BVH")
    check(integrator._queue_mode_auto(r.device_scene) == "once",
          "big scene did not select the compact-once wavefront")
    check(r._raster_enabled, "tiled primary raster is off")
    t0 = time.perf_counter()
    r.render_frame()
    jax.block_until_ready(r.image)
    cold = time.perf_counter() - t0
    check(r._raster_meta is not None, "raster bins were not built")
    t0 = time.perf_counter()
    for _ in range(frames - 1):
        stats = r.render_frame()
    jax.block_until_ready((r.image, r.net_state))
    warm_ms = 1e3 * (time.perf_counter() - t0) / max(frames - 1, 1)
    img = np.asarray(r.image)
    check(bool(np.all(np.isfinite(img))), "big scene image non-finite")
    check(float(img.std()) > 1e-3, "big scene image is flat")
    check(np.isfinite(float(stats.loss)), "big scene loss non-finite")
    check(int(stats.num_train_records) > 0, "big scene made no records")
    parity = raster_walk_parity(r)
    return {"build_s": build_s, "cold_s": cold, "warm_ms_per_frame": warm_ms,
            "triangles": r.scene.num_triangles, **parity}


def raster_walk_parity(r, seed=0):
    """Primary hits of the tiled raster vs the wide BVH walk for every
    pixel of the renderer's camera: same winner, same distance."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nrc_tpu.ops.intersect_wide import intersect_wbvh
    from nrc_tpu.ops.raster_primary import raster_closest_hit
    from nrc_tpu.scene.camera import generate_primary_rays

    r._maybe_build_raster()
    w, h = r.cfg.width, r.cfg.height
    lin = np.arange(w * h)
    pix = np.stack([lin % w, lin // w], -1).astype(np.float32)
    jit = np.random.default_rng(seed).uniform(0, 1, (w * h, 2))
    cam = r._camera_arrays()
    org, d = generate_primary_rays(
        jnp.asarray(pix), jnp.asarray(jit, jnp.float32), (w, h),
        cam.p, cam.u, cam.v, cam.w,
    )
    tmin = jnp.zeros(w * h)
    tmax = jnp.full((w * h,), 1e30)
    t_r, p_r = jax.jit(
        lambda o, dd: raster_closest_hit(r._raster_meta, r._raster_data,
                                         o, dd, tmin, tmax)
    )(org, d)
    walk = jax.jit(
        lambda o, dd: intersect_wbvh(o, dd, r.device_scene.bvh,
                                     r.device_scene.tris, tmin, tmax)
    )(org, d)
    return _hit_agreement(np.asarray(t_r), np.asarray(p_r),
                          np.asarray(walk.t), np.asarray(walk.prim),
                          RASTER_T_RTOL, "raster vs walk")


def _hit_agreement(t_a, p_a, t_b, p_b, rtol, what):
    """Winners and distances of two hit sets; ``rtol`` is a scalar or a
    per-ray array of relative distance tolerances."""
    import numpy as np

    hit_a, hit_b = p_a >= 0, p_b >= 0
    check(np.array_equal(hit_a, hit_b),
          f"{what}: {int(np.sum(hit_a != hit_b))} rays hit in one only")
    scale = np.maximum(1.0, np.abs(t_b))
    err = np.where(hit_a, np.abs(t_a - t_b) / scale, 0.0)
    t_bad = err > rtol
    if np.any(t_bad):
        i = int(np.argmax(np.where(t_bad, err, -1.0)))
        check(False,
              f"{what}: {int(t_bad.sum())} hit distances differ beyond "
              f"tolerance; worst ray {i}: t {t_a[i]!r} vs {t_b[i]!r}, "
              f"prim {p_a[i]} vs {p_b[i]}, "
              f"tolerance {np.broadcast_to(rtol, err.shape)[i]:.3g}")
    ties = int(np.sum(hit_a & (p_a != p_b)))
    return {"rays": int(p_a.size), "hits": int(hit_a.sum()),
            "tie_winners": ties,
            "max_t_rel": float(np.max(np.where(hit_a, np.abs(t_a - t_b)
                                                / scale, 0.0)))}


# ---------------------------------------------------------------------------
# Phase 5: card vs the plain reference on the host CPU
# ---------------------------------------------------------------------------

def image_agreement(a, b, pixel_rtol=IMAGE_PIXEL_RTOL):
    """(share of pixels agreeing within ``pixel_rtol``, mean |a-b| over
    mean |b|) for two [N, 3] images."""
    import numpy as np

    a = np.asarray(a, np.float64).reshape(-1, 3)
    b = np.asarray(b, np.float64).reshape(-1, 3)
    close = np.all(
        np.abs(a - b) <= pixel_rtol * np.maximum(np.abs(b), 1e-3), axis=-1
    )
    rel_mae = float(np.mean(np.abs(a - b)) / max(np.mean(np.abs(b)), 1e-12))
    return float(np.mean(close)), rel_mae


def nocache_frame(device, res=64):
    """One NO_CACHE frame of Cornell at ``res``^2, seed 0, on ``device``."""
    import jax
    import numpy as np

    from nrc_tpu.config import RenderMode

    with jax.default_device(device):
        r = _renderer(SCENE, "frequency", res, res, tile=(8, 8),
                      render_mode=RenderMode.NO_CACHE, train=False)
        r.render_frame()
        return np.asarray(r.image)


def compare_nocache_frame(device, ref_device, res=64):
    import numpy as np

    a = nocache_frame(device, res)
    b = nocache_frame(ref_device, res)
    check(bool(np.all(np.isfinite(a))), "card frame non-finite")
    frac, rel_mae = image_agreement(a, b)
    check(frac >= IMAGE_MIN_FRACTION,
          f"only {frac:.4f} of pixels agree within {IMAGE_PIXEL_RTOL}")
    check(rel_mae <= IMAGE_REL_MAE,
          f"relative MAE {rel_mae:.4f} > {IMAGE_REL_MAE}")
    return {"res": res, "pixels_close": frac, "rel_mae": rel_mae,
            "mean_card": float(a.mean()), "mean_ref": float(b.mean())}


def mlp_loss_and_grads(device, batch=16384, seed=0):
    """Loss and MLP gradients of one train step's batch on ``device``
    (frequency encoding, 64 wide, 5 hidden layers)."""
    import functools

    import jax
    import numpy as np

    from nrc_tpu.config import NetworkConfig
    from nrc_tpu.models import network as N

    cfg = NetworkConfig()
    q = _queries(batch, seed + 1)
    t = np.random.default_rng(seed + 2).uniform(0.0, 2.0, (batch, 3))
    with jax.default_device(device):
        state = N.init_network(jax.random.PRNGKey(seed), cfg)
        fn = jax.jit(functools.partial(N.loss_and_grads, cfg=cfg))
        loss, g, _ = fn(state, jax.numpy.asarray(q),
                        jax.numpy.asarray(t, jax.numpy.float32))
        return float(loss), [np.asarray(x, np.float64) for x in g]


def compare_mlp_train_step(device, ref_device, batch=16384):
    import numpy as np

    la, ga = mlp_loss_and_grads(device, batch)
    lb, gb = mlp_loss_and_grads(ref_device, batch)
    check(np.isfinite(la), "card loss non-finite")
    loss_rel = abs(la - lb) / max(abs(lb), 1e-12)
    check(loss_rel <= MLP_LOSS_RTOL, f"loss {la} vs {lb}")
    grad_rel = [float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
                for a, b in zip(ga, gb)]
    check(max(grad_rel) <= MLP_GRAD_REL_L2,
          f"gradient relative L2 errors {grad_rel}")
    return {"batch": batch, "loss_card": la, "loss_ref": lb,
            "loss_rel": loss_rel, "grad_rel_l2": grad_rel}


def bruteforce_hits(device, n_rays=65536, seed=0):
    """Closest hits of ``n_rays`` random rays from inside the Cornell box
    against all its triangles, by brute force on ``device``."""
    import jax
    import numpy as np

    from nrc_tpu.ops.intersect import TriSoA, intersect_bruteforce
    from nrc_tpu.scene.scene_builder import load_scene

    scene, _ = load_scene(SYSTEM, SCENE)
    org, d = _random_rays(n_rays, seed)
    with jax.default_device(device):
        tris = TriSoA.build(scene.p0, scene.p1, scene.p2)
        hit = jax.jit(intersect_bruteforce)(
            jax.numpy.asarray(org), jax.numpy.asarray(d), tris,
            jax.numpy.zeros(n_rays), jax.numpy.full((n_rays,), 1e30),
        )
        return np.asarray(hit.t), np.asarray(hit.prim)


def _random_rays(n_rays, seed=0):
    """Rays from uniform points inside the box, uniform directions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    org = rng.uniform(-9.5, 9.5, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return org, d


def compare_bruteforce(device, ref_device, n_rays=65536):
    import numpy as np

    from nrc_tpu.scene.scene_builder import load_scene

    t_a, p_a = bruteforce_hits(device, n_rays)
    t_b, p_b = bruteforce_hits(ref_device, n_rays)
    # |cos| between each ray and its reference winner's plane
    scene, _ = load_scene(SYSTEM, SCENE)
    _, d = _random_rays(n_rays)
    w = np.maximum(p_b, 0)
    n = np.cross(scene.p1[w] - scene.p0[w], scene.p2[w] - scene.p0[w])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    cos = np.abs(np.sum(n * d, axis=-1))
    rtol = HIT_T_RTOL * np.maximum(1.0, GRAZING_COS / np.maximum(cos, 1e-4))
    res = _hit_agreement(t_a, p_a, t_b, p_b, rtol, "card vs cpu")
    res["grazing_rays"] = int(np.sum((p_b >= 0) & (cos < GRAZING_COS)))
    return res


# ---------------------------------------------------------------------------
# --multi: the four-GPU path
# ---------------------------------------------------------------------------

def multi_phase(n_devices=4, width=320, height=320, tile=4, frames=8):
    """``ParallelRenderer`` over ``n_devices`` with level-sharded hash
    tables vs the one-device render at the same seed."""
    import jax
    import numpy as np

    from nrc_tpu.config import InputEncoding, NetworkConfig, RenderMode
    from nrc_tpu.parallel.shard import ParallelRenderer, make_mesh

    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} devices, have {len(jax.devices())}")
    out = {}
    # NO_CACHE: the pixel bands alone, identical RNG streams per pixel
    single = _renderer(SCENE, "hash", width, height, (tile, tile),
                       render_mode=RenderMode.NO_CACHE, train=False)
    single.render(2)
    multi = ParallelRenderer(
        _renderer(SCENE, "hash", width, height, (tile, tile),
                  render_mode=RenderMode.NO_CACHE, train=False),
        make_mesh(n_devices),
    )
    multi.render(2)
    out["nocache_pixels_close"], out["nocache_rel_mae"] = image_agreement(
        multi.r.image, single.image)
    check(out["nocache_pixels_close"] >= MULTI_MIN_FRACTION
          and out["nocache_rel_mae"] <= MULTI_REL_MAE,
          f"NO_CACHE multi vs single: {out}")

    # FULL + training, hash tables level-sharded over the mesh. Frame 0
    # renders with the initial network, the same on both sides.
    single = _renderer(SCENE, "hash", width, height, (tile, tile))
    single.render_frame()
    img_single = np.asarray(single.image)
    r = _renderer(SCENE, "hash", width, height, (tile, tile),
                  net_cfg=NetworkConfig(encoding=InputEncoding.HASH,
                                        hash_shard_axis="data"))
    pr = ParallelRenderer(r, make_mesh(n_devices))
    table_devices = len(r.net_state.grid.table.sharding.device_set)
    check(table_devices == n_devices,
          f"hash table spans {table_devices} devices")
    stats = pr.render_frame()
    out["full_frame0_pixels_close"], out["full_frame0_rel_mae"] = (
        image_agreement(r.image, img_single))
    check(out["full_frame0_pixels_close"] >= MULTI_MIN_FRACTION
          and out["full_frame0_rel_mae"] <= MULTI_REL_MAE,
          f"FULL frame 0 multi vs single: {out}")
    shard_devices = {s.device for s in r.image.addressable_shards}
    check(len(shard_devices) == n_devices,
          f"image shards sit on {len(shard_devices)} devices")
    losses = [float(stats.loss)]
    t0 = time.perf_counter()
    for _ in range(frames - 1):
        stats = pr.render_frame()
        losses.append(float(stats.loss))
    jax.block_until_ready(r.image)
    out["warm_ms_per_frame"] = 1e3 * (time.perf_counter() - t0) / max(
        frames - 1, 1)
    img = np.asarray(r.image)
    check(bool(np.all(np.isfinite(img))), "multi image non-finite")
    check(np.all(np.isfinite(losses)), "multi loss non-finite")
    check(np.mean(losses[-2:]) < losses[0],
          f"multi loss did not fall: {losses}")
    check(int(stats.num_train_records) > 0, "multi made no records")
    out.update(table_devices=table_devices,
               image_shard_devices=len(shard_devices),
               loss_first=losses[0], loss_last=losses[-1])
    return out


# ---------------------------------------------------------------------------

def _fmt(d):
    return ", ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in d.items()
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU path and its comparison")
    args = ap.parse_args(argv)

    dev = device_gate()
    import jax

    import nrc_tpu  # noqa: F401  (fails here when run outside the repo)

    label = card_label()

    def say(msg):
        print(f"[{label}] {msg}", flush=True)

    say(f"device {dev.device_kind}, platform {dev.platform}, "
        f"count {len(jax.devices())}")
    failed = []

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            res = fn(*a, **kw)
        except Exception as e:  # report every phase, fail at the end
            import traceback

            traceback.print_exc()
            say(f"FAIL {name}: {type(e).__name__}: {e}")
            failed.append(name)
            return None
        say(f"PASS {name} ({time.perf_counter() - t0:.1f} s): "
            + (_fmt(res) if isinstance(res, dict) else str(res)))
        return res

    if args.multi:
        phase("multi: 4-GPU Cornell 320x320 hash, level-sharded tables "
              "vs 1 GPU", multi_phase, 4)
    else:
        cpu = jax.devices("cpu")[0]
        with tempfile.TemporaryDirectory() as tmp:
            freq = phase("cornell frequency 320x320 FULL+train via cli",
                         cli_phase, "frequency", tmp)
            phase("cornell hash 320x320 FULL+train via cli",
                  cli_phase, "hash", tmp)
        for enc in ("frequency", "hash"):
            phase(f"memory_analysis {enc} frame step",
                  frame_memory_analysis, enc)
        mlp = phase("plain XLA cache MLP (informational)", mlp_chain_timing)
        if mlp and freq:
            say(f"MLP share of the warm cornell frequency frame "
                f"(informational): infer {mlp[0]:.3f} ms + 4 train steps "
                f"{mlp[1]:.3f} ms = "
                f"{100 * (mlp[0] + mlp[1]) / freq['warm_ms_per_frame']:.1f}%"
                f" of {freq['warm_ms_per_frame']:.3f} ms")
        phase("big cornell (33.6k tris) 320x320 FULL+train: wide walk, "
              "compact-once, raster, native builder", big_scene_phase)
        phase("card vs cpu: NO_CACHE frame 64x64, f32", compare_nocache_frame,
              dev, cpu)
        phase("card vs cpu: MLP train step B=16384, bf16 x bf16 -> f32",
              compare_mlp_train_step, dev, cpu)
        phase("card vs cpu: brute-force intersect 65536 rays, f32",
              compare_bruteforce, dev, cpu)
    if failed:
        say(f"{len(failed)} phase(s) failed: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
