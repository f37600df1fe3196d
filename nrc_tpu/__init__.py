"""nrc_tpu — a neural radiance caching renderer in JAX.

A from-scratch re-design of the capabilities of the reference OptiX 8 +
tiny-cuda-nn + MDL application ``Depersonalizc/neural-radiance-caching``
(SIGGRAPH 2021, "Real-time Neural Radiance Caching for Path Tracing"):

- the OptiX path-tracing megakernel becomes a *wavefront* integrator — a
  ``lax.scan`` over bounce depth on SoA ray batches, everything under one
  ``jit`` (reference: ``nrc/shaders/raygeneration.cu:139-289``);
- tiny-cuda-nn's fully-fused MLP becomes a plain bf16 matmul chain that
  XLA compiles (reference: ``nrc/src/NRCNetwork.cu``);
- the atomicAdd training-record allocator becomes a static per-tile strided
  record layout (no atomics, no mid-frame host sync — reference:
  ``nrc/shaders/hit.cu:975-1028``, ``nrc/src/Device.cpp:2487-2491``);
- multi-GPU P2P islands become a ``jax.sharding.Mesh`` with XLA collectives
  (reference: ``nrc/src/Raytracer.cpp:318-458``).

Layout: ``models/`` (NRC network), ``ops/`` (kernels: intersect, encodings,
propagation), ``render/`` (integrator + frame step), ``scene/`` (parser,
geometry, lights, materials, camera), ``parallel/`` (mesh/shard_map scaling),
``utils/`` (math, RNG, tonemap, image IO), ``app/`` (CLI).
"""

__version__ = "0.1.0"

# Persistent XLA compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR
# itself; without it the cache lives at a fixed path inside the checkout
# (the path is part of the cache key, so it must not move between runs).
import os as _os

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
    del _jax
del _os
