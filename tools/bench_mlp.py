"""Dissect the cache-MLP train/infer step cost on the accelerator.

Separates:

- per-CALL cost (one jit dispatch per step), vs
- per-STEP device cost (K steps chained inside ONE jit via lax.scan — the
  shape the frame program actually runs, no per-step dispatch), vs
- component costs (encode only, forward only).

Every timing ends with ``jax.block_until_ready``, and every measured call
chains its input on the previous call's output. Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(step, state, reps=20, warmup=3):
    """Time ``state = step(state)`` chains. ``step`` must make each call's
    input depend on the previous output (defeats dispatch dedup)."""
    import jax

    for _ in range(warmup):
        state = step(state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(reps):
        state = step(state)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--encoding", default="frequency")
    ap.add_argument("--scan-steps", type=int, default=50)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from nrc_tpu.config import InputEncoding, NetworkConfig
    from nrc_tpu.models import network as N

    cfg = NetworkConfig(encoding=InputEncoding[args.encoding.upper()])
    ns = N.init_network(jax.random.PRNGKey(0), cfg)
    B = args.batch
    q = jax.random.uniform(jax.random.PRNGKey(1), (B, 15))
    t = jax.random.uniform(jax.random.PRNGKey(2), (B, 3))
    dev = jax.devices()[0]
    out = {"device": f"{dev.platform} {dev.device_kind}", "batch": B,
           "encoding": args.encoding}

    # FLOP accounting for the 64x5 chain (fwd; bwd ~2x more):
    # 2*B*(128*64 + 4*64*64 + 64*16) per forward pass
    flops_fwd = 2 * B * (128 * 64 + (cfg.n_hidden_layers - 1) * 64 * 64 + 64 * 16)
    flops_train = 3 * flops_fwd  # fwd + dgrad + wgrad
    out["gflop_fwd"] = round(flops_fwd / 1e9, 3)

    # 1. per-call train step (round-2 measurement shape). The network state
    # chains call-to-call (real online-training dataflow).
    step = jax.jit(lambda ns, q, t: N.train_step(ns, q, t, cfg)[0])
    dt = measure(lambda s: step(s, q, t), ns)
    out["train_per_call_ms"] = round(dt * 1e3, 3)
    out["train_per_call_msamples"] = round(B / dt / 1e6, 1)

    # 2. K steps inside ONE jit (device-side step cost, no dispatch)
    K = args.scan_steps

    @jax.jit
    def train_k(ns):
        def body(ns, _):
            ns2, loss = N.train_step(ns, q, t, cfg)
            return ns2, loss
        ns, losses = jax.lax.scan(body, ns, None, length=K)
        return ns

    dt = measure(train_k, ns, reps=10)
    out["train_scanned_ms_per_step"] = round(dt / K * 1e3, 4)
    out["train_scanned_msamples"] = round(B * K / dt / 1e6, 1)
    out["train_scanned_tflops"] = round(flops_train * K / dt / 1e12, 3)

    # 3. infer per-call and scanned; the query chains on the previous output
    inf = jax.jit(
        lambda ns, q: (N.infer(ns, q, cfg), q)
    )

    def inf_step(state):
        r, q = state
        return inf(ns, q + jnp.max(r) * 1e-30)

    dt = measure(inf_step, (jnp.zeros((B, 3)), q))
    out["infer_per_call_ms"] = round(dt * 1e3, 3)
    out["infer_per_call_msamples"] = round(B / dt / 1e6, 1)

    @jax.jit
    def infer_k(q):
        def body(carry, _):
            r = N.infer(ns, q + carry, cfg)
            return jnp.max(r) * 1e-30, None
        carry, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=K)
        return q + carry  # depends on every step

    dt = measure(infer_k, q, reps=10)
    out["infer_scanned_ms_per_step"] = round(dt / K * 1e3, 4)
    out["infer_scanned_msamples"] = round(B * K / dt / 1e6, 1)
    out["infer_scanned_tflops"] = round(flops_fwd * K / dt / 1e12, 3)

    # 4. encode only (scanned)
    @jax.jit
    def enc_k(q):
        def body(carry, _):
            e = N.encode(q + carry, cfg, ns.grid)
            return jnp.max(e) * 1e-30, None
        carry, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=K)
        return q + carry

    dt = measure(enc_k, q, reps=10)
    out["encode_scanned_ms_per_step"] = round(dt / K * 1e3, 4)

    # 5. forward only on pre-encoded input (scanned)
    x = N.encode(q, cfg, ns.grid)

    @jax.jit
    def fwd_k(x):
        def body(carry, _):
            r = N.mlp_forward(ns.ema, x + carry)
            return jnp.max(r) * 1e-30, None
        carry, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=K)
        return x + carry

    dt = measure(fwd_k, x, reps=10)
    out["mlpfwd_scanned_ms_per_step"] = round(dt / K * 1e3, 4)

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
