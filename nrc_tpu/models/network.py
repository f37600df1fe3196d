"""The NRC network: 64-wide MLP + encoding + RelativeL2Luminance loss +
Adam + EMA, as one jittable train/infer module.

Replacement for the reference's tiny-cuda-nn wrapper
(``nrc/src/NRCNetwork.cu:41-128`` / ``nrc/inc/NRCNetworkConfigs.h``):

- FullyFusedMLP(ReLU, output ReLU, 64 neurons, 5 hidden layers), bias-free,
  input padded to 128 columns with ones (tcnn pads with 1s too, which
  doubles as a bias channel).
- loss ``RelativeL2Luminance``: (pred-target)^2 / (lum(sg(pred))^2 + eps)
- optimizer ``EMA(0.99)`` nesting ``Adam(lr per encoding, l2_reg 1e-6)``;
  inference uses the EMA weights, training updates the raw weights —
  exactly tcnn's EMA-optimizer semantics.

The compute path is plain jnp: six bf16 matmuls with f32 accumulation,
which XLA compiles and fuses with the elementwise work around them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import InputEncoding, NetworkConfig
from ..ops import encodings as E

# MLP input width after padding. Chosen on an earlier accelerator; not yet
# re-measured on the GPU.
LANE = 128
OUT_PAD = 16


class MLPParams(NamedTuple):
    w_in: jnp.ndarray    # [LANE, 64]
    w_hidden: jnp.ndarray  # [H-1, 64, 64]
    w_out: jnp.ndarray   # [64, OUT_PAD]


class AdamState(NamedTuple):
    mu: MLPParams
    nu: MLPParams
    step: jnp.ndarray
    # hash-grid moments when the hash encoding is active
    mu_grid: Optional[jnp.ndarray] = None
    nu_grid: Optional[jnp.ndarray] = None


class NetworkState(NamedTuple):
    """Full trainable state (a pytree; shard/replicate as one unit)."""

    params: MLPParams
    ema: MLPParams
    opt: AdamState
    grid: Optional[E.HashGridParams] = None
    ema_grid: Optional[E.HashGridParams] = None


def _encoded_dims(cfg: NetworkConfig) -> int:
    if cfg.encoding == InputEncoding.FREQUENCY:
        return E.frequency_encoded_dims(cfg)
    return E.hash_encoded_dims(cfg)


def init_network(key: jax.Array, cfg: NetworkConfig) -> NetworkState:
    """Initialize (matches tcnn: He-uniform style, zero outside padding)."""
    n = cfg.n_neurons
    assert n == 64, "fully-fused path is specialized to 64-wide"
    d_in = _encoded_dims(cfg)
    assert d_in <= LANE
    k_in, k_h, k_out, k_g = jax.random.split(key, 4)

    def uniform(k, shape, fan_in):
        scale = math.sqrt(6.0 / fan_in)
        return jax.random.uniform(k, shape, minval=-scale, maxval=scale, dtype=jnp.float32)

    w_in = jnp.zeros((LANE, n), jnp.float32)
    # +1 accounts for the ones-padding channel acting as a bias
    w_in = w_in.at[: d_in + 1].set(uniform(k_in, (d_in + 1, n), d_in + 1))
    h = cfg.n_hidden_layers - 1
    w_hidden = uniform(k_h, (h, n, n), n)
    w_out = jnp.zeros((n, OUT_PAD), jnp.float32)
    w_out = w_out.at[:, :3].set(uniform(k_out, (n, 3), n))
    import os as _os

    if _os.environ.get("NRC_WOUT_POS_INIT", "0") == "1":
        # Output-ReLU parity experiment: start every
        # radiance channel with positive-mean weights so initial
        # predictions are mostly > 0 — tests whether the reference
        # config's collapse under ReLU-output training is an init effect.
        w_out = jnp.abs(w_out)
    params = MLPParams(w_in=w_in, w_hidden=w_hidden, w_out=w_out)

    zeros = jax.tree.map(jnp.zeros_like, params)
    grid = ema_grid = None
    mu_grid = nu_grid = None
    if cfg.encoding == InputEncoding.HASH:
        grid = E.init_hash_grid(k_g, cfg)
        ema_grid = grid
        mu_grid = jnp.zeros_like(grid.table)
        nu_grid = jnp.zeros_like(grid.table)
    opt = AdamState(
        mu=zeros, nu=zeros, step=jnp.zeros((), jnp.int32),
        mu_grid=mu_grid, nu_grid=nu_grid,
    )
    return NetworkState(params=params, ema=params, opt=opt, grid=grid, ema_grid=ema_grid)


# ---------------------------------------------------------------------------
# Forward path
# ---------------------------------------------------------------------------

def _pad_input(x: jnp.ndarray, d_in: int) -> jnp.ndarray:
    """Pad encoded features to LANE with a single 1s channel then zeros
    (tcnn pads unused input dims with ones; one channel suffices as bias)."""
    b = x.shape[0]
    ones = jnp.ones((b, 1), x.dtype)
    pad = jnp.zeros((b, LANE - d_in - 1), x.dtype)
    return jnp.concatenate([x, ones, pad], axis=-1)


def mlp_forward(
    params: MLPParams, x_padded: jnp.ndarray, output_relu: bool = True
) -> jnp.ndarray:
    """[B, LANE] -> [B, 3]; bf16 matmuls, f32 accumulation.

    The reference's output activation is ReLU (radiance >= 0,
    ``NRCNetworkConfigs.h:29``); training a ReLU *output* risks permanently
    dead radiance channels (zero gradient once a channel goes all-negative —
    observed in practice), so we train on the linear output and clamp at
    inference only. Same function where it matters, no dying outputs.
    """
    h = x_padded.astype(jnp.bfloat16)
    z = jnp.dot(h, params.w_in.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    z = jax.nn.relu(z)
    for i in range(params.w_hidden.shape[0]):
        z = jnp.dot(
            z.astype(jnp.bfloat16),
            params.w_hidden[i].astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        z = jax.nn.relu(z)
    out = jnp.dot(
        z.astype(jnp.bfloat16),
        params.w_out.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    out = out[:, :3]
    return jax.nn.relu(out) if output_relu else out


def encode(
    query: jnp.ndarray,
    cfg: NetworkConfig,
    grid: Optional[E.HashGridParams],
) -> jnp.ndarray:
    if cfg.encoding == InputEncoding.FREQUENCY:
        enc = E.encode_frequency(query, cfg)
    else:
        enc = E.encode_hash(query, grid, cfg)
    return _pad_input(enc, enc.shape[-1])


def infer(state: NetworkState, query: jnp.ndarray, cfg: NetworkConfig) -> jnp.ndarray:
    """Cache inference with EMA weights (``Network::infer``, NRCNetwork.cu:61-79)."""
    x = encode(query, cfg, state.ema_grid)
    return mlp_forward(state.ema, x)


# ---------------------------------------------------------------------------
# Loss + training step
# ---------------------------------------------------------------------------

def relative_l2_luminance(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    """tcnn RelativeL2Luminance: (p-t)^2 / (lum(sg(p))^2 + 0.01)."""
    lum = (
        0.299 * pred[..., 0] + 0.587 * pred[..., 1] + 0.114 * pred[..., 2]
    )
    denom = jax.lax.stop_gradient(lum * lum) + 0.01
    return jnp.mean((pred - target) ** 2 / denom[..., None])


def loss_and_grads(
    state: NetworkState,
    query: jnp.ndarray,   # [B, 15]
    target: jnp.ndarray,  # [B, 3]
    cfg: NetworkConfig,
    loss_scale: Optional[jnp.ndarray] = None,
):
    """RelativeL2Luminance loss and its gradients w.r.t. the MLP weights
    and (hash encoding) the grid tables -> (loss, g_params, g_grid|None)."""
    import os as _os

    def loss_fn(params, grid):
        x = encode(query, cfg, grid)
        # NRC_TRAIN_OUTPUT_RELU=1: train through the ReLU output like
        # the reference config ("output_activation": "ReLU",
        # NRCNetworkConfigs.h:29) — an A/B knob for the documented
        # linear-output deviation (dying-channel risk)
        _relu_out = _os.environ.get("NRC_TRAIN_OUTPUT_RELU", "0") == "1"
        # Output-ReLU parity experiments:
        # NRC_OUTPUT_LEAKY=a trains leaky-ReLU(a) on the output instead
        # of the exact ReLU (gradient never fully gated -> no permanent
        # channel death); NRC_GRAD_SCALE=S multiplies the loss by S and
        # the gradient by 1/S around the bf16 matmul adjoints (tcnn's
        # fp16 loss-scaling, NRCNetwork.cu) — exact identity in f32,
        # only bf16 rounding of tiny gradients changes.
        _leaky = float(_os.environ.get("NRC_OUTPUT_LEAKY", "0"))
        if _relu_out and _leaky > 0.0:
            pred = mlp_forward(params, x, output_relu=False)
            pred = jnp.where(pred > 0.0, pred, _leaky * pred)
        else:
            pred = mlp_forward(params, x, output_relu=_relu_out)
        loss = relative_l2_luminance(pred, target)
        _gs = float(_os.environ.get("NRC_GRAD_SCALE", "1"))
        if _gs != 1.0:
            loss = loss * _gs
        if loss_scale is not None:
            loss = loss * loss_scale
        return loss

    if cfg.encoding == InputEncoding.HASH:
        loss, (g_params, g_grid) = jax.value_and_grad(
            loss_fn, argnums=(0, 1)
        )(state.params, state.grid)
    else:
        loss, g_params = jax.value_and_grad(loss_fn)(state.params, None)
        g_grid = None
    _gs = float(_os.environ.get("NRC_GRAD_SCALE", "1"))
    if _gs != 1.0:
        # unscale (see NRC_GRAD_SCALE above) — identity up to bf16
        # rounding inside the matmul adjoints
        loss = loss / _gs
        g_params = jax.tree.map(lambda g: g / _gs, g_params)
        if g_grid is not None:
            g_grid = jax.tree.map(lambda g: g / _gs, g_grid)
    return loss, g_params, g_grid


def train_step(
    state: NetworkState,
    query: jnp.ndarray,   # [B, 15]
    target: jnp.ndarray,  # [B, 3]
    cfg: NetworkConfig,
    learning_rate: Optional[jnp.ndarray] = None,
    grad_reduce=None,
    loss_scale: Optional[jnp.ndarray] = None,
    grid_grad_reduce=None,
) -> Tuple[NetworkState, jnp.ndarray]:
    """One SGD step (= one ``trainer->training_step``, NRCNetwork.cu:41-59).

    ``grad_reduce``: optional callable applied to the grad pytree (e.g.
    ``lambda g: jax.lax.pmean(g, 'data')`` for data-parallel training).
    ``loss_scale``: multiplier on the loss (0 drops this shard's gradient —
    used when a chip's tile shard produced no records this frame).
    ``grid_grad_reduce``: separate reduction for the hash-table gradient;
    defaults to ``grad_reduce``. With mesh-sharded tables (SURVEY P6) the
    cross-device exchange already happened inside the lookup's adjoint, so
    this must be ``lambda g: g / D`` (the loss-mean scaling), NOT a pmean.
    Returns (new_state, loss).
    """
    lr = cfg.learning_rate if learning_rate is None else learning_rate
    loss, g_params, g_grid = loss_and_grads(
        state, query, target, cfg, loss_scale
    )

    if grad_reduce is not None:
        g_params = grad_reduce(g_params)
    if g_grid is not None:
        reduce_grid = grid_grad_reduce if grid_grad_reduce is not None else grad_reduce
        if reduce_grid is not None:
            g_grid = reduce_grid(g_grid)

    # L2 regularization on MLP matrices (tcnn Adam l2_reg)
    g_params = jax.tree.map(
        lambda g, p: g + cfg.adam_l2_reg * p, g_params, state.params
    )

    step = state.opt.step + 1
    b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps
    bc1 = 1.0 - b1 ** step.astype(jnp.float32)
    bc2 = 1.0 - b2 ** step.astype(jnp.float32)

    def adam(p, g, mu, nu):
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        upd = (mu / bc1) / (jnp.sqrt(nu / bc2) + eps)
        return p - lr * upd, mu, nu

    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu in zip(state.params, g_params, state.opt.mu, state.opt.nu):
        pp, mm, nn = adam(p, g, mu, nu)
        new_p.append(pp)
        new_mu.append(mm)
        new_nu.append(nn)
    params = MLPParams(*new_p)

    decay = cfg.ema_decay
    ema = jax.tree.map(lambda e, p: decay * e + (1 - decay) * p, state.ema, params)

    grid = state.grid
    ema_grid = state.ema_grid
    mu_grid = state.opt.mu_grid
    nu_grid = state.opt.nu_grid
    if g_grid is not None:
        gt, mu_grid, nu_grid = adam(
            state.grid.table, g_grid.table, state.opt.mu_grid, state.opt.nu_grid
        )
        grid = E.HashGridParams(table=gt)
        ema_grid = E.HashGridParams(
            table=decay * state.ema_grid.table + (1 - decay) * gt
        )

    return (
        NetworkState(
            params=params,
            ema=ema,
            opt=AdamState(
                mu=MLPParams(*new_mu), nu=MLPParams(*new_nu), step=step,
                mu_grid=mu_grid, nu_grid=nu_grid,
            ),
            grid=grid,
            ema_grid=ema_grid,
        ),
        loss,
    )


def reset_network(key: jax.Array, cfg: NetworkConfig) -> NetworkState:
    """Full re-init (the reference's cache reset / encoding switch re-creates
    the model from config, ``Device.cpp:2415-2421``)."""
    return init_network(key, cfg)
