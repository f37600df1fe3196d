"""Host->device upload boundary for staged-numpy pytrees.

The scene upload path stages everything in HOST numpy and converts it
wholesale here: one ``jax.device_put`` over the whole tree, whose per-leaf
transfers issue asynchronously and overlap, with no per-leaf Python round
trips in between. Arrays that merely duplicate others are derived on
device instead (``render/scene_device.py::_derive_packed``).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def device_put_packed(tree):
    """Pytree with numpy leaves -> same pytree with device (jnp) leaves.
    Non-ndarray leaves (already-device arrays, None, static metadata) pass
    through unchanged."""
    leaves, treedef = jax.tree.flatten(tree)
    put = [x for x in leaves if isinstance(x, np.ndarray)]
    if not put:
        return tree
    moved = iter(jax.device_put(put))
    new_leaves = [
        next(moved) if isinstance(x, np.ndarray) else x for x in leaves
    ]
    return jax.tree.unflatten(treedef, new_leaves)
