"""Carry weights between the JAX package's flax dicts and the port.

`params_from_jax` maps flax's nested dict of numpy arrays (`params` and
`batch_stats` collections) to the port's flat dicts of torch tensors
keyed by dotted flax paths; `params_to_jax` maps them back. Convolution
kernels go HWIO <-> OIHW and dense kernels `(in, out)` <-> `(out, in)`;
every other leaf keeps its shape. With `stacked=True` every array
carries a leading rank dimension that is left in place.

The dicts come out in flax leaf order (`parallel/arena.flax_order`),
the order of the arena segments and of the `[L]` event-state vectors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.parallel.arena import flax_axes, flax_order


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _kernel_perm(name: str, ndim: int, lead: int, to_torch: bool):
    """Axis permutation of a leaf between the flax and torch layouts
    (None when the layouts agree; `arena.flax_axes` is the rule)."""
    axes = flax_axes(name, ndim - lead)
    if axes is None:
        return None
    if to_torch:
        axes = tuple(int(i) for i in np.argsort(axes))
    return tuple(range(lead)) + tuple(lead + p for p in axes)


def params_from_jax(
    params_np: Mapping[str, Any],
    batch_stats_np: Optional[Mapping[str, Any]] = None,
    *,
    stacked: bool = False,
    device=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """flax `params` / `batch_stats` nested dicts -> the port's (params,
    batch_stats) dicts of float32 torch tensors in torch layout."""
    lead = 1 if stacked else 0
    params = {}
    flat = _flatten(params_np)
    for name in flax_order(flat):
        a = np.array(flat[name], np.float32)  # a writable copy
        perm = _kernel_perm(name, a.ndim, lead, to_torch=True)
        if perm is not None:
            a = a.transpose(perm)
        params[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    stats_flat = _flatten(batch_stats_np or {})
    stats = {
        name: torch.from_numpy(
            np.array(stats_flat[name], np.float32)
        ).to(device)
        for name in flax_order(stats_flat)
    }
    return params, stats


def params_to_jax(
    params: Mapping[str, torch.Tensor],
    batch_stats: Optional[Mapping[str, torch.Tensor]] = None,
    *,
    stacked: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's (params, batch_stats) dicts -> flax nested dicts of
    numpy arrays in flax layout."""
    lead = 1 if stacked else 0
    flat = {}
    for name, t in params.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        perm = _kernel_perm(name, a.ndim, lead, to_torch=False)
        flat[name] = np.ascontiguousarray(a.transpose(perm) if perm else a)
    stats = {
        name: t.detach().to("cpu", torch.float32).numpy()
        for name, t in (batch_stats or {}).items()
    }
    return _nest(flat), _nest(stats)
