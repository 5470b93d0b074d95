"""Carry weights from the JAX package into the port.

``params_from_jax`` takes the JAX package's worker-stacked flax variables —
``params`` and ``batch_stats`` as nested dicts of numpy arrays with a
leading ``[N, ...]`` worker axis — and returns the port's parameters and
batch-norm buffers, keyed by the port's dotted names:

* conv kernel ``[N, kh, kw, in, out]`` (HWIO) → ``weight [N, out, in, kh, kw]``
* dense kernel ``[N, in, out]`` → ``weight [N, out, in]``
* ``bias`` → ``bias``; batch-norm ``scale`` → ``weight``
* batch-norm ``mean``/``var`` → ``running_mean``/``running_var``

``model.load_state_dict({**params, **buffers})`` then loads them.  The same
mapping converts any tree shaped like ``params`` (an optimizer's momentum).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _walk(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _walk(value, path)
        else:
            yield path, np.asarray(value)


def _param(path, arr) -> Tuple[str, np.ndarray]:
    *module, leaf = path
    if leaf == "kernel":
        if arr.ndim == 5:    # [N, kh, kw, in, out] -> [N, out, in, kh, kw]
            arr = arr.transpose(0, 4, 3, 1, 2)
        elif arr.ndim == 3:  # [N, in, out] -> [N, out, in]
            arr = arr.transpose(0, 2, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim - 1} "
                             f"per worker is neither conv nor dense")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf != "bias":
        raise ValueError(f"{'/'.join(path)}: unknown flax parameter '{leaf}'")
    return ".".join(module + [leaf]), arr


def params_from_jax(params: Mapping, batch_stats: Mapping | None = None
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(params, buffers)`` as CPU tensors keyed by the port's names."""
    out_params = {}
    for path, arr in _walk(params):
        name, value = _param(path, arr)
        out_params[name] = torch.from_numpy(np.array(value))  # writable copy
    buffers = {}
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _walk(batch_stats or {}):
        *module, leaf = path
        if leaf not in stat_names:
            raise ValueError(f"{'/'.join(path)}: unknown batch statistic "
                             f"'{leaf}'")
        buffers[".".join(module + [stat_names[leaf]])] = torch.from_numpy(
            np.array(arr))
    return out_params, buffers
