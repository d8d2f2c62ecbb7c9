"""Checkpoint / resume of streaming pipeline carries.

Counterpart of ``distantspeech_tpu/runtime/checkpoint.py``.  A pipeline
state is a nest of NamedTuples, tuples, lists and dicts whose leaves are
tensors and the host integers that the port keeps as Python ints (MCRA's
``ell`` and ``frm_cnt``, the AEC's ``cnt``, the dios ABM's ``count``, ...).
One .npz holds it, leaf ``i`` under ``leaf_{i}``, the leaves in the order
``jax.tree.leaves`` gives the JAX package's twin state: NamedTuple fields in
order, dict entries by sorted key, ``None`` dropped.  So a checkpoint of
either package loads in the other.  A host int is saved as a 0-d int array
and restored as a Python int; a tensor is restored with its template's
dtype and device.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

_SCALARS = (bool, int, float)


def _leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic) + _SCALARS):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    raise TypeError(f"checkpoint: unsupported state node {type(tree).__name__}")


def _restore(leaf: Any, saved: np.ndarray) -> Any:
    """``saved`` in the form of the template leaf ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(np.asarray(saved), device=leaf.device).to(leaf.dtype)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return np.asarray(saved).astype(leaf.dtype)
    return type(leaf)(saved.item())


def _rebuild(tree: Any, it) -> Any:
    """``tree``'s structure with each leaf replaced by ``next(it)``."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic) + _SCALARS):
        return next(it)
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return type(tree)((k, new[k]) for k in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(t, it) for t in tree))
    return type(tree)(_rebuild(t, it) for t in tree)


def save_state(path: str, state: Any) -> None:
    """Serialise a state nest to ``path`` (.npz)."""
    leaves = [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
              for leaf in _leaves(state)]
    np.savez(path, **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})


def load_state(path: str, template: Any) -> Any:
    """Restore a state saved by ``save_state`` (of either package);
    ``template`` supplies the structure, dtypes and devices (use the
    pipeline's ``*_init`` output on the device to resume on)."""
    z = np.load(path)
    leaves = _leaves(template)
    if len(z.files) != len(leaves):
        raise ValueError(f"checkpoint has {len(z.files)} leaves, template has {len(leaves)}")
    new_leaves = [_restore(leaf, z[f"leaf_{i}"]) for i, leaf in enumerate(leaves)]
    return _rebuild(template, iter(new_leaves))
