"""Checkpoint and resume of streaming state (counterpart of
``vv_dsp_tpu/utils/checkpoint.py``, its ``save`` and ``load``).

A state tree is what the ``vv_dsp_tpu_torch.streaming`` ``*_init``
functions and ``StreamingNorthStar.init`` return: tensors, nested in dicts,
lists and tuples, plus any bookkeeping of the caller's (sample counters,
block indices). A checkpoint is one ``.npz`` file written atomically:
``leaf_i`` for the i-th leaf and ``__paths__`` for the leaves' key paths.

The leaves are flattened as JAX flattens a pytree (dicts by sorted key,
then lists and tuples in order) and their paths are spelled as JAX's
``keystr`` spells them (``"['fir']"``, ``"['stft'][0]"``, ``""`` for a
single leaf), so a checkpoint written by either package loads in the
other.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _flatten(tree, path: str = ""):
    """[(key path, leaf)] in JAX's pytree order; None holds no leaf."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in _flatten(tree[key], f"{path}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in _flatten(sub, f"{path}[{i}]")]
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken in order from the iterator
    `leaves`."""
    if isinstance(like, dict):
        filled = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return {key: filled[key] for key in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    if like is None:
        return None
    return next(leaves)


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, state_tree) -> None:
    """Write a tree of tensors (or arrays, numbers) to `path` (.npz,
    atomically)."""
    flat = _flatten(state_tree)
    arrays = {f"leaf_{i}": _as_numpy(x) for i, (_, x) in enumerate(flat)}
    arrays["__paths__"] = np.array([p for p, _ in flat])
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # numpy appends .npz to the temporary name
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def load(path: str, like_tree):
    """Restore a tree saved by :func:`save` (here or by the JAX package);
    `like_tree` gives the structure (e.g. a freshly initialized state).
    Leaf count, key paths, shapes and dtypes are checked against it, so a
    configuration mismatch fails instead of scrambling or casting state.
    Each leaf lands on its template leaf's device."""
    flat_like = _flatten(like_tree)
    like_paths = [p for p, _ in flat_like]
    with np.load(path) as data:
        n_saved = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_saved != len(flat_like):
            raise ValueError(
                f"checkpoint has {n_saved} leaves but like_tree has "
                f"{len(flat_like)} — was it saved with a different config?")
        if "__paths__" in data.files:
            saved_paths = [str(p) for p in data["__paths__"]]
            if saved_paths != like_paths:
                diff = next((i, a, b) for i, (a, b)
                            in enumerate(zip(saved_paths, like_paths))
                            if a != b)
                raise ValueError(
                    "checkpoint tree structure differs from like_tree at "
                    f"leaf {diff[0]}: saved {diff[1]!r} != expected "
                    f"{diff[2]!r}")
        flat = [data[f"leaf_{i}"] for i in range(len(flat_like))]
    leaves = []
    for i, (a, (p, b)) in enumerate(zip(flat, flat_like)):
        want = (torch.empty(0, dtype=b.dtype).numpy().dtype
                if isinstance(b, torch.Tensor) else np.result_type(b))
        if tuple(a.shape) != tuple(np.shape(b)):
            raise ValueError(
                f"checkpoint leaf {i} ({p}) shape {a.shape} != expected "
                f"{tuple(np.shape(b))} — was it saved with a different "
                "config?")
        if a.dtype != want:
            raise ValueError(
                f"checkpoint leaf {i} ({p}) dtype {a.dtype} != expected "
                f"{want} — refusing a silent cast; was it saved under "
                "a different dtype config?")
        device = b.device if isinstance(b, torch.Tensor) else "cpu"
        leaves.append(torch.as_tensor(a, device=device))
    return _unflatten(like_tree, iter(leaves))
