"""Checkpoints in the JAX package's ``.npz`` leaf format.

A state tree's leaves are saved as ``leaf_{i}`` in ``jax.tree_util`` leaf
order: dicts flatten by **sorted** key, lists and tuples in order, and None
is an empty subtree.  The same order is reproduced here without JAX, so
each package reads the other's checkpoints: for the LSTM autoencoder
``leaf_0`` is ``dec1.b_hh``, then ``dec1.b_ih``, ``dec1.w_hh``,
``dec1.w_ih``, ``dec2...``, ``enc1...`` and finally ``out.b``, ``out.w``.

The full train state (the module's and optimizer's state dicts, the dropout
generator's state and the step) is the port's own format: ``torch.save``'s
bytes in the ``torch_state`` entry of an ``.npz``, read back with
``weights_only=True``.  It cannot hold the JAX package's PRNG key, nor the
JAX package the port's generator, so only params-only files carry across.
Retention follows the reference: a rolling ``model_min_val_loss-<loss>``
best checkpoint (the previous best deleted), written twice, as the full
state and as ``..._params.npz``.
"""

from __future__ import annotations

import glob
import io
import os
from typing import Any, Dict, List

import numpy as np
import torch

__all__ = [
    "tree_leaves", "save_state", "load_state", "save_train_state", "load_train_state", "save_best",
    "latest_best", "latest_resumable",
]


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict/list/tuple in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def _unflatten(template: Any, leaves) -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(sub, leaves) for sub in template)
    return next(leaves)


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _numpy_dtype(x: Any) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def save_state(path: str, state: Any) -> None:
    """Save the leaves of ``state`` (tensors or arrays) as ``leaf_{i}``."""
    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(tree_leaves(state))}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_state(path: str, template: Any) -> Any:
    """Restore a state tree as numpy arrays; ``template`` supplies the
    structure and the leaf dtypes (its leaves may be tensors or arrays)."""
    with np.load(path, allow_pickle=False) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    tmpl_leaves = tree_leaves(template)
    if len(tmpl_leaves) != n:
        raise ValueError(f"checkpoint has {n} leaves, template expects {len(tmpl_leaves)}")
    cast = [np.asarray(l).astype(_numpy_dtype(t)) for l, t in zip(leaves, tmpl_leaves)]
    return _unflatten(template, iter(cast))


def save_train_state(path: str, state: Dict[str, Any]) -> None:
    """Save a full train state: a dict of state dicts, tensors and numbers."""
    buf = io.BytesIO()
    torch.save(state, buf)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, torch_state=np.frombuffer(buf.getvalue(), np.uint8))


def load_train_state(path: str) -> Dict[str, Any]:
    """A state ``save_train_state`` wrote, its tensors on the CPU."""
    with np.load(path, allow_pickle=False) as z:
        if "torch_state" not in z.files:
            raise ValueError(f"{path} holds no train state of this package (a JAX package checkpoint?)")
        raw = z["torch_state"].tobytes()
    return torch.load(io.BytesIO(raw), map_location="cpu", weights_only=True)


def save_best(results_dir: str, val_loss: float, state: Dict[str, Any], params: Any = None) -> str:
    """Rolling best checkpoint with the loss in the filename; deletes the
    previous best (reference retention policy, run_train.py:85-92).  Writes
    the full train state and, from ``params``, a params-only snapshot in
    the JAX package's leaf format."""
    for old in glob.glob(os.path.join(results_dir, "model_min_val_loss-*")):
        os.remove(old)
    path = os.path.join(results_dir, f"model_min_val_loss-{np.around(val_loss, 4)}.npz")
    save_train_state(path, state)
    if params is not None:
        save_state(path.replace(".npz", "_params.npz"), params)
    return path


def latest_best(results_dir: str) -> str:
    """Best params-only checkpoint path, falling back to the final snapshot
    (load_model.py:47-53 semantics)."""
    best = sorted(glob.glob(os.path.join(results_dir, "model_min_val_loss-*_params.npz")))
    if best:
        return best[-1]
    final = os.path.join(results_dir, "model_autoencoder.npz")
    if os.path.isfile(final):
        return final
    raise FileNotFoundError(f"no checkpoint found in {results_dir}")


def latest_resumable(results_dir: str) -> str:
    """Full train-state checkpoint for mid-run resume."""
    best = [p for p in sorted(glob.glob(os.path.join(results_dir, "model_min_val_loss-*.npz")))
            if not p.endswith("_params.npz")]
    if best:
        return best[-1]
    raise FileNotFoundError(f"no resumable checkpoint in {results_dir}")
