"""Checkpoint save/restore + torch state-dict import.

Reference behavior (`train_instance.py:473,579-581,612-618`; generic
helpers `sparseconvnet/utils.py:201-233`): snapshot every N epochs to
`ckpts/<task>/Epoch{N}.pth`, interrupt-save, resume via --checkpoint_file,
power-of-2 retention GC. Here: one NumPy archive per snapshot, plus an
importer that maps a torch `.pth` state dict (the reference's
`baseline_m64.pth` layout: conv weights [K^3, Cin, Cout], BN
weight/bias/running_mean/running_var, Linear weight [out, in]) onto the
param/batch_stats trees.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


_STATE_FILE = "state.npz"


def _leaves_with_keys(tree):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return [jax.tree_util.keystr(p) for p, _ in flat], \
        [x for _, x in flat], treedef


def save_checkpoint(path: str, state, step: Optional[int] = None) -> str:
    """Write `state` (any pytree of arrays) to `<path>/step_<step>/` as one
    NumPy archive: leaves in flatten order plus their key paths. The file
    is written under a temporary name and renamed, so a killed save never
    leaves a partial snapshot behind."""
    step = int(step if step is not None else state.step)
    target = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(target, exist_ok=True)
    keys, leaves, _ = _leaves_with_keys(state)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    tmp = os.path.join(target, _STATE_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, __keys__=np.asarray(keys), **arrays)
    os.replace(tmp, os.path.join(target, _STATE_FILE))
    return target


def restore_checkpoint(path: str, template) -> Any:
    """Load a `save_checkpoint` snapshot into the structure of `template`
    (leaf dtypes follow the template). Raises ValueError when the saved
    tree does not have the template's key paths."""
    keys, leaves, treedef = _leaves_with_keys(template)
    with np.load(os.path.join(os.path.abspath(path), _STATE_FILE)) as z:
        saved = [str(k) for k in z["__keys__"]]
        if saved != keys:
            diff = sorted(set(saved) ^ set(keys))[:5]
            raise ValueError(f"checkpoint {path} does not match the "
                             f"template tree (e.g. {diff})")
        out = [np.asarray(z[f"leaf_{i}"]).astype(np.asarray(t).dtype)
               for i, t in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, out)


def latest_checkpoint(root: str) -> Optional[str]:
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", d)
        if m:
            steps.append(int(m.group(1)))
    if not steps:
        return None
    return os.path.join(root, f"step_{max(steps)}")


def gc_checkpoints(root: str) -> None:
    """Power-of-2 retention (reference `sparseconvnet/utils.py:219-233`):
    keep step s only if s is the max or s & (s-1) == 0-ish schedule; we keep
    the reference's rule: delete n - 2^k snapshots as new ones land —
    approximated as: keep max, powers of two, and multiples of 64."""
    if not os.path.isdir(root):
        return
    steps = sorted(
        int(m.group(1)) for d in os.listdir(root)
        if (m := re.fullmatch(r"step_(\d+)", d)))
    if not steps:
        return
    keep = {steps[-1]}
    keep.update(s for s in steps if s & (s - 1) == 0 or s % 64 == 0)
    import shutil
    for s in steps:
        if s not in keep:
            shutil.rmtree(os.path.join(root, f"step_{s}"),
                          ignore_errors=True)


# ---------------------------------------------------------------------------
# torch .pth import
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[Tuple[str, ...], Any]):
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def import_torch_state_dict(state_dict: Dict[str, "np.ndarray"],
                            params, batch_stats,
                            name_map: Dict[str, str]):
    """Overwrite param trees with torch tensors.

    name_map: torch key prefix -> tree path ('/'-joined). Handles layout:
      * conv `weight` [K^3, Cin, Cout] -> unchanged (we use the same layout,
        `submanifoldConvolution.py:27-29`);
      * Linear `weight` [out, in] -> transposed to [in, out] `kernel`;
      * BN weight/bias -> params, running_mean/running_var -> batch_stats.
    Returns (params, batch_stats). Raises KeyError on unmatched tree paths.
    """
    flat_p = _flatten(params)
    flat_s = _flatten(batch_stats)
    sd = {k: np.asarray(v) for k, v in state_dict.items()}

    for tkey, fpath in name_map.items():
        path = tuple(fpath.split("/"))
        if tkey.endswith("running_mean") or tkey.endswith("running_var"):
            if path not in flat_s:
                raise KeyError(f"no batch_stats leaf {fpath}")
            flat_s[path] = jnp.asarray(sd[tkey], flat_s[path].dtype)
            continue
        if path not in flat_p:
            raise KeyError(f"no param leaf {fpath}")
        v = sd[tkey]
        tgt = flat_p[path]
        if path[-1] == "kernel" and v.ndim == 2:
            v = v.T  # torch Linear [out,in] -> Dense [in,out]
        if v.shape != tuple(tgt.shape):
            raise ValueError(
                f"{tkey} -> {fpath}: shape {v.shape} vs {tuple(tgt.shape)}")
        flat_p[path] = jnp.asarray(v, tgt.dtype)
    return _unflatten(flat_p), _unflatten(flat_s)
