"""Tree checkpointing to ``.npz``, in the JAX package's layout.

A checkpoint is one ``step_%08d.npz`` file per step, written to a
temporary name and moved into place with ``os.replace`` (atomic).  A tree
of dicts, lists, tuples and dataclasses (e.g. the engine's
:class:`~repro_torch.core.EngineCarry` and the SSP executor's
:class:`~repro_torch.ps.SSPCarry`) is flattened to '/'-joined key
paths, with a dataclass field written ``.name`` as JAX renders an
attribute key, so the port's files hold the JAX package's keys
(``state/beta``, ``carry/.t``, ``carry/.sched/idx``, ``carry/.clocks``,
``assignment/owner``).
``None`` subtrees hold no leaf.  Tensors are written through
``.detach().cpu().numpy()``; a ``torch.Generator``'s ``get_state()`` is
a uint8 tensor and is stored as a leaf like any other.  A bfloat16 leaf
(which numpy has no type for) is stored as its 16 bits in a 2-byte void
array (``|V2``), the form in which numpy writes and reads back a JAX
package's bfloat16 (``ml_dtypes``) leaf; :func:`leaf_tensor` reads either
back to the bit, with no ``ml_dtypes`` needed.

The save is synchronous: the file holds the values the tree had at the
call, even where the caller's next step writes those tensors in place
(LDA's push updates z, B and D in place).  A restore places each leaf on
its template leaf's device and dtype, as a new tensor.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch


def _children(tree: Any):
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [("." + f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


BF16_VOID = np.dtype("V2")


def _leaf_array(leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        x = leaf.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(BF16_VOID)
        return x.numpy()
    return np.asarray(leaf)


def leaf_tensor(arr: np.ndarray) -> torch.Tensor:
    """A checkpoint leaf as a CPU tensor of its own type: a 2-byte void
    or ``ml_dtypes`` bfloat16 array as bfloat16, bit for bit."""
    a = np.array(arr)                        # a writable copy
    if a.dtype == BF16_VOID or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: _leaf_array(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in kids:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _restore_leaf(name: str, template: Any, arr: np.ndarray) -> Any:
    shape = (tuple(template.shape) if hasattr(template, "shape") else ())
    if tuple(arr.shape) != shape:
        raise ValueError(f"{name}: shape {arr.shape} != {shape}")
    if torch.is_tensor(template):
        return leaf_tensor(arr).to(device=template.device,
                                   dtype=template.dtype)
    if isinstance(template, (np.ndarray, np.generic)):
        return np.asarray(arr).astype(template.dtype)
    return type(template)(arr.item())          # a Python int/float/bool


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray],
                    prefix: str = "") -> Any:
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing {prefix}")
        return _restore_leaf(prefix, template, flat[prefix])
    vals = {k: _unflatten_into(v, flat, f"{prefix}/{k}" if prefix else k)
            for k, v in kids}
    if isinstance(template, dict):
        return {k: vals[str(k)] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(vals[str(i)] for i in range(len(template)))
    return dataclasses.replace(
        template, **{f.name: vals["." + f.name]
                     for f in dataclasses.fields(template)})


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write ``tree`` as ``ckpt_dir/step_%08d.npz``; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(tree))
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step checkpointed in ``ckpt_dir`` (None if none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def load_flat(ckpt_dir: str, step: int) -> Dict[str, np.ndarray]:
    """One checkpoint's raw flattened arrays ('/'-joined key paths): for
    callers that inspect optional subtrees before choosing a template,
    and for :func:`repro_torch.convert.checkpoint_from_jax`, which reads
    the JAX package's files."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def restore_checkpoint(ckpt_dir: str, step: int, template: Any) -> Any:
    """The checkpoint of ``step`` in the structure of ``template`` (e.g.
    the ``{"state", "carry", "assignment"}`` of a report of the same
    plan), each leaf on its template leaf's device and dtype."""
    return _unflatten_into(template, load_flat(ckpt_dir, step))
