"""Checkpoint / resume for rollout and controller state trees.

Port of qrw_tpu/utils/checkpoint.py: any state tree of NamedTuples,
tuples and lists of tensors (RolloutCarry, ControllerState, solver warm
starts) round-trips through one .npz keyed by tree path, so a long
rollout can be cut, stored and resumed bit for bit. The keys are the
`/`-joined paths qrw_tpu writes (NamedTuple field names, sequence
indices), so a checkpoint of a tree whose structure both packages share
loads in either; None leaves (qrw_tpu's empty subtrees) are not stored.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves_with_path(tree, prefix=()):
    """[(path, leaf)] of a tree's non-None leaves, in field order."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = zip(map(str, range(len(tree))), tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(_leaves_with_path(sub, prefix + (key,)))
    return out


def _rebuild(tree, leaves, prefix=()):
    """`tree` with each leaf replaced by leaves[path]."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*[_rebuild(sub, leaves, prefix + (f,))
                            for f, sub in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(sub, leaves, prefix + (str(i),))
                          for i, sub in enumerate(tree))
    return leaves[prefix]


def save_state(path: str, tree) -> str:
    """Serialize a tree of tensors to `path` (.npz), keyed by tree path."""
    data = {}
    for p, leaf in _leaves_with_path(tree):
        data["/".join(p)] = (leaf.detach().cpu().numpy()
                             if torch.is_tensor(leaf) else np.asarray(leaf))
    np.savez_compressed(path, **data)
    return path


def load_state(path: str, template):
    """Rebuild a tree from a checkpoint, with `template` giving the
    structure: each leaf takes the template leaf's dtype and device."""
    with np.load(path, allow_pickle=False) as f:
        stored = {k: f[k] for k in f.files}
    leaves = {}
    for p, t_leaf in _leaves_with_path(template):
        key = "/".join(p)
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if torch.is_tensor(t_leaf):
            leaves[p] = torch.as_tensor(stored[key]).to(
                dtype=t_leaf.dtype, device=t_leaf.device)
        else:
            leaves[p] = type(t_leaf)(stored[key])
    return _rebuild(template, leaves)
