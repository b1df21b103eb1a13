"""Checkpoint / resume for SLAM state (numpy ``.npz`` step directories).

The reference has nothing persistent (demo paints a PNG and exits,
demo.cpp:111; SURVEY.md section 5). Here the map/keyframe stores are pytrees
(backend/keyframes.py), so checkpointing is a real save/restore supporting
relocalisation and elasticity (BASELINE.json configs[4]).

A checkpoint is a directory holding one ``arrays.npz``: every leaf of the
pytree under its key path. ``save`` writes a fresh temporary step directory
next to the target and ``os.replace``s it into place, so a reader sees either
the old checkpoint or the new one, never a partial write.

Scope is per process: each process reads and writes only its own files, with
no barrier or collective, because SLAM state is host-local (the runner in
parallel/elastic.py saves from process 0 only and broadcasts the step counter
on resume, since filesystems may not be shared). A save that waited for the
other processes would deadlock that primary-only save; the two-process test
(tests/test_multiprocess.py) checks it does not.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any

import numpy as np

_FILE = "arrays.npz"


def _key(path) -> str:
    """'/'-joined key path of a pytree leaf (dict keys, fields, indices)."""
    import jax

    parts = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            parts.append(str(k.key))
        elif isinstance(k, jax.tree_util.GetAttrKey):
            parts.append(k.name)
        elif isinstance(k, jax.tree_util.SequenceKey):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)


def save(path: str, state: Any):
    """Save a pytree checkpoint at directory `path` (overwrites)."""
    import jax

    path = os.path.abspath(path)
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    arrays = {_key(p): np.asarray(v) for p, v in leaves}
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp-", dir=parent)
    try:
        with open(os.path.join(tmp, _FILE), "wb") as f:
            np.savez(f, **arrays)
        if os.path.isdir(path):
            # a directory cannot be replaced while non-empty: move the old
            # one aside first, then swap the new one in
            old = tempfile.mkdtemp(prefix=os.path.basename(path) + ".old-",
                                   dir=parent)
            os.replace(path, os.path.join(old, "ckpt"))
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore(path: str, like: Any = None) -> Any:
    """Restore a pytree checkpoint.

    With `like`, the result has like's structure, and leaves that are jax
    arrays in `like` come back as jax arrays (host numpy when several
    processes run). Without it, the result is nested dicts of numpy arrays
    keyed by the saved key paths.
    """
    import jax

    with np.load(os.path.join(os.path.abspath(path), _FILE)) as z:
        arrays = {k: z[k] for k in z.files}
    if like is None:
        out: dict = {}
        for k, v in arrays.items():
            *head, last = k.split("/")
            node = out
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
        return out
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    device = jax.process_count() == 1
    vals = []
    for p, ref in leaves:
        v = arrays[_key(p)]
        vals.append(jax.numpy.asarray(v) if device and isinstance(
            ref, jax.Array) else v)
    return jax.tree_util.tree_unflatten(treedef, vals)
