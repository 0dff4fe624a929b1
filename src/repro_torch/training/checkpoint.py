"""Checkpoints of the port: atomic, content-hashed, resumable
(``repro/training/checkpoint.py``), in the reference's format.

  * a save writes into a temporary directory, then renames it into
    place, so a crash mid-save leaves no partial checkpoint visible;
  * ``MANIFEST.json`` lists every ``.npy`` file with its sha256, shape
    and true dtype; restore verifies the hashes and skips a corrupt or
    partial checkpoint for the newest complete one;
  * ``keep`` rotates old checkpoints out;
  * numpy has no bf16, so a bf16 leaf is stored as its ``uint16`` bits
    with ``"bfloat16"`` in the manifest.

A state is a tree of dicts, tuples, lists and NamedTuples whose leaves
are torch tensors or numpy arrays.  Leaves are named as the reference's
``jax.tree_util`` paths name them (dict keys in sorted order, sequence
indices, ``.field`` for a NamedTuple field, joined by ``__``), so a state
in the reference's layout (``convert.to_jax_layout``) saved here is read
by the reference's ``CheckpointManager`` and the other way round.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import to_numpy

# true dtypes that torch.from_numpy reads as they are stored
_NUMPY_DTYPES = {"float64", "float32", "float16", "int64", "int32", "int16",
                 "int8", "uint8", "bool"}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the reference's order and naming."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [("__".join(prefix), tree)]
    out = []
    for key, sub in items:
        out.extend(_flatten(sub, prefix + (key,)))
    return out


def _rebuild(template, leaf: Callable[[str], Any],
             prefix: Tuple[str, ...] = ()):
    """``template``'s structure with each leaf replaced by ``leaf(name)``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, leaf, prefix + (str(k),))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, f), leaf,
                                         prefix + (f".{f}",))
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(x, leaf, prefix + (str(i),))
                              for i, x in enumerate(template))
    if template is None:
        return None
    return leaf("__".join(prefix))


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, true dtype name)."""
    if isinstance(leaf, torch.Tensor):
        true_dtype = str(leaf.dtype).split(".")[-1]
        return to_numpy(leaf), true_dtype
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_torch(arr: np.ndarray, true_dtype: str) -> torch.Tensor:
    if true_dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if true_dtype not in _NUMPY_DTYPES:
        raise ValueError(f"checkpoint leaf of dtype {true_dtype} is not "
                         f"read here")
    return torch.from_numpy(np.array(arr, copy=True))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state: Any, extra: Optional[dict] = None
             ) -> str:
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=f".tmp_{step}_")
        manifest = {"step": int(step), "files": {}, "extra": extra or {}}
        for name, leaf in _flatten(state):
            arr, true_dtype = _to_numpy(leaf)
            fn = f"{name}.npy"
            np.save(os.path.join(tmp, fn), arr, allow_pickle=False)
            with open(os.path.join(tmp, fn), "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["files"][fn] = {"sha256": digest,
                                     "shape": list(arr.shape),
                                     "dtype": true_dtype}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish
        self._rotate()
        return final

    def _rotate(self) -> None:
        ckpts = self.list_checkpoints()
        for path in ckpts[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def list_checkpoints(self) -> list:
        out = []
        for d in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, d)
            if d.startswith("step_") and os.path.isdir(full) \
                    and os.path.exists(os.path.join(full, "MANIFEST.json")):
                out.append(full)
        return out

    def _verify(self, path: str) -> Optional[dict]:
        try:
            with open(os.path.join(path, "MANIFEST.json")) as f:
                manifest = json.load(f)
            for fn, meta in manifest["files"].items():
                with open(os.path.join(path, fn), "rb") as f:
                    if hashlib.sha256(f.read()).hexdigest() != meta["sha256"]:
                        return None
            return manifest
        except (OSError, json.JSONDecodeError, KeyError):
            return None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[int, Any, dict]:
        """Restore into the structure of ``template``.  Picks the newest
        VERIFIED checkpoint; corrupt or partial ones are skipped.  Leaves
        come back as CPU torch tensors in their saved dtype.
        Returns (step, state, extra)."""
        ckpts = self.list_checkpoints()
        if step is not None:
            ckpts = [c for c in ckpts if c.endswith(f"step_{step:010d}")]
        names = [name for name, _ in _flatten(template)]
        for path in reversed(ckpts):
            manifest = self._verify(path)
            if manifest is None:
                continue
            if not all(f"{n}.npy" in manifest["files"] for n in names):
                continue
            leaves = {}
            for n in names:
                arr = np.load(os.path.join(path, f"{n}.npy"),
                              allow_pickle=False)
                leaves[n] = _to_torch(
                    arr, manifest["files"][f"{n}.npy"]["dtype"])
            return (manifest["step"], _rebuild(template, leaves.__getitem__),
                    manifest.get("extra", {}))
        raise FileNotFoundError(
            f"no complete checkpoint in {self.dir} "
            f"({len(ckpts)} candidates, all failed verification)")
