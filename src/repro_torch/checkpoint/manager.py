"""Fault-tolerant checkpointing: atomic commits, keep-last-k, async save,
restore into a template tree. A copy of the JAX package's
``checkpoint/manager.py`` over trees of tensors.

Layout (the reference's, so checkpoints interchange in both directions):

  <dir>/step_000123/
      shard_00000.npz      flattened leaf arrays
      manifest.json        leaf keys, shapes, dtypes, step
      COMMIT               empty marker written last: a step without COMMIT
                           is torn and ignored at restore time

Leaf keys are those of ``jax.tree_util.tree_flatten_with_path`` joined
with ``::``, made here without JAX: dict keys sorted and written
``['name']``, list and tuple items ``[i]``, NamedTuple fields ``.name``,
``None`` no leaf. So ``(params, MuonState)`` gives
``[0]::['segments']::[0]::['attn']::['q']::['u']``,
``[1]::.adamw_state::.mu::...`` and ``[1]::.step``. A Python int leaf
(the optimizers' ``step``) is saved as a 0-d int32 array, as the
reference's step is, and read back as an int.

``save`` copies every leaf to host memory before it returns (the file IO
runs on the saver thread). The copy is explicit: on the CPU
``t.cpu().numpy()`` is a view of the tensor, which the next in-place
optimizer step would overwrite while the thread writes it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

_SEP = "::"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree: PyTree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in JAX's flattening order (see the module note)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(_SEP.join(prefix), tree)]
    out = []
    for part, sub in items:
        out += _flatten_with_paths(sub, prefix + (part,))
    return out


def _rebuild(tree: PyTree, leaf_fn: Callable[[str, Any], Any],
             prefix: Tuple[str, ...] = ()) -> PyTree:
    """``tree`` with each leaf replaced by ``leaf_fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaf_fn, prefix + (f"[{k!r}]",))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*[_rebuild(getattr(tree, f), leaf_fn,
                                     prefix + (f".{f}",))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, leaf_fn, prefix + (f"[{i}]",))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return leaf_fn(_SEP.join(prefix), tree)


def _host_copy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    if isinstance(leaf, (bool, np.bool_)):
        return np.array(leaf)
    if isinstance(leaf, int):
        return np.array(leaf, np.int32)
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: PyTree, *, blocking: bool = False) -> str:
        """Snapshot ``tree`` at ``step``. The device-to-host copy happens
        before this returns (so training can go on updating in place); the
        file IO happens on the saver thread."""
        host = [(k, _host_copy(v)) for k, v in _flatten_with_paths(tree)]

        def _write():
            path = os.path.join(self.directory, f"step_{step:09d}")
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_00000.npz"),
                     **{k: v for k, v in host})
            manifest = {
                "step": step,
                "time": time.time(),
                "leaves": [{"key": k, "shape": list(v.shape),
                            "dtype": str(v.dtype)} for k, v in host],
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            open(os.path.join(tmp, "COMMIT"), "w").close()
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        self.wait()
        if self.async_save and not blocking:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
        return os.path.join(self.directory, f"step_{step:09d}")

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.directory)):
            full = os.path.join(self.directory, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "COMMIT"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, *, step: Optional[int] = None,
                placer: Optional[Callable[[str, np.ndarray], Any]] = None
                ) -> Tuple[PyTree, int]:
        """Restore into the structure of ``template``.

        ``placer(key, array)`` makes each tensor leaf (by default a tensor
        on the template leaf's device, in the saved dtype); an int leaf
        of the template comes back as an int. Missing keys fall back to
        the template value (schema evolution); extra keys are ignored."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:09d}")
        data = np.load(os.path.join(path, "shard_00000.npz"))

        def leaf(key, tmpl):
            if key not in data.files:
                return tmpl
            arr = data[key]
            if isinstance(tmpl, int) and not isinstance(tmpl, bool):
                return int(arr)
            if placer is not None:
                return placer(key, arr)
            device = tmpl.device if isinstance(tmpl, torch.Tensor) else None
            return torch.from_numpy(arr).to(device)

        return _rebuild(template, leaf), step
