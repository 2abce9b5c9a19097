"""Fault-tolerant checkpointing: atomic, step-tagged, keep-N, resumable.

A state -- a dataclass of tensors such as
:class:`~repro_torch.service.state.ServiceState`, or dicts, lists and
tuples of tensors and arrays -- is flattened to a path -> array dict and
written as ``state.npz`` into a temp dir, which is then renamed into place
atomically: a crash mid-save never corrupts the latest checkpoint.

The paths are ``repro``'s pytree paths (``repro/checkpoint/manager.py``):
one segment per level joined by ``|``, ``a:<field>`` for a dataclass or
named-tuple field, ``d:<key>`` for a dict key (keys in sorted order),
``s:<index>`` for a list or tuple item; ``None`` holds no array.  So a
``state.npz`` written by either package reads in the other.  A model (an
``nn.Module`` such as :class:`~repro_torch.models.Transformer`, whose
parameters are views of one flat buffer) is a node whose children are
its parameters, ``d:<name>`` by ``named_parameters()``; it restores into
a new model built like the template's (``type(m)(m.cfg, device=...,
dtype=...)``), every parameter written into its view.  numpy has no
bfloat16 (without ``ml_dtypes``, which the port does not import), so a
bfloat16 leaf is stored as its 16-bit pattern (``uint16``) and its path
listed in the array ``__bfloat16__`` beside it; it restores bitwise.

Beside the arrays a checkpoint can carry a *host payload*: any picklable
object (queue contents, free lists, RNG states, telemetry counters) saved
in the same atomic step directory.  It is pickled in :meth:`save`, and the
arrays are copied to the host there, so an async save snapshots live
objects before the caller can touch them again.  A payload pickled by
``repro`` names its classes in ``repro.service`` and ``repro.obs``; the
loader maps those modules to their ``repro_torch`` counterparts and
refuses any other ``repro`` name, so loading never imports ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

_SEP = "|"
_BF16 = "__bfloat16__"          # the paths of the leaves stored as bfloat16
# repro's packages whose pickled classes have a repro_torch counterpart
_MAPPED = ("repro.service", "repro.obs")


def _children(node):
    """``[(path segment, child)]`` of a container node, None for a leaf."""
    if isinstance(node, nn.Module):
        return [(f"d:{k}", p) for k, p in node.named_parameters()]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f"a:{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, dict):
        return [(f"d:{k}", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f"a:{n}", v) for n, v in zip(node._fields, node)]
    if isinstance(node, (list, tuple)):
        return [(f"s:{i}", v) for i, v in enumerate(node)]
    return None


def _host_copy(leaf) -> np.ndarray:
    """A leaf as a numpy array the caller can no longer mutate (a
    bfloat16 tensor as its 16-bit pattern, ``uint16``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf, copy=True)


def _flatten(tree, prefix: str = "", out: Optional[dict] = None) -> dict:
    """``{path: host array}`` for every leaf of ``tree``, and, where a
    leaf is a bfloat16 tensor, ``__bfloat16__``: those leaves' paths."""
    out = {} if out is None else out
    if tree is None:
        return out
    kids = _children(tree)
    if kids is None:
        out[prefix] = _host_copy(tree)
        if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
            out[_BF16] = np.append(out.get(_BF16, np.array([], str)), prefix)
        return out
    for seg, child in kids:
        _flatten(child, f"{prefix}{_SEP}{seg}" if prefix else seg, out)
    return out


def _read_bf16(flat: dict) -> dict:
    """The stored arrays with each leaf listed in ``__bfloat16__`` as the
    bfloat16 tensor of its 16-bit pattern."""
    flat = dict(flat)
    for path in flat.pop(_BF16, ()):
        bits = np.ascontiguousarray(flat[str(path)]).view(np.int16)
        flat[str(path)] = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return flat


def _unflatten(template, flat: dict, prefix: str = ""):
    """Rebuild ``template`` from a flat path -> array dict.

    Each stored array takes its template leaf's dtype and, for a tensor,
    its device.  A template leaf with no stored array keeps its template
    value -- how a checkpoint written before a state field existed
    restores into the grown structure (a v1 service checkpoint has no
    ``ServiceState.weight``).  Stored paths the template lacks are
    ignored."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        if prefix not in flat:
            return template
        arr = flat[prefix]
        if isinstance(arr, torch.Tensor):           # a bfloat16 leaf
            if isinstance(template, torch.Tensor):
                return arr.to(device=template.device, dtype=template.dtype)
            arr = arr.float().numpy()
        if isinstance(template, torch.Tensor):
            return torch.from_numpy(np.array(arr, order="C")).to(
                device=template.device, dtype=template.dtype)
        return arr.astype(template.dtype) if hasattr(template, "dtype") \
            else arr
    vals = [_unflatten(child, flat, f"{prefix}{_SEP}{seg}" if prefix
                       else seg) for seg, child in kids]
    if isinstance(template, nn.Module):
        model = type(template)(template.cfg, device=template.device,
                               dtype=template.dtype)
        with torch.no_grad():
            for p, v in zip(model.parameters(), vals):
                p.copy_(v)
        return model
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: v for f, v in zip(dataclasses.fields(template), vals)})
    if isinstance(template, dict):
        return dict(zip(sorted(template), vals))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*vals)
    return type(template)(vals)


class _PortUnpickler(pickle.Unpickler):
    """Unpickles a host payload written by either package: ``repro``'s
    service and observability classes load as their ``repro_torch``
    counterparts; any other ``repro`` name is refused."""

    def find_class(self, module: str, name: str):
        if module == "repro" or module.startswith("repro."):
            if not any(module == p or module.startswith(p + ".")
                       for p in _MAPPED):
                raise pickle.UnpicklingError(
                    f"host payload names {module}.{name}: only "
                    f"{', '.join(_MAPPED)} map to repro_torch")
            module = "repro_torch" + module[len("repro"):]
        return super().find_class(module, name)


def load_host_payload(path: str):
    """The host payload pickled at ``path`` (see :class:`_PortUnpickler`)."""
    with open(path, "rb") as f:
        return _PortUnpickler(f).load()


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Any, metadata: Optional[dict] = None,
             host_state: Any = None):
        """Write one checkpoint.  ``state`` is a tree of tensors/arrays,
        copied to the host here; ``host_state`` is any picklable object
        saved alongside it in the same atomic step directory, pickled here
        (both are snapshots before an async save returns)."""
        flat = _flatten(state)
        host_blob = None if host_state is None else pickle.dumps(
            host_state, protocol=pickle.HIGHEST_PROTOCOL)
        if self.async_save:
            self.wait()                 # re-raises a prior failed save
            self._thread = threading.Thread(
                target=self._save_worker, args=(step, flat, metadata,
                                                host_blob))
            self._thread.start()
        else:
            self._save_sync(step, flat, metadata, host_blob)

    def _save_worker(self, step, flat, metadata, host_blob):
        # On the save thread an exception would die with the thread and
        # the caller would believe the checkpoint exists: keep it for
        # wait() / the next save() to raise.
        try:
            self._save_sync(step, flat, metadata, host_blob)
        except BaseException as e:      # noqa: BLE001 -- must not be lost
            self._error = e

    def _save_sync(self, step: int, flat: dict, metadata, host_blob=None):
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "state.npz"), **flat)
            if host_blob is not None:
                with open(os.path.join(tmp, "host.pkl"), "wb") as f:
                    f.write(host_blob)
            meta = {"step": int(step), **(metadata or {})}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            # mkdtemp makes 0700 dirs and the rename would keep that mode:
            # honour the umask instead, so another user or process can
            # read the checkpoint it is handed.
            umask = os.umask(0)
            os.umask(umask)
            os.chmod(tmp, 0o777 & ~umask)
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic on one filesystem
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def wait(self):
        """Join an in-flight async save; raises the save thread's
        exception, if any (the failed step was never renamed into place)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                with_host: bool = False):
        """Restore into the structure, dtypes and devices of ``template``.
        Returns ``(state, step)`` -- or ``(state, host_state, step)`` with
        ``with_host`` -- every element None when no checkpoint exists."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return (None, None, None) if with_host else (None, None)
        base = os.path.join(self.dir, f"step_{step:010d}")
        with np.load(os.path.join(base, "state.npz")) as z:
            flat = _read_bf16({k: z[k] for k in z.files})
        state = _unflatten(template, flat)
        if not with_host:
            return state, step
        host_path = os.path.join(base, "host.pkl")
        host = load_host_payload(host_path) if os.path.exists(host_path) \
            else None
        return state, host, step
