"""Checkpoint / resume for the port: the full training state on disk.

The port's copy of ``dopt.utils.checkpoint`` without jax or orbax: the
arrays pytree goes to ``state.npz`` (dopt's numpy layout — ``/``-joined
keys, ``_flatten_for_npz`` / ``_unflatten_from_npz``), scalars, History
rows and host RNG states to ``meta.json``.

Layout:  <dir>/state.npz      the arrays pytree (numpy leaves)
         <dir>/meta.json      {round, name, algorithm, history rows, ...}
         <dir>/complete.json  every other file's size, written LAST

Saves are atomic: the new checkpoint is fully materialised (plain
writes: the staging directory and the manifest make them safe) in a
``<dir>.tmp`` sibling, the previous checkpoint (if any) is parked at
``<dir>.old``, and only then is the sibling renamed into place.  A crash
at any point leaves at least one complete checkpoint loadable —
``load_checkpoint`` falls back to ``<dir>.old`` when the primary
directory is missing or incomplete, and the size manifest rejects a
truncated file.

Across ranks (a ``WorkerGroup`` with a wire) ``save_rank_checkpoint``
gathers every per-lane tree to the whole ``[W, ...]``, rank 0 writes the
same format and every rank waits at a barrier; ``rank_state`` cuts a
loaded checkpoint to a rank's lanes.  The file does not record the rank
count: a checkpoint written at R ranks restores at one rank or at R'.

numpy has no bf16, so ``host_tree`` brings bf16 tensors to the host as
f32, which holds every bf16 value exactly (the ``dopt_torch.convert``
convention); ``copy_into`` casts them back to the trainer's storage
dtype, bit for bit, writing every carried tensor in place.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from dopt_torch.parallel.mesh import barrier, gather_workers


def host_tree(tree: dict) -> dict:
    """A (nested) dict of tensors or arrays as numpy arrays on the host;
    bf16 tensors as f32 (exact)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = host_tree(v)
        elif isinstance(v, torch.Tensor):
            v = v.detach()
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v
                      ).cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out


@torch.no_grad()
def copy_into(dst: dict[str, torch.Tensor], src: dict[str, Any], *,
              what: str) -> None:
    """Write the checkpoint's ``src`` leaves into the trainer's ``dst``
    tensors in place (``copy_``: the tensors keep their addresses, so
    captured CUDA graphs stay valid), cast to each tensor's dtype.
    Refuses a missing, extra or differently shaped leaf."""
    if set(src) != set(dst):
        raise ValueError(
            f"checkpoint '{what}' holds {sorted(src)}, this trainer "
            f"carries {sorted(dst)}")
    for k, t in dst.items():
        a = torch.from_numpy(np.asarray(src[k]))
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(
                f"checkpoint '{what}/{k}' has shape {tuple(a.shape)}, this "
                f"trainer's is {tuple(t.shape)}")
        t.copy_(a.to(t.dtype))


def _write_state(dest: Path, arrays: dict[str, Any]) -> None:
    """Materialise the arrays pytree under ``dest`` as one npz."""
    np.savez(dest / "state.npz", **_flatten_for_npz(arrays))


def _write_meta(dest: Path, meta: dict[str, Any]) -> None:
    (dest / "meta.json").write_text(json.dumps(meta, indent=2))


# Completeness marker: written LAST into the staging dir, it records
# every checkpoint file's size.  ``_is_complete`` cross-checks the
# manifest against the files on disk, so a checkpoint truncated by a
# mid-write crash (or a partial copy) is detected and rejected instead
# of loaded as garbage.
_MARKER = "complete.json"


def _write_marker(dest: Path) -> None:
    files = {
        str(p.relative_to(dest)): p.stat().st_size
        for p in sorted(dest.rglob("*"))
        if p.is_file() and p.name != _MARKER
    }
    (dest / _MARKER).write_text(json.dumps(files, indent=2))


def save_checkpoint(path: str | Path, *, arrays: dict[str, Any],
                    meta: dict[str, Any]) -> Path:
    """Save an arrays pytree (numpy leaves, or tensors: ``host_tree``)
    and JSON metadata, atomically.

    The previous checkpoint at ``path`` is never modified in place: the
    new one is built in ``<path>.tmp`` and swapped in via two renames
    (old → ``<path>.old``, tmp → ``path``).  A crash anywhere in between
    leaves either ``path`` or ``<path>.old`` as a complete checkpoint.
    """
    path = Path(path).absolute()
    arrays = {k: (host_tree(v) if isinstance(v, dict) else v)
              for k, v in arrays.items() if v is not None}
    path.parent.mkdir(parents=True, exist_ok=True)

    tmp = path.with_name(path.name + ".tmp")
    old = path.with_name(path.name + ".old")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    _write_state(tmp, arrays)
    _write_meta(tmp, meta)
    _write_marker(tmp)

    # Swap: park the previous checkpoint, promote the new one, then drop
    # the parked copy.  os.replace cannot overwrite a non-empty dir, so
    # the parked copy doubles as the crash-window fallback.  When the
    # primary is MISSING (a save after a crash that left only
    # ``<path>.old``), the parked copy is the sole good checkpoint — it
    # must survive until the promotion rename lands, so the cleanup
    # happens strictly after ``os.replace(tmp, path)`` in every case.
    if path.exists():
        if old.exists():
            shutil.rmtree(old)   # safe: primary still intact
        os.replace(path, old)
    os.replace(tmp, path)
    if old.exists():
        shutil.rmtree(old)
    return path


def _lane_tree(tree, fn, axis: int):
    """``fn`` over every leaf of a (nested) dict with its lane axis moved
    to the front and back."""
    if isinstance(tree, dict):
        return {k: _lane_tree(v, fn, axis) for k, v in tree.items()}
    if axis == 0:
        return fn(tree)
    return fn(tree.swapaxes(0, axis)).swapaxes(0, axis)


def save_rank_checkpoint(group, path, arrays: dict, meta: dict, *,
                         replicated=(), lane_axis=None) -> None:
    """Both engines' save across ranks: every per-lane tree of
    ``arrays`` is gathered to its whole ``[W, ...]`` (lane axis 0, or
    ``lane_axis[name]``), the ``replicated`` ones are the same on every
    rank, rank 0 writes dopt's format and every rank waits for the
    write.  On one rank it is ``save_checkpoint``."""
    if group.wire:
        lane_axis = lane_axis or {}
        arrays = {k: v if (k in replicated or v is None) else _lane_tree(
            v, lambda x: gather_workers(x.contiguous(), group, "checkpoint"),
            lane_axis.get(k, 0)) for k, v in arrays.items()}
    if group.rank == 0:
        save_checkpoint(path, arrays=arrays, meta=meta)
    barrier(group)


def rank_state(group, arrays: dict, *, replicated=(), lane_axis=None
               ) -> dict:
    """A loaded checkpoint's arrays cut to this rank's lanes (every rank
    reads the whole file): the inverse of ``save_rank_checkpoint``, so a
    checkpoint written at any rank count restores at any other."""
    if not group.wire:
        return arrays
    lane_axis = lane_axis or {}
    return {k: v if k in replicated else _lane_tree(
        v, lambda x: group.local(np.asarray(x)), lane_axis.get(k, 0))
        for k, v in arrays.items()}


def _is_complete(path: Path) -> bool:
    if not (path / "meta.json").exists():
        return False
    if not (path / "state.npz").exists():
        return False
    marker = path / _MARKER
    if not marker.exists():
        # Pre-manifest checkpoint: only the presence check is possible.
        return True
    try:
        manifest = json.loads(marker.read_text())
    except ValueError:
        return False
    for rel, size in manifest.items():
        f = path / rel
        if not f.is_file() or f.stat().st_size != int(size):
            return False
    return True


class IncompleteCheckpointError(RuntimeError):
    """Neither the checkpoint nor its ``.old`` fallback is complete
    (mid-write crash, truncation, or partial copy)."""


def load_checkpoint(path: str | Path) -> tuple[dict[str, Any], dict[str, Any]]:
    """Returns (arrays, meta), the arrays as a nested dict of numpy
    arrays.

    Falls back to ``<path>.old`` when ``path`` is absent or incomplete
    (the save crashed between the two promotion renames).  dopt's npz
    checkpoints load as they are; its orbax ones (a ``state/`` directory)
    are refused by name.
    """
    path = Path(path).absolute()
    if (path / "state").is_dir() and not (path / "state.npz").exists():
        raise ValueError(
            f"checkpoint at {path} holds an orbax 'state/' directory; the "
            "port reads dopt's npz layout only (save it from dopt with "
            "dopt.utils.checkpoint.HAVE_ORBAX = False)")
    if not _is_complete(path):
        old = path.with_name(path.name + ".old")
        if _is_complete(old):
            path = old
        else:
            raise IncompleteCheckpointError(
                f"checkpoint at {path} is missing, truncated, or "
                "incomplete (its size manifest does not match the files "
                f"on disk), and no complete fallback exists at {old}; "
                "re-save from a live trainer or point at an earlier "
                "checkpoint")
    meta = json.loads((path / "meta.json").read_text())
    with np.load(path / "state.npz") as z:
        arrays = _unflatten_from_npz(dict(z))
    return arrays, meta


def meta_expect(meta: dict[str, Any], *, what: str = "checkpoint",
                **expected: Any) -> None:
    """Validate checkpoint metadata fields against expected values.

    Collects EVERY mismatching (or absent-but-expected) field into one
    ValueError instead of failing on the first, so a wrong-config
    resume reports the whole disagreement at once.  Fields the
    checkpoint predates (absent AND expected None) pass — older
    checkpoints stay loadable."""
    problems = []
    for key, want in expected.items():
        got = meta.get(key)
        if got is None and want is None:
            continue
        if got != want:
            problems.append(f"{key}={got!r} (trainer expects {want!r})")
    if problems:
        raise ValueError(
            f"{what} does not match this trainer: " + "; ".join(problems))


def _flatten_for_npz(tree, prefix="") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten_for_npz(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten_from_npz(flat: dict[str, np.ndarray]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out
