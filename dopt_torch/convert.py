"""Weight carry-over between dopt's flax trees and the port's layout.

``params_from_jax`` takes a dopt params tree as numpy arrays — one
worker's or the ``[W, ...]`` stacked fleet's — and returns the port's
parameter dict with the same leading axes; ``params_to_jax`` is its
exact inverse.  Only transposes and reshapes: the round trip is
bit-exact.  Both dispatch on the tree's layers: ``conv1`` marks
Model1/Model3 (the worker axis is there when ``conv1``'s kernel has
rank 5); ``Conv_0`` marks ResNet-18, whose nested tree (``Conv_0``,
``GroupNorm_0``, ``ResidualBlock_k/{Conv_i, GroupNorm_i}``, ``head``)
maps to dotted names (``ResidualBlock_0.Conv_0.weight``), GroupNorm's
``scale`` and ``bias`` as they are; ``tok_emb`` marks the TransformerLM
(``tok_emb/embedding`` ↔ ``tok_emb.weight``, ``pos_emb`` as it is,
LayerNorms' ``scale``/``bias`` as they are, each Dense kernel
transposed); any other tree is dense — the MLP's
``{fc1, fc2, head}`` or the logistic model's ``{linear}`` (the worker
axis is there when a kernel has rank 3).

Layouts (per worker): flax conv ``[kh, kw, Cin, Cout]`` ↔ torch
``[Cout, Cin, kh, kw]``; flax dense ``[in, out]`` ↔ torch ``[out, in]``;
and the CNN's fc1 input, which flax flattens in HWC order from the NHWC
activations while the port flattens CHW from NCHW ones.  The dense
models flatten their input in HWC order in both packages.

numpy has no bf16 of its own, so bf16 crosses in f32, which holds every
bf16 value exactly: ``params_to_jax`` of bf16 tensors returns f32
arrays, and ``params_from_jax`` turns dopt's bf16 leaves into f32
arrays; casting back to bf16 on either side restores the same bits.
"""

from __future__ import annotations

import numpy as np


def _post_pool(input_shape) -> tuple[int, int]:
    h, w = input_shape[0], input_shape[1]
    return h // 2 // 2, w // 2 // 2


def _host(a) -> np.ndarray:
    """A leaf as a numpy array; a bf16 leaf (a dtype numpy lacks) as f32."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _dense(k: np.ndarray) -> np.ndarray:
    """A dense kernel between flax's ``[..., in, out]`` and torch's
    ``[..., out, in]`` (the map is its own inverse), as a fresh array."""
    return np.array(np.swapaxes(k, -1, -2), order="C")


def _conv_from_jax(k: np.ndarray) -> np.ndarray:
    """[..., kh, kw, Cin, Cout] → [..., Cout, Cin, kh, kw]."""
    lead = tuple(range(k.ndim - 4))
    return np.ascontiguousarray(np.transpose(
        k, lead + tuple(len(lead) + i for i in (3, 2, 0, 1))))


def _conv_to_jax(w: np.ndarray) -> np.ndarray:
    """[..., Cout, Cin, kh, kw] → [..., kh, kw, Cin, Cout]."""
    lead = tuple(range(w.ndim - 4))
    return np.ascontiguousarray(np.transpose(
        w, lead + tuple(len(lead) + i for i in (2, 3, 1, 0))))


def _resnet_from_jax(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_resnet_from_jax(v, f"{prefix}{key}."))
        elif key == "kernel":
            v = _host(v)
            out[f"{prefix}weight"] = (_dense(v) if prefix == "head."
                                      else _conv_from_jax(v))
        else:
            out[f"{prefix}{key}"] = np.array(_host(v))
    return out


def _resnet_to_jax(p: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for name in sorted(p):
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        if leaf == "weight":
            node["kernel"] = (_dense(p[name]) if path == ["head"]
                              else _conv_to_jax(p[name]))
        else:
            node[leaf] = p[name].copy()
    return out


def _transformer_from_jax(tree: dict) -> dict[str, np.ndarray]:
    out = {"pos_emb": np.array(_host(tree["pos_emb"]))}
    for layer, leaves in tree.items():
        if layer == "pos_emb":
            continue
        for key, v in leaves.items():
            v = _host(v)
            if key == "embedding":
                out[f"{layer}.weight"] = np.array(v)
            elif key == "kernel":
                out[f"{layer}.weight"] = _dense(v)
            else:
                out[f"{layer}.{key}"] = np.array(v)
    return out


def _transformer_to_jax(p: dict[str, np.ndarray]) -> dict:
    out: dict = {"pos_emb": p["pos_emb"].copy()}
    for name, v in p.items():
        if name == "pos_emb":
            continue
        layer, key = name.split(".")
        if name == "tok_emb.weight":
            out[layer] = {"embedding": v.copy()}
        elif key == "weight":
            out.setdefault(layer, {})["kernel"] = _dense(v)
        else:
            out.setdefault(layer, {})[key] = v.copy()
    return out


def params_from_jax(tree, *, input_shape=(28, 28, 1)) -> dict[str, np.ndarray]:
    """dopt flax tree (numpy leaves) → port parameter dict."""
    if "Conv_0" in tree:
        return _resnet_from_jax(tree)
    if "tok_emb" in tree:
        return _transformer_from_jax(tree)
    tree = {layer: {k: _host(v) for k, v in leaves.items()}
            for layer, leaves in tree.items()}
    if "conv1" not in tree:
        out = {}
        for layer, leaves in tree.items():
            out[f"{layer}.weight"] = _dense(leaves["kernel"])
            out[f"{layer}.bias"] = np.array(leaves["bias"])
        return out
    lead = tree["conv1"]["kernel"].ndim - 4   # 0 or 1 (worker)
    a = tuple(range(lead))
    hp, wp = _post_pool(input_shape)

    def fc1(k):
        c2 = tree["conv2"]["kernel"].shape[-1]
        k = k.reshape(k.shape[:lead] + (hp, wp, c2, k.shape[-1]))
        k = np.transpose(k, a + tuple(lead + i for i in (3, 2, 0, 1)))
        return k.reshape(k.shape[:lead + 1] + (-1,))

    out = {}
    for layer, f in (("conv1", _conv_from_jax), ("conv2", _conv_from_jax),
                     ("fc1", fc1), ("fc2", _dense)):
        out[f"{layer}.weight"] = np.ascontiguousarray(
            f(tree[layer]["kernel"]))
        out[f"{layer}.bias"] = np.array(tree[layer]["bias"])
    return out


def params_to_jax(params, *, input_shape=(28, 28, 1)) -> dict:
    """Port parameter dict (numpy or tensors) → dopt flax tree."""
    p = {k: (v.detach().float().cpu().numpy() if hasattr(v, "detach")
             else np.asarray(v)) for k, v in params.items()}
    if "Conv_0.weight" in p:
        return _resnet_to_jax(p)
    if "tok_emb.weight" in p:
        return _transformer_to_jax(p)
    if "conv1.weight" not in p:
        layers = dict.fromkeys(k.rsplit(".", 1)[0] for k in p)
        return {layer: {"kernel": _dense(p[f"{layer}.weight"]),
                        "bias": p[f"{layer}.bias"].copy()}
                for layer in layers}
    lead = p["conv1.weight"].ndim - 4
    a = tuple(range(lead))
    hp, wp = _post_pool(input_shape)

    def fc1(w):
        c2 = p["conv2.weight"].shape[lead]
        w = w.reshape(w.shape[:lead + 1] + (c2, hp, wp))
        w = np.transpose(w, a + tuple(lead + i for i in (2, 3, 1, 0)))
        return w.reshape(w.shape[:lead] + (-1, w.shape[-1]))

    return {layer: {"kernel": np.ascontiguousarray(f(p[f"{layer}.weight"])),
                    "bias": p[f"{layer}.bias"].copy()}
            for layer, f in (("conv1", _conv_to_jax), ("conv2", _conv_to_jax),
                             ("fc1", fc1), ("fc2", _dense))}


def params_for_rank(tree, group, *, input_shape=(28, 28, 1)
                    ) -> dict[str, np.ndarray]:
    """dopt's stacked ``[W, ...]`` flax tree (or the port's ``[W, ...]``
    dict) → this rank's ``[L, ...]`` rows in the port's layout, for a
    ``dopt_torch.parallel.WorkerGroup``: every rank converts the whole
    host tree and keeps its lanes (no collective).  One worker's tree,
    which starts every lane of every rank, goes to a trainer's
    ``init_params`` as it is."""
    full = port_layout(tree, input_shape=input_shape)
    if not group.wire:
        return full
    return {k: np.ascontiguousarray(group.local(v)) for k, v in full.items()}


def port_layout(tree, *, input_shape=(28, 28, 1)) -> dict[str, np.ndarray]:
    """A params-shaped checkpoint tree in either package's layout → the
    port's: dopt's flax tree (``{layer: {kernel, bias}}``, from a dopt
    npz checkpoint) goes through ``params_from_jax``; the port's own
    (``{"conv1.weight": ...}``) passes as it is."""
    if any(isinstance(v, dict) for v in tree.values()):
        return params_from_jax(tree, input_shape=input_shape)
    return dict(tree)


def _jax_leaves(tree) -> list[np.ndarray]:
    """A flax tree's leaves in ``jax.tree_util.tree_flatten`` order
    (dict keys sorted at every level)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _jax_leaves(tree[k])]
    return [tree]


def dopt_flat_order(shapes: dict[str, tuple[int, ...]], *,
                    input_shape=(28, 28, 1)) -> dict[str, np.ndarray | None]:
    """Each port tensor's flat index map into dopt's layout of its leaf.

    ``shapes`` holds one worker's port shapes (``{"conv1.weight": (32, 1,
    5, 5), ...}``).  For every name, ``order[name][j]`` is the port flat
    index of element j of dopt's leaf flattened in dopt's layout (conv
    ``[kh, kw, Cin, Cout]``, dense ``[in, out]``, the CNN's fc1 rows in
    HWC order), or None where the two layouts agree.  The map comes from
    ``params_to_jax`` itself, run on index-valued tensors, and dopt's
    flatten order of the leaves is the port's sorted names — so a draw
    over dopt's leaf i lands on the element of ``sorted(shapes)[i]`` it
    lands on in dopt."""
    names = sorted(shapes)
    offsets, off = {}, 0
    for name in names:
        offsets[name] = off
        off += int(np.prod(shapes[name], dtype=np.int64))
    index = {name: np.arange(offsets[name],
                             offsets[name] + int(np.prod(shapes[name],
                                                         dtype=np.int64)),
                             dtype=np.int64).reshape(shapes[name])
             for name in names}
    leaves = _jax_leaves(params_to_jax(index, input_shape=input_shape))
    if len(leaves) != len(names):
        raise ValueError(f"{len(names)} port tensors map to {len(leaves)} "
                         "dopt leaves")
    out = {}
    for name, leaf in zip(names, leaves):
        flat = np.ascontiguousarray(leaf).reshape(-1) - offsets[name]
        if flat.size != index[name].size or not (
                0 <= flat.min() and flat.max() < flat.size):
            raise ValueError(f"dopt's leaf in {name!r}'s place is not "
                             f"{name!r}'s")
        out[name] = (None if np.array_equal(flat, np.arange(flat.size))
                     else flat)
    return out
