"""Checkpoint and resume: the counterpart of
``agp_tpu/training/checkpoint.py``, in its layout, so that the port loads
the JAX package's checkpoints too.

A checkpoint is a directory: ``model.npz`` and ``state.npz`` hold the
tensors as ``leaf_0``, ``leaf_1``, ... and ``manifest.json`` each leaf's
shape and dtype.  The port's own manifest also names each leaf's path
(``state.hyper_state.kernel.mu.lengthscale``, ``model.likelihoods.1.sigma2``)
and its device, under a ``format`` key, so that its checkpoints load by
name; a pickled skeleton of (model, state) with the tensors taken out is
written beside them for the opt-in ``allow_pickle`` load.

The default load grafts the saved tensors onto templates (the model built
the same way in code and its ``init_state``) and never unpickles: it
checks the leaf count, the paths and every shape, and raises
``ValueError`` on a mismatch.  Tensors land on each template tensor's
device and in its dtype, so a float64 checkpoint loads onto a float32
template on the card; on a template of the saved dtype and device they are
bit-equal.  A checkpoint of the JAX package has no paths: its leaves are
mapped by the reference's flatten order (``interop.from_reference_leaves``),
its PRNG key dropped.

``allow_pickle=True`` restores the port's own checkpoints without
templates (unpickling runs code: only for checkpoints you trust), each
tensor on the device it was saved from.  A JAX checkpoint's pickled treedef
cannot be read without JAX, so there it raises ``ValueError``.  As in the
reference, a model whose likelihood class ``make_augmented_likelihood``
built at run time does not pickle by name: rebuild it in code and load
with templates.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Tuple

import numpy as np
import torch

from ..utils.tensors import map_named, named_leaves

FORMAT = "agp_tpu_torch/1"


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A tensor's place in a pickled skeleton: its leaf number."""

    index: int


def save(path: str, model: Any, state: Any) -> None:
    """Write (model, state) to the directory ``path``: the tensors to
    ``model.npz`` / ``state.npz``, their paths, shapes, dtypes and devices
    to ``manifest.json``, the skeletons to ``<name>.skeleton.pkl``."""
    os.makedirs(path, exist_ok=True)
    manifest = {"format": FORMAT}
    for name, tree in (("model", model), ("state", state)):
        leaves = named_leaves(tree, name)
        arrs = [t.detach().cpu().numpy() for _, t in leaves]
        np.savez(os.path.join(path, f"{name}.npz"), **{f"leaf_{i}": a for i, a in enumerate(arrs)})
        manifest[name] = [
            {"path": p, "shape": list(a.shape), "dtype": str(a.dtype), "device": str(t.device)}
            for (p, t), a in zip(leaves, arrs)
        ]
        index = {p: i for i, (p, _) in enumerate(leaves)}
        try:
            skeleton = pickle.dumps(map_named(lambda p, t: _Leaf(index[p]), tree, name))
        except (pickle.PicklingError, AttributeError, TypeError):
            skeleton = None  # a class built at run time: templates only
        with open(os.path.join(path, f"{name}.skeleton.pkl"), "wb") as f:
            f.write(skeleton or b"")
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _manifest(path: str):
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        return json.load(f)


def _load_arrays(path: str, name: str) -> list:
    data = np.load(os.path.join(path, f"{name}.npz"))  # allow_pickle=False
    return [data[f"leaf_{i}"] for i in range(len(data.files))]


def load(path: str, model_template: Any = None, state_template: Any = None,
         allow_pickle: bool = False) -> Tuple[Any, Any]:
    """Load (model, state) written by :func:`save`, or by the JAX package's
    ``checkpoint.save``.

    Default (safe) mode: pass templates of the saved objects' structure
    (the model built the same way and its ``init_state``); the tensors are
    grafted onto them and nothing is unpickled.  ``allow_pickle=True``
    restores the port's own checkpoints without templates by unpickling
    their skeletons: only for checkpoints you trust."""
    if allow_pickle:
        manifest = _manifest(path)
        if manifest is None or manifest.get("format") != FORMAT:
            raise ValueError(
                "allow_pickle restores the port's own checkpoints only: this one has no port manifest (a JAX "
                "checkpoint's treedef needs JAX); pass model_template and state_template"
            )
        out = []
        for name in ("model", "state"):
            with open(os.path.join(path, f"{name}.skeleton.pkl"), "rb") as f:
                raw = f.read()
            if not raw:
                raise ValueError(f"{name}: no skeleton was pickled (a class built at run time): load with templates")
            tensors = [torch.as_tensor(a).to(entry["device"])
                       for a, entry in zip(_load_arrays(path, name), manifest[name])]
            out.append(map_named(lambda p, leaf: tensors[leaf.index], pickle.loads(raw), name, _Leaf))
        return out[0], out[1]
    if model_template is None or state_template is None:
        raise ValueError(
            "load() is weights-only by default: pass model_template and state_template (build the model the "
            "same way and init_state it), or opt into allow_pickle=True for TRUSTED checkpoints"
        )
    return load_arrays(path, model_template, state_template)


def load_arrays(path: str, model_template: Any, state_template: Any) -> Tuple[Any, Any]:
    """Weights-only load onto templates; never unpickles.  A port
    checkpoint's tensors go by path, a JAX one's by the reference's
    flatten order; either way the leaf count and every shape must match
    the manifest, else ``ValueError``."""
    manifest = _manifest(path)
    if manifest is not None and manifest.get("format") == FORMAT:
        out = []
        for name, template in (("model", model_template), ("state", state_template)):
            saved = {e["path"]: (e, a) for e, a in zip(manifest[name], _load_arrays(path, name))}
            leaves = named_leaves(template, name)
            missing = [p for p, _ in leaves if p not in saved]
            if len(leaves) != len(saved) or missing:
                raise ValueError(
                    f"{name}: checkpoint has {len(saved)} leaves, template has {len(leaves)}"
                    + (f"; not in the checkpoint: {missing[:5]}" if missing else "")
                    + " -- template structure must match"
                )
            for p, t in leaves:
                if list(t.shape) != saved[p][0]["shape"]:
                    raise ValueError(f"{p}: checkpoint shape {saved[p][0]['shape']} != template shape {list(t.shape)}")
            # each tensor on its template tensor's device, in its dtype
            out.append(map_named(lambda p, t: torch.as_tensor(saved[p][1]).to(device=t.device, dtype=t.dtype),
                                  template, name))
        return out[0], out[1]
    return _load_reference(path, manifest, model_template, state_template)


def _load_reference(path, manifest, model_template, state_template):
    """A JAX checkpoint onto port templates, by the reference's flatten
    order (``interop.reference_leaf_table``)."""
    from ..interop import from_reference_leaves, reference_leaf_table

    leaves = {name: _load_arrays(path, name) for name in ("model", "state")}
    table = reference_leaf_table(model_template, state_template)
    for name in ("model", "state"):
        rows = [r for r in table if r[0] == name]
        if len(leaves[name]) != len(rows):
            raise ValueError(
                f"{name}: checkpoint has {len(leaves[name])} leaves, the template's reference layout has "
                f"{len(rows)} -- template structure must match"
            )
        for i, (_, ref_path, keys, t) in enumerate(rows):
            shape = list(leaves[name][i].shape) if manifest is None else manifest[name][i]["shape"]
            want = [2] if keys is None else list(t.shape)
            if shape != want:
                raise ValueError(f"{name} leaf {i} ({ref_path}): checkpoint shape {shape} != template shape {want}")
    model, state = from_reference_leaves(leaves["model"], leaves["state"], model_template, state_template)
    return _like(model, model_template, "model"), _like(state, state_template, "state")


def _like(tree, template, name):
    """``template`` with each tensor replaced by ``tree``'s at its path, on
    the template tensor's device and in its dtype."""
    got = dict(named_leaves(tree, name))
    return map_named(lambda p, t: got[p].to(device=t.device, dtype=t.dtype), template, name)
