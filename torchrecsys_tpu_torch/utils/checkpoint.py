"""Checkpoints in a torch-native format (counterpart of
``torchrecsys_tpu/utils/checkpoint.py:27-102``, whose train state is an
Orbax checkpoint the port cannot read without JAX).

A checkpoint directory holds

- ``state.pt``: the train state (``{"tables", "dense", "model_state",
  "emb_opt", "dense_opt", "step", "rng"}``) written by ``torch.save`` with
  every tensor on the CPU and the generator as ``{"device": type,
  "state": gen.get_state()}``, so :func:`restore_checkpoint` reads it with
  ``weights_only=True``;
- ``schema.json``: the dataset schema, byte-equal to the JAX package's;
- ``aux.pkl``: what a cold process needs besides the numbers, under the
  keys of the JAX package's ``pack_store_aux`` (:59-86): the raw-id
  vocabularies, the item metadata table, the model and train configs, the
  sequence nets' user history windows (and, from the facade,
  ``dataset_cols``).

:func:`restore_checkpoint` holds every leaf against a target state and
raises ``ValueError`` naming the first that differs in shape or dtype:
``torch.load`` needs no target, so this is where a checkpoint of another
dataset is caught.

On a mesh (parallel/mesh.py) :func:`save_checkpoint` gathers the whole
state on every rank (parallel/sharding.py::gather_state) and world rank 0
writes the same files a single device writes; :func:`restore_checkpoint`
reads the whole state and keeps this rank's piece of it, whatever mesh
saved it, as Orbax re-shards in the JAX package (:8-9).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Dict, Optional

import torch

from torchrecsys_tpu_torch.config import DataSchema, ModelConfig, TrainConfig

STATE_FILE = "state.pt"
# leaves a state not made by fit leaves empty (load_jax_tables, init_tables)
_OPTIONAL = ("dense_opt", "rng")


def _to_cpu(tree: Any) -> Any:
    """Tensors to the CPU and the generator to its device type and state;
    plain containers and ints as they are."""
    if isinstance(tree, torch.Generator):
        return {"device": tree.device.type, "state": tree.get_state()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        # torch.save writes a view's whole storage: keep only the tensor's
        if t.untyped_storage().nbytes() != t.numel() * t.element_size():
            t = t.clone()
        return t
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


def save_checkpoint(
    directory: str,
    state: Dict[str, Any],
    schema: Optional[DataSchema] = None,
    aux: Optional[Dict[str, Any]] = None,
    mesh=None,
) -> None:
    """Write ``state`` to ``directory/state.pt`` and, when given, the
    schema (``schema.json``) and ``aux`` (``aux.pkl``, :func:`save_aux`).
    On a ``mesh`` every rank calls it with its piece of the state; the
    whole state is gathered (a state without tables, EASE's, is whole on
    every rank) and world rank 0 writes, the others wait."""
    if mesh is not None:
        from torchrecsys_tpu_torch.parallel.sharding import gather_state

        if "tables" in state:
            state = gather_state(state, mesh)
        if mesh.rank != 0:
            _barrier(mesh)
            return
        try:
            save_checkpoint(directory, state, schema, aux)
        finally:
            _barrier(mesh)
        return
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    torch.save(_to_cpu(state), os.path.join(directory, STATE_FILE))
    if schema is not None:
        with open(os.path.join(directory, "schema.json"), "w") as f:
            f.write(schema.to_json())
    if aux is not None:
        save_aux(directory, aux)


def _barrier(mesh) -> None:
    if mesh.world > 1:
        import torch.distributed as dist

        dist.barrier()


def save_aux(directory: str, aux: Dict[str, Any]) -> None:
    with open(os.path.join(os.path.abspath(directory), "aux.pkl"), "wb") as f:
        pickle.dump(aux, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_aux(directory: str) -> Optional[Dict[str, Any]]:
    """The ``aux.pkl`` dict, or None when the directory has none."""
    path = os.path.join(os.path.abspath(directory), "aux.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def load_schema(directory: str) -> DataSchema:
    with open(os.path.join(os.path.abspath(directory), "schema.json")) as f:
        return DataSchema.from_dict(json.load(f))


def pack_store_aux(store, model_cfg: ModelConfig, train_cfg: Optional[TrainConfig]) -> Dict[str, Any]:
    """The raw-id vocabularies, the item metadata table, the configs and,
    for the nets that read one (lstm, sasrec, hstu), each user's history window
    ``history: {ids, mask}`` (:59-86): it derives from the train split,
    which a cold process does not have."""
    from torchrecsys_tpu_torch.models import MODEL_REGISTRY

    m = store.metadata
    aux = {
        "user_vocab": store.user_encoder.to_list(),
        "item_vocab": store.item_encoder.to_list(),
        "metadata": {
            "ids": m.ids,
            "mask": m.mask,
            "names": tuple(m.names),
            "vocabs": [e.to_list() for e in m.encoders],
        },
        "model_cfg": dataclasses.asdict(model_cfg),
        "train_cfg": dataclasses.asdict(train_cfg) if train_cfg else None,
    }
    if getattr(MODEL_REGISTRY.get(model_cfg.net_type), "needs_history", False):
        h_ids, h_mask = store.user_history(model_cfg.history_len)
        aux["history"] = {"ids": h_ids, "mask": h_mask}
    return aux


def _check(loaded: Any, target: Any, where: str) -> None:
    """``loaded`` against ``target``: the same dict keys and list lengths,
    tensors of the same shape and dtype, ints where the target has ints."""
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            got = sorted(loaded) if isinstance(loaded, dict) else type(loaded).__name__
            raise ValueError(f"checkpoint {where}: keys {got} != {sorted(target)}")
        for k in target:
            sub = f"{where}[{k!r}]" if where else k
            if loaded[k] is None and sub in _OPTIONAL:
                continue
            _check(loaded[k], target[k], sub)
    elif isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(target):
            raise ValueError(f"checkpoint {where}: expected a list of {len(target)}")
        for i, (a, t) in enumerate(zip(loaded, target)):
            _check(a, t, f"{where}[{i}]")
    elif isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor):
            raise ValueError(f"checkpoint {where}: {type(loaded).__name__}, want a tensor")
        if loaded.shape != target.shape or loaded.dtype != target.dtype:
            raise ValueError(
                f"checkpoint {where}: {tuple(loaded.shape)} {loaded.dtype} != "
                f"{tuple(target.shape)} {target.dtype} (a checkpoint of another dataset "
                "or model?)"
            )
    elif isinstance(target, int):
        if not isinstance(loaded, int):
            raise ValueError(f"checkpoint {where}: {loaded!r}, want an int")


def restore_checkpoint(
    directory: str, target_state: Dict[str, Any], device: Any, seed: int = 0, mesh=None
) -> Dict[str, Any]:
    """The state of ``directory/state.pt`` on ``device``, checked leaf by
    leaf against ``target_state`` (tensors may live on the ``meta``
    device; its ``rng`` is not read). ``dense_opt`` and ``rng`` may be
    None in the checkpoint: a state that ``fit`` did not make. A generator
    saved on ``device``'s type comes back exactly (a resumed fit draws what
    an uninterrupted one would); one saved on another type (card -> CPU)
    is replaced by a generator derived from ``(seed, step)``. On a
    ``mesh``, this rank's piece of the state, on the mesh's device."""
    from torchrecsys_tpu_torch.train.trainer import derived_generator

    if mesh is not None:
        from torchrecsys_tpu_torch.parallel.sharding import shard_state

        return shard_state(restore_checkpoint(directory, target_state, mesh.device, seed), mesh)
    device = torch.device(device)
    path = os.path.join(os.path.abspath(directory), STATE_FILE)
    loaded = torch.load(path, weights_only=True, map_location=device)
    if not isinstance(loaded, dict):
        raise ValueError(f"{path} holds no train state")
    _check({k: v for k, v in loaded.items() if k != "rng"},
           {k: v for k, v in target_state.items() if k != "rng"}, "")
    saved = loaded.get("rng")
    if saved is not None:
        if saved["device"] == device.type:
            gen = torch.Generator(device=device)
            gen.set_state(saved["state"].cpu())
        else:
            gen = derived_generator(device, seed, loaded["step"])
        loaded["rng"] = gen
    return loaded
