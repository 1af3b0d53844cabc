"""Carry weights, configs and IVF-PQ indexes across from the JAX package.

Everything here takes plain numpy arrays and dicts -- the caller converts
JAX arrays with ``np.asarray`` -- so this module imports nothing of
``repro`` or ``jax``.  ``torch.from_numpy`` does not take the
``ml_dtypes.bfloat16`` arrays that bf16 JAX arrays become, so bf16 goes
through a ``uint16`` view of the same bits and ``.view(torch.bfloat16)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import (MoEConfig, TransformerConfig,
                                            TransformerParams)
from repro_torch.retrieval.ivf_pq import IVFPQIndex
from repro_torch.training.pytree import tree_map


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """Exact tensor copy of a numpy array, bfloat16 included, on
    ``device`` (the GPU unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    a = np.array(a, order="C")        # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy; bfloat16 comes back as float32 (exact widening)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _convert(tree: dict, device, dtype, path: tuple[str, ...] = ()) -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict) and "q" in val:
            # int8 {"q", "scale"} leaf: kept as it is
            out[key] = {k: tensor_from_numpy(v, device) for k, v in val.items()}
        elif isinstance(val, dict):
            out[key] = _convert(val, device, dtype, path + (key,))
        else:
            t = tensor_from_numpy(val, device)
            if key.startswith("ln"):
                # norm weights stay float32: rms_norm multiplies in float32
                t = t.float()
            elif dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            out[key] = t
    return out


def params_from_jax(tree_of_numpy: dict, device="cuda",
                    dtype: torch.dtype | None = None) -> TransformerParams:
    """The port's parameters from ``tr.init_params``'s nested dict (leaves
    already numpy), layers still stacked on axis 0.  ``dtype`` casts the
    floating matmul weights (embed, head, projections) once at load; the
    JAX package casts the same weights per call with ``maybe_dequant``,
    which rounds to the same numbers."""
    dev = resolve_device(device)
    return TransformerParams(_convert(tree_of_numpy, dev, dtype))


def tree_from_jax(tree_of_numpy, device="cuda"):
    """The same tree of nested dicts and lists (a recsys or GNN model's
    parameters, a train state) with every numpy leaf an exact tensor copy
    on ``device``, its dtype kept.  None of ``params_from_jax``'s
    transformer rules apply: no leaf is cast, none read as int8."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree_of_numpy)


def config_from_jax(fields: dict) -> TransformerConfig:
    """The port's ``TransformerConfig`` from ``dataclasses.asdict`` of the
    JAX one (a nested ``moe`` dict becomes a ``MoEConfig``)."""
    fields = dict(fields)
    if isinstance(fields.get("moe"), dict):
        fields["moe"] = MoEConfig(**fields["moe"])
    known = {f.name for f in dataclasses.fields(TransformerConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"fields the port's TransformerConfig lacks: "
                         f"{sorted(unknown)}")
    return TransformerConfig(**fields)


def index_from_jax(centroids, codebooks, list_ids, list_codes,
                   n_vectors: int, device="cuda") -> IVFPQIndex:
    """The port's ``IVFPQIndex`` from the arrays of a JAX-built index."""
    dev = resolve_device(device)
    return IVFPQIndex(
        centroids=tensor_from_numpy(np.asarray(centroids, np.float32), dev),
        codebooks=tensor_from_numpy(np.asarray(codebooks, np.float32), dev),
        list_ids=tensor_from_numpy(np.asarray(list_ids, np.int32), dev),
        list_codes=tensor_from_numpy(np.asarray(list_codes, np.uint8), dev),
        n_vectors=int(n_vectors))
