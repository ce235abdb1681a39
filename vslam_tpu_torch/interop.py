"""Carry the JAX package's state into the port and back.

The JAX package keeps its state in NamedTuple pytrees (``LandmarkState``,
``KeyframeState``, ``Features``, ``BAProblem``, ``StreamState``); the port
keeps dataclasses of tensors with the same field names, shapes, dtypes and
fill values. The exchange format is a mapping of field name -> numpy
array (or anything ``np.asarray`` takes, so a pytree's ``_asdict()`` works
as it is), which keeps this module free of any JAX import:

    lm = interop.from_arrays(LandmarkState, jax_lm._asdict(), device)
    arrays = interop.to_arrays(lm)   # field name -> numpy array

Fields of the source that the target does not have (the reference's PRNG
key, its tune vector, place-recognition buffers) are ignored; a nested
dataclass field (``StreamState.kf``) is converted recursively.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from . import resolve_device


def _as_mapping(x):
    if hasattr(x, "_asdict"):
        return x._asdict()
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return x


def from_arrays(cls, arrays, device="cuda"):
    """Build the port's dataclass ``cls`` from a mapping of field name ->
    array, on ``device`` (the card unless the caller names another; raises
    if there is none). Missing optional fields keep their defaults."""
    device = resolve_device(device)
    arrays = _as_mapping(arrays)
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in arrays or arrays[f.name] is None:
            continue
        value, hint = arrays[f.name], hints[f.name]
        if dataclasses.is_dataclass(hint):
            kwargs[f.name] = from_arrays(hint, value, device)
        elif hint is int:
            kwargs[f.name] = int(np.asarray(value))
        else:
            kwargs[f.name] = torch.as_tensor(np.array(value), device=device)
    return cls(**kwargs)


def to_arrays(obj) -> dict:
    """The port's dataclass -> mapping of field name -> numpy array (nested
    dataclasses become nested mappings)."""
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            out[f.name] = to_arrays(value)
        elif torch.is_tensor(value):
            out[f.name] = value.detach().cpu().numpy()
        else:
            out[f.name] = value
    return out
