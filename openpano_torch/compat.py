"""State carried over from the JAX package, without importing it.

The system has no weights: what makes the two packages compute the same
thing is the configuration, the PRNG key and the input arrays.  The inputs
pass as numpy arrays; these two helpers carry the other two.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Config
from .utils import prng


def config_from_fields(d: dict) -> Config:
    """The port's Config from ``dataclasses.asdict`` of a JAX ``Config``
    (the field sets are equal; an unknown field raises)."""
    names = {f.name for f in dataclasses.fields(Config)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"fields unknown to openpano_torch.Config: {sorted(unknown)}")
    return Config(**d)


def key_from_numpy(k, device=None) -> torch.Tensor:
    """The port's threefry key from ``np.asarray(jax.random.PRNGKey(s))``,
    a uint32 pair."""
    k = np.asarray(k, dtype=np.uint32).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {k.shape}")
    return prng.key((int(k[0]), int(k[1])), device)
