"""Carry a model and state across from the JAX package.

``from_jax_model`` / ``from_jax_data`` take the JAX package's ``Model`` /
``Data`` as duck-typed objects whose leaves ``np.asarray`` can read (its
``Layout`` exposes ``_arrays``) and return the port's containers, without
importing jax.  The parity tests use them to feed both packages the same
compiled model and state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import (Model, Option, Data, Contact,
                                                Layout, NameTable)
from mujoco_sim_tpu_torch.utils.struct import leaf_names

_NAME_FIELDS = ("body", "joint", "geom", "site", "mesh", "sensor", "eq",
                "actuator", "tendon", "key")


def _host(cls, src):
    """Port container of class cls from src's same-named fields: leaves as
    numpy arrays, static fields as they are."""
    leaves = set(leaf_names(cls))
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name)
        if f.name in leaves and v is not None:
            v = np.asarray(v)
        kw[f.name] = v
    return cls(**kw)


def from_jax_model(m) -> Model:
    """Port Model (numpy leaves, as models/compile.py returns) from a JAX
    package Model; pass it through engine.put_model before stepping."""
    out = _host(Model, m).replace(opt=_host(Option, m.opt))
    layout = Layout(**{k: np.asarray(v) for k, v in m.layout._arrays.items()})
    names = NameTable(**{k: getattr(m.names, k) for k in _NAME_FIELDS})
    return out.replace(layout=layout, names=names)


def from_jax_data(d, device="cpu") -> Data:
    """Port Data from a JAX package Data whose leaves already carry the
    leading env axis (e.g. a vmapped or broadcast batch)."""
    def conv(cls, src):
        return cls(**{n: torch.as_tensor(np.array(getattr(src, n)),
                                         device=device)
                      for n in leaf_names(cls) if n != "contact"},
                   **({"contact": conv(Contact, src.contact)}
                      if cls is Data else {}))
    return conv(Data, d)
