"""Device mesh management.

The framework uses a 2-D GSPMD mesh with axes ``("data", "model")``:

- ``data``: batch data-parallelism (the reference's DDP, SURVEY §2.7) —
  XLA inserts the gradient all-reduce;
- ``model``: tensor parallelism over attention heads / FFN hidden dim for
  the frozen 8B LLM and the Whisper encoder (a first-class feature the
  reference never had; each of its GPUs held the full model).

``use_mesh`` installs the mesh in a context so model code can apply
activation sharding constraints without threading the mesh everywhere.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_state = threading.local()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None,
              n_pipe: int = 1) -> Mesh:
    """("data", "model") mesh, with an optional trailing "pipe" axis for
    pipeline parallelism (parallel/pipeline.py) when ``n_pipe > 1``.
    Devices are laid out in the order given; every card of a host reaches
    every other at the same rate, so the order carries no topology."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // (n_model * n_pipe)
    assert n_data * n_model * n_pipe == len(devices), (
        f"mesh {n_data}x{n_model}x{n_pipe} != {len(devices)} devices")
    if n_pipe > 1:
        arr = np.asarray(devices).reshape(n_data, n_model, n_pipe)
        return Mesh(arr, ("data", "model", "pipe"))
    arr = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(arr, ("data", "model"))


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        if mesh is not None:
            with mesh:
                yield mesh
        else:
            yield None
    finally:
        _state.mesh = prev


def named_sharding(*spec) -> Optional[NamedSharding]:
    mesh = current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, P(*spec))
