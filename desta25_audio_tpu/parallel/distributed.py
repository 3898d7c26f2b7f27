"""Multi-host coordination.

The reference delegates multi-process setup to torchrun + NCCL env
handshakes (SURVEY §2.7); the JAX equivalent is
``jax.distributed.initialize`` (given the coordinator address, process
count and process id from ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``) and ``process_index``-gated
host work.  Dataset-cache barriers
(simple_dataset.py:23-38, :433) are unnecessary here — preprocessing is
stateless — but a barrier helper is provided for host-side rendezvous
(e.g. checkpoint directory creation).
"""

from __future__ import annotations

import logging
import os

import jax

logger = logging.getLogger(__name__)


def maybe_initialize() -> None:
    """Initialize jax.distributed when running multi-host (no-op on a
    single host / CPU).  Must be called before anything initializes the
    XLA backend, so the env checks come first — ``jax.process_count()``
    itself would initialize it."""
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    n_proc = os.environ.get("JAX_NUM_PROCESSES")
    try:
        if coord and n_proc and int(n_proc) > 1:
            jax.distributed.initialize(
                coordinator_address=coord,
                num_processes=int(n_proc),
                process_id=int(os.environ.get("JAX_PROCESS_ID", "0")))
            logger.info("jax.distributed initialized: process %d/%d",
                        jax.process_index(), jax.process_count())
    except RuntimeError as e:
        # double-init (or init after backend touch) must not kill a run
        logger.warning("jax.distributed.initialize skipped: %s", e)


def is_main_process() -> bool:
    return jax.process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Cross-host sync (device-mediated allreduce; cheap at host cadence)."""
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)
