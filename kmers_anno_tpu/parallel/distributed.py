"""Multi-host mesh initialization (jax.distributed).

The reference is single-JVM (SURVEY.md §2d: no MPI/NCCL/sockets); this
engine scales across processes with JAX's distributed runtime: every
process runs the SAME program, ``jax.distributed.initialize`` wires them
into one system, and the (data, table) mesh then spans the devices of all
processes, with XLA collectives (NCCL on GPUs) between them.  One process
driving all local cards needs none of this.

Configuration follows the standard JAX environment contract so launchers
(mpirun, Slurm, Kubernetes) work unchanged:

* ``KAN_COORDINATOR`` / ``JAX_COORDINATOR_ADDRESS`` — "host:port" of
  process 0.  Unset ⇒ single-host mode, no-op.
* ``KAN_NUM_PROCESSES`` / ``JAX_NUM_PROCESSES`` — world size.
* ``KAN_PROCESS_ID`` / ``JAX_PROCESS_ID`` — this process's rank.

Set all three explicitly: a plain GPU host offers JAX no cluster to
auto-detect.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

_initialized = False


def distributed_env(environ=None) -> dict | None:
    """Read the coordinator config from the environment.

    returns None for single-host mode, else a kwargs dict for
    ``jax.distributed.initialize`` (missing values left to auto-detect).
    """
    env = os.environ if environ is None else environ

    def pick(*names):
        for n in names:
            v = env.get(n)
            if v:
                return v
        return None

    coord = pick("KAN_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
    if coord is None:
        return None
    kwargs: dict = {"coordinator_address": coord}
    n = pick("KAN_NUM_PROCESSES", "JAX_NUM_PROCESSES")
    if n is not None:
        kwargs["num_processes"] = int(n)
    pid = pick("KAN_PROCESS_ID", "JAX_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    return kwargs


def maybe_init_distributed(environ=None) -> bool:
    """Initialize jax.distributed when a coordinator is configured.

    Idempotent; returns True iff running multi-host after the call.  Must
    run before any other JAX API touches the backend.
    """
    global _initialized
    if _initialized:
        return True
    kwargs = distributed_env(environ)
    if kwargs is None:
        return False
    import jax

    log.info("Initializing jax.distributed: %s", kwargs)
    jax.distributed.initialize(**kwargs)
    _initialized = True
    log.info("Distributed runtime up: process %d/%d, %d local / %d global "
             "devices.", jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())
    return True


def is_primary() -> bool:
    """True on the process that should write reports (rank 0).  The
    reference writes ONE report from its single JVM; in a multi-process
    mesh every process computes identical (allgathered) results and only
    the primary emits them."""
    import jax

    return jax.process_index() == 0
