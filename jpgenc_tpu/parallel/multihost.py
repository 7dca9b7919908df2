"""Multi-host control plane (SURVEY.md section 3 "Distributed communication
backend"): jax.distributed coordination + host-side byte-blob assembly.

On a pod slice each host process runs the same SPMD program; device-side
traffic rides ICI/DCN via XLA collectives (the psum'd histograms and sharded
encode in parallel.mesh), while the final entropy-segment byte blobs — which
live on hosts, not devices — are exchanged with
`multihost_utils.process_allgather`. On a single-process setup every function
degenerates to a no-op/identity, so the same code path is exercised by CI.
"""
from __future__ import annotations

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the jax.distributed coordination service (gRPC).

    MUST run before any other jax API touches a backend (jax.devices(),
    jax.process_count(), any computation) — jax.distributed.initialize raises
    once the backends exist, and probing process_count() is itself such a
    touch. Re-entry is guarded via the distributed client state instead.

    With explicit arguments this connects to (or hosts) the given coordinator.
    With no arguments it attempts cluster auto-detection (cluster managers /
    standard env vars); when auto-detection finds no cluster, the process
    stays single-process and this returns quietly.
    """
    import jax
    if jax.distributed.is_initialized():
        return  # coordination service already up
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (RuntimeError, ValueError):
        if coordinator_address is not None or num_processes is not None:
            raise  # explicit configuration must not fail silently
        # argless auto-detection found no cluster: single-process run


def process_count() -> int:
    import jax
    return jax.process_count()


def gather_bytes(local: bytes) -> list[bytes]:
    """All-gather one byte blob per process (DCN, host side).

    Used to assemble striped single-image scans whose stripes live on
    different hosts: each process contributes its stripes' stuffed segment
    bytes; every process receives all blobs in process order. Single-process
    runs return [local].
    """
    import jax
    if jax.process_count() == 1:
        return [local]
    from jax.experimental import multihost_utils

    # fixed-shape exchange: length-prefix + pad to the global max
    n = np.int64(len(local))
    lens = multihost_utils.process_allgather(n)
    cap = int(np.max(lens))
    buf = np.zeros(cap, np.uint8)
    buf[:len(local)] = np.frombuffer(local, np.uint8)
    blobs = multihost_utils.process_allgather(buf)
    return [blobs[i, :int(lens[i])].tobytes() for i in range(len(lens))]


def owned_indices(n_items: int) -> range:
    """Contiguous shard of item indices owned by this process (batch driver:
    each host encodes and writes its own shard; the manifest keyed by index
    keeps relaunches idempotent)."""
    import jax
    p, np_ = jax.process_index(), jax.process_count()
    per = -(-n_items // np_)
    return range(p * per, min((p + 1) * per, n_items))
