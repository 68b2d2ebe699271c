"""Shared host-side worker pool, sized by --nproc/-j.

The reference sizes one CTPL thread pool from its -j flag and runs
every CPU stage on it (reference: src/CONSENT-correction.cpp:77); this
is the equivalent for the stages that stay on the host here (k-mer
counting, DBG polish, stitch apply).  Threads — not processes — because
the hot host paths are native calls and numpy kernels that release the
GIL.

One process-wide pool is kept per worker count so the engine and the
stitcher share workers instead of re-spawning per batch.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

_POOLS: dict = {}


def host_pool(n_workers: Optional[int],
              kind: str = "work") -> Optional[ThreadPoolExecutor]:
    """The shared pool for `n_workers` threads (None = os.cpu_count());
    returns None when a pool would not help (n_workers <= 1).

    `kind` keys separate pools: a task running ON one pool must not
    fan out onto the SAME pool (all workers could be occupied by
    outer tasks waiting on their own inner map — deadlock), so nested
    stages use a different kind (e.g. the engine's per-job chains run
    on "chain" while their inner window fan-outs run on "work")."""
    n = n_workers if n_workers and n_workers > 0 else (os.cpu_count() or 1)
    if n <= 1:
        return None
    pool = _POOLS.get((n, kind))
    if pool is None:
        pool = ThreadPoolExecutor(max_workers=n)
        _POOLS[(n, kind)] = pool
    return pool
