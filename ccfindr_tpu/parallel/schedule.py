"""Multi-host work scheduling for rank sweeps and restarts.

TPU-native replacement for the reference's Rmpi load-balanced restart
farm (Rmpi::mpi.applyLB, R/bayesian.R:262-263): the (rank, run) grid is
statically partitioned across JAX processes (hosts); each host runs its
share as one batched vmapped factorization on its local devices, and
per-item scalar results (log evidences) are exchanged with a global
all-gather so every host performs the identical best-of-runs selection.

Static balanced partitioning replaces dynamic load balancing: all items
of one rank cost the same sweeps/sec, and the batched while_loop
already load-balances within a host (instances that converge early
ride along masked).
"""

from __future__ import annotations

import numpy as np


def partition_items(n_items: int, n_procs: int, proc_id: int
                    ) -> np.ndarray:
    """Indices of the work items owned by ``proc_id``.

    Round-robin so that (rank, run) items of the same rank spread
    across hosts (ranks differ in cost; round-robin balances them).
    """
    return np.arange(proc_id, n_items, n_procs)


def rank_run_grid(ranks, nrun: int) -> list[tuple[int, int]]:
    """The flattened (rank, run) work grid, rank-major."""
    return [(r, i) for r in ranks for i in range(nrun)]


def gather_results(local_values: np.ndarray, local_idx: np.ndarray,
                   n_items: int, fill=-np.inf, process_count=None):
    """All-gather scalar per-item results across processes.

    Single-process: scatter local values into the global slots.
    Multi-process: uses jax.experimental.multihost_utils.  Every item
    is owned by exactly one process (partition_items), so elementwise
    max over the gathered (procs, n_items) table reconstructs the full
    vector; ``fill`` must therefore be below any real value.
    """
    import jax

    if process_count is None:
        process_count = jax.process_count()
    out = np.full(n_items, fill, dtype=np.float64)
    out[np.asarray(local_idx, dtype=np.int64)] = local_values
    if process_count == 1:
        return out
    gathered = _allgather(out)             # (procs, n_items)
    return np.max(gathered, axis=0)


def gather_rows(local_rows, local_idx, n_items: int, row_len: int,
                process_count=None):
    """All-gather per-item integer VECTOR results (e.g. the per-restart
    hard cluster assignments the ML consensus needs — m int32 each).

    Each item is owned by exactly one process (partition_items);
    non-owners contribute all-zero rows, so summing the gathered
    (procs, n_items, row_len) table reconstructs the full matrix.
    """
    import jax

    if process_count is None:
        process_count = jax.process_count()
    out = np.zeros((n_items, row_len), np.int32)
    if len(local_idx):
        out[np.asarray(local_idx, dtype=np.int64)] = local_rows
    if process_count == 1:
        return out
    gathered = _allgather(out)             # (procs, n_items, row_len)
    return gathered.sum(axis=0, dtype=np.int32)


def _allgather(arr: np.ndarray) -> np.ndarray:
    """process_allgather seam (monkeypatchable in single-process
    tests)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(
        np.asarray(arr)))


def exchange_winner(tree_or_zeros, is_owner: bool, owner: int,
                    process_count=None):
    """Replicate the winning (best-ELBO) factors to every host.

    Each host passes SAME-SHAPED arrays (its candidate if ``is_owner``
    else zeros); a process_allgather + owner-row selection makes the
    result identical everywhere — the TPU-native analog of
    Rmpi gathering worker results to the driver
    (reference R/bayesian.R:262-268).
    """
    import jax

    if process_count is None:
        process_count = jax.process_count()
    if process_count == 1:
        return tree_or_zeros
    import jax.numpy  # noqa: F401

    return jax.tree.map(lambda a: _allgather(a)[owner], tree_or_zeros)
