"""Randomized truncated SVD on device (an irlba equivalent).

The reference initializes VB-NMF from a truncated SVD via irlba on the
host (R/bayesian.R:150-159); at atlas scale (10^5-10^6 cells) a host
Lanczos on a densified matrix is the bottleneck SURVEY §7.3 flags.
This module implements the Halko-Martinsson-Tropp randomized
range-finder entirely in JAX: the only operations touching X are tall
GEMMs X @ Omega and X^T @ Q — matrix-unit work that GSPMD shards over the cell
axis when X is mesh-sharded, and that run as O(nnz * k) COO scans for
ops.sparse.SparseCounts input (no densification anywhere).

Algorithm (with q power iterations, re-orthogonalized each half-step):
    Y = X @ Omega;  Q = qr(Y)
    repeat q times:  Q = qr(X^T @ Q);  Q = qr(X @ Q)
    B = Q^T @ X  (k+p x m);  svd(B) -> (u_b, s, vt);  U = Q @ u_b
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .sparse import SparseCounts


def _resolve_chunk(sc: SparseCounts, chunk: int) -> int:
    import math

    return math.gcd(int(sc.row.shape[-1]), int(chunk))


def coo_matmul(sc: SparseCounts, b, chunk: int = 1 << 16):
    """X @ b for COO X (n x m) and dense b (m, k) — O(nnz * k)."""
    return _coo_matmul(sc, b, chunk=_resolve_chunk(sc, chunk))


@functools.partial(jax.jit, static_argnames=("chunk",))
def _coo_matmul(sc: SparseCounts, b, chunk: int):
    k = b.shape[1]
    b_x = jnp.concatenate([b, jnp.zeros((1, k), b.dtype)])
    nchunks = sc.row.shape[0] // chunk
    rows = sc.row.reshape(nchunks, chunk)
    cols = sc.col.reshape(nchunks, chunk)
    vals = sc.val.reshape(nchunks, chunk)

    def body(y, inp):
        rr, cc, vv = inp
        return y.at[rr].add(vv[:, None] * b_x[cc]), None

    y0 = jnp.zeros((sc.n + 1, k), b.dtype)
    y, _ = lax.scan(body, y0, (rows, cols, vals))
    return y[: sc.n]


def coo_rmatmul(sc: SparseCounts, a, chunk: int = 1 << 16):
    """X^T @ a for COO X (n x m) and dense a (n, k) — O(nnz * k)."""
    return _coo_rmatmul(sc, a, chunk=_resolve_chunk(sc, chunk))


@functools.partial(jax.jit, static_argnames=("chunk",))
def _coo_rmatmul(sc: SparseCounts, a, chunk: int):
    k = a.shape[1]
    a_x = jnp.concatenate([a, jnp.zeros((1, k), a.dtype)])
    nchunks = sc.row.shape[0] // chunk
    rows = sc.row.reshape(nchunks, chunk)
    cols = sc.col.reshape(nchunks, chunk)
    vals = sc.val.reshape(nchunks, chunk)

    def body(z, inp):
        rr, cc, vv = inp
        return z.at[cc].add(vv[:, None] * a_x[rr]), None

    z0 = jnp.zeros((sc.m + 1, k), a.dtype)
    z, _ = lax.scan(body, z0, (rows, cols, vals))
    return z[: sc.m]


def randomized_svd(x, rank: int, oversample: int = 10, n_iter: int = 4,
                   seed: int = 0, dtype=None):
    """Top-``rank`` SVD triplet (u, s, vt) of X by randomized range
    finding — X may be a dense jax/NumPy array (optionally
    mesh-sharded; XLA inserts the collectives) or a
    ops.sparse.SparseCounts (COO scans, no densification).
    """
    if isinstance(x, SparseCounts):
        n, m = x.n, x.m
        if dtype is None:
            dtype = x.val.dtype
        mv = lambda b: coo_matmul(x, b)        # noqa: E731
        rmv = lambda a: coo_rmatmul(x, a)      # noqa: E731
    else:
        x = jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)
        if dtype is None:
            dtype = x.dtype
        n, m = x.shape
        mv = lambda b: x @ b                   # noqa: E731
        rmv = lambda a: x.T @ a                # noqa: E731

    k = min(rank + oversample, min(n, m))
    key = jax.random.PRNGKey(seed)
    omega = jax.random.normal(key, (m, k), dtype)

    q, _ = jnp.linalg.qr(mv(omega))
    for _ in range(n_iter):
        z, _ = jnp.linalg.qr(rmv(q))
        q, _ = jnp.linalg.qr(mv(z))
    b = rmv(q).T                               # (k, m)
    ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[:, :rank], s[:rank], vt[:rank]
