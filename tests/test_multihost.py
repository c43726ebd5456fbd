"""REAL multi-process verification of the multi-host path.

Spawns 2 subprocess JAX CPU processes that join one
``jax.distributed`` runtime (localhost Gloo coordinator) and run the
same ``vb_factorize`` — the (rank, run) grid partitions across the
processes, log evidences cross the process boundary through
``multihost_utils.process_allgather``, and the winning factors
replicate.  Both hosts must return results bit-identical to each
other AND to a single-process run (reference Rmpi analog,
R/bayesian.R:260-263).  No monkeypatching — this exercises the actual
collective ordering across processes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import ccfindr_tpu as cf
from ccfindr_tpu.parallel._mh_worker import build_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_workers(tmp_path, nproc, port, **kw):
    """Launch nproc workers; return their .npz output paths."""
    env = dict(os.environ)
    # workers configure their own platform/flags; drop the parent's
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs, outs = [], []
    args = []
    for k, v in kw.items():
        args += [f"--{k}", str(v)]
    for pid in range(nproc):
        out = str(tmp_path / f"host{pid}.npz")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ccfindr_tpu.parallel._mh_worker",
             "--pid", str(pid), "--nproc", str(nproc),
             "--port", str(port), "--out", out, "--x64"] + args,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for pr in procs:
        try:
            stdout, _ = pr.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for pid, (pr, log) in enumerate(zip(procs, logs)):
        assert pr.returncode == 0, f"worker {pid} failed:\n{log}"
    return outs


def test_two_process_distributed_matches_single_host(tmp_path):
    ranks, nrun, itmax, seed = [2, 3, 4], 3, 300, 5

    # single-host oracle (in-process; conftest x64 matches --x64)
    s = build_problem(cf)
    ref = cf.vb_factorize(s, ranks=ranks, nrun=nrun, verbose=0,
                          Itmax=itmax, seed=seed)

    outs = _spawn_workers(
        tmp_path, nproc=2, port=_free_port(),
        ranks=",".join(map(str, ranks)), nrun=nrun, itmax=itmax,
        seed=seed)

    for path in outs:
        got = np.load(path)
        assert [int(r) for r in got["ranks"]] == ref.ranks
        np.testing.assert_array_equal(got["lml"],
                                      ref.measure["lml"].to_numpy())
        for k, r in enumerate(ref.ranks):
            np.testing.assert_array_equal(got[f"basis_{r}"],
                                          ref.basis[k])
            np.testing.assert_array_equal(got[f"coeff_{r}"],
                                          ref.coeff[k])
    # and both hosts agree bit-for-bit with each other
    a, b = np.load(outs[0]), np.load(outs[1])
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])


def test_three_process_idle_host(tmp_path):
    """More processes than work items: the idle host must JOIN the
    collective exchange instead of raising/deadlocking (the owning
    hosts block in the all-gather otherwise).  VB with 2 (rank, run)
    items across 3 processes — every host, including the
    idle one, returns the single-host result bit-for-bit."""
    ranks, nrun, itmax, seed = [2, 3], 1, 150, 5

    s = build_problem(cf)
    ref = cf.vb_factorize(s, ranks=ranks, nrun=nrun, verbose=0,
                          Itmax=itmax, seed=seed)

    outs = _spawn_workers(
        tmp_path, nproc=3, port=_free_port(),
        ranks=",".join(map(str, ranks)), nrun=nrun, itmax=itmax,
        seed=seed)

    for path in outs:
        got = np.load(path)
        np.testing.assert_array_equal(got["lml"],
                                      ref.measure["lml"].to_numpy())
        for k, r in enumerate(ref.ranks):
            np.testing.assert_array_equal(got[f"basis_{r}"],
                                          ref.basis[k])


def test_three_process_ml_idle_host(tmp_path):
    """ML twin of the idle-host case: 2 restarts across 3 processes
    (restart-granular partition) — the idle host joins the
    cid/likelihood gathers and returns the single-host table."""
    ranks, nrun, itmax, seed = [2], 2, 100, 5

    s = build_problem(cf)
    ref = cf.factorize(s, ranks=ranks, nrun=nrun, verbose=0,
                       Itmax=itmax, seed=seed)

    outs = _spawn_workers(
        tmp_path, nproc=3, port=_free_port(), mode="ml",
        ranks=",".join(map(str, ranks)), nrun=nrun, itmax=itmax,
        seed=seed)

    for path in outs:
        got = np.load(path)
        np.testing.assert_array_equal(
            got["lml"], ref.measure["likelihood"].to_numpy())
        np.testing.assert_array_equal(
            got["dispersion"], ref.measure["dispersion"].to_numpy())
        np.testing.assert_array_equal(got["basis_2"], ref.basis[0])


def test_two_process_ml_restart_split_matches_single_host(tmp_path):
    """Restart-granular ML multi-host: ONE rank
    with nrun=8 splits 4/4 across 2 real processes — the per-restart
    hard assignments all-gather, both hosts accumulate the identical
    consensus, and the measure table + winning factors reproduce the
    single-host run bit-for-bit (per-restart keys derive from the
    grid position, not the process)."""
    ranks, nrun, itmax, seed = [3], 8, 120, 7

    s = build_problem(cf)
    ref = cf.factorize(s, ranks=ranks, nrun=nrun, verbose=0,
                       Itmax=itmax, seed=seed)

    outs = _spawn_workers(
        tmp_path, nproc=2, port=_free_port(), mode="ml",
        ranks=",".join(map(str, ranks)), nrun=nrun, itmax=itmax,
        seed=seed)

    for path in outs:
        got = np.load(path)
        np.testing.assert_array_equal(
            got["lml"], ref.measure["likelihood"].to_numpy())
        np.testing.assert_array_equal(
            got["dispersion"], ref.measure["dispersion"].to_numpy())
        np.testing.assert_array_equal(
            got["cophenetic"], ref.measure["cophenetic"].to_numpy())
        np.testing.assert_array_equal(got["basis_3"], ref.basis[0])
        np.testing.assert_array_equal(got["coeff_3"], ref.coeff[0])


def test_two_process_ml_factorize_matches_single_host(tmp_path):
    """ML path multi-host: the (sample, rank)
    item grid partitions across 2 real processes; both hosts return
    measures and factors bit-identical to the single-process run."""
    ranks, nrun, itmax, seed = [2, 3, 4], 3, 120, 5

    s = build_problem(cf)
    ref = cf.factorize(s, ranks=ranks, nrun=nrun, verbose=0,
                       Itmax=itmax, seed=seed)

    outs = _spawn_workers(
        tmp_path, nproc=2, port=_free_port(), mode="ml",
        ranks=",".join(map(str, ranks)), nrun=nrun, itmax=itmax,
        seed=seed)

    for path in outs:
        got = np.load(path)
        assert [int(r) for r in got["ranks"]] == ref.ranks
        np.testing.assert_array_equal(
            got["lml"], ref.measure["likelihood"].to_numpy())
        np.testing.assert_array_equal(
            got["dispersion"], ref.measure["dispersion"].to_numpy())
        np.testing.assert_array_equal(
            got["cophenetic"], ref.measure["cophenetic"].to_numpy())
        for k, r in enumerate(ref.ranks):
            np.testing.assert_array_equal(got[f"basis_{r}"],
                                          ref.basis[k])
            np.testing.assert_array_equal(got[f"coeff_{r}"],
                                          ref.coeff[k])
