from .profiling import profile_trace, Timings  # noqa: F401

import os as _os

import numpy as _np

_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """Where JAX's persistent compilation cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path — the cache key includes it, so it must not move)."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache for this process and
    return its directory.  Call it before the first compilation.
    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads that directory
    itself and no other is configured.  Importing the library sets
    nothing; scripts call this."""
    import jax

    path = compile_cache_dir()
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every compile: a chip run recompiles many small programs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def auto_storage_dtype(mat):
    """Pick the compressed on-device X dtype for ``storage_dtype='auto'``.

    Raw UMI counts are small integers; storing X as int8/int16 on
    device cuts the bytes of X each sweep reads 4x/2x with EXACT math —
    the kernels upcast in registers before any arithmetic.  Returns
    ``numpy.int8``/``numpy.int16`` when every entry is an integer that
    fits, else ``None`` (normalized/float matrices and counts beyond
    int16 keep the full-precision stream).

    The integrality scan runs in bounded chunks so the atlas-scale
    matrix (2e9 elements) never allocates a full-size temporary.
    """
    if mat.size == 0:
        return None
    mx = float(mat.max())
    if mx > _np.iinfo(_np.int16).max or float(mat.min()) < 0:
        return None
    rows = max(1, (1 << 24) // max(1, int(mat.shape[-1])))
    for i0 in range(0, mat.shape[0], rows):
        blk = mat[i0:i0 + rows]
        if not _np.array_equal(blk, _np.round(blk)):
            return None
    return _np.int8 if mx <= _np.iinfo(_np.int8).max else _np.int16
