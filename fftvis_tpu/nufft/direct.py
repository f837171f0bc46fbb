"""Exact (direct-DFT) nonuniform transforms.

Two roles, mirroring the reference's test strategy of cross-validating
against an independent simulator (ref /root/reference/tests/
test_cpu_simulate.py:137-144, which uses matvis as oracle):

  1. Oracle implementations (NumPy float64) used by the in-repo direct
     simulation engine and the NUFFT unit tests.
  2. Fast exact small-problem paths on device: for small (n_src x n_targets)
     the direct sum is a single dense complex matmul, which beats
     spread+FFT+interp below a crossover planned by the engine's cost model.
"""

from __future__ import annotations

import numpy as np


def direct_type3_np(x: np.ndarray, c: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Exact f[.,k] = sum_j c[.,j] exp(+i s_k . x_j). NumPy, float64.

    x: (d, n), c: (..., n), s: (d, m) -> (..., m)
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    s = np.atleast_2d(np.asarray(s, dtype=np.float64))
    phase = np.einsum("dj,dk->jk", x, s)  # (n, m)
    return np.asarray(c) @ np.exp(1j * phase)


def direct_type1_np(x: np.ndarray, c: np.ndarray, modes: np.ndarray) -> np.ndarray:
    """Exact type-1 gathered at integer modes. NumPy, float64.

    x: (d, n) radians, c: (..., n), modes: (d, m) ints -> (..., m)
    """
    return direct_type3_np(x, c, np.asarray(modes, dtype=np.float64))


def direct_type2_np(x: np.ndarray, f: np.ndarray, modes: np.ndarray) -> np.ndarray:
    """Exact type-2: c[., j] = sum_k f[., k] exp(+i modes_k . x_j).

    x: (d, n) radians, f: (..., m), modes: (d, m) ints -> (..., n).
    The transpose of :func:`direct_type1_np` (same +i sign convention).
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    modes = np.atleast_2d(np.asarray(modes, dtype=np.float64))
    phase = np.einsum("dk,dj->kj", modes, x)  # (m, n)
    return np.asarray(f) @ np.exp(1j * phase)


def direct_type3_jax(x, c, s, source_block: int = 8192):
    """Exact type-3 on device as blocked dense complex matmuls.

    x: (d, n) device, c: (C, n) device, s: (d, m) host or device.
    Blocks over sources to bound the (block, m) phase matrix; each block is
    one dense matmul. Exact to working precision (no eps error).
    """
    import jax
    import jax.numpy as jnp

    x = jnp.atleast_2d(x)
    s = jnp.atleast_2d(jnp.asarray(s, dtype=x.dtype))
    d, n = x.shape
    m = s.shape[1]
    C = c.shape[0]
    cdtype = c.dtype

    nblk = max(1, -(-n // source_block))
    pad = nblk * source_block - n
    xp = jnp.pad(x, ((0, 0), (0, pad)))
    cp = jnp.pad(c, ((0, 0), (0, pad)))
    xb = xp.reshape(d, nblk, source_block).transpose(1, 0, 2)  # (nblk, d, B)
    cb = cp.reshape(C, nblk, source_block).transpose(1, 0, 2)  # (nblk, C, B)

    def body(acc, blk):
        xk, ck = blk
        phase = jnp.einsum("db,dm->bm", xk, s)  # (B, m)
        e = jnp.exp(1j * phase).astype(cdtype)
        return acc + ck @ e, None

    init = jnp.zeros((C, m), dtype=cdtype)
    out, _ = jax.lax.scan(body, init, (xb, cb))
    return out
