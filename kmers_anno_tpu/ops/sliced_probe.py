"""Bucket-sorted sliced probe for tables far larger than the cache.

``ops.hashtable.probe_table`` expresses the bucket walk as one XLA row
gather: every query pays a random device-memory access once the table
outgrows the on-chip cache.  This path turns random access into
sequential streaming plus random access within a cache-size slice: sort
queries by home bucket, then scan the table in slices; each slice is one
sequential read and each query gathers its bucket row from the *slice*.
Its cost is two N-element device sorts (one to group queries by bucket,
one to restore their order — the second is skipped in payload mode).
The crossover against the plain gather (``SLICED_THRESHOLD_BYTES``) and
the slice size were tuned on the chip this engine was first built for
and are unmeasured on the H100.

The probe walk (up to ``max_probes`` consecutive buckets, wrapping mod B)
is folded into the row width instead of extra gathers: ``windowed_table``
materializes row b as the concatenation of buckets b..b+P-1 (mod B), so
one gather resolves the whole walk and a slice is self-contained.

Skew safety: queries are assigned to slices by hash, so slice populations
concentrate tightly around n/G; the per-slice query window is padded to
``qwin`` ≈ 1.25× the mean.  If an adversarial/duplicate-heavy batch
overflows a window, the kernel detects it and falls back to the plain
full-table gather walk *inside* jit (lax.cond) — always correct, slow
only on inputs no real proteome produces.

Reference analogue: the HashMap walk in ApplyKmerProcessor.java:122-145.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .hashing import mix_kmer
from .hashtable import BUCKET

ROW = 3 * BUCKET          # uint32 words per bucket row
MAX_SLICE_ROWS = 1 << 16  # 65536 rows/slice: 12.6 MB at max_probes 2
# Tables larger than this take the sliced path.  Both constants are
# inherited from the engine's first chip and unmeasured on the H100 (its
# L2 is 50 MB).  Tables small enough for the wide-bucket layout
# (ops.widetable, ≤ ~3M keys) never get here.
SLICED_THRESHOLD_BYTES = 48 << 20


def windowed_table(table: np.ndarray, max_probes: int) -> np.ndarray:
    """(B, 24) bucket table → (B, 24·P) probe-window table where row b
    holds buckets b..b+P-1 (mod B): one row gather covers the whole walk."""
    table = np.asarray(table)
    if max_probes <= 1:
        return np.ascontiguousarray(table)
    return np.ascontiguousarray(np.concatenate(
        [np.roll(table, -i, axis=0) for i in range(max_probes)], axis=1))


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _compare_window(rows, ql, qh, max_probes: int):
    """Vectorized early-stop compare over a gathered (Q, 24·P) window.
    Payloads are viewed as int32 (bit-identical: packed payloads keep bit
    31 clear)."""
    val = jnp.full(rows.shape[:-1], -1, jnp.int32)
    for i in range(max_probes):
        tlo = rows[..., i * ROW + 0 * BUCKET: i * ROW + 1 * BUCKET]
        thi = rows[..., i * ROW + 1 * BUCKET: i * ROW + 2 * BUCKET]
        tv = rows[..., i * ROW + 2 * BUCKET: i * ROW + 3 * BUCKET].astype(
            jnp.int32)
        hit = (tlo == ql[..., None]) & (thi == qh[..., None])
        hv = jnp.sum(jnp.where(hit, tv, 0), axis=-1)
        val = jnp.where((val < 0) & jnp.any(hit, axis=-1), hv, val)
    return val


@partial(jax.jit, static_argnames=("max_probes",))
def probe_windowed(wtable, key_lo, key_hi, valid, max_probes: int):
    """Plain gather walk on a windowed table (one gather per query).
    Used directly for mid-size tables and as the sliced path's overflow
    fallback; bit-identical to ops.hashtable.probe_table."""
    nb = wtable.shape[0]
    mask = jnp.uint32(nb - 1)
    shape = key_lo.shape
    lo = key_lo.reshape(-1)
    hi = key_hi.reshape(-1)
    b = (mix_kmer(lo, hi, jnp) & mask).astype(jnp.int32)
    val = _compare_window(wtable[b], lo, hi, max_probes)
    return jnp.where(valid.reshape(-1), val, -1).reshape(shape)


@partial(jax.jit, static_argnames=("max_probes",))
def probe_table_sliced(wtable, key_lo, key_hi, valid, max_probes: int,
                       payload=None):
    """Sort-and-stream probe of a windowed table (the big-table hot path).

    wtable: (B, 24·max_probes) uint32 from ``windowed_table`` (device-
            resident; B a power of two)
    key_lo/key_hi: (N,) uint32 query keys
    valid:  (N,) bool — invalid queries return -1
    payload: optional (N,) int32 rider (e.g. segment ids).  When given,
            the restore sort is SKIPPED and the return is
            (values, payload) in bucket-sorted order — the right mode
            for order-free consumers (segment votes), saving one of the
            two big sorts that bound this path.
    returns (N,) int32 — stored payload, or -1 on miss/invalid — or the
            (values, payload) pair in sorted order when payload is given
    """
    n = key_lo.shape[0]
    nb = wtable.shape[0]
    roww = wtable.shape[1]
    s_rows = min(nb, MAX_SLICE_ROWS)
    n_slices = nb // s_rows
    # hash-uniform slice populations concentrate at n/G with std ~sqrt:
    # 1.25× the mean is a huge margin, and every padded row is a wasted
    # gather (the dominant cost), so keep the window tight
    qwin = -(-max(1024, (5 * n) // (4 * n_slices)) // 1024) * 1024
    mask = jnp.uint32(nb - 1)
    b = (mix_kmer(key_lo, key_hi, jnp) & mask).astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32)
    if payload is None:
        b_s, lo_s, hi_s, pos_s = jax.lax.sort(
            (b, key_lo, key_hi, pos), num_keys=1)
    else:
        vmask = jnp.where(valid, jnp.int32(0), jnp.int32(-1))
        b_s, lo_s, hi_s, vmask_s, pay_s, pos_s = jax.lax.sort(
            (b, key_lo, key_hi, vmask, payload, pos), num_keys=1)
    # pad reads to n+qwin: dynamic_slice CLAMPS a start near the end,
    # which would shift the read window against the write position
    b_p = jnp.concatenate([b_s, jnp.full(qwin, nb, jnp.int32)])
    lo_p = jnp.concatenate([lo_s, jnp.zeros(qwin, jnp.uint32)])
    hi_p = jnp.concatenate([hi_s, jnp.zeros(qwin, jnp.uint32)])
    bounds = jnp.arange(n_slices + 1, dtype=jnp.int32) * s_rows
    starts = jnp.searchsorted(b_s, bounds).astype(jnp.int32)
    overflow = jnp.any(starts[1:] - starts[:-1] > qwin)

    def fast(_):
        def step(g, out):
            start = starts[g]
            lb = jax.lax.dynamic_slice(b_p, (start,), (qwin,)) - g * s_rows
            ql = jax.lax.dynamic_slice(lo_p, (start,), (qwin,))
            qh = jax.lax.dynamic_slice(hi_p, (start,), (qwin,))
            sl = jax.lax.dynamic_slice(wtable, (g * s_rows, 0),
                                       (s_rows, roww))
            rows = sl[jnp.clip(lb, 0, s_rows - 1)]
            val = _compare_window(rows, ql, qh, max_probes)
            # windows overlap forward only: garbage tail beyond this
            # slice's real count is rewritten by later (higher-g) steps
            return jax.lax.dynamic_update_slice(out, val, (start,))

        out_pad = jax.lax.fori_loop(
            0, n_slices, step, jnp.full(n + qwin, -1, jnp.int32))
        if payload is not None:
            return out_pad[:n]                 # stays in sorted order
        # restore original query order
        _, out = jax.lax.sort((pos_s, out_pad[:n]), num_keys=1)
        return out

    def slow(_):
        # qwin overflow (pathological duplicate skew): full gather walk
        vals = _compare_window(wtable[b], key_lo, key_hi, max_probes)
        if payload is not None:
            # permute into the same sorted order as the fast path
            return vals[pos_s]
        return vals

    out = jax.lax.cond(overflow, slow, fast, None)
    if payload is not None:
        return jnp.where(vmask_s == 0, out, -1), pay_s
    return jnp.where(valid, out, -1)


def pick_probe(table_bytes: int):
    """True when a table of this size should use the sliced probe."""
    return table_bytes > SLICED_THRESHOLD_BYTES
