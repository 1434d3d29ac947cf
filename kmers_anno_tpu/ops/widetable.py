"""Wide-bucket single-gather hash table: the fast-path probe layout.

Replaces the reference's ``HashMap<String, String>`` kmer database walk
(ApplyKmerProcessor.java:101-110, 122-145) with a layout built around one
idea: probe cost is the *number of row gathers*, and a wide row costs
little more than a narrow one.

* Narrow buckets force walks: the 8-slot layout (ops.hashtable) needs
  ``max_probes`` = 2-3 row gathers per lookup.  This layout uses **24
  slots per bucket** (row = 72 uint32 = 288 B) and the build **retries
  hash salts until no bucket overflows** (mean occupancy is kept ≤ 8, so
  P(Poisson(8) > 24) ≈ 2e-7 per bucket and almost every salt works).
  Result: ``max_probes == 1`` — every lookup is exactly ONE row gather.
* Post-gather compares are retiled slot-major: the gathered (Q, 72) rows
  become (Q/128, 72, 128) so each slot compare runs over 128 contiguous
  queries.

Keys are compared in full (bit-exact text-equality semantics, no
fingerprinting).

Capacity: rows ≤ MAX_WIDE_ROWS keeps the table small enough for the
single-gather layout (up to ~3M keys, ≥ BASELINE configs 1/2, the
1M-entry headline shape); bigger tables fall back to ops.sliced_probe.
``MAX_WIDE_ROWS`` and the 128-wide retile are inherited from the chip the
engine was first built for and are unmeasured on the H100.
"""

from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .hashing import mix_kmer_salted, salt_sequence

log = logging.getLogger(__name__)

EMPTY = np.uint32(0xFFFFFFFF)   # no packed kmer key word is all-ones
SLOTS = 24                      # slots per bucket (row = 3*SLOTS words)
MAX_WIDE_ROWS = 1 << 18         # single-gather row cap (inherited)
TARGET_MU = 8.0                 # target mean keys/bucket (load 1/3)
MAX_MU = 12.0                   # absolute cap before falling back
_LANES = 128


def wide_rows_for(n_keys: int) -> int | None:
    """Power-of-two row count targeting TARGET_MU keys/bucket, or None
    when the table would leave the single-gather fast zone."""
    want = max(128, int(np.ceil(n_keys / TARGET_MU)))
    rows = 1 << (want - 1).bit_length()
    if rows > MAX_WIDE_ROWS:
        rows = MAX_WIDE_ROWS
    if n_keys / rows > MAX_MU:
        return None
    return rows


def fits_wide(n_keys: int) -> bool:
    return wide_rows_for(n_keys) is not None


def build_wide_table(key_lo, key_hi, values, n_rows: int | None = None,
                     max_salts: int = 32):
    """Build the wide-bucket table from unique keys (host, vectorized).

    key_lo/key_hi: (N,) uint32 packed kmer keys (deduplicated)
    values:        (N,) uint32/int32 payloads with bit 31 clear
    returns (table (rows, 3*SLOTS) uint32, salt int, max_probes int)

    Tries ``max_salts`` hash salts for an overflow-free placement
    (max_probes == 1).  If every salt overflows (adversarial key sets),
    falls back to the best salt with a bounded bucket walk — still
    correct, one extra gather per probe round.
    """
    key_lo = np.asarray(key_lo, np.uint32)
    key_hi = np.asarray(key_hi, np.uint32)
    values = np.asarray(values).astype(np.uint32)
    n = len(key_lo)
    if n_rows is None:
        n_rows = wide_rows_for(n)
        if n_rows is None:
            raise ValueError(
                f"{n} keys exceed the wide-table fast-zone capacity; "
                "use the sliced-probe layout instead")
    if n > n_rows * SLOTS:
        raise ValueError(f"{n} keys do not fit {n_rows}x{SLOTS} slots")
    mask = np.uint32(n_rows - 1)

    best = None  # (overflow_count, salt, home)
    for salt in salt_sequence(max_salts):
        home = (mix_kmer_salted(key_lo, key_hi, np.uint32(salt), np)
                & mask).astype(np.int64)
        over = int(np.maximum(
            np.bincount(home, minlength=n_rows) - SLOTS, 0).sum())
        if over == 0:
            best = (0, salt, home)
            break
        if best is None or over < best[0]:
            best = (over, salt, home)
    over, salt, home = best
    if over:
        log.warning("wide table: no overflow-free salt in %d tries; "
                    "%d keys walk (max_probes > 1)", max_salts, over)

    flat = np.empty((3, n_rows * SLOTS), np.uint32)
    flat[0].fill(EMPTY)
    flat[1].fill(EMPTY)
    flat[2].fill(0)
    max_probes = 1
    if n:
        # greedy placement on home-sorted keys: pos = running max of
        # (rank, home*SLOTS) — overflow walks to the next bucket.
        order = np.argsort(home, kind="stable")
        hb = home[order]
        ar = np.arange(n, dtype=np.int64)
        pos = ar + np.maximum.accumulate(hb * SLOTS - ar)
        ok = pos < n_rows * SLOTS
        flat[0][pos[ok]] = key_lo[order[ok]]
        flat[1][pos[ok]] = key_hi[order[ok]]
        flat[2][pos[ok]] = values[order[ok]]
        max_probes = int((pos[ok] // SLOTS - hb[ok]).max(initial=0)) + 1
        spill = np.flatnonzero(~ok)
        if len(spill):  # wrapped past the last bucket: continue from 0
            counts = np.bincount(pos[ok] // SLOTS, minlength=n_rows)
            for s in spill:
                bb = 0
                while counts[bb] >= SLOTS:
                    bb += 1
                    if bb >= n_rows:
                        raise RuntimeError("wide table is over-full")
                i = order[s]
                p = bb * SLOTS + counts[bb]
                flat[0][p] = key_lo[i]
                flat[1][p] = key_hi[i]
                flat[2][p] = values[i]
                counts[bb] += 1
                max_probes = max(max_probes, n_rows - int(hb[s]) + bb + 1)

    table = np.concatenate([flat[0].reshape(n_rows, SLOTS),
                            flat[1].reshape(n_rows, SLOTS),
                            flat[2].reshape(n_rows, SLOTS)], axis=1)
    return table, salt, max_probes


def build_wide_table_device(key_lo, key_hi, values, n_rows: int,
                            salt: int = 0):
    """Jit-composable DEVICE build of the wide-bucket table (one salt).

    Same greedy sorted placement as build_wide_table, as sort +
    associative max-scan + scatter.  Tries only the given salt and
    requires an overflow-free placement (max_probes == 1): ``bad`` is
    True when any real key would walk, and callers then fall back to
    the salt-retrying host build.  Padding entries use EMPTY keys.

    The projection engine builds one such table per close genome from
    its singleton kmers: at TARGET_MU ≈ 8 the rows stay inside the
    fast-gather zone (≤ MAX_WIDE_ROWS), so every stream-window lookup
    is ONE row gather — the 8-slot device build at load 1/8 puts ~1M
    keys into 2^20 buckets (100 MB), deep in the slow-gather zone, and
    measures ~5× slower end to end.
    """
    n = key_lo.shape[0]
    mask = jnp.uint32(n_rows - 1)
    real = key_lo != EMPTY
    home = jnp.where(
        real,
        (mix_kmer_salted(key_lo, key_hi, jnp.uint32(salt), jnp)
         & mask).astype(jnp.int32),
        jnp.int32(n_rows))
    order = jnp.argsort(home)
    hb = home[order]
    ar = jnp.arange(n, dtype=jnp.int32)
    pos = ar + jax.lax.associative_scan(jnp.maximum, hb * SLOTS - ar)
    ok = pos < n_rows * SLOTS
    walk = jnp.where(ok, pos // SLOTS - hb, 1)
    bad = jnp.any(real[order] & (~ok | (walk >= 1)))
    drop = jnp.where(ok & (walk < 1), pos, n_rows * SLOTS)
    cap = n_rows * SLOTS + 1
    flat_lo = jnp.full(cap, EMPTY, jnp.uint32
                       ).at[drop].set(key_lo[order], mode="drop")[:-1]
    flat_hi = jnp.full(cap, EMPTY, jnp.uint32
                       ).at[drop].set(key_hi[order], mode="drop")[:-1]
    flat_val = jnp.zeros(cap, jnp.uint32
                         ).at[drop].set(values[order], mode="drop")[:-1]
    table = jnp.concatenate([flat_lo.reshape(n_rows, SLOTS),
                             flat_hi.reshape(n_rows, SLOTS),
                             flat_val.reshape(n_rows, SLOTS)], axis=1)
    return table, bad


@partial(jax.jit, static_argnames=("max_probes",))
def probe_wide(table, key_lo, key_hi, valid, salt, max_probes: int = 1):
    """Single-gather lookup of a key batch (the hot path).

    table:  (rows, 3*SLOTS) uint32 wide-bucket table
    key_lo/key_hi: (...,) uint32 query keys
    valid:  (...,) bool — invalid queries return -1
    salt:   uint32 scalar — the salt build_wide_table chose
    returns (...,) int32 — stored payload, or -1 on miss/invalid

    One row gather per probe round (max_probes is 1 for overflow-free
    builds), compares retiled slot-major over 128-query tiles.
    """
    n_rows = table.shape[0]
    shape = key_lo.shape
    lo = key_lo.reshape(-1)
    hi = key_hi.reshape(-1)
    q = lo.shape[0]
    qpad = -q % _LANES
    v = valid.reshape(-1)
    if qpad:
        lo = jnp.concatenate([lo, jnp.zeros(qpad, jnp.uint32)])
        hi = jnp.concatenate([hi, jnp.zeros(qpad, jnp.uint32)])
        v = jnp.concatenate([v, jnp.zeros(qpad, bool)])
    qb = (q + qpad) // _LANES
    b = (mix_kmer_salted(lo, hi, salt.astype(jnp.uint32), jnp)
         & jnp.uint32(n_rows - 1)).astype(jnp.int32)
    # invalid queries (padding windows, ~8% of an apply batch) would
    # otherwise gather RANDOM rows; pinning them to row 0 keeps those
    # gathers cache-hot (results are masked below either way)
    b = jnp.where(v, b, 0)
    lo_t = lo.reshape(qb, 1, _LANES)
    hi_t = hi.reshape(qb, 1, _LANES)
    val = jnp.full((qb, _LANES), -1, jnp.int32)
    for _ in range(max_probes):
        rows = table[b]                               # (Q, 72) ONE gather
        rt = jnp.swapaxes(rows.reshape(qb, _LANES, 3 * SLOTS), 1, 2)
        tlo = rt[:, 0 * SLOTS: 1 * SLOTS, :]          # (qb, 24, 128)
        thi = rt[:, 1 * SLOTS: 2 * SLOTS, :]
        tv = rt[:, 2 * SLOTS: 3 * SLOTS, :].astype(jnp.int32)
        hit = (tlo == lo_t) & (thi == hi_t)
        anyhit = jnp.any(hit, axis=1)
        # keys are unique: at most one slot matches; sum selects it
        hv = jnp.sum(jnp.where(hit, tv, 0), axis=1)
        val = jnp.where((val < 0) & anyhit, hv, val)
        if max_probes > 1:
            b = (b + 1) & jnp.int32(n_rows - 1)
    out = val.reshape(-1)[:q]
    return jnp.where(valid.reshape(-1), out, -1).reshape(shape)
