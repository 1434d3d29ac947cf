"""Bucketed open-addressing hash table on device (build + probe).

This replaces the reference's ``HashMap<String, String>`` kmer database
(ApplyKmerProcessor.java:101-110) with the structure the BASELINE north star
prescribes: keys live in **buckets of 8 slots**, stored as one flat uint32
row per bucket

    table[bucket] = [lo×8 | hi×8 | value×8]        (24 × uint32 = 96 B)

so one probe step is ONE row gather followed by 8 vectorized compares.
With a 0.5 load factor (≈4 keys/bucket expected), almost every key is
found in the first bucket and the longest walk is 2-3 buckets — versus ~46
probe rounds for classic 1-slot linear probing on the same data.

Collision policy: a key whose home bucket ``hash & (B-1)`` is full walks to
the next bucket.  The build fills buckets round by round (all keys try
their current bucket; overflow moves on), which preserves the probe
invariant: a key placed r buckets from home implies every earlier bucket on
its walk is permanently full, so lookups can stop early at the first
non-full bucket.  An empty slot has lo == 0xFFFFFFFF, which no packed kmer
can produce (every 5-bit field of a real key is ≤ 27 < 31).

* ``build_table`` is host-side vectorized NumPy (the build is offline; the
  *distributed* build path is the sort-based group-by in engine.signature).
* ``probe_table`` is the jitted hot path: a statically unrolled walk of at
  most ``max_probes`` buckets.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .hashing import mix_kmer

EMPTY = np.uint32(0xFFFFFFFF)
BUCKET = 8  # slots per bucket

_SCRATCH = __import__("threading").local()


def table_size_for(n_keys: int, load_factor: float = 0.5) -> int:
    """Power-of-two bucket count targeting the given load factor."""
    want = max(2, int(n_keys / (load_factor * BUCKET)))
    return 1 << (want - 1).bit_length()


def build_table(key_lo, key_hi, values, n_buckets: int | None = None,
                load_factor: float = 0.5):
    """Build a bucketed table from unique keys (host-side, vectorized).

    key_lo/key_hi: (N,) uint32 packed kmer keys (must be deduplicated)
    values:        (N,) uint32/int32 payloads (role indices; >= 0)
    returns (table (n_buckets, 3*BUCKET) uint32 np.ndarray,
             max_probes int — the longest bucket walk, probe loop bound)
    """
    key_lo = np.asarray(key_lo, np.uint32)
    key_hi = np.asarray(key_hi, np.uint32)
    values = np.asarray(values).astype(np.uint32)
    n = len(key_lo)
    if n_buckets is None:
        n_buckets = table_size_for(n, load_factor)
    if n > n_buckets * BUCKET:
        raise ValueError(f"{n} keys do not fit {n_buckets}x{BUCKET} slots")
    mask = np.uint32(n_buckets - 1)
    # Reuse per-thread scratch planes: fresh multi-MB allocations fault in
    # new pages on every call (hundreds of µs/page under THP defrag),
    # dwarfing the actual build work.
    cache = _SCRATCH.__dict__.setdefault("planes", {})
    planes = cache.get(n_buckets)
    if planes is None:
        planes = tuple(np.empty(n_buckets * BUCKET, np.uint32)
                       for _ in range(3))
        cache[n_buckets] = planes
    flat_lo, flat_hi, flat_val = planes
    flat_lo.fill(EMPTY)
    flat_hi.fill(EMPTY)
    flat_val.fill(0)
    walk_max = 0

    if n:
        # Greedy placement for keys sorted by home bucket equals consecutive
        # slot fill: pos[k] = max(pos[k-1] + 1, 8*home[k]), a running
        # maximum — one argsort + one maximum.accumulate instead of a
        # round-by-round walk.  The probe invariant holds: a key landing in
        # bucket B > home implies every bucket home..B-1 was already full.
        home = (mix_kmer(key_lo, key_hi, np) & mask).astype(np.int64)
        order = np.argsort(home, kind="stable")
        hb = home[order]
        ar = np.arange(n, dtype=np.int64)
        pos = ar + np.maximum.accumulate(hb * BUCKET - ar)
        ok = pos < n_buckets * BUCKET
        # pos is strictly increasing: these are sequential (sorted) writes
        flat_lo[pos[ok]] = key_lo[order[ok]]
        flat_hi[pos[ok]] = key_hi[order[ok]]
        flat_val[pos[ok]] = values[order[ok]]
        walk_max = int((pos[ok] // BUCKET - hb[ok]).max(initial=0))

        spill = np.flatnonzero(~ok)
        if len(spill):
            # Rare wraparound tail: these keys walked past the last bucket
            # (provably full through the end); continue from bucket 0.
            counts = np.bincount(pos[ok] // BUCKET, minlength=n_buckets)
            for k in spill:  # already in pos order
                bb = 0
                while counts[bb] >= BUCKET:
                    bb += 1
                    if bb >= n_buckets:
                        raise RuntimeError("bucketed table is over-full")
                i = order[k]
                p = bb * BUCKET + counts[bb]
                flat_lo[p] = key_lo[i]
                flat_hi[p] = key_hi[i]
                flat_val[p] = values[i]
                counts[bb] += 1
                walk_max = max(walk_max, n_buckets - int(hb[k]) + bb)

    table = np.concatenate([flat_lo.reshape(n_buckets, BUCKET),
                            flat_hi.reshape(n_buckets, BUCKET),
                            flat_val.reshape(n_buckets, BUCKET)], axis=1)
    return table, walk_max + 1


def build_table_device(key_lo, key_hi, values, n_buckets: int):
    """Jit-composable DEVICE build of the bucketed table.

    Same greedy sorted placement as :func:`build_table`, expressed as
    sort + associative max-scan + scatter so it runs inside a jitted
    program (the projection engine builds a fresh singleton table per
    close genome ON DEVICE — pushing raw keys costs ~3× less transfer
    than pushing a built table, and the build itself is ~ms).

    key_lo/key_hi: (N,) uint32 packed keys; padding entries use
    ``EMPTY`` (no packed kmer reaches it) and are skipped.
    values: (N,) uint32 payloads.

    returns (table (n_buckets, 3*BUCKET) uint32,
             bad bool scalar — True when a real key overflowed the walk
             bound or wrapped past the last bucket; callers must then
             fall back to the host build (load factor 0.25 makes this
             astronomically rare for hash-mixed keys))
    """
    n = key_lo.shape[0]
    mask = jnp.uint32(n_buckets - 1)
    real = key_lo != EMPTY
    home = jnp.where(
        real, (mix_kmer(key_lo, key_hi, jnp) & mask).astype(jnp.int32),
        jnp.int32(n_buckets))               # pads sort last, then drop
    order = jnp.argsort(home)
    hb = home[order]
    ar = jnp.arange(n, dtype=jnp.int32)
    pos = ar + jax.lax.associative_scan(jnp.maximum, hb * BUCKET - ar)
    ok = pos < n_buckets * BUCKET
    walk = jnp.where(ok, pos // BUCKET - hb, 0)
    bad = jnp.any(real[order] & (~ok | (walk >= MAX_DEVICE_PROBES)))
    drop = jnp.where(ok, pos, n_buckets * BUCKET)
    flat_lo = jnp.full(n_buckets * BUCKET + 1, EMPTY, jnp.uint32
                       ).at[drop].set(key_lo[order], mode="drop")[:-1]
    flat_hi = jnp.full(n_buckets * BUCKET + 1, EMPTY, jnp.uint32
                       ).at[drop].set(key_hi[order], mode="drop")[:-1]
    flat_val = jnp.zeros(n_buckets * BUCKET + 1, jnp.uint32
                         ).at[drop].set(values[order], mode="drop")[:-1]
    table = jnp.concatenate([flat_lo.reshape(n_buckets, BUCKET),
                             flat_hi.reshape(n_buckets, BUCKET),
                             flat_val.reshape(n_buckets, BUCKET)], axis=1)
    return table, bad


MAX_DEVICE_PROBES = 2   # static probe bound for device-built tables


def device_table_buckets(n_keys: int) -> int:
    """Bucket count for device builds: load factor 0.125 (mean 1
    key/bucket) makes a walk ≥ MAX_DEVICE_PROBES astronomically rare —
    every probe round is a full unrolled gather pass over the query
    batch, so fewer rounds beat a smaller table."""
    return max(2, 1 << (max(n_keys, 2) - 1).bit_length())


@partial(jax.jit, static_argnames=("max_probes",))
def probe_table(table, key_lo, key_hi, valid, max_probes: int):
    """Look up a batch of keys (the hot path).

    table:   (B, 3*BUCKET) uint32
    key_lo/key_hi: (...,) uint32 query keys
    valid:   (...,) bool — invalid queries return -1 without probing
    returns  (...,) int32 — stored value, or -1 on miss/invalid
    """
    n_buckets = table.shape[0]
    mask = jnp.uint32(n_buckets - 1)
    shape = key_lo.shape
    lo = key_lo.reshape(-1)
    hi = key_hi.reshape(-1)
    b = (mix_kmer(lo, hi, jnp) & mask).astype(jnp.int32)
    out = jnp.full(lo.shape, -1, jnp.int32)
    active = valid.reshape(-1)

    # statically unrolled bucket walk — max_probes is 1-3 in practice
    for _ in range(max_probes):
        rows = table[b]                                      # (Q, 24) gather
        tlo = rows[:, 0 * BUCKET: 1 * BUCKET]
        thi = rows[:, 1 * BUCKET: 2 * BUCKET]
        tval = rows[:, 2 * BUCKET: 3 * BUCKET]
        hitmask = (tlo == lo[:, None]) & (thi == hi[:, None])  # (Q, 8)
        anyhit = jnp.any(hitmask, axis=-1)
        # at most one slot matches (keys unique): sum selects it
        val = jnp.sum(jnp.where(hitmask, tval, 0),
                      axis=-1).astype(jnp.int32)
        out = jnp.where(active & anyhit, val, out)
        full = jnp.all(tlo != EMPTY, axis=-1)
        active = active & ~anyhit & full
        b = (b + 1) & jnp.int32(n_buckets - 1)
    return out.reshape(shape)
