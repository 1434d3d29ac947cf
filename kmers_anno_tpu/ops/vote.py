"""Segmented vote role calling (device): unanimous and weighted.

``unanimous_vote`` replicates the ``apply`` voting loop
(ApplyKmerProcessor.java:122-147, SURVEY.md §2c Q9) as an order-free
reduction.  The Java loop walks kmers sequentially and aborts at the first
conflicting hit; the outcome only depends on order-free facts:

* a peg is *bad* iff two hits disagree anywhere  ⇔  min(hit roles) != max
* the called role is the unanimous role
* the hit count (when unanimous) is the total number of hits

so the whole batch reduces with two masked min/max reductions and a sum —
no scan, no data-dependent control flow.

``weighted_vote_flat`` is the north-star extension (BASELINE config 2:
"weighted voting enabled"): every table entry carries a weight, a
sequence's tally per role is the sum of its hit weights, and the
best-tally role is called when the tally clears a threshold.  Tallies are
computed with one device sort over (segment, role) pairs + segmented sums
— scalable to any role count, unlike a dense (seq × role) matrix.
Deterministic tie-break: equal tallies call the smaller role index.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_INT32_MAX = 2**31 - 1  # plain int: no device work at import time


@jax.jit
def unanimous_vote(roles: jnp.ndarray, valid: jnp.ndarray,
                   min_hits: jnp.ndarray):
    """Vote per sequence.

    roles: (B, L) int32 — probed role index per kmer position, -1 = miss
    valid: (B, L) bool — kmer validity mask
    min_hits: int32 scalar — minimum hit count to call a role

    returns (called_role (B,) int32 (-1 = not called), hits (B,) int32)
    where hits is the unanimous hit count (0 when ambiguous/uncalled).
    """
    hit = valid & (roles >= 0)
    n_hits = jnp.sum(hit, axis=-1).astype(jnp.int32)
    rmin = jnp.min(jnp.where(hit, roles, _INT32_MAX), axis=-1)
    rmax = jnp.max(jnp.where(hit, roles, -1), axis=-1)
    unanimous = (n_hits > 0) & (rmin == rmax)
    called = unanimous & (n_hits >= min_hits)
    role = jnp.where(called, rmax, -1)
    count = jnp.where(unanimous, n_hits, 0)
    return role, count


def split_packed_payload(val: jnp.ndarray):
    """Split packed (weight, role) table payloads.

    val: (...,) int32 probe results — -1 = miss, else
         (fp16_bits(weight) << 16) | role_idx  (role_idx < 65536,
         weight >= 0 so the sign bit is clear and val stays positive)
    returns (role (...,) int32 with -1 preserved, weight (...,) float32)
    """
    miss = val < 0
    role = jnp.where(miss, -1, val & 0xFFFF)
    bits = (val.astype(jnp.uint32) >> jnp.uint32(16)).astype(jnp.uint16)
    weight = jax.lax.bitcast_convert_type(bits, jnp.float16)
    weight = jnp.where(miss, 0.0, weight.astype(jnp.float32))
    return role.astype(jnp.int32), weight


@partial(jax.jit, static_argnames=("n_seqs",))
def weighted_vote_flat(roles: jnp.ndarray, weights: jnp.ndarray,
                       seg_ids: jnp.ndarray, valid: jnp.ndarray,
                       min_weight: jnp.ndarray, *, n_seqs: int):
    """Weighted best-role vote over a flat token stream (sort-based).

    NOTE: kept as the shape-oblivious reference implementation for tests;
    the engines route to weighted_vote_dense / weighted_vote_chunked
    (large 1-D device sorts are slow, and this path accumulates tallies
    in sorted-run order while the dense paths accumulate in scatter
    order, so near-tie float tallies can disagree across paths — ADVICE
    r2.  Using one family of paths in production removes that
    shape-dependence).

    roles:    (T,) int32 role per kmer window, -1 = miss
    weights:  (T,) float32 weight per hit (ignored where miss/invalid)
    seg_ids:  (T,) int32 sequence index per window (padding → n_seqs)
    valid:    (T,) bool kmer-window validity
    min_weight: float32 scalar — minimum winning tally to call

    returns (role (n_seqs,) int32 — called role or -1,
             tally (n_seqs,) float32 — winning tally, 0 when uncalled)
    """
    t = roles.shape[0]
    hit = valid & (roles >= 0)
    seg = jnp.where(hit, seg_ids, n_seqs).astype(jnp.int32)
    rol = jnp.where(hit, roles, _INT32_MAX)
    w = jnp.where(hit, weights, 0.0)
    # one sort groups equal (seg, role) pairs into runs
    sseg, srol, sw = jax.lax.sort((seg, rol, w), num_keys=2)
    first = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (sseg[1:] != sseg[:-1]) | (srol[1:] != srol[:-1])])
    run = jnp.cumsum(first.astype(jnp.int32)) - 1
    tally = jax.ops.segment_sum(sw, run, num_segments=t)
    # per-run row: (segment, role, tally) at each run's first position
    run_seg = jnp.where(first & (sseg < n_seqs), sseg, n_seqs)
    run_tally = jnp.where(first, tally[run], 0.0)
    best = jax.ops.segment_max(run_tally, run_seg,
                               num_segments=n_seqs + 1)[:-1]
    # among winning runs of a segment, call the smallest role index
    is_best = first & (run_tally >= best[jnp.minimum(run_seg, n_seqs - 1)]) \
        & (run_seg < n_seqs)
    cand = jnp.where(is_best, srol, _INT32_MAX)
    role = jax.ops.segment_min(cand, run_seg, num_segments=n_seqs + 1)[:-1]
    called = (best >= min_weight) & (role != _INT32_MAX) & (best > 0.0)
    return (jnp.where(called, role, -1).astype(jnp.int32),
            jnp.where(called, best, 0.0))


@partial(jax.jit, static_argnames=("n_seqs", "n_roles"))
def weighted_vote_dense(roles: jnp.ndarray, weights: jnp.ndarray,
                        seg_ids: jnp.ndarray, valid: jnp.ndarray,
                        min_weight: jnp.ndarray, *, n_seqs: int,
                        n_roles: int):
    """Dense-tally weighted vote: scatter-add hit weights into an
    (n_seqs, n_roles) matrix and argmax each row.  Preferred when
    n_seqs × n_roles fits comfortably in memory (the role file is
    typically 10²-10³ roles) — one scatter + one row reduction, no sort;
    jnp.argmax's first-max rule gives the same smaller-role-index
    tie-break as weighted_vote_flat.
    """
    hit = valid & (roles >= 0)
    idx = jnp.where(hit, seg_ids * n_roles + roles, n_seqs * n_roles)
    tallies = jax.ops.segment_sum(
        jnp.where(hit, weights, 0.0), idx,
        num_segments=n_seqs * n_roles + 1)[:-1].reshape(n_seqs, n_roles)
    best = jnp.max(tallies, axis=-1)
    role = jnp.argmax(tallies, axis=-1).astype(jnp.int32)
    called = (best >= min_weight) & (best > 0.0)
    return (jnp.where(called, role, -1),
            jnp.where(called, best, 0.0))


@jax.jit
def weighted_vote_rows(roles: jnp.ndarray, weights: jnp.ndarray,
                       valid: jnp.ndarray, min_weight: jnp.ndarray):
    """Weighted best-role vote on a 2-D row layout (the r4 fast path).

    roles:   (B, L) int32 probed role per kmer window, -1 = miss
    weights: (B, L) float32 hit weights
    valid:   (B, L) bool window validity
    min_weight: float32 scalar — minimum winning tally to call

    Row-local algorithm, no scatter anywhere: sort each row by role (a
    vectorized per-row sort), turn equal-role runs into tallies with a
    row cumsum, and take the best run per row.  Equal tallies call the
    smallest role index (runs are role-ascending and argmax takes the
    first maximum), matching the other weighted paths.  Accumulation
    order within a row is fixed (sorted-run cumsum), so results don't
    depend on batch shape.

    returns (role (B,) int32 — called role or -1,
             tally (B,) float32 — winning tally, 0 when uncalled)
    """
    nrows = roles.shape[0]
    hit = valid & (roles >= 0)
    r = jnp.where(hit, roles, _INT32_MAX)
    w = jnp.where(hit, weights, 0.0)
    rs, ws = jax.lax.sort((r, w), dimension=-1, num_keys=1)
    cw = jnp.cumsum(ws, axis=-1)
    first = jnp.concatenate(
        [jnp.ones((nrows, 1), jnp.bool_), rs[:, 1:] != rs[:, :-1]], axis=-1)
    last = jnp.concatenate(
        [rs[:, 1:] != rs[:, :-1], jnp.ones((nrows, 1), jnp.bool_)], axis=-1)
    # cumsum just before each run start, forward-filled through the run
    # (cw is nondecreasing, so cummax propagates the run's base correctly)
    base = jax.lax.cummax(jnp.where(first, cw - ws, -1.0), axis=1)
    tally = cw - base
    cand = jnp.where(last & (rs != _INT32_MAX), tally, -1.0)
    best = jnp.max(cand, axis=-1)
    arg = jnp.argmax(cand, axis=-1)
    role = jnp.take_along_axis(rs, arg[:, None], axis=-1)[:, 0]
    called = (best >= min_weight) & (best > 0.0)
    return (jnp.where(called, role, -1).astype(jnp.int32),
            jnp.where(called, best, 0.0))


# dense tally matrices beyond this many elements use the chunked path
DENSE_VOTE_LIMIT = 1 << 25


@partial(jax.jit, static_argnames=("n_seqs", "n_roles", "r_blk"))
def weighted_vote_chunked(roles: jnp.ndarray, weights: jnp.ndarray,
                          seg_ids: jnp.ndarray, valid: jnp.ndarray,
                          min_weight: jnp.ndarray, *, n_seqs: int,
                          n_roles: int, r_blk: int):
    """Dense weighted vote in role blocks, for huge role spaces.

    When n_seqs × n_roles exceeds DENSE_VOTE_LIMIT a single dense tally
    matrix would not fit, and a sort-based vote costs a full sort per
    batch.  This path sweeps the role
    space in blocks of ``r_blk`` roles, computing a dense tally per block
    and keeping a running (best tally, best role).  Ties: a strictly
    greater tally is required to displace the incumbent, and jnp.argmax
    takes the first maximum within a block, so equal tallies resolve to
    the smallest role index — the same rule as the other vote paths.
    """
    hit = valid & (roles >= 0)
    n_blocks = -(-n_roles // r_blk)

    def body(i, carry):
        best, brole = carry
        base = i * r_blk
        in_blk = hit & (roles >= base) & (roles < base + r_blk)
        idx = jnp.where(in_blk, seg_ids * r_blk + (roles - base),
                        n_seqs * r_blk)
        tallies = jax.ops.segment_sum(
            jnp.where(in_blk, weights, 0.0), idx,
            num_segments=n_seqs * r_blk + 1)[:-1].reshape(n_seqs, r_blk)
        bmax = jnp.max(tallies, axis=-1)
        barg = jnp.argmax(tallies, axis=-1).astype(jnp.int32) + base
        better = bmax > best
        return (jnp.where(better, bmax, best),
                jnp.where(better, barg, brole))

    best, role = jax.lax.fori_loop(
        0, n_blocks, body,
        (jnp.zeros(n_seqs, jnp.float32), jnp.full(n_seqs, -1, jnp.int32)))
    called = (best >= min_weight) & (best > 0.0)
    return (jnp.where(called, role, -1),
            jnp.where(called, best, 0.0))


def pick_weighted_vote(n_seqs: int, n_roles: int):
    """Route a weighted vote by shape: dense when the tally matrix fits,
    chunked role blocks otherwise.  Never the sort-based path (r2: it can
    hang the backend for minutes at large shapes)."""
    if n_roles <= 0:
        raise ValueError("weighted vote requires a known role count")
    if n_seqs * n_roles <= DENSE_VOTE_LIMIT:
        return partial(weighted_vote_dense, n_seqs=n_seqs, n_roles=n_roles)
    r_blk = max(1, DENSE_VOTE_LIMIT // n_seqs)
    return partial(weighted_vote_chunked, n_seqs=n_seqs, n_roles=n_roles,
                   r_blk=r_blk)
