"""Device-mesh sharding of the apply pipeline.

Three table layouts (SURVEY.md §5.8):

* **Replicated table** — one copy per chip; the probe is a local gather and
  the only collective is metric reduction.  Right up to ~100M entries
  (~1.3 GB of bucket rows at 0.5 load factor fits device memory
  comfortably).
* **Broadcast-sharded table** (``sharded_apply_step``) — keys are
  partitioned host-side by ``mix_kmer(key) % n_shards`` into per-shard
  bucketed open-addressing tables of identical bucket count B, stacked
  (n_shards, B, 24) uint32 and laid out along the ``table`` mesh axis.
  Each shard probes the (replicated-over-table) token batch against its
  local sub-table; because exactly one shard owns any key, a
  ``jax.lax.pmax`` over the table axis merges per-position role hits
  (miss = -1 loses the max).  The segmented unanimous vote then runs on
  the merged roles.  Table memory ÷ n_shards, probe compute replicated.
* **all_to_all-routed sharded table** (``routed_apply_step``) — the token
  stream is *also* split over the table axis (with a k−1 halo per chunk so
  every kmer window is produced exactly once, §5.7).  Each device packs its
  chunk's kmers, buckets them by owner shard ``hash % n_shards``, and a
  single ``jax.lax.all_to_all`` over the ``table`` axis delivers every key
  (+ its segment id) to the shard that owns it.  The owner probes its local
  sub-table and reduces *partial votes* per protein segment; because
  unanimity voting is order-free (min/max/sum), the global vote is just
  ``psum``/``pmin``/``pmax`` of the per-segment tallies over the ``table``
  axis — no reverse all_to_all of per-token hits is ever needed.  This
  divides both table memory AND probe compute by n_shards; the wire cost is
  one 12-byte (lo, hi, seg) record per kmer over the interconnect.

Both steps are built with ``jax.shard_map`` over an explicit Mesh so the
driver can compile them on a virtual CPU mesh (tests) and on real chips
unchanged.  Multi-host initialization lives in ``parallel.distributed``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.dna_kmers import pack_dna_windows
from ..ops.hashing import mix_kmer
from ..ops.hashtable import EMPTY, build_table, probe_table, table_size_for
from ..ops.kmers import pack_kmer_windows
from ..ops.vote import DENSE_VOTE_LIMIT, split_packed_payload

_INT32_MAX = 2**31 - 1


def _pack_windows(alphabet: str):
    """Window packer for the table's alphabet ("prot" | "dna")."""
    return pack_dna_windows if alphabet == "dna" else pack_kmer_windows


def make_mesh(n_data: int, n_table: int = 1,
              devices: list | None = None) -> Mesh:
    """A (data, table) mesh over the first n_data*n_table devices."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_table
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.array(devices[:need]).reshape(n_data, n_table)
    return Mesh(grid, ("data", "table"))


# ---------------------------------------------------------------------------
# table sharding (host side)
# ---------------------------------------------------------------------------

def shard_signature_table(key_lo: np.ndarray, key_hi: np.ndarray,
                          values: np.ndarray, n_shards: int,
                          load_factor: float = 0.5):
    """Partition keys by hash and build one bucketed table per shard.

    returns (tables (n_shards, B, 24) uint32 np array, max_probes int)
    All shard tables share the bucket count of the largest shard so the
    stack is rectangular (required for a sharded device array).
    """
    h = mix_kmer(key_lo.astype(np.uint32), key_hi.astype(np.uint32), np)
    owner = (h % np.uint32(n_shards)).astype(np.int64)
    counts = np.bincount(owner, minlength=n_shards)
    n_buckets = table_size_for(int(counts.max()), load_factor)
    tables = np.zeros((n_shards,), object)
    max_probes = 1
    for s in range(n_shards):
        mask = owner == s
        tbl, probes = build_table(key_lo[mask], key_hi[mask],
                                  values[mask].astype(np.uint32),
                                  n_buckets=n_buckets)
        tables[s] = tbl
        max_probes = max(max_probes, probes)
    return np.stack(list(tables)), max_probes


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------

def _vote(roles, valid, seg_ids, min_hits, n_seqs):
    hit = valid & (roles >= 0)
    seg = jnp.where(hit, seg_ids, n_seqs)
    n_hits = jax.ops.segment_sum(
        hit.astype(jnp.int32), seg, num_segments=n_seqs + 1)[:-1]
    rmin = jax.ops.segment_min(
        jnp.where(hit, roles, _INT32_MAX), seg, num_segments=n_seqs + 1)[:-1]
    rmax = jax.ops.segment_max(
        jnp.where(hit, roles, -1), seg, num_segments=n_seqs + 1)[:-1]
    unanimous = (n_hits > 0) & (rmin == rmax)
    called = unanimous & (n_hits >= min_hits)
    return jnp.where(called, rmax, -1), jnp.where(called, n_hits, 0)


def _weighted_tally(payload, valid, seg_ids, n_seqs, n_roles, psum_axis,
                    r_blk: int = 4096):
    """Per-segment best (tally, role) from packed (weight, role) payloads.

    When ``psum_axis`` is set the dense tallies are psum-merged over that
    mesh axis BEFORE the argmax — the routed-probe partial-vote merge
    (each table shard only sees the hits of the keys it owns; weighted
    tallies, unlike unanimity, need the summed mass per (seg, role) before
    any max is taken).  Dense when (n_seqs × n_roles) fits
    DENSE_VOTE_LIMIT, role-blocked fori_loop otherwise (psum per block) —
    the sort-based path is never used.
    """
    roles, weights = split_packed_payload(payload)
    hit = valid & (roles >= 0)
    if n_seqs * n_roles <= DENSE_VOTE_LIMIT:
        idx = jnp.where(hit, seg_ids * n_roles + roles, n_seqs * n_roles)
        tallies = jax.ops.segment_sum(
            jnp.where(hit, weights, 0.0), idx,
            num_segments=n_seqs * n_roles + 1)[:-1].reshape(n_seqs, n_roles)
        if psum_axis is not None:
            tallies = jax.lax.psum(tallies, psum_axis)
        return (jnp.max(tallies, axis=-1),
                jnp.argmax(tallies, axis=-1).astype(jnp.int32))
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
        if psum_axis is not None:
            tallies = jax.lax.psum(tallies, psum_axis)
        bmax = jnp.max(tallies, axis=-1)
        barg = jnp.argmax(tallies, axis=-1).astype(jnp.int32) + base
        better = bmax > best   # ties keep the earlier (smaller) role
        return (jnp.where(better, bmax, best),
                jnp.where(better, barg, brole))

    return jax.lax.fori_loop(
        0, n_blocks, body,
        (jnp.zeros(n_seqs, jnp.float32), jnp.full(n_seqs, -1, jnp.int32)))


def _weighted_vote(payload, valid, seg_ids, min_weight, n_seqs, n_roles,
                   psum_axis=None):
    best, role = _weighted_tally(payload, valid, seg_ids, n_seqs, n_roles,
                                 psum_axis)
    called = (best >= min_weight) & (best > 0.0)
    return (jnp.where(called, role, -1),
            jnp.where(called, best, 0.0))


def replicated_apply_step(mesh: Mesh, *, k: int, max_probes: int,
                          n_seqs: int, weighted: bool = False,
                          n_roles: int = 0, alphabet: str = "prot"):
    """Jitted apply step: table replicated, token batch sharded on ``data``.

    Returned fn signature: (table (B, 24), codes (D, T), seg_ids (D, T),
    valid (D, T), min_hits) → (roles (D, n_seqs), hits (D, n_seqs)) where D
    is the data-axis size (one flat token stream per data shard).
    weighted=True: table payloads are packed (fp16 weight, role), the
    threshold arg is a float32 min_weight, and hits are float32 tallies.
    """
    pack = _pack_windows(alphabet)

    def step(table, codes, seg_ids, valid, thresh):
        lo, hi = pack(codes, k)
        val = probe_table(table, lo, hi, valid, max_probes)
        if weighted:
            return _weighted_vote(val, valid, seg_ids, thresh,
                                  n_seqs, n_roles)
        return _vote(val, valid, seg_ids, thresh, n_seqs)

    sharded = jax.shard_map(
        jax.vmap(step, in_axes=(None, 0, 0, 0, None)),
        mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P("data"), P()),
        out_specs=(P("data"), P("data")),
        check_vma=False)
    return jax.jit(sharded)


def sharded_apply_step(mesh: Mesh, *, k: int, max_probes: int, n_seqs: int,
                       weighted: bool = False, n_roles: int = 0,
                       alphabet: str = "prot"):
    """Jitted apply step with the table sharded over the ``table`` axis.

    Returned fn signature: (tables (n_shards, B, 24), codes (D, T),
    seg_ids (D, T), valid (D, T), min_hits) → (roles (D, n_seqs),
    hits (D, n_seqs)).  Probe hits merge across shards with pmax; the vote
    runs on the merged roles (replicated over the table axis).  The pmax
    merge is payload-agnostic: exactly one shard owns any key, packed
    weighted payloads are non-negative (fp16 sign bit clear), and misses
    (-1) lose the max — so the same merge serves weighted tables.
    """
    pack = _pack_windows(alphabet)

    def step(tables, codes, seg_ids, valid, thresh):
        # local shapes: tables (1, B, 24); codes/seg/valid (D/data, T)
        table = tables[0]
        def one(codes1, seg1, valid1):
            lo, hi = pack(codes1, k)
            local = probe_table(table, lo, hi, valid1, max_probes)
            merged = jax.lax.pmax(local, "table")
            if weighted:
                return _weighted_vote(merged, valid1, seg1, thresh,
                                      n_seqs, n_roles)
            return _vote(merged, valid1, seg1, thresh, n_seqs)
        return jax.vmap(one)(codes, seg_ids, valid)

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P("table"), P("data"), P("data"), P("data"), P()),
        out_specs=(P("data"), P("data")),
        check_vma=False)
    return jax.jit(sharded)


# ---------------------------------------------------------------------------
# all_to_all-routed sharded probe (§5.8 large-table mode)
# ---------------------------------------------------------------------------

def split_tokens_for_table_axis(codes: np.ndarray, seg_ids: np.ndarray,
                                valid: np.ndarray, n_table: int, k: int,
                                n_seqs: int, pad_code: int):
    """Split one flat token stream into n_table chunks with k−1 halos.

    Chunk c covers core token positions [c·Tc, (c+1)·Tc) plus a k−1 halo so
    every kmer window starting in the core is packable locally; ``valid`` is
    True only at core starts, so each window is routed exactly once.

    returns (codes (n_table, Tc+k−1) uint8, seg_ids (…) int32,
             valid (…) bool) — stackable along a leading data axis.
    """
    t = len(codes)
    tc = -(-t // n_table)
    width = tc + k - 1
    total = n_table * tc + k - 1
    pc = np.full(total, pad_code, codes.dtype)
    ps = np.full(total, n_seqs, np.int32)
    pv = np.zeros(total, bool)
    pc[:t] = codes
    ps[:t] = seg_ids
    pv[:t] = valid
    out_c = np.empty((n_table, width), codes.dtype)
    out_s = np.empty((n_table, width), np.int32)
    out_v = np.zeros((n_table, width), bool)
    for c in range(n_table):
        lo = c * tc
        out_c[c] = pc[lo: lo + width]
        out_s[c] = ps[lo: lo + width]
        out_v[c, :tc] = pv[lo: lo + tc]   # halo starts stay invalid
    return out_c, out_s, out_v


def routed_apply_step(mesh: Mesh, *, k: int, max_probes: int, n_seqs: int,
                      capacity: int | None = None, weighted: bool = False,
                      n_roles: int = 0, alphabet: str = "prot"):
    """Jitted apply step routing kmers to their owner shard via all_to_all.

    Input layout (see ``split_tokens_for_table_axis``): the token stream of
    each data row is split over the ``table`` axis too, so every device owns
    a (row, chunk) tile.  fn signature:

        (tables (n_shards, B, 24), codes (D, n_shards, Tc), seg_ids (…),
         valid (…), min_hits)
      → (roles (D, n_seqs) int32, hits (D, n_seqs) int32,
         overflow () int32 — 1 if any routing bucket overflowed
         ``capacity`` (results then undercount; re-run with a larger
         capacity).  Default capacity Tc is provably overflow-free.)

    weighted=True: each shard reduces PARTIAL dense (seg, role) weight
    tallies from its packed payloads; the global vote psum-merges tallies
    over the ``table`` axis before the argmax (``_weighted_tally``) — the
    weighted analogue of the unanimity psum/pmin/pmax merge.  The psum
    changes float32 summation order vs the single-device dense tally, so
    a near-tie (within ~1 ulp) can resolve to a different equally-tallied
    role depending on shard count (ADVICE r3); unanimity-mode results are
    exact in every topology.
    """
    n_table = mesh.shape["table"]
    pack = _pack_windows(alphabet)

    def step(tables, codes, seg_ids, valid, min_hits):
        # local: tables (1, B, 24); codes/seg/valid (Dl, 1, Tc)
        table = tables[0]
        codes, seg_ids, valid = codes[:, 0], seg_ids[:, 0], valid[:, 0]
        tc = codes.shape[1]
        cap = tc if capacity is None else capacity
        shard_ids = jnp.arange(n_table, dtype=jnp.int32)

        def pack_one(codes1, seg1, valid1):
            lo, hi = pack(codes1, k)
            h = mix_kmer(lo, hi, jnp)
            owner = jnp.where(valid1,
                              (h % jnp.uint32(n_table)).astype(jnp.int32),
                              n_table)
            # rank of each key within its owner bucket (stable, no sort)
            onehot = owner[:, None] == shard_ids[None, :]     # (Tc, n_t)
            csum = jnp.cumsum(onehot.astype(jnp.int32), axis=0)
            rank = jnp.take_along_axis(
                csum, jnp.clip(owner, 0, n_table - 1)[:, None], 1)[:, 0] - 1
            ok = (owner < n_table) & (rank < cap)
            slot = jnp.where(ok, owner * cap + rank, n_table * cap)
            blo = jnp.full(n_table * cap, EMPTY, jnp.uint32
                           ).at[slot].set(lo, mode="drop")
            bhi = jnp.full(n_table * cap, EMPTY, jnp.uint32
                           ).at[slot].set(hi, mode="drop")
            bseg = jnp.full(n_table * cap, n_seqs, jnp.int32
                            ).at[slot].set(seg1, mode="drop")
            ovf = jnp.any((owner < n_table) & (rank >= cap))
            return (blo.reshape(n_table, cap), bhi.reshape(n_table, cap),
                    bseg.reshape(n_table, cap), ovf)

        blo, bhi, bseg, ovf = jax.vmap(pack_one)(codes, seg_ids, valid)
        # one exchange: row s of each device's buffer → shard s
        rlo = jax.lax.all_to_all(blo, "table", split_axis=1, concat_axis=1)
        rhi = jax.lax.all_to_all(bhi, "table", split_axis=1, concat_axis=1)
        rseg = jax.lax.all_to_all(bseg, "table", split_axis=1, concat_axis=1)

        rvalid = rlo != EMPTY   # no packed key has the top 2 bits set
        vals = probe_table(table, rlo, rhi, rvalid, max_probes)
        d_local = vals.shape[0]
        vflat = vals.reshape(d_local, -1)
        sflat = rseg.reshape(d_local, -1)
        mflat = rvalid.reshape(d_local, -1)
        overflow = jax.lax.pmax(
            jnp.any(ovf).astype(jnp.int32), ("data", "table"))

        if weighted:
            out_roles, out_hits = jax.vmap(
                lambda v1, s1, m1: _weighted_vote(
                    v1, m1, s1, min_hits, n_seqs, n_roles,
                    psum_axis="table"))(vflat, sflat, mflat)
            return out_roles, out_hits, overflow

        hit = mflat & (vflat >= 0)
        seg = jnp.where(hit, sflat, n_seqs)

        def tally_one(h1, r1, s1):
            n_hits = jax.ops.segment_sum(
                h1.astype(jnp.int32), s1, num_segments=n_seqs + 1)[:-1]
            rmin = jax.ops.segment_min(
                jnp.where(h1, r1, _INT32_MAX), s1,
                num_segments=n_seqs + 1)[:-1]
            rmax = jax.ops.segment_max(
                jnp.where(h1, r1, -1), s1, num_segments=n_seqs + 1)[:-1]
            return n_hits, rmin, rmax

        n_hits, rmin, rmax = jax.vmap(tally_one)(hit, vflat, seg)
        # the vote is order-free (Q9): merge partial tallies collectively
        n_hits = jax.lax.psum(n_hits, "table")
        rmin = jax.lax.pmin(rmin, "table")
        rmax = jax.lax.pmax(rmax, "table")
        unanimous = (n_hits > 0) & (rmin == rmax)
        called = unanimous & (n_hits >= min_hits)
        out_roles = jnp.where(called, rmax, -1)
        out_hits = jnp.where(called, n_hits, 0)
        return out_roles, out_hits, overflow

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P("table"), P("data", "table"), P("data", "table"),
                  P("data", "table"), P()),
        out_specs=(P("data"), P("data"), P()),
        check_vma=False)
    return jax.jit(sharded)


# ---------------------------------------------------------------------------
# per-window probe steps (DNA mode: hits are clustered by POSITION on the
# host, so the mesh must return the full probed stream, not a per-segment
# vote)
# ---------------------------------------------------------------------------

def replicated_probe_step(mesh: Mesh, *, k: int, max_probes: int,
                          alphabet: str = "dna"):
    """(table (B, 24), codes (D, T), valid (D, T)) → payloads (D, T) int32.

    Table replicated, window streams sharded on ``data`` — data
    parallelism over genomes/contigs for the positional (DNA) probe.
    """
    pack = _pack_windows(alphabet)

    def step(table, codes, valid):
        lo, hi = pack(codes, k)
        return probe_table(table, lo, hi, valid, max_probes)

    sharded = jax.shard_map(
        jax.vmap(step, in_axes=(None, 0, 0)),
        mesh=mesh,
        in_specs=(P(), P("data"), P("data")),
        out_specs=P("data"),
        check_vma=False)
    return jax.jit(sharded)


def sharded_probe_step(mesh: Mesh, *, k: int, max_probes: int,
                       alphabet: str = "dna"):
    """Per-window probe with the table hash-sharded over ``table``.

    (tables (n_shards, B, 24), codes (D, T), valid (D, T)) → (D, T) int32.
    Every shard probes the full (table-replicated) stream against its
    sub-table; exactly one shard owns any key, so a pmax over the table
    axis merges per-POSITION results — positions survive the merge, which
    the routed vote deliberately discards.  Table memory ÷ n_shards.
    """
    pack = _pack_windows(alphabet)

    def step(tables, codes, valid):
        table = tables[0]

        def one(codes1, valid1):
            lo, hi = pack(codes1, k)
            local = probe_table(table, lo, hi, valid1, max_probes)
            return jax.lax.pmax(local, "table")

        return jax.vmap(one)(codes, valid)

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P("table"), P("data"), P("data")),
        out_specs=P("data"),
        check_vma=False)
    return jax.jit(sharded)
