"""Signature-table annotation engine (the ``apply`` hot path).

Replicates ApplyKmerProcessor.java:113-155 with the device dataflow of
the BASELINE north star.  Two device layouts:

**Row layout (default, r4).**  Proteins are length-sorted and encoded into
2-D (rows, width) code matrices; the device step is

    pack kmer windows → ONE row gather per window against the wide-bucket
    table (ops.widetable, max_probes == 1) → per-row vote reductions

Everything is dense row-wise work with zero scatters, where the
flat-stream step spends its time in scatter-based ``jax.ops.segment_*``
votes and multi-round narrow-bucket gathers.  Length sorting bounds
padding waste (make_row_batches), and row/width buckets
bound recompiles.

**Flat-stream layout (big tables).**  Tables past the wide-table capacity
(~3M keys) keep the r3 path: one flat token stream with segment ids,
probed through the sort-and-stream sliced probe (ops.sliced_probe), with
segmented votes.

The Java inner loop walks kmers sequentially and aborts on the first
conflicting role hit; the outcome is order-free (SURVEY.md §2c Q9), so
both layouts reduce with min/max/sum — no data-dependent control flow.
"""

from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..genome.gto import Genome, Feature
from ..ops.encode import PROT_PAD, encode_protein
from ..ops.hashtable import probe_table
from ..ops.kmers import pack_kmer_windows
from ..ops.sliced_probe import probe_table_sliced
from ..ops.vote import (pick_weighted_vote, split_packed_payload,
                        unanimous_vote, weighted_vote_rows)
from ..ops.widetable import probe_wide
from .protein_kmers import apply_drop_last
from .signature import SignatureTable

log = logging.getLogger(__name__)

_INT32_MAX = 2**31 - 1


def _bucket(n: int, minimum: int) -> int:
    """Round up to the next power of two (≥ minimum) to bound recompiles."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


@partial(jax.jit, static_argnames=("k", "max_probes", "n_seqs", "sliced"))
def apply_flat(table, codes, seg_ids, valid, min_hits, *,
               k: int, max_probes: int, n_seqs: int, sliced: bool = False):
    """The fused apply step over a flat token stream.

    table:    (B, 24) uint32 bucketed signature table — or, when
              ``sliced`` is True, the (B, 24·max_probes) probe-window
              layout served by the sort-and-stream big-table probe
              (ops.sliced_probe)
    codes:    (T,) uint8 concatenated protein codes (PROT_PAD padding)
    seg_ids:  (T,) int32 protein index per token (padding → n_seqs)
    valid:    (T,) bool — kmer window starting here stays inside one protein
    min_hits: int32 scalar — minimum unanimous hits to call a role

    returns (role (n_seqs,) int32 — called role index or -1,
             hits (n_seqs,) int32 — unanimous hit count, 0 if uncalled)
    """
    lo, hi = pack_kmer_windows(codes, k)
    if sliced:
        # payload mode: seg ids ride the bucket sort and the segment
        # votes run on the permuted stream — order-free reductions make
        # the restore sort (one of the two big sorts bounding the
        # sliced probe) unnecessary
        roles, seg_p = probe_table_sliced(table, lo, hi, valid,
                                          max_probes, payload=seg_ids)
        hit = roles >= 0
        seg = jnp.where(hit, seg_p, n_seqs)
    else:
        roles = probe_table(table, lo, hi, valid, max_probes)
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


@partial(jax.jit, static_argnames=("k", "max_probes", "n_seqs", "n_roles",
                                   "sliced"))
def apply_weighted_flat(table, codes, seg_ids, valid, min_weight, *,
                        k: int, max_probes: int, n_seqs: int,
                        n_roles: int, sliced: bool = False):
    """Weighted-vote apply step (north-star config 2): same pack + probe
    as apply_flat, but payloads carry packed (weight, role) and the vote
    is a best-tally reduction instead of unanimity.

    The vote is always a dense tally — one (n_seqs, n_roles) matrix when
    it fits DENSE_VOTE_LIMIT, a fori_loop over role blocks otherwise
    (ops.vote.pick_weighted_vote); no input shape reaches the slow
    sort-based path."""
    lo, hi = pack_kmer_windows(codes, k)
    if sliced:
        val, seg_p = probe_table_sliced(table, lo, hi, valid,
                                        max_probes, payload=seg_ids)
        valid_p = val >= 0
        roles, weights = split_packed_payload(val)
        vote = pick_weighted_vote(n_seqs, n_roles)
        return vote(roles, weights, seg_p, valid_p, min_weight)
    val = probe_table(table, lo, hi, valid, max_probes)
    roles, weights = split_packed_payload(val)
    vote = pick_weighted_vote(n_seqs, n_roles)
    return vote(roles, weights, seg_ids, valid, min_weight)


class FlatBatch:
    """A flat token-stream batch of protein sequences (host side)."""

    __slots__ = ("codes", "seg_ids", "valid", "n_seqs")

    def __init__(self, proteins: list[str], k: int,
                 min_tokens: int = 16384, min_seqs: int = 256):
        n = len(proteins)
        total = sum(map(len, proteins))
        width = _bucket(total, min_tokens)
        self.n_seqs = _bucket(n, min_seqs)
        got = native.flat_batch(proteins, k, width, self.n_seqs)
        if got is not None:  # C++ data loader (kan_host.cpp)
            self.codes, self.seg_ids, self.valid = got
            self.valid = apply_drop_last(self.valid)
            return
        codes = np.full(width, PROT_PAD, np.uint8)
        seg_ids = np.full(width, self.n_seqs, np.int32)
        valid = np.zeros(width, bool)
        pos = 0
        for i, prot in enumerate(proteins):
            ln = len(prot)
            codes[pos: pos + ln] = encode_protein(prot)
            seg_ids[pos: pos + ln] = i
            if ln >= k:
                valid[pos: pos + ln - k + 1] = True
            pos += ln
        self.codes = codes
        self.seg_ids = seg_ids
        self.valid = apply_drop_last(valid)


# ---------------------------------------------------------------------------
# row layout (the r4 fast path)
# ---------------------------------------------------------------------------

# coarse width buckets (≤ ~14% padding between steps); widths are multiples
# of 32 so flattened (rows × width) stays lane-aligned with rows % 8 == 0
_W_BUCKETS = [64, 96, 128, 160, 192, 224, 256, 320, 384, 448, 512, 640,
              768, 896, 1024, 1280, 1536, 1792, 2048, 2560, 3072, 3584,
              4096, 5120, 6144, 7168, 8192, 10240, 12288, 14336, 16384]
_MAX_ROW_TOKENS = 1 << 22      # per-device-call token budget
_MIN_SPLIT_ROWS = 64           # don't split batches smaller than this


def _bucket_width(n: int) -> int:
    for w in _W_BUCKETS:
        if n <= w:
            return w
    return -(-n // 2048) * 2048


@partial(jax.jit, static_argnames=("k", "max_probes"))
def apply_rows(table, salt, codes, valid, min_hits, *,
               k: int, max_probes: int):
    """Row-layout unanimity apply step: ONE gather per kmer window.

    table/salt: wide-bucket table (ops.widetable.build_wide_table)
    codes: (rows, width) uint8 protein codes, PROT_PAD padding
    valid: (rows, width) bool kmer-window validity
    returns (role (rows,) int32 — called role or -1, hits (rows,) int32)
    """
    lo, hi = pack_kmer_windows(codes, k)
    roles = probe_wide(table, lo, hi, valid, salt, max_probes=max_probes)
    return unanimous_vote(roles, valid, min_hits)


@partial(jax.jit, static_argnames=("k", "max_probes"))
def apply_rows_weighted(table, salt, codes, valid, min_weight, *,
                        k: int, max_probes: int):
    """Row-layout weighted apply step: packed (weight, role) payloads and
    the row-sort best-tally vote (ops.vote.weighted_vote_rows)."""
    lo, hi = pack_kmer_windows(codes, k)
    val = probe_wide(table, lo, hi, valid, salt, max_probes=max_probes)
    roles, weights = split_packed_payload(val)
    return weighted_vote_rows(roles, weights, valid, min_weight)


class RowBatch:
    """A (rows, width) padded batch of protein sequences (host side).

    ``idx`` maps local row → caller protein index (batches are built from
    length-sorted slices, so results must be scattered back)."""

    __slots__ = ("codes", "valid", "idx", "n")

    def __init__(self, proteins: list[str], k: int, idx: np.ndarray):
        self.idx = idx
        self.n = len(proteins)
        width = _bucket_width(max(map(len, proteins)))
        rows = -(-self.n // 8) * 8
        got = native.row_batch(proteins, k, rows, width)
        if got is not None:            # C++ data loader (kan_host.cpp)
            self.codes, self.valid = got
            self.valid = apply_drop_last(self.valid)
            return
        codes = np.full((rows, width), PROT_PAD, np.uint8)
        valid = np.zeros((rows, width), bool)
        for i, prot in enumerate(proteins):
            ln = len(prot)
            codes[i, :ln] = encode_protein(prot)
            if ln >= k:
                valid[i, : ln - k + 1] = True
        self.codes = codes
        self.valid = apply_drop_last(valid)


def make_row_batches(proteins: list[str], k: int) -> list[RowBatch]:
    """Split a protein list into length-homogeneous RowBatches.

    Sorts by length, then greedily cuts a new batch when the padded token
    count would exceed the per-call budget or padding waste would pass
    ~30% — so probe work (∝ padded tokens) stays within a few percent of
    the true token count while the number of device calls stays small.
    """
    lens = np.fromiter(map(len, proteins), np.int64, len(proteins))
    order = np.argsort(lens, kind="stable")
    batches: list[RowBatch] = []
    i, n = 0, len(proteins)
    while i < n:
        j, real = i, 0
        while j < n:
            width = _bucket_width(int(lens[order[j]]))
            rows = j - i + 1
            if rows * width > _MAX_ROW_TOKENS and rows > 1:
                break
            if (rows > _MIN_SPLIT_ROWS
                    and real + lens[order[j]] < 0.7 * rows * width):
                break
            real += int(lens[order[j]])
            j += 1
        sel = order[i:j]
        batches.append(RowBatch([proteins[s] for s in sel], k, sel))
        i = j
    return batches


class KmerApplyEngine:
    """Annotates genomes against a packed signature table.

    weighted=False (default) is the reference-exact unanimity vote
    (ApplyKmerProcessor.java:122-147); weighted=True enables the
    north-star weighted best-tally vote, calling a role when its summed
    hit weights reach ``min_weight`` (default: min_hits).

    Tables within the wide-table capacity use the row layout; larger
    tables use the flat-stream + sliced-probe layout (module docstring).
    """

    def __init__(self, signatures: SignatureTable, min_hits: int = 5,
                 weighted: bool = False, min_weight: float | None = None):
        self.signatures = signatures
        self.k = signatures.k
        self.min_hits = min_hits
        self.weighted = weighted
        self.min_weight = float(min_hits if min_weight is None
                                else min_weight)
        self.role_ids = signatures.role_ids
        wide = signatures.device_wide_table(packed_weights=weighted)
        if wide is not None:
            self.mode = "wide"
            self.table, self.salt, self.max_probes = wide
        else:
            self.mode = "flat"
            self.table, self.max_probes, self.sliced = (
                signatures.device_probe_table(packed_weights=weighted))

    # ----- device steps -----

    def _flat_step(self, batch: FlatBatch):
        args = (self.table, jnp.asarray(batch.codes),
                jnp.asarray(batch.seg_ids), jnp.asarray(batch.valid))
        kw = dict(k=self.k, max_probes=self.max_probes, n_seqs=batch.n_seqs,
                  sliced=self.sliced)
        if self.weighted:
            return apply_weighted_flat(
                *args, jnp.float32(self.min_weight),
                n_roles=len(self.role_ids), **kw)
        return apply_flat(*args, jnp.int32(self.min_hits), **kw)

    def _row_step(self, batch: RowBatch):
        args = (self.table, self.salt, jnp.asarray(batch.codes),
                jnp.asarray(batch.valid))
        kw = dict(k=self.k, max_probes=self.max_probes)
        if self.weighted:
            return apply_rows_weighted(
                *args, jnp.float32(self.min_weight), **kw)
        return apply_rows(*args, jnp.int32(self.min_hits), **kw)

    def _call_batches(self, n: int, prepared) -> tuple[np.ndarray,
                                                       np.ndarray]:
        """Run prepared batches; returns (role, hits) in caller order."""
        role = np.full(n, -1, np.int32)
        hits = np.zeros(n, np.float32 if self.weighted else np.int32)
        if isinstance(prepared, FlatBatch):
            r, h = self._flat_step(prepared)
            role[:] = np.asarray(r)[:n]
            hits[:] = np.asarray(h)[:n]
            return role, hits
        outs = [self._row_step(b) for b in prepared]  # queue all steps
        for batch, (r, h) in zip(prepared, outs):
            role[batch.idx] = np.asarray(r)[: batch.n]
            hits[batch.idx] = np.asarray(h)[: batch.n]
        return role, hits

    def _decode(self, role: np.ndarray, hits: np.ndarray):
        conv = (lambda h: round(float(h), 4)) if self.weighted else int
        return [(self.role_ids[r], conv(h)) if r >= 0 else None
                for r, h in zip(role, hits)]

    # ----- public API -----

    def call_proteins(self, proteins: list[str]
                      ) -> list[tuple[str, int] | None]:
        """Per protein: (role_id, unanimous hit count) or None when no role
        is called (miss / conflicting hits / below min_hits)."""
        if not proteins:
            return []
        role, hits = self._call_batches(
            len(proteins), self._prepare_proteins(proteins))
        return self._decode(role, hits)

    def _prepare_proteins(self, proteins: list[str]):
        if self.mode == "wide":
            return make_row_batches(proteins, self.k)
        return FlatBatch(proteins, self.k)

    def prepare(self, genome: Genome):
        """Host-side prep (peg selection + batch encode) — GIL-light, safe
        to run in a prefetch worker thread."""
        pegs = [f for f in genome.pegs if f.protein_translation]
        if not pegs:
            return pegs, None
        return pegs, self._prepare_proteins(
            [f.protein_translation for f in pegs])

    def call_prepared(self, pegs: list[Feature], prepared
                      ) -> list[tuple[Feature, str, int]]:
        """Device step + decode on a prepared batch."""
        if prepared is None:
            return []
        role, hits = self._call_batches(len(pegs), prepared)
        conv = (lambda h: round(float(h), 4)) if self.weighted else int
        return [(feat, self.role_ids[r], conv(h))
                for feat, r, h in zip(pegs, role, hits) if r >= 0]

    def call_genome(self, genome: Genome
                    ) -> list[tuple[Feature, str, int]]:
        """All called (feature, role_id, hits) triples of a genome's pegs,
        in peg order (ApplyKmerProcessor.java:122-147)."""
        return self.call_prepared(*self.prepare(genome))
