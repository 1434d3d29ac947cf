"""ORF-projection annotation engine (the ``kmers``/``batch`` flagship path,
KmerProcessor.annotateGenome — KmerProcessor.java:166-287).

Pipeline, re-architected for the device:

1. **Contig kmer index** (hot loop #1): 6-frame device translation + window
   packing (ops.contig_kmers) over the new genome's contigs; the HashMap of
   kmer→locations becomes a device sort-based CSR (unique keys → location
   ranges) fronted by the bucketed probe table.  STRICT mode drops
   multi-location kmers (KmerFactory.java:64-68); AGGRESSIVE keeps all.
2. **Peg singleton kmers** per close genome (hot loop #2): flat-stream
   window packing + device sort; kmers occurring exactly once survive
   (Q5 — CountMap.getSingletons, KmerProcessor.java:319-327).
3. **Matching** (hot loop #3): one device probe of all singleton kmers
   against the contig table; hits expand through the CSR to
   (peg, contig-location) pairs.
4. **Window scan** (hot loop #4): pairs bucket by (peg, frame) — frame =
   strand + codon phase of the location (FramedLocationLists semantics) —
   and each bucket's sorted location list is scanned for evidence windows
   (Q6), feeding the proposal list (Q3 strength/3, Q7 ORF dedup).
5. Surviving proposals become features in numbering order (Q8), with
   start-aware translation and the two annotation-history strings.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..genome.dna import DnaTranslator
from ..genome.gto import Feature, Genome
from ..genome.locations import Location
from ..ops.contig_kmers import SCAN_BLOCK, extract_contig_kmers, scan_stream
from ..ops.encode import PROT_PAD, encode_dna, encode_protein
from ..ops.hashtable import (MAX_DEVICE_PROBES, build_table,
                             build_table_device, device_table_buckets,
                             probe_table)
from ..ops.kmers import pack_kmer_windows
from ..ops.translate import codon_lut
from ..ops.widetable import (build_wide_table, build_wide_table_device,
                             probe_wide, wide_rows_for)
from .apply_engine import _bucket
from .proposals import PegProposalList

log = logging.getLogger(__name__)

TOOL_NAME = "kmers.anno"


# ---------------------------------------------------------------------------
# device group-by: unique keys with counts (shared by index + singletons)
# ---------------------------------------------------------------------------

@jax.jit
def _sort_with_payload(lo, hi, payload):
    """Sort (hi, lo) keys carrying one int32 payload; returns sorted arrays
    plus first-of-segment flags and per-position segment ids."""
    shi, slo, spay = jax.lax.sort((hi, lo, payload), num_keys=2)
    prev_hi = jnp.concatenate([shi[:1] ^ jnp.uint32(1), shi[:-1]])
    prev_lo = jnp.concatenate([slo[:1], slo[:-1]])
    first = (shi != prev_hi) | (slo != prev_lo)
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    counts = jax.ops.segment_sum(jnp.ones_like(seg), seg,
                                 num_segments=lo.shape[0])
    return slo, shi, spay, first, seg, counts


# ---------------------------------------------------------------------------
# contig kmer index
# ---------------------------------------------------------------------------

@dataclass
class ContigKmerIndex:
    """Device-probed kmer → location-list index over a genome's contigs.

    CSR layout: unique keys (in the probe table, value = rank) own the
    location range locs[starts[rank] : starts[rank] + counts[rank]].
    """

    k: int
    table: jnp.ndarray          # (B, 24) device probe table (key → rank)
    max_probes: int
    ukey_lo: np.ndarray         # (U,) uint32 — unique packed keys
    ukey_hi: np.ndarray         # (U,) uint32
    starts: np.ndarray          # (U,) int64
    counts: np.ndarray          # (U,) int32
    loc_contig: np.ndarray      # (N,) int32  — contig index
    loc_strand: np.ndarray      # (N,) int8   — 0='+', 1='-'
    loc_left: np.ndarray        # (N,) int32  — 1-based left edge
    contig_ids: list            # contig index → id
    n_unique: int

    @classmethod
    def build(cls, genome: Genome, k: int = 8,
              strict: bool = False) -> "ContigKmerIndex":
        parts = []
        contig_ids = []
        for ci, contig in enumerate(genome.contigs):
            got = extract_contig_kmers(contig.sequence, k,
                                       genome.genetic_code)
            got["contig"] = np.full(len(got["lo"]), ci, np.int32)
            parts.append(got)
            contig_ids.append(contig.id)
        lo = np.concatenate([p["lo"] for p in parts])
        hi = np.concatenate([p["hi"] for p in parts])
        left = np.concatenate([p["left"] for p in parts])
        strand = np.concatenate([p["strand"] for p in parts])
        contig = np.concatenate([p["contig"] for p in parts])
        n = len(lo)
        if n == 0:
            raise ValueError("genome has no contig kmers")

        got = native.groupby(lo, hi)
        if got is not None:
            # host C++ group-by (kan_groupby): one sort, zero device
            # round-trips
            sidx, ustarts = got
            starts_all = ustarts
            ukey_lo = lo[sidx[ustarts]]
            ukey_hi = hi[sidx[ustarts]]
            ucounts = np.diff(np.append(ustarts, n)).astype(np.int32)
        else:
            # device sort by key; payload = original row index
            idx = np.arange(n, dtype=np.int32)
            slo, shi, sidx, first, seg, counts = _sort_with_payload(
                jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(idx))
            slo = np.asarray(slo)
            shi = np.asarray(shi)
            sidx = np.asarray(sidx)
            first = np.asarray(first)
            counts = np.asarray(counts)

            starts_all = np.flatnonzero(first)          # (U,)
            ukey_lo = slo[starts_all]
            ukey_hi = shi[starts_all]
            ucounts = counts[: len(starts_all)]
        if strict:
            keep = ucounts == 1                      # STRICT: unique only
            ukey_lo, ukey_hi = ukey_lo[keep], ukey_hi[keep]
            starts_all, ucounts = starts_all[keep], ucounts[keep]
        table, max_probes = build_table(
            ukey_lo, ukey_hi, np.arange(len(ukey_lo), dtype=np.uint32))
        return cls(
            k=k, table=jnp.asarray(table), max_probes=max_probes,
            ukey_lo=ukey_lo, ukey_hi=ukey_hi,
            starts=starts_all.astype(np.int64),
            counts=ucounts.astype(np.int32),
            loc_contig=contig[sidx], loc_strand=strand[sidx],
            loc_left=left[sidx], contig_ids=contig_ids,
            n_unique=len(ukey_lo))


# ---------------------------------------------------------------------------
# device-resident stream window index (the accelerator path)
# ---------------------------------------------------------------------------

def _bucket_blocks(n: int) -> int:
    """Round a block count to {2^m, 3·2^(m-1)} to bound recompiles."""
    n = max(n, 1)
    p = 1 << (n - 1).bit_length()
    if p * 3 // 4 >= n:
        return p * 3 // 4
    return p


@partial(jax.jit, static_argnames=("k", "n_pad"))
def _q1_mask(seg_start, seg_len, d_bad, *, k: int, n_pad: int):
    """Q1 per-segment window validity ON DEVICE (strict drop-last,
    KmerReference.java:186-187), so no (n_pad,) host mask is pushed."""
    pos = jnp.arange(n_pad, dtype=jnp.int32)
    seg = jnp.searchsorted(seg_start, pos, side="right").astype(
        jnp.int32) - 1
    local = pos - seg_start[seg]
    length = seg_len[seg]
    k3 = 3 * k
    n_out = length - k3 + 1
    flen = (length - local % 3) // 3
    valid = (local < jnp.maximum(n_out, 0)) & ((local // 3) < (flen - k))
    return valid & ~d_bad


@jax.jit
def _strict_window_mask(d_lo, d_hi, d_valid):
    """STRICT mode (KmerFactory.java:64-68) on the window stream: keep
    only windows whose kmer occurs exactly once among valid windows."""
    n = d_lo.shape[0]
    sent = jnp.int32(1 << 30)              # > any packed hi (≤ 30 bits)
    key_hi = jnp.where(d_valid, d_hi, sent)
    pos = jnp.arange(n, dtype=jnp.int32)
    shi, slo, spos = jax.lax.sort((key_hi, d_lo, pos), num_keys=2)
    prev_hi = jnp.concatenate([shi[:1] ^ 1, shi[:-1]])
    prev_lo = jnp.concatenate([slo[:1], slo[:-1]])
    first = (shi != prev_hi) | (slo != prev_lo)
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    counts = jax.ops.segment_sum(jnp.ones(n, jnp.int32), seg,
                                 num_segments=n)
    keep = (counts[seg] == 1) & (shi != sent)
    return jnp.zeros(n, bool).at[spos].set(keep)


@partial(jax.jit, static_argnames=("n_buckets",))
def _build_singleton_table(s_lo, s_hi, s_peg, n_buckets: int):
    """Device build of one close genome's singleton table (cacheable)."""
    return build_table_device(s_lo, s_hi, s_peg, n_buckets)


@partial(jax.jit, static_argnames=("n_rows",))
def _build_singleton_wide(s_lo, s_hi, s_peg, n_rows: int):
    """Device wide-bucket build (salt 0; bad flag on any walk)."""
    return build_wide_table_device(s_lo, s_hi, s_peg, n_rows)


_PROBE_CHUNK = 1 << 19     # windows per probe step: the gathered row
                           # buffer is the memory hot spot (72 words per
                           # window); chunking keeps it at ~150 MB even
                           # when several genome bodies overlap in one
                           # XLA program (10 unchunked bodies OOM'd HBM)


def _chunked_pay(table, d_lo, d_hi, d_valid, max_probes: int, salt):
    """Probe the whole stream in _PROBE_CHUNK slices (jit-composable)."""

    def probe(cl, ch, cv):
        if salt is None:                     # 8-slot bucketed layout
            return probe_table(table, cl.astype(jnp.uint32),
                               ch.astype(jnp.uint32), cv, max_probes)
        return probe_wide(table, cl.astype(jnp.uint32),
                          ch.astype(jnp.uint32), cv,
                          jnp.uint32(salt), max_probes=max_probes)

    n = d_lo.shape[0]
    if n <= _PROBE_CHUNK:
        return probe(d_lo, d_hi, d_valid)
    pad = -n % _PROBE_CHUNK
    lo_p = jnp.concatenate([d_lo, jnp.zeros(pad, d_lo.dtype)])
    hi_p = jnp.concatenate([d_hi, jnp.zeros(pad, d_hi.dtype)])
    v_p = jnp.concatenate([d_valid, jnp.zeros(pad, bool)])

    def step(i, out):
        s = i * _PROBE_CHUNK
        pv = probe(jax.lax.dynamic_slice(lo_p, (s,), (_PROBE_CHUNK,)),
                   jax.lax.dynamic_slice(hi_p, (s,), (_PROBE_CHUNK,)),
                   jax.lax.dynamic_slice(v_p, (s,), (_PROBE_CHUNK,)))
        return jax.lax.dynamic_update_slice(out, pv, (s,))

    out = jax.lax.fori_loop(0, (n + pad) // _PROBE_CHUNK, step,
                            jnp.full(n + pad, -1, jnp.int32))
    return out[:n]


def _rle_body(table, d_lo, d_hi, d_valid, cap: int, rcap: int,
              max_probes: int, salt=None):
    """Probe the window stream against a singleton table and return the
    hits RUN-LENGTH ENCODED (jit-composable body).

    Matched windows are overwhelmingly CONSECUTIVE stream positions with
    the same peg (a projected gene body matches at every window until a
    mismatch breaks the run), so (start, length, peg) triples compress
    the host pull by one to two orders of magnitude.

    returns (starts (rcap,), pegs (rcap,), lens (rcap,) int32,
             n_runs, n_hits int32 scalars)
    Results are ONLY valid when n_hits <= cap and n_runs <= rcap —
    callers must retry with bigger caps otherwise.
    """
    # an oversized cap must clamp to the true stream length, or ps (a
    # clamped slice) and idx (arange(cap)) would disagree in shape and
    # crash the jitted probe at trace time (ADVICE r4)
    cap = min(cap, int(d_lo.shape[0]))
    rcap = min(rcap, cap)
    pay = _chunked_pay(table, d_lo, d_hi, d_valid, max_probes, salt)
    hit = pay >= 0
    n_hits = jnp.sum(hit.astype(jnp.int32))
    miss = jnp.where(hit, jnp.int8(0), jnp.int8(1))
    pos = jnp.arange(pay.shape[0], dtype=jnp.int32)
    # stable sort-compaction keeps hits in stream order
    _, pos_s, pay_s = jax.lax.sort((miss, pos, pay), num_keys=2)
    ps = pos_s[:cap]
    gs = pay_s[:cap]
    idx = jnp.arange(cap, dtype=jnp.int32)
    ok = idx < n_hits
    brk = jnp.concatenate([
        jnp.ones(1, bool),
        (ps[1:] != ps[:-1] + 1) | (gs[1:] != gs[:-1])]) & ok
    n_runs = jnp.sum(brk.astype(jnp.int32))
    rid = jnp.cumsum(brk.astype(jnp.int32)) - 1
    seg = jnp.where(ok, rid, cap)
    lens = jax.ops.segment_sum(ok.astype(jnp.int32), seg,
                               num_segments=cap + 1)[:cap]
    nbrk = jnp.where(brk, jnp.int8(0), jnp.int8(1))
    _, bidx = jax.lax.sort((nbrk, idx), num_keys=1)
    return (ps[bidx][:rcap], gs[bidx][:rcap], lens[:rcap],
            n_runs, n_hits)


@partial(jax.jit, static_argnames=("cap", "rcap", "max_probes", "salt"))
def _probe_rle(table, d_lo, d_hi, d_valid, *,
               cap: int, rcap: int, max_probes: int, salt=None):
    """One-genome RLE probe (see _rle_body)."""
    return _rle_body(table, d_lo, d_hi, d_valid, cap, rcap, max_probes,
                     salt)


@partial(jax.jit, static_argnames=("cap", "rcap", "meta"))
def _probe_rle_multi(tables, d_lo, d_hi, d_valid, *,
                     cap: int, rcap: int, meta: tuple):
    """ALL close genomes in one device call against their (cached,
    possibly differently-sized) tables; outputs stacked (G, rcap).

    meta: per-genome static (max_probes, salt-or-None) — salt present
    means the table uses the wide-bucket single-gather layout.

    One dispatch + one result set for the whole close-genome loop
    instead of one per genome.
    """
    outs = [_rle_body(t, d_lo, d_hi, d_valid, cap, rcap, mp, salt)
            for t, (mp, salt) in zip(tables, meta)]
    return tuple(jnp.stack([o[i] for o in outs]) for i in range(5))


# ---------------------------------------------------------------------------
# fused union-probe + on-device window scan (the r5 fast path)
# ---------------------------------------------------------------------------
#
# The r4 path probed the FULL window stream once per close genome and
# RLE-compressed each genome's hits for a host-side window scan: 10 big
# device sorts, a multi-MB pull, ~7 s of host expansion/argsort on ~10M
# pairs, and a 10-body unrolled jit that took minutes to compile.  The
# r5 path keeps hot loops 3 AND 4 on device:
#
#   1. probe the stream ONCE against the UNION of all close genomes'
#      singleton kmers and compact the hit positions (one sort);
#   2. lax.scan over the close genomes (ONE compiled body): probe the
#      compacted keys against each genome's table, sort hits by the
#      packed (frame, peg, contig, left) candidate key, run the Q6
#      window scan with a merge-rank trick (no 64-bit searchsorted
#      needed), extend candidates via gathers into device ORF scan
#      arrays, apply float64-exact weak/small filters, and run the Q7
#      ORF dedup against an incumbent array CARRIED across genomes;
#   3. pull ONE flat buffer (~3 MB) of per-genome STORED events + stats;
#      the host only replays them into the proposal dict
#      (PegProposalList.replay_stored) and emits features.
#
# Packed candidate key (uint32 pair) — fixed field widths so the scan
# body compiles once:  khi = frame(3) | peg(20) | contig_hi(6),
# klo = contig_lo(4) | left(28).  _close_set validates the widths and
# falls back to the RLE path when a genome exceeds them.

_LEFT_BITS = 28
_CONTIG_BITS = 10
_PEG_BITS = 20
_LMASK = (1 << _LEFT_BITS) - 1
_SENTINEL = 0xFFFFFFFF


# --- device ORF extension state (ops/orf.py semantics as gathers) -------

_ORF_GAP = 4            # separator width between contigs (code 6 blocks)
_ORF_SEP = np.uint8(6)  # reserved code: forces stop=True / start=False


def _min_ev_table(min_strength: float, max_len: int) -> np.ndarray:
    """minev[L] = smallest integer ev with NOT (ev / L < min_strength),
    under float64 division — so the device's integer compare reproduces
    propose_batch's `evidence / length < min_strength` bit-exactly."""
    L = np.arange(max_len + 1, dtype=np.int64)
    L[0] = 1
    ev = np.ceil(min_strength * L).astype(np.int64)
    ev = np.maximum(ev, 0)
    ev = np.where((ev - 1) >= 0, np.where((ev - 1) / L >= min_strength,
                                          ev - 1, ev), ev)
    ev = np.where(ev / L < min_strength, ev + 1, ev)
    bad = (ev / L < min_strength) | ((ev - 1) / L >= min_strength)
    bad &= ev - 1 >= 0
    if bad.any():  # pragma: no cover - construction is provably 1 step
        raise AssertionError("min_ev_table failed to converge")
    return ev.astype(np.int32)


def _next_true_dev(mask):
    """Device _next_true (ops/orf.py): per phase, smallest q >= p with
    q ≡ p (mod 3) and mask[q]; -1 when none.  len(mask) % 3 == 0."""
    n = mask.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    big = jnp.int32(1 << 30)
    res = jnp.zeros(n, jnp.int32)
    for ph in range(3):
        v = jnp.where(mask[ph::3], pos[ph::3], big)
        m = jnp.flip(jax.lax.cummin(jnp.flip(v)))
        res = res.at[ph::3].set(jnp.where(m < big, m, -1))
    return res


def _prev_true_dev(mask):
    n = mask.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    res = jnp.zeros(n, jnp.int32)
    for ph in range(3):
        v = jnp.where(mask[ph::3], pos[ph::3], jnp.int32(-1))
        res = res.at[ph::3].set(jax.lax.cummax(v))
    return res


@jax.jit
def _build_orf_scans(codes, start_lut, stop_lut):
    """ContigOrfScan for a whole genome in ONE padded code stream.

    codes: (N,) uint8 — contigs separated by >= _ORF_GAP _ORF_SEP codes
    (leading + trailing gaps included; N ≡ 2 mod 3 so each phase slices
    evenly).  Separator codons are forced stop=True/start=False, which
    BLOCKS every scan at contig boundaries: a walk that would leave its
    contig lands on a separator and fails the local-range/start checks —
    the same outcome as the host scans' -1 sentinels.
    """
    c0, c1, c2 = codes[:-2], codes[1:-1], codes[2:]
    ok = (c0 < 4) & (c1 < 4) & (c2 < 4)
    gap = (c0 >= _ORF_SEP) | (c1 >= _ORF_SEP) | (c2 >= _ORF_SEP)
    i0 = c0.astype(jnp.int32)
    i1 = c1.astype(jnp.int32)
    i2 = c2.astype(jnp.int32)
    pid = jnp.where(ok, i0 * 16 + i1 * 4 + i2, 64)
    mid = jnp.where(ok, (i2 ^ 2) * 16 + (i1 ^ 2) * 4 + (i0 ^ 2), 64)
    p_start = start_lut[pid] & ~gap
    p_stop = stop_lut[pid] | gap
    m_start = start_lut[mid] & ~gap
    m_stop = stop_lut[mid] | gap
    return (_next_true_dev(p_stop), _prev_true_dev(p_start | p_stop),
            _prev_true_dev(m_stop), _next_true_dev(m_start | m_stop),
            p_start, m_start)


@partial(jax.jit, static_argnames=("k", "ucap", "max_probes"))
def _union_compact(table, salt, d_lo, d_hi, d_valid,
                   seg_start, seg_contig, seg_strand, seg_len,
                   *, k: int, ucap: int, max_probes: int):
    """Probe the stream against the union table and compact hits.

    returns (lo_c, hi_c — compacted window keys,
             klo — uint32 contig_lo|left candidate-key half,
             base — uint32 frame|contig_hi candidate-key half (peg 0),
             n_union int32 scalar; results valid iff n_union <= ucap)
    """
    pay = _chunked_pay(table, d_lo, d_hi, d_valid, max_probes, salt)
    hit = pay >= 0
    n_union = jnp.sum(hit.astype(jnp.int32))
    miss = jnp.where(hit, jnp.int8(0), jnp.int8(1))
    pos = jnp.arange(pay.shape[0], dtype=jnp.int32)
    _, pos_s, lo_s, hi_s = jax.lax.sort(
        (miss, pos, d_lo, d_hi), num_keys=2)
    pos_c = pos_s[:ucap]
    lo_c = lo_s[:ucap].astype(jnp.uint32)
    hi_c = hi_s[:ucap].astype(jnp.uint32)
    # stream position → (contig, strand, left, frame): the device locate
    seg = jnp.searchsorted(seg_start, pos_c, side="right").astype(
        jnp.int32) - 1
    local = pos_c - seg_start[seg]
    strand = seg_strand[seg].astype(jnp.int32)
    length = seg_len[seg]
    k3 = 3 * k
    left = jnp.where(strand == 0, local + 1, (length - k3 + 1) - local)
    right = left + k3 - 1
    frame = jnp.where(strand == 0, 3 + left % 3, right % 3)
    contig = seg_contig[seg].astype(jnp.uint32)
    left_u = left.astype(jnp.uint32)
    klo = ((contig & 15) << _LEFT_BITS) | left_u
    base = (frame.astype(jnp.uint32) << (_PEG_BITS + _CONTIG_BITS - 4)
            ) | (contig >> 4)
    return lo_c, hi_c, klo, base, n_union


@partial(jax.jit, static_argnames=("k", "ucap", "pcap", "lcap",
                                   "scap", "max_probes"))
def _scan_genomes(tables, salts, pinfo, lo_c, hi_c, klo, base, n_union,
                  scans, orf_off, contig_len, minev, min_evidence,
                  *, k: int, ucap: int, pcap: int, lcap: int,
                  scap: int, max_probes: int):
    """One lax.scan body over all close genomes: probe + Q6 window scan
    + ORF extension + exact weak/small filters + Q7 dedup.

    tables: (G, rows, 72) stacked wide singleton tables
    salts:  (G,) uint32
    pinfo:  (G, 3, Pmax) int32 — host-precomputed per-peg [maxlen3,
            minlen3, minkmers] (float64 rounding stays on host so the
            fuzz thresholds match numpy bit-for-bit)
    scans:  the 6 _build_orf_scans arrays (device Location.extend)
    orf_off/contig_len: (C,) int32 per-contig offset into the scan
            stream / contig length
    minev:  (Lmax+1,) int32 — _min_ev_table(min_strength) so the weak
            filter matches numpy float64 division bit-exactly
    returns ONE flat int32 buffer: G*(scap*8) STORED-event rows
            [contig, strand, ext_l, ext_r, evidence, peg, left,
            best_edge] in candidate order + G*10 stats [n_hits, n_groups,
            low_kmer, too_short, n_live, rejected, weak, small,
            n_stored, n_cand] + [n_union] — a single host pull.  The
            incumbent (best ev, len per ORF address) is CARRIED across
            genomes by the lax.scan, so stored/merged decisions are
            exactly propose_batch's.
    """
    k3 = 3 * k
    idx = jnp.arange(ucap, dtype=jnp.int32)
    valid_c = idx < n_union
    pmax = pinfo.shape[2]
    pegshift = _CONTIG_BITS - 4
    gshift = jnp.uint32(pegshift)
    frameshift = jnp.uint32(_PEG_BITS + pegshift)
    (next_stop_p, prev_event_p, prev_stop_m, next_event_m,
     p_start, m_start) = scans
    n2_all = next_stop_p.shape[0]
    ospan = n2_all + 4              # ORF address space per strand
    pidx = jnp.arange(pcap, dtype=jnp.int32)

    def body(carry, g):
        table, salt, pi = g
        pay = probe_wide(table, lo_c, hi_c, valid_c, salt,
                         max_probes=max_probes)
        hit = pay >= 0
        nh = jnp.sum(hit.astype(jnp.int32))
        peg_u = jnp.where(hit, pay, 0).astype(jnp.uint32)
        khi = jnp.where(hit, base | (peg_u << gshift),
                        jnp.uint32(_SENTINEL))
        khi_s, klo_s = jax.lax.sort((khi, klo), num_keys=2)
        ok = idx < nh
        left_s = (klo_s & jnp.uint32(_LMASK)).astype(jnp.int32)
        contig_s = ((klo_s >> jnp.uint32(_LEFT_BITS))
                    | ((khi_s & jnp.uint32((1 << pegshift) - 1))
                       << jnp.uint32(4))).astype(jnp.int32)
        peg_s = ((khi_s >> gshift)
                 & jnp.uint32((1 << _PEG_BITS) - 1)).astype(jnp.int32)
        frame_s = (khi_s >> frameshift).astype(jnp.int32)
        pegc = jnp.minimum(peg_s, pmax - 1)
        # groups = (frame, peg); runs = (frame, peg, contig)
        gkey = khi_s >> gshift
        rlo = klo_s >> jnp.uint32(_LEFT_BITS)
        one = jnp.ones(1, bool)
        gfirst = jnp.concatenate([one, gkey[1:] != gkey[:-1]])
        rfirst = jnp.concatenate([one, (khi_s[1:] != khi_s[:-1])
                                  | (rlo[1:] != rlo[:-1])])
        rid = jnp.cumsum(rfirst.astype(jnp.int32)) - 1
        gstart = jax.lax.cummax(jnp.where(gfirst, idx, -1))
        glast = jnp.concatenate([gfirst[1:], one])
        gend = jnp.flip(jax.lax.cummin(
            jnp.flip(jnp.where(glast, idx + 1, ucap + 1))))
        size = gend - gstart
        i_local = idx - gstart
        maxlen3 = pi[0][pegc]
        minlen3 = pi[1][pegc]
        minkm = pi[2][pegc]
        group_ok = minkm <= size
        cand = ok & group_ok & (i_local <= size - minkm)
        n_cand = jnp.sum(cand.astype(jnp.int32))
        # compact the CANDIDATES first (stable: unique idx key) so the
        # merged-rank pass carries ccap queries instead of ucap — the
        # r5a version merged a Q copy of every hit and scattered ev/edge
        # back over 2*ucap, which dominated the body's runtime
        _, cc = jax.lax.sort(
            (jnp.where(cand, jnp.int8(0), jnp.int8(1)), idx), num_keys=2)
        cc = cc[:pcap]
        ccap_i = jnp.arange(pcap, dtype=jnp.int32)
        c_is = ccap_i < n_cand
        # ---- Q6 evidence via a merged-rank pass ----
        # host reference: ub = searchsorted(run-prefixed rights,
        # left + maxlen3); here right ≡ left + 3K-1, so the query is the
        # candidate key with left += delta (never carries past the left
        # field — _close_set validates) and Q-before-B tie order gives
        # the strict '<' count without 64-bit keys.  Merged-sort Q rows
        # preserve candidate order (delta is constant within a group and
        # the group prefix dominates the key), so a Q row's rank among Q
        # rows IS its candidate slot.
        delta_c = jnp.maximum(pi[0][jnp.minimum(peg_s[cc], pmax - 1)]
                              - (k3 - 1), 0).astype(jnp.uint32)
        q_hi = jnp.where(c_is, khi_s[cc], jnp.uint32(_SENTINEL))
        q_lo = klo_s[cc] + delta_c
        two = ucap + pcap
        mk_hi = jnp.concatenate([q_hi, khi_s])
        mk_lo = jnp.concatenate([q_lo, klo_s])
        tag = jnp.concatenate([jnp.zeros(pcap, jnp.int8),
                               jnp.ones(ucap, jnp.int8)])
        src = jnp.concatenate([cc, idx])
        # left and run id ride as sort PAYLOADS: an extra operand moves
        # through the bitonic net for ~1 ms while a 1.5M data-dependent
        # gather costs ~9 ms
        rid_2 = jnp.concatenate([rid[cc], rid])
        left_2 = jnp.concatenate([left_s[cc], left_s])
        mk_hi, mk_lo, tag_m, src_m, rid_m, left_m = jax.lax.sort(
            (mk_hi, mk_lo, tag, src, rid_2, left_2), num_keys=3)
        isb = tag_m == 1
        p = jnp.arange(two, dtype=jnp.int32)
        q_rank = jnp.cumsum((~isb).astype(jnp.int32)) - 1
        ub = p - q_rank                       # #B strictly before this Q
        ev_m = jnp.maximum(ub - src_m - 1, 0) + 1
        # best edge: B[ub-1] (clamped to the element itself, host
        # semantics s_right[max(ub-1, i)]) — two small gathers into the
        # pre-merge sorted arrays replace a segmented last-B scan; the
        # run guard handles ub pointing before this element's run
        bi = jnp.clip(ub - 1, 0, ucap - 1)
        bleft = (klo_s[bi] & jnp.uint32(_LMASK)).astype(jnp.int32)
        brun = rid[bi]
        bestleft = jnp.where((ub >= 1) & (brun == rid_m), bleft, -1)
        be_m = jnp.maximum(bestleft, left_m) + (k3 - 1)
        # scatter Q results to candidate slots (q_rank == cand slot)
        tgt = jnp.where(~isb, jnp.clip(q_rank, 0, pcap), pcap)
        evidence = jnp.zeros(pcap + 1, jnp.int32).at[tgt].set(
            ev_m, mode="drop")[:pcap]
        best_edge = jnp.zeros(pcap + 1, jnp.int32).at[tgt].set(
            be_m, mode="drop")[:pcap]
        cl = c_left0 = left_s[cc]
        short_c = c_is & (best_edge < c_left0 + minlen3[cc])
        live_c = c_is & ~short_c
        n_live = jnp.sum(live_c.astype(jnp.int32))
        n_short = jnp.sum(short_c.astype(jnp.int32))
        # compact LIVE candidates (too-short rows are ~60% of cands on
        # projection workloads): extension + dedup then run on lcap
        # arrays instead of pcap
        _, lv = jax.lax.sort(
            (jnp.where(live_c, jnp.int8(0), jnp.int8(1)), pidx),
            num_keys=2)
        lv = lv[:lcap]
        c_live = jnp.arange(lcap, dtype=jnp.int32) < n_live
        cc2 = cc[lv]
        c_contig = contig_s[cc2]
        c_strand = jnp.where(frame_s[cc2] >= 3, 0, 1).astype(jnp.int32)
        c_left = cl[lv]
        c_peg = peg_s[cc2]
        c_bedge = best_edge[lv]
        c_ev = evidence[lv]

        # ---- device Location.extend (ops/orf.py semantics) ----
        off = orf_off[jnp.clip(c_contig, 0, orf_off.shape[0] - 1)]
        lc = contig_len[jnp.clip(c_contig, 0, orf_off.shape[0] - 1)]
        n2c = lc - 2
        plus = c_strand == 0

        def gat(arr, local, valid):
            gi = jnp.clip(off + jnp.clip(local, 0, n2c - 1), 0,
                          n2_all - 1)
            return jnp.where(valid & (n2c > 0), arr[gi], -1)

        # '+': stop downstream of right, start-or-stop upstream of left
        posp = c_bedge                      # 1-based right ≡ 0-based next
        qp = gat(next_stop_p, posp, plus & (posp < n2c))
        qp_l = qp - off
        p0p = c_left - 1
        p0p = jnp.where(p0p >= n2c,
                        p0p - 3 * ((p0p - (n2c - 1) + 2) // 3), p0p)
        ep = gat(prev_event_p, p0p, plus)
        ep_l = ep - off
        ep_start = jnp.where(
            ep >= 0, p_start[jnp.clip(ep, 0, n2_all - 1)], False)
        ok_p = (plus & (posp < n2c) & (qp >= 0) & (qp_l < n2c)
                & (ep >= 0) & (ep_l >= 0) & (ep_l < n2c) & ep_start)
        # '-': stop upstream below left, start-or-stop downstream of right
        posm = c_left - 4
        posm = jnp.where(posm >= n2c,
                         posm - 3 * ((posm - (n2c - 1) + 2) // 3), posm)
        qm = gat(prev_stop_m, posm, (~plus) & (posm >= 0))
        qm_l = qm - off
        p0m = c_bedge - 3
        p0m = jnp.where(p0m < 0, p0m + 3 * ((-p0m + 2) // 3), p0m)
        em = gat(next_event_m, p0m, (~plus) & (p0m < n2c))
        em_l = em - off
        em_start = jnp.where(
            em >= 0, m_start[jnp.clip(em, 0, n2_all - 1)], False)
        ok_m = ((~plus) & (posm >= 0) & (qm >= 0) & (qm_l >= 0)
                & (em >= 0) & (em_l < n2c) & em_start)
        len_ok = ((c_bedge - c_left + 1) % 3) == 0
        ok_ext = c_live & len_ok & jnp.where(plus, ok_p, ok_m)
        ext_l = jnp.where(plus, ep_l + 1, qm_l + 1)
        ext_r = jnp.where(plus, qp_l + 3, em_l + 3)

        # ---- exact weak/small filters (propose_batch order) ----
        elen = jnp.where(ok_ext, ext_r - ext_l + 1, 1)
        thr = minev[jnp.clip(elen, 0, minev.shape[0] - 1)]
        weak = ok_ext & (c_ev < thr)
        small = ok_ext & ~weak & (c_ev < min_evidence)
        fin = ok_ext & ~weak & ~small
        n_rej = jnp.sum((c_live & ~ok_ext).astype(jnp.int32))
        n_weak = jnp.sum(weak.astype(jnp.int32))
        n_small = jnp.sum(small.astype(jnp.int32))

        # ---- Q7 ORF dedup with exact stored/merged decisions ----
        inc_ev, inc_len = carry
        lpos = jnp.arange(lcap, dtype=jnp.int32)
        orf_end = jnp.where(plus, ext_r, ext_l)
        addr = jnp.where(fin, off + orf_end + c_strand * ospan,
                         2 * ospan)
        a_s, i_s = jax.lax.sort((addr, lpos), num_keys=2)
        fin_s = a_s < 2 * ospan
        ev_s = jnp.where(fin_s, c_ev[i_s], -1)
        ln_s = jnp.where(fin_s, elen[i_s], 0)
        first = jnp.concatenate([jnp.ones(1, bool),
                                 a_s[1:] != a_s[:-1]])

        def comb(a, b):
            fa, ea, la = a
            fb, eb, lb = b
            gt = (ea > eb) | ((ea == eb) & (la > lb))
            return (fa | fb,
                    jnp.where(fb, eb, jnp.where(gt, ea, eb)),
                    jnp.where(fb, lb, jnp.where(gt, la, lb)))

        _, m_ev, m_ln = jax.lax.associative_scan(
            comb, (first, ev_s, ln_s))
        # exclusive within-segment prefix max
        x_ev = jnp.where(first, -1,
                         jnp.concatenate([jnp.full(1, -1, m_ev.dtype),
                                          m_ev[:-1]]))
        x_ln = jnp.where(first, 0,
                         jnp.concatenate([jnp.zeros(1, m_ln.dtype),
                                          m_ln[:-1]]))
        ac = jnp.clip(a_s, 0, 2 * ospan - 1)
        g_ev = jnp.where(fin_s, inc_ev[ac], -1)
        g_ln = jnp.where(fin_s, inc_len[ac], 0)
        inc_gt = (g_ev > x_ev) | ((g_ev == x_ev) & (g_ln > x_ln))
        eff_ev = jnp.where(inc_gt, g_ev, x_ev)
        eff_ln = jnp.where(inc_gt, g_ln, x_ln)
        stored_s = fin_s & ((ev_s > eff_ev)
                            | ((ev_s == eff_ev) & (ln_s > eff_ln)))
        # incumbent update: segment-inclusive max vs incumbent at last
        last = jnp.concatenate([first[1:], jnp.ones(1, bool)]) & fin_s
        fi_gt = (g_ev > m_ev) | ((g_ev == m_ev) & (g_ln > m_ln))
        f_ev = jnp.where(fi_gt, g_ev, m_ev)
        f_ln = jnp.where(fi_gt, g_ln, m_ln)
        tgt2 = jnp.where(last, a_s, 2 * ospan)
        inc_ev = inc_ev.at[tgt2].set(f_ev, mode="drop")
        inc_len = inc_len.at[tgt2].set(f_ln, mode="drop")

        # stored rows back in candidate order, compacted to scap
        stored = jnp.zeros(lcap, bool).at[i_s].set(stored_s)
        n_stored = jnp.sum(stored.astype(jnp.int32))
        _, si = jax.lax.sort(
            (jnp.where(stored, jnp.int8(0), jnp.int8(1)), lpos),
            num_keys=2)
        si = si[:scap]
        rows = jnp.stack([c_contig[si], c_strand[si], ext_l[si],
                          ext_r[si], c_ev[si], c_peg[si], c_left[si],
                          c_bedge[si]], 1)
        stats = jnp.stack([
            nh, jnp.sum((gfirst & ok).astype(jnp.int32)),
            jnp.sum((gfirst & ok & ~group_ok).astype(jnp.int32)),
            n_short, n_live,
            n_rej, n_weak, n_small, n_stored, n_cand])
        return (inc_ev, inc_len), (rows, stats)

    carry0 = (jnp.full(2 * ospan + 1, -1, jnp.int32),
              jnp.zeros(2 * ospan + 1, jnp.int32))
    _, (rows, stats) = jax.lax.scan(body, carry0,
                                    (tables, salts, pinfo))
    return jnp.concatenate([rows.reshape(-1), stats.reshape(-1),
                            n_union.reshape(1)])


def genome_stream(genome: Genome, k: int):
    """Both strands of every contig, concatenated for ops.contig_kmers.
    scan_stream: segments in reading order, each followed by 3k ambiguity
    codes (≥ 3k-1, so no window crosses one), the whole padded to a
    bucketed whole number of SCAN_BLOCKs of windows plus 3k-1.

    returns (stream (W,) uint8, meta [(contig idx, strand, offset,
    length)] per segment, per-contig forward codes)."""
    from ..ops.encode import DNA_AMBIG, reverse_complement_codes

    k3 = 3 * k
    parts, meta, contig_codes = [], [], []
    pos = 0
    for ci, contig in enumerate(genome.contigs):
        codes = encode_dna(contig.sequence)
        contig_codes.append(codes)
        length = len(codes)
        for strand, arr in ((0, codes),
                            (1, reverse_complement_codes(codes))):
            meta.append((ci, strand, pos, length))
            parts.append(arr)
            parts.append(np.full(k3, DNA_AMBIG, np.uint8))
            pos += length + k3
    n_blocks = _bucket_blocks(-(-max(pos - k3 + 1, 1) // SCAN_BLOCK))
    parts.append(np.full(n_blocks * SCAN_BLOCK + k3 - 1 - pos, DNA_AMBIG,
                         np.uint8))
    return np.concatenate(parts), meta, contig_codes


@dataclass
class StreamWindowIndex:
    """Device-resident contig window keys (base-major stream order).

    Inverts the probe direction of ContigKmerIndex: instead of building a
    genome-size hash table over contig kmers and probing peg singletons
    into it (CSR expansion of location lists), the contig windows STAY on
    device as one packed stream and each close genome's (small) singleton
    set becomes the table — a window hit directly IS a (peg, location)
    pair.  Eliminates the megabyte host pulls and the host table build
    that dominate the host-index path (KmerReference.getContigKmers /
    KmerProcessor.java:197-207 semantics, identical pair multiset).
    """

    k: int
    gc: int
    d_lo: jnp.ndarray           # (N,) int32 device window keys
    d_hi: jnp.ndarray
    d_valid: jnp.ndarray        # (N,) bool device
    seg_start: np.ndarray       # (S,) int64 stream offset per segment
    seg_contig: np.ndarray      # (S,) int32
    seg_strand: np.ndarray      # (S,) int8
    seg_len: np.ndarray         # (S,) int64 contig length
    contig_ids: list
    n_windows: int
    contig_codes: list = None   # per-contig uint8 codes (lazy ORF state)
    _orf: tuple = None          # cached device ORF-extension state

    def orf_state(self):
        """Device ORF-extension state (lazy): the _build_orf_scans
        arrays + per-contig (offset, length) in the padded code stream.
        One ~3 MB push per genome, reused by every close genome."""
        if self._orf is not None:
            return self._orf
        from ..genome.dna import GeneticCode

        parts = [np.full(_ORF_GAP, _ORF_SEP, np.uint8)]
        offs = []
        pos = _ORF_GAP
        for codes in self.contig_codes:
            offs.append(pos)
            parts.append(codes)
            parts.append(np.full(_ORF_GAP, _ORF_SEP, np.uint8))
            pos += len(codes) + _ORF_GAP
        want = _bucket(pos + 4, 4096)
        want += (2 - want % 3) % 3          # ≡ 2 mod 3: phases slice even
        parts.append(np.full(want - pos, _ORF_SEP, np.uint8))
        stream = np.concatenate(parts)
        code = GeneticCode.get(self.gc)
        order = {"t": 0, "c": 1, "a": 2, "g": 3}

        def lut65(codons):
            out = np.zeros(65, bool)
            for c in codons:
                out[order[c[0]] * 16 + order[c[1]] * 4 + order[c[2]]] = 1
            return out

        scans = _build_orf_scans(jnp.asarray(stream),
                                 jnp.asarray(lut65(code.starts)),
                                 jnp.asarray(lut65(code.stops)))
        self._orf = (scans,
                     jnp.asarray(np.array(offs, np.int32)),
                     jnp.asarray(np.array(
                         [len(c) for c in self.contig_codes], np.int32)))
        return self._orf

    @classmethod
    def build(cls, genome: Genome, k: int = 8,
              strict: bool = False) -> "StreamWindowIndex":
        stream, meta, contig_codes = genome_stream(genome, k)
        n_pad = len(stream) - 3 * k + 1
        d_lo, d_hi, d_bad = scan_stream(
            jnp.asarray(stream), jnp.asarray(codon_lut(genome.genetic_code)),
            k)

        # Q1 validity per segment (strict drop-last, KmerReference
        # .java:186-187) computed ON DEVICE from segment metadata; Q2
        # ambiguity lives in the device ``bad`` flags
        d_valid = _q1_mask(
            jnp.asarray(np.array([m[2] for m in meta], np.int32)),
            jnp.asarray(np.array([m[3] for m in meta], np.int32)),
            d_bad, k=k, n_pad=n_pad)
        if strict:
            d_valid = _strict_window_mask(d_lo, d_hi, d_valid)
        # window count per segment, analytically (the log line only)
        n_windows = 0
        for _, _, _, length in meta:
            n_out = length - 3 * k + 1
            for ph in range(3):
                if n_out > ph:
                    n_windows += max(0, min(-(-(n_out - ph) // 3),
                                            (length - ph) // 3 - k))
        return cls(
            k=k, gc=genome.genetic_code, d_lo=d_lo, d_hi=d_hi,
            d_valid=d_valid,
            seg_start=np.array([m[2] for m in meta], np.int64),
            seg_contig=np.array([m[0] for m in meta], np.int32),
            seg_strand=np.array([m[1] for m in meta], np.int8),
            seg_len=np.array([m[3] for m in meta], np.int64),
            contig_ids=[c.id for c in genome.contigs],
            n_windows=n_windows, contig_codes=contig_codes)

    def locate(self, pos: np.ndarray):
        """Stream positions → (contig idx, strand, 1-based left edge)."""
        seg = np.searchsorted(self.seg_start, pos, side="right") - 1
        local = pos - self.seg_start[seg]
        strand = self.seg_strand[seg]
        length = self.seg_len[seg]
        k3 = 3 * self.k
        left = np.where(strand == 0, local + 1,
                        (length - k3 + 1) - local)
        return (self.seg_contig[seg], strand.astype(np.int8),
                left.astype(np.int32))


# ---------------------------------------------------------------------------
# close-genome peg singleton kmers
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k",))
def _flat_kmers(codes, lengths_bcast, pos_in_seq, k: int):
    """Packed kmers + peg-path validity over a flat protein token stream:
    Q1 (drop the final kmer: pos < len - k, strict) and Q2 peg path
    ('X'-only rejection — KmerReference.java:134-139)."""
    from ..ops.encode import PROT_X
    from ..ops.kmers import window_any
    lo, hi = pack_kmer_windows(codes, k)
    bad = (codes == PROT_X) | (codes >= PROT_PAD)
    has_bad = window_any(bad, k)
    valid = (pos_in_seq < lengths_bcast - k) & ~has_bad
    return lo, hi, valid


def peg_singleton_kmers(genome: Genome, k: int = 8):
    """Unique peg kmers of a genome: (lo, hi, peg_index) arrays plus the
    peg list (Q5 — only kmers occurring exactly once genome-wide)."""
    pegs = [f for f in genome.pegs if f.protein_translation]
    if not pegs:
        return (np.zeros(0, np.uint32), np.zeros(0, np.uint32),
                np.zeros(0, np.int32), pegs)
    proteins = [f.protein_translation for f in pegs]
    lengths = np.array([len(p) for p in proteins], np.int64)
    total = int(lengths.sum())
    width = _bucket(total, 4096)
    got = native.flat_peg_batch(proteins, width, -1)
    if got is not None:  # C++ data loader (kan_host.cpp)
        codes, peg_of, pos_in_seq, len_bcast = got
    else:
        codes = np.full(width, PROT_PAD, np.uint8)
        peg_of = np.full(width, -1, np.int32)
        len_bcast = np.zeros(width, np.int32)
        pos_in_seq = np.zeros(width, np.int32)
        pos = 0
        for i, f in enumerate(pegs):
            ln = lengths[i]
            codes[pos: pos + ln] = encode_protein(f.protein_translation)
            peg_of[pos: pos + ln] = i
            len_bcast[pos: pos + ln] = ln
            pos_in_seq[pos: pos + ln] = np.arange(ln)
            pos += ln
    if native.available():
        # host fast path: vectorized NumPy pack + C++ group-by — no
        # device round-trips (Q1 strict drop-last, Q2 'X'-only rejection)
        from ..ops.encode import PROT_X
        from .signature import pack_kmers_np
        lo, hi = pack_kmers_np(codes, k)
        nw = len(lo)
        bad = (codes == PROT_X) | (codes >= PROT_PAD)
        has_bad = np.zeros(nw, bool)
        for j in range(k):
            has_bad |= bad[j: j + nw]
        valid = ((pos_in_seq[:nw] < len_bcast[:nw] - k) & ~has_bad)
        lo, hi, peg_idx = lo[valid], hi[valid], peg_of[:nw][valid]
        order, ustarts = native.groupby(lo, hi)
        counts = np.diff(np.append(ustarts, len(lo)))
        sel = order[ustarts[counts == 1]]
        return lo[sel], hi[sel], peg_idx[sel], pegs

    lo, hi, valid = _flat_kmers(jnp.asarray(codes), jnp.asarray(len_bcast),
                                jnp.asarray(pos_in_seq), k)
    valid = np.asarray(valid)
    lo = np.asarray(lo)[valid]
    hi = np.asarray(hi)[valid]
    peg_idx = peg_of[valid]

    # singletons via device sort group-by
    slo, shi, spay, first, seg, counts = _sort_with_payload(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(peg_idx))
    first = np.asarray(first)
    counts = np.asarray(counts)
    starts = np.flatnonzero(first)
    singles = counts[: len(starts)] == 1
    sel = starts[singles]
    return (np.asarray(slo)[sel], np.asarray(shi)[sel],
            np.asarray(spay)[sel], pegs)


# ---------------------------------------------------------------------------
# the annotator
# ---------------------------------------------------------------------------

class _PegInfo(NamedTuple):
    """The slice of a close-genome Feature the window scan needs (kept
    in the device-table cache instead of whole Genome objects)."""

    id: str
    function: str
    protein_length: int


@dataclass
class _CloseSet:
    """Device-resident state for one ordered set of close genomes (the
    fused-scan path): stacked singleton tables + union table + per-peg
    threshold arrays, cached across the new genomes of a batch run."""

    tables: jnp.ndarray          # (G, rows, 72) uint32
    salts: jnp.ndarray           # (G,) uint32
    pinfo: jnp.ndarray           # (G, 3, Pmax) int32
    union_table: jnp.ndarray     # (Ru, 72) uint32
    union_salt: jnp.ndarray      # uint32 scalar
    union_mp: int
    mp_max: int
    peg_infos: list              # per live genome: list[_PegInfo]
    n_singles: list              # per INPUT genome (zeros included)
    live_map: list               # live genome → input genome position
    n_union_keys: int
    max_delta: int               # max maxlen3 across genomes
    ucap_hint: int = 0


class ProjectionAnnotator:
    """Annotates genomes by projecting close-genome proteins onto ORFs."""

    def __init__(self, min_strength: float = 0.50, max_fuzz: float = 1.5,
                 min_fuzz: float = 0.8, max_genomes: int = 10,
                 min_evidence: int = 10, k: int = 8,
                 algorithm: str = "AGGRESSIVE",
                 trace_function: str | None = None,
                 engine: str = "auto",
                 table_cache_bytes: int = 4 << 30):
        if engine not in ("auto", "device", "host"):
            raise ValueError(f"unknown projection engine {engine!r}")
        if min_strength >= 1.0:
            raise ValueError("Minimum strength must be less than 1.")
        if max_fuzz <= 1.0:
            raise ValueError("Max length factor must be greater than 1.")
        if min_fuzz > 1.0:
            raise ValueError(
                "Min length factor must be less than or equal to 1.")
        self.min_strength = min_strength
        self.max_fuzz = max_fuzz
        self.min_fuzz = min_fuzz
        self.max_genomes = max_genomes
        self.min_evidence = min_evidence
        self.k = k
        self.strict = algorithm.upper() == "STRICT"
        self.trace_function = trace_function
        self.engine = engine
        self.table_cache_bytes = table_cache_bytes
        self._table_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._singleton_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._closeset_cache: "OrderedDict[tuple, _CloseSet]" = OrderedDict()
        self._pcap_hint = 1 << 14
        self._lcap_hint = 1 << 14
        self._scap_hint = 1 << 13
        self._minev_cache: dict[int, jnp.ndarray] = {}

    def _minev_for(self, index: "StreamWindowIndex"):
        """Device weak-filter threshold table covering this genome's
        longest possible extended ORF (float64-exact — _min_ev_table)."""
        size = _bucket(int(index.seg_len.max(initial=1)) + 2, 1 << 16)
        got = self._minev_cache.get(size)
        if got is None:
            got = jnp.asarray(
                _min_ev_table(self.min_strength / 3, size))
            self._minev_cache[size] = got
        return got

    def _use_stream_index(self) -> bool:
        """Device stream path on accelerators; host index on plain CPU."""
        if self.engine != "auto":
            return self.engine == "device"
        return jax.default_backend() != "cpu"

    def annotate_genome(self, genome: Genome, close_loader) -> dict:
        """Annotate in place; close_loader(genome_id) → Genome | None.

        Returns the proposal statistics dict.
        """
        k = self.k
        log.info("Annotating proposed genome %s: %s", genome.id, genome.name)
        real_strength = self.min_strength / 3          # Q3
        proposals = PegProposalList(genome, real_strength,
                                    self.min_evidence)
        if self._use_stream_index():
            index = StreamWindowIndex.build(genome, k, strict=self.strict)
            log.info("%d kmer windows found in genome.", index.n_windows)
        else:
            index = ContigKmerIndex.build(genome, k, strict=self.strict)
            log.info("%d kmers found in genome.", index.n_unique)
        close = genome.close_genomes
        log.info("%d close genomes available from input.", len(close))
        i_genome = 1
        loaded = []
        for cg in close:
            if i_genome > self.max_genomes:
                break
            log.info("Retrieving close genome #%d %s: %s.", i_genome,
                     cg.genome_id, cg.genome_name)
            old_genome = close_loader(cg.genome_id)
            if old_genome is None:
                log.warning("Genome %s not found-- skipping.", cg.genome_id)
                continue
            i_genome += 1
            loaded.append(old_genome)
        if isinstance(index, StreamWindowIndex):
            self._project_all_stream(loaded, index, proposals)
        else:
            for old_genome in loaded:
                self._project_from(old_genome, index, proposals)
        log.info("%d proposals made, %d merged, %d rejected, %d too weak, "
                 "%d too little evidence, %d kept.", proposals.made,
                 proposals.merged, proposals.rejected, proposals.weak,
                 proposals.small, proposals.count)
        # emit features in numbering order (Q8)
        peg_count = 0
        xlator = DnaTranslator(genome.genetic_code)
        for prop in proposals:
            peg_count += 1
            self._make_feature(prop, genome, peg_count, xlator)
        log.info("Processing complete. %d features in genome.", peg_count)
        return {
            "made": proposals.made, "merged": proposals.merged,
            "rejected": proposals.rejected, "weak": proposals.weak,
            "small": proposals.small, "kept": proposals.count,
            "pegs": peg_count,
        }

    # ----- per close genome -----

    # ----- close-genome singleton tables (device-resident, cached) -----

    def _close_table(self, old_genome: Genome):
        """Device singleton table for one close genome, LRU-cached by
        (genome id, k).

        The reference recounts peg kmers per (new genome x close genome)
        pair (KmerProcessor.java:195); a batch run reuses the same ~10
        close genomes for every input genome, so memoizing the built
        table removes both the singleton recount AND the host-to-device
        push from the steady state (semantically identical: the table
        depends only on the close genome).
        """
        key = (old_genome.id, self.k)
        got = self._table_cache.get(key)
        if got is not None:
            self._table_cache.move_to_end(key)
            return got
        lo, hi, peg_idx, pegs = peg_singleton_kmers(old_genome, self.k)
        peg_info = [_PegInfo(f.id, f.function, f.protein_length)
                    for f in pegs]
        n = len(lo)
        if n == 0:
            got = (None, 0, None, 0, peg_info)
        else:
            n_pad = _bucket(n, 4096)
            s_lo = np.full(n_pad, 0xFFFFFFFF, np.uint32)
            s_hi = np.full(n_pad, 0xFFFFFFFF, np.uint32)
            s_peg = np.zeros(n_pad, np.uint32)
            s_lo[:n] = lo
            s_hi[:n] = hi
            s_peg[:n] = peg_idx
            d_args = (jnp.asarray(s_lo), jnp.asarray(s_hi),
                      jnp.asarray(s_peg))
            n_rows = wide_rows_for(n_pad)
            if n_rows is not None:
                # wide-bucket layout: rows stay in the fast-gather zone
                # and every stream lookup is ONE row gather
                table, bad = _build_singleton_wide(*d_args, n_rows)
                if bool(bad):
                    # one-in-hundreds salt failure: host salt-retry build
                    log.info("device wide build of %d keys overflowed; "
                             "host salt-retry build", n)
                    htab, hsalt, hmp = build_wide_table(
                        lo, hi, peg_idx.astype(np.uint32))
                    got = (jnp.asarray(htab), hmp, hsalt, n, peg_info)
                else:
                    got = (table, 1, 0, n, peg_info)
            else:
                # huge singleton set: 8-slot bucketed device build
                table, bad = _build_singleton_table(
                    *d_args, device_table_buckets(n_pad))
                if bool(bad):
                    log.warning("device singleton-table build overflowed "
                                "(%d keys); using the host build", n)
                    htable, mp = build_table(lo, hi,
                                             peg_idx.astype(np.uint32))
                    got = (jnp.asarray(htable), mp, None, n, peg_info)
                else:
                    got = (table, MAX_DEVICE_PROBES, None, n, peg_info)
        self._table_cache[key] = got
        total = sum(e[0].nbytes for e in self._table_cache.values()
                    if e[0] is not None)
        while total > self.table_cache_bytes and len(self._table_cache) > 1:
            _, e = self._table_cache.popitem(last=False)
            if e[0] is not None:
                total -= e[0].nbytes
        return got

    def _singletons(self, genome: Genome):
        """Host singleton kmers of a close genome, LRU-cached by id."""
        key = (genome.id, self.k)
        got = self._singleton_cache.get(key)
        if got is not None:
            self._singleton_cache.move_to_end(key)
            return got
        lo, hi, peg_idx, pegs = peg_singleton_kmers(genome, self.k)
        peg_info = [_PegInfo(f.id, f.function, f.protein_length)
                    for f in pegs]
        got = (lo, hi, np.asarray(peg_idx, np.uint32), peg_info)
        self._singleton_cache[key] = got
        while len(self._singleton_cache) > 64:
            self._singleton_cache.popitem(last=False)
        return got

    def _close_set(self, olds: list) -> "_CloseSet | None":
        """Build (or fetch) the fused-scan device state for this ordered
        close-genome set; None when any genome exceeds the packed-key
        field widths or the wide-table capacity (RLE fallback)."""
        key = (tuple(og.id for og in olds), self.k)
        cs = self._closeset_cache.get(key)
        if cs is not None:
            self._closeset_cache.move_to_end(key)
            return cs
        singles = [self._singletons(og) for og in olds]
        n_singles = [len(s[0]) for s in singles]
        live = [(i, s) for i, s in enumerate(singles) if len(s[0])]
        if not live:
            return None
        rows_list = []
        for _, s in live:
            if len(s[3]) > (1 << _PEG_BITS):
                return None
            r = wide_rows_for(_bucket(len(s[0]), 4096))
            if r is None:
                return None                     # huge singleton set
            rows_list.append(r)
        # union of all singleton kmers across the set
        keys64 = np.unique(np.concatenate(
            [(s[1].astype(np.uint64) << np.uint64(32))
             | s[0].astype(np.uint64) for _, s in live]))
        if wide_rows_for(len(keys64)) is None:
            return None
        u_lo = (keys64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        u_hi = (keys64 >> np.uint64(32)).astype(np.uint32)
        utab, usalt, ump = build_wide_table(
            u_lo, u_hi, np.zeros(len(u_lo), np.uint32))
        rows_common = max(rows_list)
        tables, salts, mps = [], [], []
        for _, s in live:
            lo, hi, peg_idx, _ = s
            n = len(lo)
            n_pad = _bucket(n, 4096)
            s_lo = np.full(n_pad, 0xFFFFFFFF, np.uint32)
            s_hi = np.full(n_pad, 0xFFFFFFFF, np.uint32)
            s_peg = np.zeros(n_pad, np.uint32)
            s_lo[:n], s_hi[:n], s_peg[:n] = lo, hi, peg_idx
            table, bad = _build_singleton_wide(
                jnp.asarray(s_lo), jnp.asarray(s_hi), jnp.asarray(s_peg),
                rows_common)
            if bool(bad):
                htab, hsalt, hmp = build_wide_table(
                    lo, hi, peg_idx, n_rows=rows_common)
                tables.append(jnp.asarray(htab))
                salts.append(hsalt)
                mps.append(hmp)
            else:
                tables.append(table)
                salts.append(0)
                mps.append(1)
        pmax = _bucket(max(len(s[3]) for _, s in live), 1024)
        pinfo = np.zeros((len(live), 3, pmax), np.int32)
        pinfo[:, 2, :] = 1 << 30              # pad pegs: never group_ok
        max_delta = 0
        for j, (_, s) in enumerate(live):
            plen3 = np.fromiter((p.protein_length for p in s[3]),
                                np.int64, len(s[3])) * 3
            maxlen3 = (plen3 * self.max_fuzz + 1).astype(np.int64)
            pinfo[j, 0, : len(plen3)] = maxlen3
            pinfo[j, 1, : len(plen3)] = (plen3 * self.min_fuzz
                                         ).astype(np.int64)
            pinfo[j, 2, : len(plen3)] = (plen3 * (self.min_strength / 3)
                                         ).astype(np.int64)
            if len(maxlen3):
                max_delta = max(max_delta, int(maxlen3.max()))
        cs = _CloseSet(
            tables=jnp.stack(tables),
            salts=jnp.asarray(np.array(salts, np.uint32)),
            pinfo=jnp.asarray(pinfo),
            union_table=jnp.asarray(utab),
            union_salt=jnp.uint32(usalt),
            union_mp=ump, mp_max=max(mps),
            peg_infos=[s[3] for _, s in live],
            n_singles=n_singles,
            live_map=[i for i, _ in live],
            n_union_keys=len(keys64), max_delta=max_delta)
        self._closeset_cache[key] = cs
        while len(self._closeset_cache) > 4:
            self._closeset_cache.popitem(last=False)
        return cs

    def _project_all_stream(self, olds: list, index: StreamWindowIndex,
                            proposals: PegProposalList) -> None:
        """Fused union-probe + device window-scan path; RLE fallback when
        the packed-key fields or wide-table capacity don't fit."""
        if not olds:
            return
        cs = self._close_set(olds)
        if (cs is None
                or len(index.contig_ids) > (1 << _CONTIG_BITS)
                or (int(index.seg_len.max(initial=0)) + cs.max_delta
                    + 3 * self.k) >= (1 << _LEFT_BITS)):
            return self._project_all_stream_rle(olds, index, proposals)
        for og, n in zip(olds, cs.n_singles):
            log.info("%d unique peg kmers in %s.", n, og.id)
        n_stream = int(index.d_lo.shape[0])
        g = len(cs.peg_infos)
        d_segs = (jnp.asarray(index.seg_start.astype(np.int32)),
                  jnp.asarray(index.seg_contig),
                  jnp.asarray(index.seg_strand),
                  jnp.asarray(index.seg_len.astype(np.int32)))
        scans, orf_off, contig_len = index.orf_state()
        minev = self._minev_for(index)
        # union hits rarely exceed the union key count (multi-location
        # kmers are the exception); the retry loop covers the exception,
        # so size for the common case — every per-element device pass
        # downstream scales with ucap
        ucap = cs.ucap_hint or min(
            _bucket(cs.n_union_keys + 4096, 1 << 16), n_stream)
        pcap = self._pcap_hint
        lcap = self._lcap_hint
        scap = self._scap_hint
        while True:
            ucap_eff = min(ucap, n_stream)
            pcap_eff = min(pcap, ucap_eff)
            lcap_eff = min(lcap, pcap_eff)
            scap_eff = min(scap, lcap_eff)
            u = _union_compact(
                cs.union_table, cs.union_salt, index.d_lo, index.d_hi,
                index.d_valid, *d_segs, k=self.k, ucap=ucap_eff,
                max_probes=cs.union_mp)
            flat = _scan_genomes(
                cs.tables, cs.salts, cs.pinfo, *u,
                scans, orf_off, contig_len, minev,
                jnp.int32(self.min_evidence),
                k=self.k, ucap=ucap_eff, pcap=pcap_eff, lcap=lcap_eff,
                scap=scap_eff, max_probes=cs.mp_max)
            buf = np.asarray(flat)              # the ONE host pull
            nc = g * scap_eff * 8
            rows_all = buf[:nc].reshape(g, scap_eff, 8)
            stats = buf[nc: nc + g * 10].reshape(g, 10)
            n_union = int(buf[-1])
            if n_union > ucap_eff and ucap_eff < n_stream:
                ucap = min(max(ucap * 2, _bucket(n_union, 1 << 16)),
                           n_stream)
                continue
            max_cand = int(stats[:, 9].max(initial=0))
            if max_cand > pcap_eff:
                pcap = _bucket(max_cand, pcap_eff * 2)
                continue
            max_live = int(stats[:, 4].max(initial=0))
            if max_live > lcap_eff:
                lcap = _bucket(max_live, lcap_eff * 2)
                continue
            max_stored = int(stats[:, 8].max(initial=0))
            if max_stored > scap_eff:
                scap = _bucket(max_stored, scap_eff * 2)
                continue
            break
        cs.ucap_hint = ucap
        self._pcap_hint = pcap
        self._lcap_hint = lcap
        self._scap_hint = scap
        for j in range(g):
            (n_hits, n_groups, low_kmer, too_short, n_live,
             n_rej, n_weak, n_small, n_stored, _n_cand) = (
                int(v) for v in stats[j])
            log.info("%d matching kmers found.", n_hits)
            if n_hits == 0:
                continue
            peg_info = cs.peg_infos[j]
            rows = rows_all[j, :n_stored].astype(np.int64)
            funcs = [p.function for p in peg_info]
            stored = proposals.replay_stored(
                rows, index.contig_ids, funcs, made=n_live,
                rejected=n_rej, weak=n_weak, small=n_small)
            if self.trace_function is not None:
                for ci, prop in stored:
                    if prop.function != self.trace_function:
                        continue
                    peg = peg_info[int(rows[ci, 5])]
                    whole = Location(
                        index.contig_ids[int(rows[ci, 0])],
                        "+" if rows[ci, 1] == 0 else "-",
                        int(rows[ci, 6]), int(rows[ci, 7]))
                    log.info("Proposal stored using %s at location %s "
                             "with evidence %d and strength %s.", peg.id,
                             whole, int(rows[ci, 4]), prop.strength)
            log.info("%d peg/frame pairs examined, %d had too few kmers, "
                     "%d were too short, %d proposals were made.",
                     n_groups, low_kmer, too_short, n_live)

    def _project_all_stream_rle(self, olds: list,
                                index: StreamWindowIndex,
                                proposals: PegProposalList) -> None:
        """Project every close genome through ONE multi-table device call
        (_probe_rle_multi) against the cached singleton tables, then
        expand RLE hits and scan/propose per genome in order -- proposal
        insertion order matches the sequential reference loop
        (KmerProcessor.java:183-270) exactly."""
        n_stream = index.d_lo.shape[0]
        entries = [self._close_table(og) for og in olds]
        for og, entry in zip(olds, entries):
            log.info("%d unique peg kmers in %s.", entry[3], og.id)
        live = [e for e in entries if e[0] is not None]
        if not live:
            return
        max_single = max(e[3] for e in live)
        # clamp to the TRUE stream length, not its power-of-two bucket:
        # n_stream can be 3·2^(m-1)·8192 and a pow2 clamp could exceed
        # it, tripping the shape guard in _rle_body (ADVICE r4)
        cap = min(_bucket(2 * max_single + 4096, 1 << 14), n_stream)
        rcap = min(_bucket(max(max_single // 8, 1), 1 << 14), cap)
        tables = tuple(e[0] for e in live)
        meta = tuple((e[1], e[2]) for e in live)
        while True:
            starts_b, pegs_b, lens_b, n_runs_d, n_hits_d = _probe_rle_multi(
                tables, index.d_lo, index.d_hi, index.d_valid,
                cap=cap, rcap=rcap, meta=meta)
            n_hits_a = np.asarray(n_hits_d)
            n_runs_a = np.asarray(n_runs_d)
            if int(n_hits_a.max()) <= cap and int(n_runs_a.max()) <= rcap:
                break
            cap = min(max(cap * 2, _bucket(int(n_hits_a.max()), 1 << 14)),
                      n_stream)
            rcap = min(max(rcap * 2,
                           _bucket(max(int(n_runs_a.max()), 1), 1 << 14)),
                       cap)
        starts_all = np.asarray(starts_b)          # (G, rcap): ONE pull
        pegs_all = np.asarray(pegs_b)
        lens_all = np.asarray(lens_b)
        for j, (_, _, _, _, peg_info) in enumerate(live):
            n_hits = int(n_hits_a[j])
            n_runs = int(n_runs_a[j])
            log.info("%d matching kmers found.", n_hits)
            if n_hits == 0:
                continue
            starts = starts_all[j, :n_runs].astype(np.int64)
            lens = lens_all[j, :n_runs].astype(np.int64)
            run_peg = pegs_all[j, :n_runs]
            base = np.repeat(np.cumsum(lens) - lens, lens)
            pos = np.repeat(starts, lens) + np.arange(n_hits) - base
            pair_peg = np.repeat(run_peg, lens).astype(np.int32)
            l_contig, l_strand, l_left = index.locate(pos)
            self._scan_and_propose(l_contig, l_strand, l_left, pair_peg,
                                   peg_info, index.contig_ids, proposals)

    def _project_from(self, old_genome: Genome, index: ContigKmerIndex,
                      proposals: PegProposalList) -> None:
        k = self.k
        lo, hi, peg_idx, pegs = peg_singleton_kmers(old_genome, k)
        log.info("%d unique peg kmers in %s.", len(lo), old_genome.id)
        if not len(lo):
            return
        got = self._match_host_index(index, lo, hi, peg_idx)
        if got is None:
            return
        l_contig, l_strand, l_left, pair_peg = got
        log.info("%d matching kmers found.", len(l_left))
        self._scan_and_propose(l_contig, l_strand, l_left, pair_peg,
                               pegs, index.contig_ids, proposals)

    def _match_host_index(self, index: ContigKmerIndex, lo, hi, peg_idx):
        """Probe singletons into the host contig index + CSR expansion."""
        ranks = np.asarray(probe_table(
            index.table, jnp.asarray(lo), jnp.asarray(hi),
            jnp.ones(len(lo), bool), index.max_probes))
        hit = ranks >= 0
        ranks = ranks[hit]
        peg_hit = peg_idx[hit]
        if not len(ranks):
            return None
        # CSR expansion: each (peg, rank) pair fans out to counts[rank] locs
        counts = index.counts[ranks]
        starts = index.starts[ranks]
        total = int(counts.sum())
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
        loc_idx = np.repeat(starts, counts) + offs
        pair_peg = np.repeat(peg_hit, counts)
        return (index.loc_contig[loc_idx], index.loc_strand[loc_idx],
                index.loc_left[loc_idx], pair_peg)

    def _scan_and_propose(self, l_contig, l_strand, l_left, pair_peg,
                          pegs, contig_ids, proposals) -> None:
        """Shared window-scan tail (Q6/Q7): identical for both match
        paths — the (frame, peg, contig, left) sort fully determines
        candidate order, so the pair source order never matters."""
        k = self.k
        l_right = l_left + 3 * k - 1                 # Q4: span 3K bases

        # frame of each location: '+' → P(left%3), '-' → M(right%3)
        frame = np.where(l_strand == 0, 3 + l_left % 3, l_right % 3)
        # group by (frame, peg): matches FramedLocationLists bucketing.
        # A single packed-key argsort is ~2-3× faster than the 4-key
        # lexsort; fall back when the packed key would not fit 63 bits.
        bits_peg = max(int(pair_peg.max(initial=0)), 1).bit_length()
        bits_con = max(int(l_contig.max(initial=0)), 1).bit_length()
        bits_left = max(int(l_left.max(initial=0)), 1).bit_length()
        if 3 + bits_peg + bits_con + bits_left <= 63:
            key = (((frame.astype(np.int64) << bits_peg
                     | pair_peg) << bits_con | l_contig)
                   << bits_left) | l_left
            order = np.argsort(key, kind="stable")
        else:
            order = np.lexsort((l_left, l_contig, pair_peg, frame))
        g_frame = frame[order]
        g_peg = pair_peg[order]
        boundary = np.flatnonzero(
            (g_frame[1:] != g_frame[:-1]) | (g_peg[1:] != g_peg[:-1]))
        group_starts = np.concatenate([[0], boundary + 1])
        group_ends = np.concatenate([boundary + 1, [len(order)]])

        # ---- vectorized window scan (Q6, KmerProcessor.java:240-254) ----
        # Group rows are sorted by (contig, left) and every location spans
        # exactly 3K-1 bases, so within a (group, contig) run the rights are
        # monotone: each start's evidence window [i+1, ub) is contiguous and
        # ub comes from ONE global searchsorted, its best edge is rights[ub-1].
        # This turns the reference's O(n^2) per-frame scan into O(n log n)
        # over all groups at once, preserving candidate order exactly.
        m = len(order)
        s_contig = l_contig[order]
        s_left = l_left[order].astype(np.int64)
        s_right = l_right[order].astype(np.int64)
        group_id = np.zeros(m, np.int64)
        group_id[group_starts[1:]] = 1
        group_id = np.cumsum(group_id)
        run_first = np.ones(m, bool)
        run_first[1:] = ((group_id[1:] != group_id[:-1])
                         | (s_contig[1:] != s_contig[:-1]))
        run_id = np.cumsum(run_first) - 1

        n_groups = len(group_starts)
        sizes = group_ends - group_starts
        plen3 = np.fromiter((p.protein_length for p in pegs),
                            np.int64, len(pegs)) * 3
        peg_lens = plen3[g_peg[group_starts]]
        max_lens = (peg_lens * self.max_fuzz + 1).astype(np.int64)
        min_lens = (peg_lens * self.min_fuzz).astype(np.int64)
        min_kmers = (peg_lens * (self.min_strength / 3)).astype(np.int64)
        group_ok = min_kmers <= sizes
        pegs_found = n_groups
        low_kmer = int((~group_ok).sum())

        # per-element candidacy: i_local <= size - min_kmers, group viable
        i_local = np.arange(m) - np.repeat(group_starts, sizes)
        cand = group_ok[group_id] & (
            i_local <= (sizes - min_kmers)[group_id])
        # segmented searchsorted via run-offset keys (contig edges < 2^34)
        OFF = np.int64(1) << 40
        keys = run_id * OFF + s_right
        max_edge = s_left + max_lens[group_id]
        ub = np.searchsorted(keys, run_id * OFF + max_edge, side="left")
        evidence_v = np.maximum(ub - np.arange(m) - 1, 0) + 1
        best_edge_v = s_right[np.maximum(ub - 1, np.arange(m))]
        min_edge = s_left + min_lens[group_id]
        short = cand & (best_edge_v < min_edge)
        too_short = int(short.sum())
        live = np.flatnonzero(cand & ~short)

        proposal_count = len(live)
        # one vectorized extend+filter+dedup pass over all live candidates
        # (counter- and result-identical to per-candidate propose calls)
        cand_peg = g_peg[group_starts][group_id[live]]
        peg_funcs = [f.function for f in pegs]
        stored = proposals.propose_batch(
            s_contig[live].astype(np.int64), contig_ids,
            l_strand[order[live]].astype(np.int64),
            s_left[live], best_edge_v[live], evidence_v[live],
            cand_peg, peg_funcs)
        if self.trace_function is not None:
            for ci, prop in stored:
                if prop.function != self.trace_function:
                    continue
                gi = live[ci]
                peg = pegs[cand_peg[ci]]
                whole = Location(contig_ids[int(s_contig[gi])],
                                 "+" if l_strand[order[gi]] == 0 else "-",
                                 int(s_left[gi]), int(best_edge_v[gi]))
                log.info("Proposal stored using %s at location %s with "
                         "evidence %d and strength %s.", peg.id, whole,
                         int(evidence_v[gi]), prop.strength)
        log.info("%d peg/frame pairs examined, %d had too few kmers, "
                 "%d were too short, %d proposals were made.",
                 pegs_found, low_kmer, too_short, proposal_count)

    # ----- feature emission (Q8) -----

    @staticmethod
    def _make_feature(proposal, genome: Genome, peg_num: int,
                      xlator: DnaTranslator) -> None:
        fid = f"fig|{genome.id}.peg.{peg_num}"
        loc = proposal.loc
        feat = Feature.create(fid, proposal.function, loc.contig_id,
                              loc.strand, loc.left, loc.right)
        dna = genome.get_dna(loc)
        prot = xlator.peg_translate(dna, 1, len(dna) - 3)
        feat.protein_translation = prot
        feat.add_annotation(
            "Annotated with evidence %d and strength %2.4f"
            % (proposal.evidence, proposal.strength), TOOL_NAME)
        feat.add_annotation("Set function to " + proposal.function,
                            TOOL_NAME)
        genome.add_feature(feat)
