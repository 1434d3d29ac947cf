"""Kmer-hash similarity annotation engine (``hashAnno`` command,
HashAnnotationProcessor.java:63-330).

Implements the contract of the external ``GenomeProteinKmers``/``Prototype``
classes (SURVEY.md §2b) with a device-probed design:

* A genome's usable proteins (non-blank, no '*') are deduplicated by MD5
  and their DISTINCT kmers become a device CSR: unique kmer → list of
  protein indices, fronted by the bucketed probe table.
* Every protein starts with the **default proposal** (its old annotation at
  similarity 0.0) — this is why the reference's per-feature output can show
  score 0.0 = "defaulted" (Q12, HashAnnotationProcessor.java:297).
* Prototypes are scored in chunks entirely on device: one probe of all
  chunk kmers, then a **dense pair-count kernel** — each hit scatters its
  kmer's owner proteins (a fixed-width owner matrix, one gather) into an
  (n_prototypes, n_proteins) common-count matrix, similarity is computed
  densely, and the per-protein best prototype is one masked row argmax.
  No sort, no host np.unique, no data-dependent shapes: everything is
  scatter-add + elementwise + reduction.
  Similarity is the Jaccard similarity of distinct kmer sets |∩| / |∪| —
  the SEED convention (``ProteinKmers.distance`` is the matching Jaccard
  distance, SURVEY.md §2b ProteinKmers row; the 0.0125 default floor ≈
  1/80 of shared kmers).
* A proposal improves only on strictly greater similarity, and must meet
  the minScore floor; within a chunk, the earliest prototype wins ties
  (jnp.argmax's first-max rule) — matching the reference's sequential
  first-wins processing order.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from functools import partial

import jax

from .. import native
from ..genome.gto import Genome, protein_md5
from ..ops.encode import PROT_PAD, encode_protein
from ..ops.hashtable import build_table, probe_table
from ..ops.kmers import pack_kmer_windows
from .apply_engine import _bucket

log = logging.getLogger(__name__)


@partial(jax.jit, static_argnames=("k",))
def _pack(codes, k: int):
    return pack_kmer_windows(codes, k)


# dense (prototypes × proteins) chunks are capped at this many cells
DENSE_CELLS = 1 << 26

# owner-matrix width cap: one highly duplicated protein family (dozens of
# identical transposase copies sharing every kmer) would otherwise inflate
# the (U, cap) matrix genome-wide to multi-GB (ADVICE r2).  Kmers with more
# owners keep their first OWNER_CAP in the device matrix; the overflow
# owners live in a host CSR and are added to the common-count matrix after
# the device step (it returns to the host for float64 Jaccard anyway).
OWNER_CAP = 32


@partial(jax.jit, static_argnames=("n_prot", "n_proto"))
def _chunk_best(owner_mat, ranks, proto_of, n1, n2, minc,
                state_c, state_u, state_i, state_m, chunk_base,
                *, n_prot: int, n_proto: int):
    """Common-count matrix + EXACT best-proposal reduction, all device.

    The r3 design pulled the whole (n_proto, n_prot) common matrix per
    chunk for host float64 Jaccard (~33 MB/chunk — the pull dominated
    the engine).  Similarities here are small rationals c/u with
    c, u < 2^15 (GenomeProteinKmers guards the protein length), so:

    * distinct sims differ by ≥ 1/(u1·u2) ≫ f64 ulp — INTEGER
      cross-multiplication (c1·u2 vs c2·u1, exact in int32) decides
      exactly what the reference's Java double compares decide;
    * the min-score floor uses a host-precomputed f64-exact threshold
      table (minc[u] = smallest c with c/u >= minScore as doubles).

    A log2 tournament over the prototype axis keeps the FIRST maximum
    (earliest prototype wins ties, the sequential processing order);
    the running best (c, u, global prototype index) per protein is
    device state threaded across chunks, improved only on strictly
    greater similarity.  state_m counts improvement events.
    returns updated (state_c, state_u, state_i, state_m).
    """
    common = _chunk_commons_body(owner_mat, ranks, proto_of,
                                 n_prot=n_prot, n_proto=n_proto)
    c = common                                      # (R, P)
    u = n1[None, :] + n2[:, None] - c
    uc = jnp.clip(u, 1, minc.shape[0] - 1)
    c = jnp.where(c >= minc[uc], c, 0)              # min-score floor
    cc, uu = c, jnp.where(c > 0, u, 1)
    ii = jax.lax.broadcasted_iota(jnp.int32, cc.shape, 0)
    r = cc.shape[0]
    while r > 1:                                    # first-max tournament
        half = r // 2
        c1, u1, i1 = cc[:half], uu[:half], ii[:half]
        c2, u2, i2 = cc[half:], uu[half:], ii[half:]
        p1 = c1 * u2
        p2 = c2 * u1
        win1 = (p1 > p2) | ((p1 == p2) & (i1 < i2))
        cc = jnp.where(win1, c1, c2)
        uu = jnp.where(win1, u1, u2)
        ii = jnp.where(win1, i1, i2)
        r = half
    bc, bu, bi = cc[0], uu[0], ii[0]
    improved = (bc > 0) & (bc * state_u > state_c * bu)
    return (jnp.where(improved, bc, state_c),
            jnp.where(improved, bu, state_u),
            jnp.where(improved, chunk_base + bi, state_i),
            state_m + jnp.sum(improved.astype(jnp.int32)))


def _chunk_commons_body(owner_mat, ranks, proto_of, *, n_prot: int,
                        n_proto: int):
    """Dense common-kmer count matrix for one prototype chunk (device).

    owner_mat: (U, cap) int32 — owner protein indices per unique genome
               kmer rank, padded with n_prot
    ranks:     (H,) int32 — probed rank per chunk kmer, -1 = miss/padding
    proto_of:  (H,) int32 — prototype index per chunk kmer
    returns (n_proto, n_prot) int32 — |kmers(prototype) ∩ kmers(protein)|

    The combinatorial work (CSR expansion + per-pair counting, the old
    host np.unique explosion) is one gather + one scatter-add here; the
    final Jaccard + argmax stays on the host in float64 so scores are
    bit-identical to the reference's Java doubles (device float32 would
    reorder near-ties).
    """
    hit = ranks >= 0
    owners = jnp.where(hit[:, None],
                       owner_mat[jnp.maximum(ranks, 0)], n_prot)  # (H, cap)
    proto = jnp.where(hit, proto_of, n_proto)
    idx = proto[:, None] * (n_prot + 1) + owners
    common = jax.ops.segment_sum(
        jnp.ones(idx.size, jnp.int32), idx.reshape(-1),
        num_segments=(n_proto + 1) * (n_prot + 1))
    return common.reshape(n_proto + 1, n_prot + 1)[:n_proto, :n_prot]


@partial(jax.jit, static_argnames=("n_prot", "n_proto"))
def _chunk_commons(owner_mat, ranks, proto_of, *, n_prot: int,
                   n_proto: int):
    """Standalone common-matrix jit (the host-float64 fallback path —
    heavy-owner CSR genomes and >16k-aa proteins)."""
    return _chunk_commons_body(owner_mat, ranks, proto_of,
                               n_prot=n_prot, n_proto=n_proto)


@dataclass
class Prototype:
    """One row of the role annotation file (protein, annotation)."""

    protein: str
    annotation: str


class RateLogger:
    """Every-N-seconds progress rate logger (the reference logs prototype
    lines/second every 5 s — HashAnnotationProcessor.java:265-270)."""

    def __init__(self, unit: str = "lines", interval: float = 5.0):
        self.unit = unit
        self.interval = interval
        self.start = time.time()
        self._last = self.start
        self.n = 0

    def add(self, n: int) -> None:
        self.n += n
        now = time.time()
        if now - self._last >= self.interval:
            rate = self.n / max(now - self.start, 1e-9)
            log.info("%d %s processed (%.0f %s/second).",
                     self.n, self.unit, rate, self.unit)
            self._last = now


class PrototypeSet:
    """Prototype kmers packed once and reused across every genome.

    The reference re-walks the prototype list per genome
    (HashAnnotationProcessor.java:259-263); here the chunked, packed,
    device-resident query arrays are cached per chunk size, so an N-genome
    run pays the prototype encode/pack/upload cost once, not N times.
    """

    def __init__(self, protos: list[Prototype], k: int):
        self.protos = protos
        self.k = k
        self._cache: dict[int, list] = {}

    def __len__(self) -> int:
        return len(self.protos)

    def chunks(self, chunk: int) -> list:
        """Prepared chunks: (d_lo, d_hi, d_proto, d_valid, n2, protos,
        n_proto_pad) with device-resident query arrays."""
        cached = self._cache.get(chunk)
        if cached is not None:
            return cached
        cached = []
        for start in range(0, len(self.protos), chunk):
            sub = self.protos[start: start + chunk]
            lo, hi, proto_of, n2 = _distinct_kmers_flat(
                [p.protein for p in sub], self.k)
            n_proto = _bucket(len(sub), 64)
            h = _bucket(len(lo), 4096)
            qlo = np.zeros(h, np.uint32)
            qhi = np.zeros(h, np.uint32)
            qproto = np.full(h, n_proto, np.int32)
            qvalid = np.zeros(h, bool)
            qlo[: len(lo)], qhi[: len(lo)] = lo, hi
            qproto[: len(lo)] = proto_of
            qvalid[: len(lo)] = True
            cached.append((jnp.asarray(qlo), jnp.asarray(qhi),
                           jnp.asarray(qproto), jnp.asarray(qvalid),
                           np.pad(n2, (0, n_proto - len(n2))), sub,
                           n_proto))
        self._cache[chunk] = cached
        return cached


def _distinct_kmers_flat(proteins: list[str], k: int):
    """Distinct kmers per protein over a flat stream.

    returns (lo, hi, owner) arrays — each protein's kmer set, deduplicated
    within the protein — plus per-protein distinct-kmer counts.
    Kmer extraction keeps ALL length-k windows (a pure kmer-set iterator:
    the external ProteinKmers contract, not the in-repo Q1/Q2 extractors).
    """
    n = len(proteins)
    if n == 0:
        z = np.zeros(0, np.uint32)
        return z, z, np.zeros(0, np.int32), np.zeros(0, np.int64)
    lengths = np.array([len(p) for p in proteins], np.int64)
    total = int(lengths.sum())
    width = _bucket(total, 4096)
    # ProteinKmers keeps ALL ln-k+1 windows (no Q1 drop, no ambiguity
    # filter) — same contract the build/apply engines use
    got = native.flat_batch(proteins, k, width, -1)
    if got is not None:  # C++ data loader (kan_host.cpp)
        codes, owner, valid = got
    else:
        codes = np.full(width, PROT_PAD, np.uint8)
        owner = np.full(width, -1, np.int32)
        valid = np.zeros(width, bool)
        pos = 0
        for i, p in enumerate(proteins):
            ln = len(p)
            codes[pos: pos + ln] = encode_protein(p)
            owner[pos: pos + ln] = i
            if ln >= k:
                valid[pos: pos + ln - k + 1] = True
            pos += ln
    from .protein_kmers import apply_drop_last
    valid = apply_drop_last(valid)   # GenomeProteinKmers shares the
    # external-jar window-count risk fence (see protein_kmers.py)
    d_lo, d_hi = _pack(jnp.asarray(codes), k)
    lo = np.asarray(d_lo)[valid]
    hi = np.asarray(d_hi)[valid]
    own = owner[valid]
    # dedup (kmer, owner) pairs via one uint64 key + lexsort (np.unique
    # with axis=0 sorts void views — an order of magnitude slower).
    # Output is KEY-MAJOR (key, then owner): equal kmers are adjacent, so
    # callers can group by key with one adjacent-diff pass and no re-sort.
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    order = np.lexsort((own, key))
    k_s, o_s = key[order], own[order]
    keep = np.ones(len(order), bool)
    keep[1:] = (k_s[1:] != k_s[:-1]) | (o_s[1:] != o_s[:-1])
    k_u, own_u = k_s[keep], o_s[keep]
    lo_u = (k_u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi_u = (k_u >> np.uint64(32)).astype(np.uint32)
    counts = np.bincount(own_u, minlength=n).astype(np.int64)
    return lo_u, hi_u, own_u.astype(np.int32), counts


class GenomeProteinKmers:
    """Per-genome kmer hash with best-proposal bookkeeping
    (GenomeProteinKmers contract, HashAnnotationProcessor.java:233-291)."""

    def __init__(self, k: int, min_score: float):
        self.k = k
        self.min_score = min_score
        self._fids: list[str] = []
        self._proteins: list[str] = []
        self._annotations: list[str] = []
        self._md5_of: dict[str, int] = {}
        self._built = False

    def add_protein(self, fid: str, prot: str, annotation: str) -> None:
        md5 = protein_md5(prot)
        if md5 in self._md5_of:
            return  # identical sequence already registered
        self._md5_of[md5] = len(self._proteins)
        self._fids.append(fid)
        self._proteins.append(prot)
        self._annotations.append(annotation)
        self._built = False

    # ----- index construction -----

    def _build(self) -> None:
        lo, hi, owner, counts = _distinct_kmers_flat(self._proteins, self.k)
        self.protein_kmer_counts = counts
        n = len(self._proteins)
        # defaults: old annotation at similarity 0.0
        self.best_sim = np.zeros(n, np.float64)
        self.best_anno = list(self._annotations)
        if len(lo):
            # _distinct_kmers_flat output is key-major: equal kmers are
            # adjacent, so unique keys fall out of one adjacent-diff pass
            first = np.ones(len(lo), bool)
            first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
            starts = np.flatnonzero(first)
            u = len(starts)
            ucounts = np.diff(np.append(starts, len(lo))).astype(np.int64)
            slo, shi, sown = lo, hi, owner
            # fixed-width owner matrix: rank → its owner proteins, padded
            # with the (bucketed) protein count; ONE device gather expands
            # a probe hit into owners.  Rows and protein count are padded
            # to power-of-two buckets so _chunk_scores compiles O(log n)
            # programs across genomes, not one per genome.
            cap = min(int(ucounts.max(initial=1)), OWNER_CAP)
            self.n_pad = _bucket(n, 256)
            u_pad = _bucket(u, 4096)
            owner_mat = np.full((u_pad, cap), self.n_pad, np.int32)
            rows = np.repeat(np.arange(u), ucounts)
            cols = np.arange(len(rows)) - np.repeat(
                np.cumsum(ucounts) - ucounts, ucounts)
            in_cap = cols < cap
            owner_mat[rows[in_cap], cols[in_cap]] = sown[: len(rows)][in_cap]
            self.owner_mat = jnp.asarray(owner_mat)
            # host CSR of the overflow owners (ranks sorted; usually empty)
            over = ~in_cap
            if over.any():
                h_ranks, h_counts = np.unique(rows[over],
                                              return_counts=True)
                self.heavy_ranks = h_ranks.astype(np.int32)
                self.heavy_off = np.concatenate(
                    [[0], np.cumsum(h_counts)]).astype(np.int64)
                self.heavy_owners = sown[: len(rows)][over].astype(np.int32)
                log.info("%d kmers exceed the owner cap %d (%d overflow "
                         "owner entries on the host CSR path).",
                         len(h_ranks), cap, len(self.heavy_owners))
            else:
                self.heavy_ranks = np.zeros(0, np.int32)
                self.heavy_off = np.zeros(1, np.int64)
                self.heavy_owners = np.zeros(0, np.int32)
            table, self.max_probes = build_table(
                slo[starts], shi[starts],
                np.arange(u, dtype=np.uint32))
            self.table = jnp.asarray(table)
            self.kmer_count = u
        else:
            self.table = None
            self.kmer_count = 0
        self._built = True

    @property
    def n_kmers(self) -> int:
        if not self._built:
            self._build()
        return self.kmer_count

    # ----- prototype scoring -----

    def process_proposals(self,
                          prototypes: "list[Prototype] | PrototypeSet",
                          chunk: int = 4096,
                          rate: "RateLogger | None" = None) -> int:
        """Score every prototype; returns total match count (proteins whose
        proposal a prototype improved).  Pass a PrototypeSet to reuse the
        packed prototype kmers across genomes; ``rate`` gets one ``add``
        per scored chunk (the 5-second lines/s instrument)."""
        if not self._built:
            self._build()
        if isinstance(prototypes, list):
            prototypes = PrototypeSet(prototypes, self.k)
        # bound the dense (chunk × proteins) pair matrix
        n_pad = getattr(self, "n_pad",
                        _bucket(max(len(self._proteins), 1), 256))
        chunk = max(1, min(chunk, DENSE_CELLS // (n_pad + 1) - 1))
        max_len = max((len(p) for p in self._proteins), default=0)
        max_len = max(max_len,
                      max((len(p.protein) for p in prototypes.protos),
                          default=0))
        fast = (self.table is not None and not len(self.heavy_owners)
                and max_len <= 16384)
        if not fast:
            # heavy-owner CSR or huge proteins: host-float64 path
            matches = 0
            for prepared in prototypes.chunks(chunk):
                matches += self._process_chunk(prepared)
                if rate is not None:
                    rate.add(len(prepared[5]))
            return matches
        # fast path: device-resident exact-rational best reduction —
        # ONE small pull at the end instead of a (chunk × proteins)
        # matrix pull per chunk (_chunk_best)
        minc = self._minc_table(_bucket(2 * max_len + 4, 1024))
        n = len(self._proteins)
        d_n1 = jnp.asarray(np.pad(
            self.protein_kmer_counts.astype(np.int32),
            (0, self.n_pad - n)))
        state = (jnp.zeros(self.n_pad, jnp.int32),
                 jnp.ones(self.n_pad, jnp.int32),
                 jnp.full(self.n_pad, -1, jnp.int32),
                 jnp.int32(0))
        base = 0
        for prepared in prototypes.chunks(chunk):
            d_lo, d_hi, d_proto, d_valid, n2, protos, n_proto = prepared
            if protos:
                ranks = probe_table(self.table, d_lo, d_hi, d_valid,
                                    self.max_probes)
                state = _chunk_best(
                    self.owner_mat, ranks, d_proto, d_n1,
                    jnp.asarray(n2.astype(np.int32)), minc, *state,
                    jnp.int32(base), n_prot=self.n_pad, n_proto=n_proto)
            base += len(protos)
            if rate is not None:
                rate.add(len(protos))
        bc = np.asarray(state[0])[:n].astype(np.int64)
        bu = np.asarray(state[1])[:n].astype(np.int64)
        bi = np.asarray(state[2])[:n]
        matches = int(state[3])
        # float64 division reproduces the Java double the reference
        # emits; the device compared the same rationals exactly
        self.best_sim = np.where(bc > 0, bc / np.maximum(bu, 1), 0.0)
        protos_all = prototypes.protos
        for p in np.flatnonzero(bi >= 0):
            self.best_anno[p] = protos_all[int(bi[p])].annotation
        return matches

    def _minc_table(self, size: int):
        """minc[u] = smallest common count c with (c / u as float64)
        >= minScore — the device's integer floor test matches the
        host/Java double compare bit-for-bit."""
        cache = getattr(self, "_minc_cache", None)
        if cache is None:
            cache = self._minc_cache = {}
        got = cache.get(size)
        if got is None:
            from .projection import _min_ev_table

            got = jnp.asarray(_min_ev_table(self.min_score, size))
            cache[size] = got
        return got

    def _process_chunk(self, prepared) -> int:
        d_lo, d_hi, d_proto, d_valid, n2, protos, n_proto = prepared
        if self.table is None or not protos:
            return 0
        n_prot = len(self._proteins)
        ranks = probe_table(self.table, d_lo, d_hi, d_valid,
                            self.max_probes)
        common = np.asarray(_chunk_commons(
            self.owner_mat, ranks, d_proto,
            n_prot=self.n_pad, n_proto=n_proto))[: len(protos), : n_prot]
        if len(self.heavy_owners):
            # owners beyond OWNER_CAP: host CSR add onto the common matrix
            r = np.asarray(ranks)
            p = np.asarray(d_proto)
            pos = np.flatnonzero((r >= 0) & (p < len(protos))
                                 & np.isin(r, self.heavy_ranks))
            if len(pos):
                hidx = np.searchsorted(self.heavy_ranks, r[pos])
                lens = self.heavy_off[hidx + 1] - self.heavy_off[hidx]
                # CSR slice concatenation without a Python loop
                flat = (np.repeat(self.heavy_off[hidx], lens)
                        + np.arange(int(lens.sum()))
                        - np.repeat(np.cumsum(lens) - lens, lens))
                np.add.at(common,
                          (np.repeat(p[pos], lens),
                           self.heavy_owners[flat]), 1)
        # exact float64 Jaccard + first-max argmax (Java-double parity)
        n1 = self.protein_kmer_counts[None, :]
        union = n1 + n2[: len(protos), None] - common
        sim = np.where(common > 0, common / np.maximum(union, 1), 0.0)
        sim[sim < self.min_score] = 0.0
        best = sim.max(axis=0)
        winner = sim.argmax(axis=0)  # first max = earliest prototype
        improved = np.flatnonzero(best > self.best_sim)
        self.best_sim[improved] = best[improved]
        for p in improved:
            self.best_anno[p] = protos[int(winner[p])].annotation
        return len(improved)

    # ----- lookup -----

    def get_proposal(self, md5: str):
        """(similarity, annotation) for a protein MD5, or None."""
        idx = self._md5_of.get(md5)
        if idx is None:
            return None
        if not self._built:
            self._build()
        return float(self.best_sim[idx]), self.best_anno[idx]


OUTPUT_HEADER = "fid\tscore\tnew_annotation\told_annotation"


def _emit_rows(genome: Genome, gk: GenomeProteinKmers,
               defaults: "dict[str, str] | None" = None):
    """Per-feature output rows of one genome against a scored index
    (Q12 output classes — HashAnnotationProcessor.java:278-305).

    ``defaults``: per-genome md5 → first-registered old annotation.  In
    batched mode the shared index's 0.0-score default would otherwise be
    whichever GENOME registered the sequence first; this map restores the
    per-genome default the reference computes."""
    rows = []
    changes = []
    d_count = c_count = 0
    for feat in genome.features:
        old = feat.peg_function
        prot = feat.protein_translation
        md5 = protein_md5(prot) if prot else ""
        proposal = gk.get_proposal(md5) if md5 else None
        if proposal is None:
            rows.append((feat.id, "", old, old))
        else:
            score, new = proposal
            if score == 0.0 and defaults is not None:
                new = defaults.get(md5, new)
            score_str = repr(score) if score else "0.0"
            row = (feat.id, score_str, new, old)
            rows.append(row)
            if score == 0.0:
                d_count += 1
            elif old == new:
                c_count += 1
            else:
                changes.append(row)
    return rows, changes, d_count, c_count


def annotate_genome_rows(genome: Genome,
                         prototypes: "list[Prototype] | PrototypeSet",
                         k: int, min_score: float,
                         rate: "RateLogger | None" = None):
    """Full hashAnno pass over one genome.  Pass a PrototypeSet when
    annotating many genomes so prototype packing happens once.

    returns (rows — one (fid, score_str, new, old) per feature in order,
             change_rows subset, stats dict).
    """
    gk = GenomeProteinKmers(k, min_score)
    f_count = s_count = p_count = 0
    for feat in genome.features:
        prot = feat.protein_translation
        f_count += 1
        if not prot or "*" in prot:
            s_count += 1
        else:
            p_count += 1
            gk.add_protein(feat.id, prot, feat.peg_function)
    log.info("%d features processed, %d skipped, %d proteins, %d kmers "
             "in %s.", f_count, s_count, p_count, gk.n_kmers, genome)
    matches = gk.process_proposals(prototypes, rate=rate)
    rows, changes, d_count, c_count = _emit_rows(genome, gk)
    stats = dict(features=f_count, skipped=s_count, proteins=p_count,
                 matches=matches, defaulted=d_count, confirmed=c_count,
                 changed=len(changes))
    return rows, changes, stats


def annotate_genomes_batched(genomes: "list[Genome]",
                             prototypes: "list[Prototype] | PrototypeSet",
                             k: int, min_score: float,
                             rate: "RateLogger | None" = None):
    """Score SEVERAL genomes through one combined device index.

    The prototype set is shared across genomes, and a protein's best
    proposal depends only on its sequence (its distinct-kmer set), so
    distinct proteins of a whole genome batch can live in ONE owner
    matrix / probe table and be scored by one device pass — the device-
    batching analogue of the reference's genome thread fan-out
    (HashAnnotationProcessor.java:208 parallelStream).  Identical
    sequences across genomes share one index entry and one proposal —
    the result every per-genome run would compute for them anyway.

    returns [(rows, changes, stats) per genome, in input order]; each
    stats carries the per-genome Q12 class counts and the BATCH-wide
    ``matches`` total (per-genome attribution is meaningless when
    proteins are shared).
    """
    gk = GenomeProteinKmers(k, min_score)
    per_counts = []
    per_defaults: list[dict[str, str]] = []
    for genome in genomes:
        f_count = s_count = p_count = 0
        defaults: dict[str, str] = {}
        for feat in genome.features:
            prot = feat.protein_translation
            f_count += 1
            if not prot or "*" in prot:
                s_count += 1
            else:
                p_count += 1
                gk.add_protein(feat.id, prot, feat.peg_function)
                defaults.setdefault(protein_md5(prot), feat.peg_function)
        per_counts.append((f_count, s_count, p_count))
        per_defaults.append(defaults)
    log.info("%d proteins (%d kmers) from %d genomes in one device "
             "batch.", len(gk._proteins), gk.n_kmers, len(genomes))
    matches = gk.process_proposals(prototypes, rate=rate)
    out = []
    for genome, (f_count, s_count, p_count), defaults in zip(
            genomes, per_counts, per_defaults):
        rows, changes, d_count, c_count = _emit_rows(genome, gk, defaults)
        out.append((rows, changes,
                    dict(features=f_count, skipped=s_count,
                         proteins=p_count, matches=matches,
                         defaulted=d_count, confirmed=c_count,
                         changed=len(changes))))
    return out
