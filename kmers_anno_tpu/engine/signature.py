"""Discriminating-kmer signature table: build, save/load, device packing.

Replicates the two-pass ``build`` semantics (BuildKmerProcessor.java:137-223,
SURVEY.md §3.2) with a device architecture: instead of a
``HashMap<String, RoleCounter>``, kmers are packed into (lo, hi) uint32 key
pairs and the good/bad role bookkeeping becomes a device **sort-based
group-by** (jax.lax.sort + segmented min/max), which is how a hash-map
build maps onto an accelerator without atomics.

Semantics preserved exactly:

* a peg contributes kmers only when its function has exactly ONE interesting
  role after RoleMap filtering (Q10 — BuildKmerProcessor.java:156-175);
* pegs with ZERO interesting roles form a kill list: any kmer they contain
  is deleted from the table (pass 2, BuildKmerProcessor.java:196-208);
* a kmer survives pass 1 only if every occurrence carries the same role
  (RoleCounter.isGood ⇔ badCount == 0, RoleCounter.java:54-56) — in
  order-free terms: min(role) == max(role) over its occurrence segment;
* output is one ``kmer TAB roleId`` line per surviving kmer
  (BuildKmerProcessor.java:212-216).  The reference emits HashMap order
  (arbitrary); we emit packed-key sort order (deterministic).

The kill pass is itself a device op: candidates are packed into an
open-addressing table, kill kmers are probed against it, and hit slots are
marked dead — no host-side set membership at any scale.
"""

from __future__ import annotations

import logging
import sys
from dataclasses import dataclass, field
from functools import partial
from typing import IO, Iterable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..genome.gto import Genome
from ..genome.roles import RoleMap
from ..ops.dna_kmers import (DNA_MAX_K, DNA_MIN_K, pack_dna_np,
                             unpack_dna_np)
from ..ops.encode import (decode_dna, decode_protein, encode_dna,
                          encode_protein)
from ..ops.hashtable import EMPTY, build_table, probe_table, table_size_for
from ..utils.counters import CountMap

log = logging.getLogger(__name__)

_NO_ROLE = np.int32(2**31 - 1)
_FP16_MAX = 65504.0  # largest finite float16


# ---------------------------------------------------------------------------
# host-side packing (NumPy mirror of ops.kmers.pack_kmer_windows)
# ---------------------------------------------------------------------------

def pack_kmers_np(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All length-k windows of a protein code array, packed 5 bits/char.

    codes: (L,) uint8; returns (lo, hi): (L-k+1,) uint32 each.
    Bit layout identical to ops.kmers.pack_kmer_windows so host-packed keys
    and device-packed keys compare equal.
    """
    if k > 12:
        # 5 bits/char: chars 0-5 in lo, 6-11 in hi; a 13th would shift
        # past bit 31.  DNA tables (k ≤ 15) use ops.dna_kmers instead.
        raise ValueError(f"protein kmer packing supports k <= 12, got {k}")
    n = len(codes) - k + 1
    if n <= 0:
        z = np.zeros(0, np.uint32)
        return z, z
    lo = np.zeros(n, np.uint32)
    hi = np.zeros(n, np.uint32)
    c = codes.astype(np.uint32)
    for j in range(k):
        w = c[j: j + n]
        if j < 6:
            lo |= w << np.uint32(5 * j)
        else:
            hi |= w << np.uint32(5 * (j - 6))
    return lo, hi


def unpack_kmer_np(lo: np.ndarray, hi: np.ndarray, k: int) -> np.ndarray:
    """Inverse of pack_kmers_np: (N,) lo/hi → (N, k) uint8 codes."""
    n = len(lo)
    out = np.zeros((n, k), np.uint8)
    for j in range(k):
        word = lo if j < 6 else hi
        shift = 5 * j if j < 6 else 5 * (j - 6)
        out[:, j] = (word >> np.uint32(shift)) & np.uint32(31)
    return out


# ---------------------------------------------------------------------------
# device group-by: unanimity over sorted key segments
# ---------------------------------------------------------------------------

CONFLICT = np.int32(-2)  # role tombstone: key seen with ≥2 distinct roles


@jax.jit
def _resolve_groupby(lo: jnp.ndarray, hi: jnp.ndarray, role: jnp.ndarray):
    """Sort (hi, lo) keys and resolve each key's role by unanimity.

    lo/hi:  (N,) uint32 packed keys (EMPTY/EMPTY = padding, sorts last)
    role:   (N,) int32 role per occurrence; CONFLICT (-2) marks keys
            already known conflicted from an earlier merge round — any
            segment containing one stays conflicted (min ≠ max)
    returns (slo, shi, out_role, keep) — sorted arrays; keep is True at
    the FIRST position of every real key; out_role there is the unanimous
    role or CONFLICT.  This is the mergeable kernel of the streaming
    build: state ∪ new occurrences re-resolve in one sort per flush.
    """
    n = lo.shape[0]
    shi, slo, srole = jax.lax.sort((hi, lo, role), num_keys=2)
    prev_hi = jnp.concatenate([shi[:1] ^ jnp.uint32(1), shi[:-1]])
    prev_lo = jnp.concatenate([slo[:1], slo[:-1]])
    first = (shi != prev_hi) | (slo != prev_lo)
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    rmin = jax.ops.segment_min(srole, seg, num_segments=n)
    rmax = jax.ops.segment_max(srole, seg, num_segments=n)
    out_role = jnp.where(rmin == rmax, rmin, CONFLICT)[seg]
    keep = first & (slo != EMPTY)
    return slo, shi, out_role, keep


@jax.jit
def _dedup_groupby(lo: jnp.ndarray, hi: jnp.ndarray):
    """Sorted unique keys of a padded key array (kill-list merges)."""
    shi, slo = jax.lax.sort((hi, lo), num_keys=2)
    prev_hi = jnp.concatenate([shi[:1] ^ jnp.uint32(1), shi[:-1]])
    prev_lo = jnp.concatenate([slo[:1], slo[:-1]])
    keep = ((shi != prev_hi) | (slo != prev_lo)) & (slo != EMPTY)
    return slo, shi, keep


@partial(jax.jit, static_argnames=("n_cand", "max_probes"))
def _mark_killed(cand_table, kill_lo, kill_hi, n_cand, max_probes):
    """Probe kill kmers against the candidate table; return a bool mask over
    candidate indices that were hit (pass 2 delete semantics)."""
    valid = kill_lo != EMPTY
    idx = probe_table(cand_table, kill_lo, kill_hi, valid, max_probes)
    dead = jnp.zeros((n_cand,), jnp.bool_)
    return dead.at[jnp.where(idx >= 0, idx, n_cand)].set(True, mode="drop")


def _pad_pow2(arrs: tuple[np.ndarray, ...], fill, dtype=None,
              minimum: int = 1 << 12) -> tuple[jnp.ndarray, ...]:
    """Concatenate + pad each array list to one power-of-two width so the
    jitted group-bys compile O(log n) programs, not one per size."""
    n = len(arrs[0])
    width = max(minimum, 1 << (max(n, 1) - 1).bit_length())
    out = []
    for a, f in zip(arrs, fill):
        buf = np.full(width, f, a.dtype if dtype is None else dtype)
        buf[:n] = a
        out.append(jnp.asarray(buf))
    return tuple(out)


class StreamingTableBuilder:
    """Bounded-memory accumulator for the signature build (SURVEY §7 hard
    part 5: the 100M+-entry build is itself a distributed sort group-by,
    not a hash map).

    Feed per-genome (key, role) occurrences and kill keys; the builder
    keeps only the SORTED UNIQUE state — one (lo, hi, role) triple per
    key, with CONFLICT tombstones for keys seen under ≥2 roles — and
    re-resolves state ∪ pending in one device sort whenever the pending
    occurrence pool exceeds ``chunk_entries``.  Host memory is therefore
    O(unique keys + chunk), independent of total occurrences; device
    memory is one padded sort per flush.
    """

    def __init__(self, chunk_entries: int = 1 << 23,
                 backend: str = "auto"):
        """backend: "auto" = the C++ merge builder when available (the
        single-host fast path — the device sorts compile for minutes at
        build scale on some backends), "native" = require it, "device" =
        force the JAX sort group-by (the distributed-build kernel)."""
        self.chunk_entries = chunk_entries
        self._native = (native.make_builder()
                        if backend in ("auto", "native") else None)
        if backend == "native" and self._native is None:
            raise RuntimeError("native builder unavailable")
        z = np.zeros(0, np.uint32)
        self.state: tuple[np.ndarray, np.ndarray, np.ndarray] = (
            z, z, np.zeros(0, np.int32))
        self.kill_state: tuple[np.ndarray, np.ndarray] = (z, z)
        self._pend: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._pend_n = 0
        self._pend_kill: list[tuple[np.ndarray, np.ndarray]] = []
        self._pend_kill_n = 0

    def add_candidates(self, lo: np.ndarray, hi: np.ndarray,
                       role: np.ndarray) -> None:
        if len(lo):
            if self._native is not None:
                self._native.add_candidates(lo, hi, role)
                return
            self._pend.append((lo, hi, role))
            self._pend_n += len(lo)
            if self._pend_n >= self.chunk_entries:
                self._flush()

    def add_kills(self, lo: np.ndarray, hi: np.ndarray) -> None:
        if len(lo):
            if self._native is not None:
                self._native.add_kills(lo, hi)
                return
            self._pend_kill.append((lo, hi))
            self._pend_kill_n += len(lo)
            if self._pend_kill_n >= self.chunk_entries:
                self._flush_kills()

    def _flush(self) -> None:
        if not self._pend:
            return
        slo, shi, srole = self.state
        lo = np.concatenate([slo] + [p[0] for p in self._pend])
        hi = np.concatenate([shi] + [p[1] for p in self._pend])
        role = np.concatenate([srole] + [p[2] for p in self._pend])
        self._pend, self._pend_n = [], 0
        dlo, dhi, drole, keep = _resolve_groupby(
            *_pad_pow2((lo, hi), (EMPTY, EMPTY)),
            _pad_pow2((role,), (0,))[0])
        keep = np.asarray(keep)
        self.state = (np.asarray(dlo)[keep], np.asarray(dhi)[keep],
                      np.asarray(drole)[keep])
        log.info("build state: %d unique kmers (%d conflicted).",
                 len(self.state[0]),
                 int((self.state[2] == CONFLICT).sum()))

    def _flush_kills(self) -> None:
        if not self._pend_kill:
            return
        klo, khi = self.kill_state
        lo = np.concatenate([klo] + [p[0] for p in self._pend_kill])
        hi = np.concatenate([khi] + [p[1] for p in self._pend_kill])
        self._pend_kill, self._pend_kill_n = [], 0
        dlo, dhi, keep = _dedup_groupby(
            *_pad_pow2((lo, hi), (EMPTY, EMPTY)))
        keep = np.asarray(keep)
        self.kill_state = (np.asarray(dlo)[keep], np.asarray(dhi)[keep])

    def finish(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
        """Resolve everything: returns (lo, hi, role) of surviving
        discriminating kmers (sorted by key) + stats."""
        if self._native is not None:
            lo, hi, role, stats = self._native.finish()
            self._native.close()
            self._native = None
            return lo, hi, role, stats
        self._flush()
        self._flush_kills()
        lo, hi, role = self.state
        n_unique = len(lo)
        live = role != CONFLICT
        lo, hi, role = lo[live], hi[live], role[live]
        n_pruned = n_unique - len(lo)

        n_killed = 0
        klo, khi = self.kill_state
        if len(klo) and len(lo):
            cand_table, max_probes = build_table(
                lo, hi, np.arange(len(lo), dtype=np.uint32))
            dead = np.zeros(len(lo), bool)
            step = self.chunk_entries
            for s in range(0, len(klo), step):
                kl, kh = _pad_pow2((klo[s: s + step], khi[s: s + step]),
                                   (EMPTY, EMPTY))
                hit = _mark_killed(cand_table, kl, kh, len(lo), max_probes)
                dead |= np.asarray(hit)
            n_killed = int(dead.sum())
            lo, hi, role = lo[~dead], hi[~dead], role[~dead]
        stats = {"pruned": n_pruned, "killed": n_killed,
                 "unique": n_unique}
        return lo, hi, role, stats


def _dedup_pairs(lo: np.ndarray, hi: np.ndarray,
                 role: np.ndarray | None) -> tuple[np.ndarray, ...]:
    """Host dedup of (key, role) pairs within one genome via one uint64
    key + lexsort (np.unique with axis=0 sorts void views — far slower).
    Safe because unanimity only depends on the SET of roles seen per
    kmer, not counts."""
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    if role is None:
        k_u = np.unique(key)
        return ((k_u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (k_u >> np.uint64(32)).astype(np.uint32))
    order = np.lexsort((role, key))
    k_s, r_s = key[order], role[order]
    keep = np.ones(len(order), bool)
    keep[1:] = (k_s[1:] != k_s[:-1]) | (r_s[1:] != r_s[:-1])
    k_u, r_u = k_s[keep], r_s[keep]
    return ((k_u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (k_u >> np.uint64(32)).astype(np.uint32),
            r_u.astype(np.int32))


# ---------------------------------------------------------------------------
# the signature table object
# ---------------------------------------------------------------------------

@dataclass
class SignatureTable:
    """A built discriminating-kmer table: packed keys + role indices.

    ``alphabet`` selects the key packing: "prot" = 5-bit protein codes
    (ops.kmers, k ≤ 12), "dna" = 2-bit nucleotide codes with a marker bit
    (ops.dna_kmers, k ≤ 15).  Both produce (lo, hi) uint32 pairs served by
    the same bucketed device table.
    """

    k: int
    key_lo: np.ndarray          # (N,) uint32
    key_hi: np.ndarray          # (N,) uint32
    role_idx: np.ndarray        # (N,) int32 — index into role_ids
    role_ids: list[str]         # role index → role ID string
    alphabet: str = "prot"      # "prot" | "dna"
    weights: np.ndarray | None = None  # (N,) float32 ≥ 0, or None
    stats: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.key_lo)

    # ----- text round-trip (the reference interchange format) -----

    def kmer_texts(self) -> list[str]:
        if self.alphabet == "dna":
            codes = unpack_dna_np(self.key_lo, self.key_hi, self.k)
            return [decode_dna(row) for row in codes]
        codes = unpack_kmer_np(self.key_lo, self.key_hi, self.k)
        return [decode_protein(row) for row in codes]

    def save(self, target: str | IO) -> None:
        """Write ``kmer TAB roleId`` lines (BuildKmerProcessor.java:215);
        weighted tables append a third ``weight`` column (north-star
        extension — the reference format has no weights).  A ``.kdb`` /
        ``.npz`` path selects the binary format instead (save_binary)."""
        if isinstance(target, str) and target.endswith((".kdb", ".npz")):
            return self.save_binary(target)
        fh = open(target, "w") if isinstance(target, str) else target
        try:
            if self.weights is None:
                for text, ridx in zip(self.kmer_texts(), self.role_idx):
                    fh.write(f"{text}\t{self.role_ids[ridx]}\n")
            else:
                for text, ridx, w in zip(self.kmer_texts(), self.role_idx,
                                         self.weights):
                    fh.write(f"{text}\t{self.role_ids[ridx]}\t{w:.6g}\n")
        finally:
            if isinstance(target, str):
                fh.close()

    # ----- binary round-trip (the at-scale interchange format) -----
    #
    # The TSV format re-parses every kmer string; at 10M-100M entries
    # (BASELINE configs 4-5) that is minutes of host time.  The binary
    # format is the packed arrays themselves (uncompressed npz): loads
    # are a few array reads regardless of table size.

    def save_binary(self, path: str) -> None:
        with open(path, "wb") as fh:
            np.savez(
                fh, format=np.array("kmers-anno-tpu-kdb-1"),
                k=np.array(self.k, np.int32),
                alphabet=np.array(self.alphabet),
                role_ids=np.array(self.role_ids, dtype="U"),
                key_lo=self.key_lo, key_hi=self.key_hi,
                role_idx=self.role_idx,
                **({"weights": self.weights}
                   if self.weights is not None else {}))

    @classmethod
    def load_binary(cls, path: str) -> "SignatureTable":
        with np.load(path, allow_pickle=False) as z:
            fmt = str(z["format"])
            if fmt != "kmers-anno-tpu-kdb-1":
                raise ValueError(f"unknown kmer DB format {fmt!r}")
            return cls(
                k=int(z["k"]), key_lo=z["key_lo"], key_hi=z["key_hi"],
                role_idx=z["role_idx"], role_ids=list(z["role_ids"]),
                alphabet=str(z["alphabet"]),
                weights=z["weights"] if "weights" in z else None)

    @classmethod
    def load(cls, source: str | IO,
             alphabet: str | None = None) -> "SignatureTable":
        """Load a kmer DB TSV; K is inferred from the kmer text length
        (ApplyKmerProcessor.java:108).  Binary DBs (save_binary) are
        auto-detected by their zip magic.

        ``alphabet`` None = auto-detect: kmer texts that are entirely
        lowercase acgtu are DNA (GTO contig DNA is lowercase; protein
        kmers are uppercase), everything else is protein.  Pass "prot" or
        "dna" to force.
        """
        if isinstance(source, str):
            with open(source, "rb") as bf:
                if bf.read(4) == b"PK\x03\x04":  # npz zip magic
                    return cls.load_binary(source)
        fh = open(source, "r") if isinstance(source, str) else source
        try:
            kmers: list[str] = []
            ridx: list[int] = []
            role_ids: list[str] = []
            role_index: dict[str, int] = {}
            wcol: list[float] = []
            for line in fh:
                line = line.rstrip("\r\n")
                if not line:
                    continue
                fields = line.split("\t")
                kmer, role = fields[:2]
                i = role_index.get(role)
                if i is None:
                    i = role_index[role] = len(role_ids)
                    role_ids.append(role)
                kmers.append(kmer)
                ridx.append(i)
                if len(fields) >= 3:
                    w = float(fields[2])
                    if w < 0:
                        raise ValueError(f"negative kmer weight {w}")
                    wcol.append(w)
        finally:
            if isinstance(source, str):
                fh.close()
        if not kmers:
            raise ValueError("empty kmer database")
        if wcol and len(wcol) != len(kmers):
            raise ValueError("weight column present on only some rows")
        weights = np.asarray(wcol, np.float32) if wcol else None
        k = len(kmers[0])
        if alphabet is None:
            # Case-insensitive: DNA kmers from external tools may be
            # uppercase; mis-detecting one as protein would silently pack
            # garbage keys for k > 12 (ADVICE r2).
            dna_chars = set("acgtu")
            alphabet = ("dna" if all(set(km.lower()) <= dna_chars
                                     for km in kmers) else "prot")
        if alphabet == "dna":
            kmers = [km.lower() for km in kmers]
        lo = np.zeros(len(kmers), np.uint32)
        hi = np.zeros(len(kmers), np.uint32)
        if alphabet == "dna":
            for i, km in enumerate(kmers):
                codes = encode_dna(km)
                if (codes >= 4).any():
                    raise ValueError(f"ambiguous base in DNA kmer {km!r}")
                klo, khi = pack_dna_np(codes, k)
                lo[i], hi[i] = klo[0], khi[0]
        else:
            for i, km in enumerate(kmers):
                klo, khi = pack_kmers_np(encode_protein(km), k)
                lo[i], hi[i] = klo[0], khi[0]
        return cls(k=k, key_lo=lo, key_hi=hi,
                   role_idx=np.asarray(ridx, np.int32), role_ids=role_ids,
                   alphabet=alphabet, weights=weights)

    # ----- device packing -----

    def device_table(self, load_factor: float = 0.5,
                     packed_weights: bool = False):
        """Pack into the bucketed open-addressing device table.

        packed_weights=True stores ``(fp16_bits(weight) << 16) | role_idx``
        payloads for the weighted-vote path (ops.vote.split_packed_payload
        decodes them); missing weights default to 1.0.  Requires < 65536
        roles.  Default payloads are plain role indices (reference-exact
        unanimity path).

        returns (table (B, 24) uint32 jnp array — resident on device so the
        hot path never re-uploads it, max_probes int)
        """
        table, max_probes = build_table(
            self.key_lo, self.key_hi, self._payloads(packed_weights),
            load_factor=load_factor)
        return jnp.asarray(table), max_probes

    def device_table_np(self, load_factor: float = 0.5,
                        packed_weights: bool = False):
        """device_table, but returning the host numpy table (callers that
        place arrays themselves, e.g. the multi-process mesh engine)."""
        return build_table(
            self.key_lo, self.key_hi, self._payloads(packed_weights),
            load_factor=load_factor)

    def device_wide_table(self, packed_weights: bool = False):
        """Pack into the wide-bucket single-gather layout (ops.widetable)
        — the r4 fast path: one row gather per lookup, ``max_probes``
        almost always 1 via salt retry.

        returns (table (rows, 72) uint32 jnp array, salt uint32 jnp
        scalar, max_probes int), or None when the table is too large for
        the single-gather fast zone (fall back to device_probe_table).
        """
        from ..ops.widetable import build_wide_table, fits_wide
        if not fits_wide(len(self.key_lo)):
            return None
        table, salt, max_probes = build_wide_table(
            self.key_lo, self.key_hi, self._payloads(packed_weights))
        return (jnp.asarray(table), jnp.uint32(salt), max_probes)

    def device_probe_table(self, load_factor: float = 0.5,
                           packed_weights: bool = False):
        """Like device_table, but auto-selects the big-table layout: tables
        past SLICED_THRESHOLD_BYTES come back in the probe-window layout
        for ops.sliced_probe.probe_table_sliced (prefer
        device_wide_table when the key count fits it).

        returns (table jnp array, max_probes int, sliced bool)
        """
        from ..ops.sliced_probe import pick_probe, windowed_table
        table, max_probes = build_table(
            self.key_lo, self.key_hi, self._payloads(packed_weights),
            load_factor=load_factor)
        if pick_probe(table.nbytes):
            log.info("table is %.0f MB: using the sliced probe layout "
                     "(window x%d).", table.nbytes / 1e6, max_probes)
            return (jnp.asarray(windowed_table(table, max_probes)),
                    max_probes, True)
        return jnp.asarray(table), max_probes, False

    def _payloads(self, packed_weights: bool) -> np.ndarray:
        if packed_weights:
            if len(self.role_ids) >= 1 << 16:
                raise ValueError("weighted payload packing supports "
                                 "< 65536 roles")
            w = (self.weights if self.weights is not None
                 else np.ones(len(self.key_lo), np.float32))
            # fp16 payload: clamp to the finite range.  'balance' weights
            # of rare roles can exceed 65504; letting them become +inf
            # would make a single hit win any threshold (ADVICE r2).
            if len(w) and float(w.max()) > _FP16_MAX:
                log.warning(
                    "clamping %d kmer weights above %.0f to the fp16 "
                    "payload maximum", int((w > _FP16_MAX).sum()), _FP16_MAX)
                w = np.minimum(w, _FP16_MAX)
            bits = w.astype(np.float16).view(np.uint16).astype(np.uint32)
            return (bits << np.uint32(16)) | self.role_idx.astype(np.uint32)
        return self.role_idx.astype(np.uint32)

    def role_counts(self) -> CountMap:
        counts = CountMap()
        for ridx in self.role_idx:
            counts.count(self.role_ids[ridx])
        return counts


# ---------------------------------------------------------------------------
# the build pipeline
# ---------------------------------------------------------------------------

def _peg_keys(genome: Genome, peg, k: int, alphabet: str
              ) -> tuple[np.ndarray, np.ndarray] | None:
    """Packed kmer keys of one peg in the requested alphabet, or None when
    the peg has no usable sequence.  Protein mode packs every window of the
    translation; DNA mode packs the unambiguous windows of the coding-strand
    CDS DNA (apply scans both strands, so genes on either strand are found
    without storing reverse complements)."""
    if alphabet == "dna":
        loc = peg.location
        if loc is None:
            return None
        dna = genome.get_dna(loc)
        if len(dna) < k:
            return None
        from ..ops.dna_kmers import dna_valid_np
        codes = encode_dna(dna)
        lo, hi = pack_dna_np(codes, k)
        ok = dna_valid_np(codes, k)
        return lo[ok], hi[ok]
    prot = peg.protein_translation
    if not prot or len(prot) < k:
        return None
    return pack_kmers_np(encode_protein(prot), k)


def _flat_protein_keys(prots: list[str], k: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Packed kmer keys of a protein batch over ONE flat token stream.

    Feeds the C++ data loader (native.flat_batch) when available and packs
    all windows with one vectorized pass — the build-side counterpart of
    the apply path's FlatBatch (a per-peg Python pack loop was the r2
    build bottleneck).  returns (lo, hi, seg): every in-protein window's
    key plus the index of the protein it came from.
    """
    if not prots:
        z = np.zeros(0, np.uint32)
        return z, z, np.zeros(0, np.int32)
    total = sum(map(len, prots))
    width = total + k   # tail pad so the window pack covers every start
    got = native.flat_batch(prots, k, width, -1)
    if got is not None:
        codes, seg, valid = got
    else:
        codes = np.full(width, 0, np.uint8)
        seg = np.full(width, -1, np.int32)
        valid = np.zeros(width, bool)
        pos = 0
        for i, p in enumerate(prots):
            ln = len(p)
            codes[pos: pos + ln] = encode_protein(p)
            seg[pos: pos + ln] = i
            if ln >= k:
                valid[pos: pos + ln - k + 1] = True
            pos += ln
    from .protein_kmers import apply_drop_last
    lo, hi = pack_kmers_np(codes, k)
    v = apply_drop_last(valid[: len(lo)])
    return lo[v], hi[v], seg[: len(lo)][v]


def compute_weights(role_idx: np.ndarray, mode: str) -> np.ndarray | None:
    """Per-kmer weights for the weighted-vote extension.

    mode "uniform": every kmer weighs 1.0.  mode "balance": kmers of a
    role weigh mean_kmers_per_role / kmers(role), so every role carries
    the same total vote mass regardless of how many signature kmers it
    owns.  mode "none": None (reference-exact unweighted table).
    """
    if mode == "none":
        return None
    if mode == "uniform":
        return np.ones(len(role_idx), np.float32)
    if mode == "balance":
        if len(role_idx) == 0:
            return np.zeros(0, np.float32)
        counts = np.bincount(role_idx)
        mean = len(role_idx) / max((counts > 0).sum(), 1)
        return (mean / counts[role_idx]).astype(np.float32)
    raise ValueError(f"unknown weight mode {mode!r}")


def build_signatures(genomes: Iterable[Genome], role_map: RoleMap,
                     good_roles: Sequence[str], k: int = 8,
                     genome_filter: set[str] | None = None,
                     progress: bool = True,
                     alphabet: str = "prot",
                     weight_mode: str = "none") -> SignatureTable:
    """Build the discriminating-kmer table (``build`` command semantics).

    genomes:       iterable of Genome (one pass; streaming-friendly)
    role_map:      role definitions (roles.in.subsystems)
    good_roles:    interesting role IDs (roles.to.use column 1)
    genome_filter: optional set of genome IDs to process (-g option)
    alphabet:      "prot" (reference semantics) or "dna" (north-star
                   config 3: nucleotide kmers from CDS DNA)
    weight_mode:   "none" | "uniform" | "balance" — per-kmer vote weights
                   (north-star weighted voting; "none" = reference table)
    """
    good = set(good_roles)
    role_ids: list[str] = []
    role_index: dict[str, int] = {}

    builder = StreamingTableBuilder()
    buffered = 0

    for genome in genomes:
        if genome_filter is not None and genome.id not in genome_filter:
            continue
        g_lo: list[np.ndarray] = []
        g_hi: list[np.ndarray] = []
        g_role: list[np.ndarray] = []
        gk_lo: list[np.ndarray] = []
        gk_hi: list[np.ndarray] = []
        n_interesting = 0
        n_buffered = 0
        i_prots: list[str] = []      # protein mode: batch the encode
        i_ridx: list[int] = []
        k_prots: list[str] = []
        for peg in genome.pegs:
            if alphabet == "prot":
                prot = peg.protein_translation
                if not prot or len(prot) < k:
                    continue
                keys = None
            else:
                keys = _peg_keys(genome, peg, k, alphabet)
                if keys is None:
                    continue
            peg_roles = [r for r in peg.get_useful_roles(role_map)
                         if r.id in good]
            if not peg_roles:
                # kill-list protein (BuildKmerProcessor.java:160-164)
                if keys is None:
                    k_prots.append(prot)
                else:
                    lo, hi = keys
                    gk_lo.append(lo)
                    gk_hi.append(hi)
                n_buffered += 1
            elif len(peg_roles) == 1:
                # sole interesting role (Q10)
                rid = peg_roles[0].id
                ridx = role_index.get(rid)
                if ridx is None:
                    ridx = role_index[rid] = len(role_ids)
                    role_ids.append(rid)
                if keys is None:
                    i_prots.append(prot)
                    i_ridx.append(ridx)
                else:
                    lo, hi = keys
                    g_lo.append(lo)
                    g_hi.append(hi)
                    g_role.append(np.full(len(lo), ridx, np.int32))
                n_interesting += 1
        if i_prots:
            # one flat-stream encode per genome (C++ loader + vector pack)
            lo, hi, seg = _flat_protein_keys(i_prots, k)
            g_lo.append(lo)
            g_hi.append(hi)
            g_role.append(np.asarray(i_ridx, np.int32)[seg])
        if k_prots:
            lo, hi, _ = _flat_protein_keys(k_prots, k)
            gk_lo.append(lo)
            gk_hi.append(hi)
        if g_lo:
            lo, hi, role = _dedup_pairs(
                np.concatenate(g_lo), np.concatenate(g_hi),
                np.concatenate(g_role))
            builder.add_candidates(lo, hi, role)
        if gk_lo:
            lo, hi = _dedup_pairs(
                np.concatenate(gk_lo), np.concatenate(gk_hi), None)
            builder.add_kills(lo, hi)
        buffered += n_buffered
        if progress:
            log.info("%s: %d interesting pegs, %d buffered.",
                     genome, n_interesting, n_buffered)

    # Pass 1 prune (unanimity) + pass 2 kill, streamed (bounded memory).
    slo, shi, srole, bstats = builder.finish()
    log.info("%d non-unique kmers deleted.  %d discriminating kmers left.  "
             "%d proteins buffered.", bstats["pruned"],
             bstats["unique"] - bstats["pruned"], buffered)
    log.info("%d kmers killed by buffered proteins.  "
             "%d discriminating kmers remaining.",
             bstats["killed"], len(slo))

    table = SignatureTable(
        k=k, key_lo=slo, key_hi=shi, role_idx=srole, role_ids=role_ids,
        alphabet=alphabet, weights=compute_weights(srole, weight_mode),
        stats={"buffered": buffered, "pruned": bstats["pruned"],
               "killed": bstats["killed"]})
    counts = table.role_counts()
    for rid in good:
        if counts.get_count(rid) == 0:
            log.warning("No kmers found for %s: %s.",
                        rid, role_map.get_name(rid))
    return table
