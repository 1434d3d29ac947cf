"""Device 6-frame contig k-mer extraction (KmerReference.getContigKmers,
KmerReference.java:157-203).

The reference translates each strand frame by frame through per-codon string
loops and inserts every kmer substring into a HashMap.  Here the whole
contig is translated at every codon start in one LUT gather
(ops.translate.sliding_translate), the three frame proteins are stride-3
slices, and kmers are packed/validated as vectorized windows — one jitted
program per padded contig width.  ``scan_stream`` does the same translate
and pack for a whole genome's concatenated strands at base granularity
(the projection engine's device path), with ``frame_kmers_by_base`` as
its per-strand reference.

Semantics preserved exactly:

* Q1 — the final possible kmer of each frame protein is dropped
  (loop bound ``i < frameLen - K``, KmerReference.java:186-187);
* Q2 — kmers containing 'X' or '*' are rejected (KmerReference.java:190);
* coordinates — plus-strand left = pos*3 + frame (1-based frame 1..3,
  KmerPosition.java:60-62); minus-strand left = (contigLen − 3K + 2) −
  (pos*3 + frame) (KmerPosition.java:78-86, Q11); every location spans
  3K bases (Q4).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .encode import DNA_PAD, PROT_PAD, PROT_STOP, PROT_X, encode_dna
from .kmers import kmer_valid_mask, pack_kmer_windows
from .translate import codon_lut, sliding_translate


def _bucket_width(n: int, minimum: int = 4096) -> int:
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


@partial(jax.jit, static_argnames=("k",))
def _strand_frame_kmers(dna_codes, length, k: int, lut):
    """All frame kmers of ONE strand sequence (already in reading order).

    dna_codes: (W,) uint8 padded with DNA_PAD; length: true length scalar.
    returns per frame f∈{0,1,2} (stacked axis 0, shape (3, FW)):
      lo, hi   — packed kmer keys at frame-protein position p
      valid    — Q1/Q2 validity
    FW = (W - 2) // 3 + 1 positions per frame (padded).
    """
    aa = sliding_translate(dna_codes, lut)           # (W-2,)
    n_aa = aa.shape[0]
    fw = (n_aa + 2) // 3
    los, his, valids = [], [], []
    for f in range(3):
        prot = aa[f::3]
        prot = jnp.pad(prot, (0, fw - prot.shape[0]), constant_values=31)
        # frame protein true length: floor((L - f) / 3)
        flen = jnp.maximum((length - f) // 3, 0)
        lo, hi = pack_kmer_windows(prot, k)
        valid = kmer_valid_mask(prot, flen, k, reject_stop=True,
                                drop_last=True)
        los.append(lo)
        his.append(hi)
        valids.append(valid)
    return jnp.stack(los), jnp.stack(his), jnp.stack(valids)


# Stream lengths are rounded to whole blocks of this many bases (and the
# block count to a few buckets) so one compiled scan serves many genomes.
SCAN_BLOCK = 8192


@partial(jax.jit, static_argnames=("k",))
def scan_stream(stream, lut, k: int):
    """Base-granular 6-frame scan of a concatenated DNA stream.

    stream: (W,) uint8 DNA codes; segments (contig strands in reading
            order) are separated by ≥ 3k-1 ambiguity codes (value ≥ 4) so
            no window crosses one.
    lut:    (65,) codon LUT (ops.translate.codon_lut).
    returns flat (lo, hi, bad) of length n = W - 3k + 1: position p holds
    the kmer whose amino acids sit at codon starts p, p+3, …, p+3(k-1),
    packed like ops.kmers, and ``bad`` marks windows holding 'X', '*' or
    an ambiguous codon.  Frame and Q1 bookkeeping (p % 3, p // 3) is the
    caller's; positions past a segment's last window are masked there.
    """
    aa = sliding_translate(stream, lut)              # (W-2,)
    n = stream.shape[0] - 3 * k + 1
    lo = jnp.zeros(n, jnp.int32)
    hi = jnp.zeros(n, jnp.int32)
    bad = jnp.zeros(n, jnp.bool_)
    for j in range(k):
        a = aa[3 * j: 3 * j + n].astype(jnp.int32)
        if j < 6:
            lo = lo | (a << (5 * j))
        else:
            hi = hi | (a << (5 * (j - 6)))
        bad = bad | (a == PROT_X) | (a == PROT_STOP) | (a >= PROT_PAD)
    return lo, hi, bad


def frame_kmers_by_base(codes: np.ndarray, k: int, gc: int):
    """Reference for :func:`scan_stream` on ONE strand: the
    :func:`_strand_frame_kmers` output re-laid out base-major (entry
    p = 3q + f is frame f's kmer at frame position q), cut to the
    max(L - 3k + 1, 0) positions that hold a whole window.

    returns np arrays (lo, hi) uint32 and ``valid`` bool (Q1 + Q2)."""
    length = len(codes)
    padded = np.full(_bucket_width(length), DNA_PAD, np.uint8)
    padded[:length] = codes
    lo, hi, valid = _strand_frame_kmers(
        jnp.asarray(padded), jnp.int32(length), k,
        jnp.asarray(codon_lut(gc)))
    n = max(length - 3 * k + 1, 0)
    return tuple(np.asarray(x).T.reshape(-1)[:n] for x in (lo, hi, valid))


def extract_contig_kmers(contig_seq: str, k: int, gc: int):
    """All valid (kmer, left, strand) tuples of one contig, both strands.

    returns dict with np arrays lo, hi, left (1-based), strand ('+'=0,
    '-'=1), all shape (N,).
    """
    codes = encode_dna(contig_seq)
    length = len(codes)
    width = _bucket_width(length)
    padded = np.full(width, DNA_PAD, np.uint8)
    padded[:length] = codes
    # minus strand: reverse complement in code space
    rc = np.full(width, DNA_PAD, np.uint8)
    rc_codes = np.where(codes < 4, codes ^ 2, codes)[::-1]
    rc[:length] = rc_codes
    lut = jnp.asarray(codon_lut(gc))
    d_len = jnp.int32(length)

    out_lo, out_hi, out_left, out_strand = [], [], [], []
    for strand, seq in ((0, padded), (1, rc)):
        lo, hi, valid = _strand_frame_kmers(jnp.asarray(seq), d_len, k, lut)
        lo = np.asarray(lo)
        hi = np.asarray(hi)
        valid = np.asarray(valid)
        fw = lo.shape[1]
        pos = np.arange(fw, dtype=np.int64)
        for f in range(3):
            v = valid[f]
            p = pos[v]
            # KmerPosition: frame argument is 1-based
            if strand == 0:
                left = p * 3 + (f + 1)
            else:
                left = (length - 3 * k + 2) - (p * 3 + (f + 1))
            out_lo.append(lo[f][v])
            out_hi.append(hi[f][v])
            out_left.append(left.astype(np.int32))
            out_strand.append(np.full(v.sum(), strand, np.int8))
    return {
        "lo": np.concatenate(out_lo),
        "hi": np.concatenate(out_hi),
        "left": np.concatenate(out_left),
        "strand": np.concatenate(out_strand),
    }
