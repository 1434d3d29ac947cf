"""The base-granular stream scan (ops.contig_kmers.scan_stream) vs the
per-frame XLA reference (_strand_frame_kmers, re-laid out base-major)."""

import jax.numpy as jnp
import numpy as np
import pytest

from kmers_anno_tpu.ops.contig_kmers import frame_kmers_by_base, scan_stream
from kmers_anno_tpu.ops.encode import (DNA_AMBIG, encode_dna,
                                       reverse_complement_codes)
from kmers_anno_tpu.ops.translate import codon_lut
from tests.fixtures import make_projection_pair

K = 8


def _scan_one(codes, k, gc=11):
    """scan_stream over one strand padded with ambiguity codes, with the
    Q1 drop-last mask the projection engine applies per segment."""
    length = len(codes)
    stream = np.full(length + 3 * k + 5, DNA_AMBIG, np.uint8)
    stream[:length] = codes
    lo, hi, bad = scan_stream(jnp.asarray(stream),
                              jnp.asarray(codon_lut(gc)), k)
    n = max(length - 3 * k + 1, 0)
    p = np.arange(n)
    q1 = (p // 3) < (length - p % 3) // 3 - k
    valid = q1 & ~np.asarray(bad)[:n]
    return (np.asarray(lo)[:n].astype(np.uint32),
            np.asarray(hi)[:n].astype(np.uint32), valid)


def _assert_matches(codes, k, gc=11):
    lo, hi, valid = _scan_one(codes, k, gc)
    wlo, whi, wvalid = frame_kmers_by_base(codes, k, gc)
    np.testing.assert_array_equal(valid, wvalid)
    np.testing.assert_array_equal(lo[valid], wlo[wvalid])
    np.testing.assert_array_equal(hi[valid], whi[wvalid])
    return int(valid.sum())


@pytest.mark.parametrize("k", [8, 12])
def test_scan_matches_reference_random(k):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=2000).astype(np.uint8)
    assert _assert_matches(codes, k) > 0


def test_scan_matches_reference_ambiguous():
    rng = np.random.default_rng(4)
    seq = "".join(np.array(list("tcagn"))[rng.integers(0, 5, size=1500)])
    _assert_matches(encode_dna(seq), K)


@pytest.mark.parametrize("seq", ["", "tcag", "t" * (3 * K - 1),
                                 "atg" * (K + 2)])
def test_scan_short_and_empty(seq):
    _assert_matches(encode_dna(seq), K)


def test_scan_output_length_and_dtypes():
    stream = jnp.full(100, DNA_AMBIG, jnp.uint8)
    lo, hi, bad = scan_stream(stream, jnp.asarray(codon_lut(11)), K)
    assert lo.shape == hi.shape == bad.shape == (100 - 3 * K + 1,)
    assert lo.dtype == hi.dtype == jnp.int32 and bad.dtype == jnp.bool_
    assert bool(bad.all())


def _gapped_genome():
    """Two-contig genome from the projection fixtures, with runs of
    ambiguous bases inside the first contig."""
    a, _ = make_projection_pair(seed=5, n_genes=6)
    b, _ = make_projection_pair(seed=6, n_genes=4)
    c1 = a.raw["contigs"][0]
    dna = c1["dna"]
    c1["dna"] = dna[:300] + "n" * 40 + dna[300:700] + "nrn" + dna[700:]
    c2 = dict(b.raw["contigs"][0], id="newcon2")
    a.raw["contigs"].append(c2)
    from kmers_anno_tpu.genome.gto import Genome
    return Genome(a.raw)


def test_stream_index_matches_reference_per_segment():
    """StreamWindowIndex.build (the device path) over a multi-segment
    stream with ambiguity gaps: every segment and strand equals the
    per-strand reference, and the masked windows locate to exactly the
    host extractor's (kmer, contig, strand, left) set."""
    from kmers_anno_tpu.engine.projection import StreamWindowIndex
    from kmers_anno_tpu.ops.contig_kmers import extract_contig_kmers

    g = _gapped_genome()
    idx = StreamWindowIndex.build(g, K)
    lo = np.asarray(idx.d_lo).astype(np.uint32)
    hi = np.asarray(idx.d_hi).astype(np.uint32)
    valid = np.asarray(idx.d_valid)
    assert len(idx.seg_start) == 2 * len(g.contigs)
    for start, ci, strand in zip(idx.seg_start, idx.seg_contig,
                                 idx.seg_strand):
        codes = encode_dna(g.contigs[ci].sequence)
        if strand == 1:
            codes = reverse_complement_codes(codes)
        wlo, whi, wvalid = frame_kmers_by_base(codes, K, g.genetic_code)
        sl = slice(start, start + len(wvalid))
        np.testing.assert_array_equal(valid[sl], wvalid)
        np.testing.assert_array_equal(lo[sl][wvalid], wlo[wvalid])
        np.testing.assert_array_equal(hi[sl][wvalid], whi[wvalid])

    pos = np.flatnonzero(valid)
    contig, strand, left = idx.locate(pos)
    got = set(zip(lo[pos].tolist(), hi[pos].tolist(), contig.tolist(),
                  strand.tolist(), left.tolist()))
    want = set()
    for ci, c in enumerate(g.contigs):
        d = extract_contig_kmers(c.sequence, K, g.genetic_code)
        want |= set(zip(d["lo"].tolist(), d["hi"].tolist(),
                        [ci] * len(d["lo"]), d["strand"].tolist(),
                        d["left"].tolist()))
    assert got == want
