"""Synthetic workloads made from a seed, for the benchmark and the chip
smoke test: a signature table with planted role segments, proteins that
carry them, and a genome with planted ORFs plus close genomes whose pegs
are those ORFs' proteins (as the ``kmers``/``batch`` engine consumes)."""

from __future__ import annotations

import numpy as np

from ..engine.signature import pack_kmers_np
from ..genome.dna import DnaTranslator, reverse_complement
from ..genome.gto import Genome
from ..ops.encode import decode_protein

AA = "ACDEFGHIKLMNPQRSTVWY"
_DNA = np.frombuffer(b"tcag", np.uint8)       # NCBI order: code → base
# codon index c0*16 + c1*4 + c2 with t=0 c=1 a=2 g=3
_STOP_CODONS = (0 * 16 + 2 * 4 + 2,           # taa
                0 * 16 + 2 * 4 + 3,           # tag
                0 * 16 + 3 * 4 + 2)           # tga
PROTO_LEN = 120                               # role prototype residues


def make_workload(rng: np.random.Generator, n_keys: int = 1_000_000,
                  n_roles: int = 2000, k: int = 8):
    """Role prototypes + a kmer→role table of about ``n_keys`` entries.

    Every kmer of each role's prototype (PROTO_LEN protein codes 0..19)
    maps to that role; the rest of the table is filler kmers with random
    roles.  returns (protos (n_roles, PROTO_LEN) uint8, key_lo, key_hi,
    role) with keys unique (first occurrence wins, like
    HashMap.computeIfAbsent)."""
    protos = rng.integers(0, 20, size=(n_roles, PROTO_LEN)).astype(np.uint8)
    lo_all, hi_all, role_all = [], [], []
    for r in range(n_roles):
        lo, hi = pack_kmers_np(protos[r], k)
        lo_all.append(lo)
        hi_all.append(hi)
        role_all.append(np.full(len(lo), r, np.int32))
    n_proto = sum(len(x) for x in lo_all)
    n_fill = max(0, n_keys - n_proto)
    fill = rng.integers(0, 20, size=(n_fill + k - 1,)).astype(np.uint8)
    flo, fhi = pack_kmers_np(fill, k)
    lo_all.append(flo)
    hi_all.append(fhi)
    role_all.append(rng.integers(0, n_roles, size=len(flo)).astype(np.int32))
    lo = np.concatenate(lo_all)
    hi = np.concatenate(hi_all)
    role = np.concatenate(role_all)
    _, idx = np.unique(np.stack([hi, lo], 1), axis=0, return_index=True)
    idx = np.sort(idx)
    return protos, lo[idx], hi[idx], role[idx]


def planted_proteins(rng: np.random.Generator, protos: np.ndarray,
                     n: int, min_len: int, max_len: int) -> list[str]:
    """``n`` random proteins of length in [min_len, max_len); 90% carry a
    random role prototype at a random offset."""
    out = []
    lens = rng.integers(min_len, max_len, size=n)
    roles = rng.integers(0, len(protos), size=n)
    plant = rng.random(n) < 0.9
    for ln, r, p in zip(lens, roles, plant):
        codes = rng.integers(0, 20, size=int(ln)).astype(np.uint8)
        if p:
            off = int(rng.integers(0, ln - protos.shape[1] + 1))
            codes[off: off + protos.shape[1]] = protos[r]
        out.append(decode_protein(codes))
    return out


def _dna(codes: np.ndarray) -> str:
    return _DNA[codes].tobytes().decode("ascii")


def _clean_gene(rng: np.random.Generator, lo_cod: int, hi_cod: int) -> str:
    """atg + a stop-free random reading frame + taa."""
    n = int(rng.integers(lo_cod, hi_cod))
    cod = rng.integers(0, 4, size=(n, 3))
    idx = cod[:, 0] * 16 + cod[:, 1] * 4 + cod[:, 2]
    body = cod[~np.isin(idx, _STOP_CODONS)].reshape(-1)
    return "atg" + _dna(body.astype(np.uint8)) + "taa"


def _mutate(rng: np.random.Generator, protein: str, rate: float) -> str:
    if rate <= 0:
        return protein
    b = bytearray(protein.encode("ascii"))
    for i in np.flatnonzero(rng.random(len(b)) < rate):
        b[i] = ord(AA[int(rng.integers(0, len(AA)))])
    return b.decode("ascii")


def make_projection_workload(rng: np.random.Generator,
                             contig_genes=(3500,), n_close: int = 10,
                             lo_cod: int = 60, hi_cod: int = 500,
                             spacer=(30, 31), protein_mutation: float = 0.0):
    """A new genome with planted clean ORFs (alternating strands) on one
    contig per entry of ``contig_genes``, plus ``n_close`` close genomes
    whose pegs are the ORFs' proteins (each close genome independently
    point-mutated at ``protein_mutation`` per residue).

    returns (n_bases, olds: {genome_id: Genome}, new_genome) where
    ``new_genome(genome_id="400.1", snp_rate=0.0, seed=0)`` builds a fresh
    Genome (annotation mutates it) listing every close genome, with base
    substitutions at ``snp_rate`` for a distinct but close variant.
    """
    xl = DnaTranslator(11)
    contigs, genes = [], []
    for n_genes in contig_genes:
        parts = [_dna(rng.integers(0, 4, 50).astype(np.uint8))]
        for _ in range(n_genes):
            gene = _clean_gene(rng, lo_cod, hi_cod)
            parts.append(gene if len(genes) % 2 == 0
                         else reverse_complement(gene))
            genes.append(gene)
            gap = int(rng.integers(*spacer))
            parts.append(_dna(rng.integers(0, 4, gap).astype(np.uint8)))
        contigs.append("".join(parts))
    prots = [xl.peg_translate(g, 1, len(g) - 3) for g in genes]

    def old_genome(gid, seed):
        mrng = np.random.default_rng(seed)
        feats = [{
            "id": f"fig|{gid}.peg.{i + 1}", "type": "CDS",
            "function": f"Projected role number {i + 1}",
            "location": [["oc", str(1000 * i + 1), "+", len(gene)]],
            "protein_translation": _mutate(mrng, prots[i], protein_mutation),
            "annotations": [], "aliases": []}
            for i, gene in enumerate(genes)]
        return Genome({
            "id": gid, "scientific_name": "Oldus", "genetic_code": 11,
            "domain": "Bacteria", "features": feats,
            "contigs": [{"id": "oc", "dna": "acgt" * 50}],
            "close_genomes": [], "subsystems": []})

    olds = {f"{300 + i}.1": old_genome(f"{300 + i}.1", i)
            for i in range(n_close)}

    def new_genome(genome_id: str = "400.1", snp_rate: float = 0.0,
                   seed: int = 0):
        srng = np.random.default_rng(seed)
        dna = []
        for seq in contigs:
            if snp_rate > 0:
                b = np.frombuffer(seq.encode("ascii"), np.uint8).copy()
                hit = np.flatnonzero(srng.random(len(b)) < snp_rate)
                b[hit] = _DNA[srng.integers(0, 4, len(hit))]
                seq = b.tobytes().decode("ascii")
            dna.append(seq)
        return Genome({
            "id": genome_id, "scientific_name": "Novus",
            "genetic_code": 11, "domain": "Bacteria", "features": [],
            "contigs": [{"id": f"nc{i + 1}", "dna": d, "genetic_code": 11}
                        for i, d in enumerate(dna)],
            "close_genomes": [
                {"genome": gid, "genome_name": "Oldus",
                 "closeness_measure": 99.0} for gid in olds],
            "subsystems": []})

    return sum(len(c) for c in contigs), olds, new_genome
