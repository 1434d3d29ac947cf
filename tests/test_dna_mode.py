"""DNA-mode annotation (BASELINE config 3): 2-bit packing, strand-aware
contig apply, build --dna, CLI e2e — all against naive string oracles."""

import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from kmers_anno_tpu.engine.dna_apply import DnaApplyEngine, cluster_hits
from kmers_anno_tpu.engine.signature import SignatureTable, build_signatures
from kmers_anno_tpu.genome.gto import Genome
from kmers_anno_tpu.ops.dna_kmers import (dna_valid_np, pack_dna_np,
                                          pack_dna_windows, unpack_dna_np)
from kmers_anno_tpu.ops.encode import decode_dna, encode_dna

from fixtures import ROLE_DEFS, make_role_map, write_role_files

K = 15
COMP = str.maketrans("acgt", "tgca")


def rc(s: str) -> str:
    return s.translate(COMP)[::-1]


def random_dna(rng: random.Random, n: int) -> str:
    return "".join(rng.choice("acgt") for _ in range(n))


def dna_kmers(seq: str, k: int = K) -> list[str]:
    """Oracle: every unambiguous k-substring."""
    return [seq[i: i + k] for i in range(len(seq) - k + 1)
            if set(seq[i: i + k]) <= set("acgt")]


# ---------------------------------------------------------------------------
# fixture genomes with real CDS coordinates on one contig
# ---------------------------------------------------------------------------

def make_dna_genome(genome_id: str, seed: int,
                    cds_specs: list[tuple[str, int, str]],
                    extra_pegs: list[tuple[str, str]] = ()) -> Genome:
    """Build a genome whose contig embeds CDS regions with known strands.

    cds_specs: (function, cds_length, strand) — CDS DNA is random per peg,
    placed left-to-right with 60 bp spacers.  extra_pegs: (function, dna)
    pairs appended the same way on '+'.
    """
    rng = random.Random(seed)
    parts, features = [], []
    pos = 1  # 1-based contig coordinate of the next free base
    n = 0

    def place(function: str, cds: str, strand: str):
        nonlocal pos, n
        spacer = random_dna(rng, 60)
        parts.append(spacer)
        pos += len(spacer)
        left = pos
        right = pos + len(cds) - 1
        parts.append(cds if strand == "+" else rc(cds))
        pos = right + 1
        n += 1
        begin = left if strand == "+" else right
        features.append({
            "id": f"fig|{genome_id}.peg.{n}",
            "type": "CDS",
            "function": function,
            "location": [["con1", str(begin), strand, len(cds)]],
            "protein_translation": "M" * 10,
            "annotations": [], "aliases": [],
        })
        return left, right

    for function, length, strand in cds_specs:
        place(function, random_dna(rng, length), strand)
    for function, dna in extra_pegs:
        place(function, dna, "+")
    parts.append(random_dna(rng, 60))
    return Genome({
        "id": genome_id, "scientific_name": f"Dna testus {genome_id}",
        "genetic_code": 11, "domain": "Bacteria",
        "features": features,
        "contigs": [{"id": "con1", "dna": "".join(parts),
                     "genetic_code": 11}],
        "close_genomes": [], "subsystems": [],
    })


def oracle_build_dna(genomes, role_map, good_roles, k=K) -> dict[str, str]:
    """Naive transcription of the two-pass build over CDS DNA."""
    from collections import defaultdict
    seen = defaultdict(set)
    kill = set()
    for g in genomes:
        for peg in g.pegs:
            dna = g.get_dna(peg.location)
            roles = [r.id for r in peg.get_useful_roles(role_map)
                     if r.id in good_roles]
            if len(roles) == 1:
                for km in dna_kmers(dna, k):
                    seen[km].add(roles[0])
            elif not roles:
                kill.update(dna_kmers(dna, k))
    return {km: next(iter(rs)) for km, rs in seen.items()
            if len(rs) == 1 and km not in kill}


GOOD = {rid for rid, _ in ROLE_DEFS[:4]}


@pytest.fixture(scope="module")
def role_map():
    return make_role_map()


@pytest.fixture(scope="module")
def train_genomes(role_map):
    rng = random.Random(4242)
    shared = random_dna(rng, 40)  # embedded under two roles -> pruned
    killed = random_dna(rng, 40)  # embedded in an uninteresting peg too
    gs = []
    for i in range(2):
        specs = [(name, 300 + 30 * j, "+" if (i + j) % 2 else "-")
                 for j, (rid, name) in enumerate(ROLE_DEFS[:4])]
        extra = []
        if i == 0:
            extra = [
                (ROLE_DEFS[0][1], random_dna(rng, 60) + shared),
                (ROLE_DEFS[1][1], shared + random_dna(rng, 60)),
                (ROLE_DEFS[2][1], killed + random_dna(rng, 60)),
                (ROLE_DEFS[4][1], random_dna(rng, 30) + killed),  # kill peg
            ]
        gs.append(make_dna_genome(f"77{i}.1", seed=100 + i, cds_specs=specs,
                                  extra_pegs=extra))
    return gs


@pytest.fixture(scope="module")
def built(train_genomes, role_map):
    return build_signatures(train_genomes, role_map, GOOD, k=K,
                            progress=False, alphabet="dna")


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def test_pack_roundtrip():
    seq = "acgtacgtggttccaagtcgatcgtagc"
    codes = encode_dna(seq)
    lo, hi = pack_dna_np(codes, K)
    assert (hi == 0).all()
    texts = [decode_dna(row) for row in unpack_dna_np(lo, hi, K)]
    assert texts == [seq[i: i + K] for i in range(len(seq) - K + 1)]


def test_pack_marker_bit_no_empty_collision():
    # poly-g is the worst case: all 2-bit fields = 3
    codes = encode_dna("g" * 40)
    lo, _ = pack_dna_np(codes, 15)
    assert (lo != np.uint32(0xFFFFFFFF)).all()
    assert (lo >> 31 == 0).all()  # top bit clear (mesh padding invariant)


def test_device_host_pack_agree():
    rng = random.Random(7)
    seq = random_dna(rng, 200)
    codes = encode_dna(seq)
    dlo, dhi = pack_dna_windows(jnp.asarray(codes), K)
    hlo, hhi = pack_dna_np(codes, K)
    n = len(hlo)
    assert (np.asarray(dlo)[:n] == hlo).all()
    assert (np.asarray(dhi)[:n] == hhi).all()


def test_valid_mask_ambiguity():
    seq = "acgtacgtacgtacgtnacgtacgtacgtacgta"
    v = dna_valid_np(encode_dna(seq), K)
    npos = seq.index("n")
    for i in range(len(v)):
        assert v[i] == (not (i <= npos < i + K))


# ---------------------------------------------------------------------------
# build --dna
# ---------------------------------------------------------------------------

def test_build_dna_matches_oracle(built, train_genomes, role_map):
    oracle = oracle_build_dna(train_genomes, role_map, GOOD)
    device_db = dict(zip(built.kmer_texts(),
                         (built.role_ids[r] for r in built.role_idx)))
    assert device_db == oracle
    assert len(device_db) > 500


def test_build_dna_exercises_prune_and_kill(built):
    assert built.stats["pruned"] > 0
    assert built.stats["killed"] > 0
    assert built.alphabet == "dna"


def test_save_load_roundtrip(built, tmp_path):
    path = str(tmp_path / "dna.tbl")
    built.save(path)
    loaded = SignatureTable.load(path)
    assert loaded.alphabet == "dna"
    assert loaded.k == K
    assert sorted(loaded.kmer_texts()) == sorted(built.kmer_texts())


# ---------------------------------------------------------------------------
# apply on raw contigs, strand-aware
# ---------------------------------------------------------------------------

def oracle_regions(seq: str, db: dict[str, str], k: int, max_gap: int,
                   min_hits: int):
    """Independent loop-based region caller over one contig."""
    out = []
    for strand in "+-":
        s = seq if strand == "+" else rc(seq)
        hits = [(i, db[s[i: i + k]]) for i in range(len(s) - k + 1)
                if s[i: i + k] in db]
        cluster: list[tuple[int, str]] = []
        for pos, role in hits + [(10**9, "")]:
            if cluster and (pos - cluster[-1][0] > max_gap
                            or role != cluster[-1][1]):
                if len(cluster) >= min_hits:
                    w0, w1 = cluster[0][0], cluster[-1][0]
                    if strand == "+":
                        left, right = w0 + 1, w1 + k
                    else:
                        left = len(s) - w1 - k + 1
                        right = len(s) - w0
                    out.append((strand, left, right, cluster[0][1],
                                len(cluster)))
                cluster = []
            cluster.append((pos, role))
    return sorted(out)


def test_apply_dna_strand_aware(built, role_map):
    # target genome: fresh spacers around CDS DNA drawn from the training
    # genes so table kmers hit; strands flipped vs training placement
    rng = random.Random(31337)
    tg = make_dna_genome(
        "880.1", seed=555,
        cds_specs=[(ROLE_DEFS[0][1], 330, "+"), (ROLE_DEFS[1][1], 300, "-")])
    # splice two *training* CDS sequences into the target contig
    train = make_dna_genome(
        "771.1", seed=101,
        cds_specs=[(name, 300 + 30 * j, "+" if (1 + j) % 2 else "-")
                   for j, (rid, name) in enumerate(ROLE_DEFS[:4])])
    cds0 = train.get_dna(train.pegs[0].location)
    cds1 = train.get_dna(train.pegs[1].location)
    seq = (random_dna(rng, 80) + cds0 + random_dna(rng, 80)
           + rc(cds1) + random_dna(rng, 80))
    tg.contigs[0].raw["dna"] = seq

    engine = DnaApplyEngine(built, min_hits=5, max_gap=200)
    calls = engine.call_genome(tg)
    got = sorted((f.location.strand, f.location.left, f.location.right,
                  role, hits) for f, role, hits in calls)

    db = dict(zip(built.kmer_texts(),
                  (built.role_ids[r] for r in built.role_idx)))
    expected = oracle_regions(seq, db, K, max_gap=200, min_hits=5)
    assert got == expected
    # both strands actually called, with the right roles
    strands = {(role, strand) for strand, _, _, role, _ in expected}
    assert (ROLE_DEFS[0][0], "+") in strands
    assert (ROLE_DEFS[1][0], "-") in strands


def test_cluster_hits_gap_and_role_splits():
    roles = np.full(100, -1, np.int32)
    roles[[3, 5, 9]] = 2          # cluster A (role 2)
    roles[[11, 12]] = 7           # role change splits
    roles[[40, 44]] = 7           # gap > 20 splits
    got = cluster_hits(roles, k=15, max_gap=20, min_hits=2)
    assert got == [(3, 9, 2, 3), (11, 12, 7, 2), (40, 44, 7, 2)]


# ---------------------------------------------------------------------------
# CLI e2e
# ---------------------------------------------------------------------------

def test_cli_build_apply_dna(built, train_genomes, tmp_path, role_map):
    import os
    gto_dir = tmp_path / "gtos"
    gto_dir.mkdir()
    for g in train_genomes:
        g.save(str(gto_dir / f"{g.id}.gto"))
    role_file, use_file = write_role_files(tmp_path)
    db_file = str(tmp_path / "dna.tbl")

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(os.path.abspath(
                       __file__))), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run(
        [sys.executable, "-m", "kmers_anno_tpu", "build", "--dna",
         "-o", db_file, role_file, use_file, str(gto_dir)],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert open(db_file).readline().split("\t")[0].islower()

    r = subprocess.run(
        [sys.executable, "-m", "kmers_anno_tpu", "apply", "--format",
         "VERIFY", "-m", "5", db_file, use_file, str(gto_dir)],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "genome_id\tpeg_id\trole\thits\tfunction"
    # the training genomes' own contigs must light up their roles
    assert len(lines) > 4
    assert any(".region." in ln for ln in lines[1:])
