"""Weighted voting (BASELINE config 2 / north-star): packed (weight, role)
payloads, best-tally vote vs a Python oracle, unanimity byte-identity."""

import random

import numpy as np
import pytest

from kmers_anno_tpu.engine.apply_engine import KmerApplyEngine
from kmers_anno_tpu.engine.signature import (SignatureTable, build_signatures,
                                             compute_weights)

from fixtures import ROLE_DEFS, make_genome, make_role_map, random_protein
from oracle import protein_kmers

GOOD = {rid for rid, _ in ROLE_DEFS[:4]}
K = 8


@pytest.fixture(scope="module")
def built():
    genomes = [make_genome(f"200{i}.1", seed=50 + i) for i in range(3)]
    t = build_signatures(genomes, make_role_map(), GOOD, k=K,
                         progress=False, weight_mode="balance")
    assert t.weights is not None and len(t.weights) == len(t)
    return t


def oracle_weighted(protein: str, db: dict[str, tuple[str, float]],
                    min_weight: float):
    """Loop-based weighted vote: tally fp16-quantized weights per role,
    call the best role (ties -> lexically determined by role order in the
    engine, so the oracle returns the tally map for comparison)."""
    tallies: dict[str, float] = {}
    for km in protein_kmers(protein, K):
        if km in db:
            role, w = db[km]
            tallies[role] = tallies.get(role, 0.0) + float(np.float16(w))
    if not tallies:
        return None
    best = max(tallies.values())
    if best < min_weight:
        return None
    winners = [r for r, t in tallies.items() if t == best]
    return winners, best


def test_weight_modes():
    ridx = np.array([0, 0, 0, 1], np.int32)
    assert compute_weights(ridx, "none") is None
    assert (compute_weights(ridx, "uniform") == 1.0).all()
    bal = compute_weights(ridx, "balance")
    # two live roles, 4 kmers -> mean 2.0; role0 kmers weigh 2/3, role1 2/1
    np.testing.assert_allclose(bal, [2 / 3, 2 / 3, 2 / 3, 2.0], rtol=1e-6)


def test_save_load_weights_roundtrip(built, tmp_path):
    path = str(tmp_path / "weighted.tbl")
    built.save(path)
    first = open(path).readline().rstrip("\n").split("\t")
    assert len(first) == 3
    loaded = SignatureTable.load(path)
    assert loaded.weights is not None
    np.testing.assert_allclose(loaded.weights, built.weights, rtol=1e-4)


def test_weighted_matches_oracle(built):
    db = {km: (built.role_ids[r], float(w))
          for km, r, w in zip(built.kmer_texts(), built.role_idx,
                              built.weights)}
    rng = random.Random(77)
    # proteins spliced from table kmers of different roles + noise
    kmers_by_role: dict[str, list[str]] = {}
    for km, (role, _) in db.items():
        kmers_by_role.setdefault(role, []).append(km)
    roles = sorted(kmers_by_role)
    proteins = []
    for i in range(60):
        parts = [random_protein(rng, rng.randint(5, 20))]
        for _ in range(rng.randint(0, 6)):
            role = rng.choice(roles)
            parts.append(rng.choice(kmers_by_role[role]))
            parts.append(random_protein(rng, rng.randint(0, 10)))
        proteins.append("".join(parts))

    engine = KmerApplyEngine(built, min_hits=2, weighted=True,
                             min_weight=1.5)
    got = engine.call_proteins(proteins)
    for prot, result in zip(proteins, got):
        expect = oracle_weighted(prot, db, 1.5)
        if expect is None:
            assert result is None, prot
        else:
            winners, best = expect
            role, tally = result
            assert role in winners, (prot, result, expect)
            assert tally == pytest.approx(best, rel=1e-3)


def test_weighted_tie_breaks_to_smaller_role_index(built):
    # two single-kmer proteins with equal weights: engine must pick the
    # smaller role INDEX deterministically
    texts = built.kmer_texts()
    w = np.ones(len(texts), np.float32)
    table = SignatureTable(k=built.k, key_lo=built.key_lo,
                           key_hi=built.key_hi, role_idx=built.role_idx,
                           role_ids=built.role_ids, weights=w)
    idx_a = int(np.flatnonzero(built.role_idx == 0)[0])
    idx_b = int(np.flatnonzero(built.role_idx == 1)[0])
    prot = texts[idx_a] + texts[idx_b]  # one hit each, weight 1.0 each
    engine = KmerApplyEngine(table, weighted=True, min_weight=0.5)
    got = engine.call_proteins([prot])
    assert got[0] == (table.role_ids[0], 1.0)


def test_unweighted_path_byte_identical(built):
    """A weighted table driven through the default engine must reproduce
    the plain unanimity results exactly (payload packing only changes in
    weighted mode)."""
    plain = SignatureTable(k=built.k, key_lo=built.key_lo,
                           key_hi=built.key_hi, role_idx=built.role_idx,
                           role_ids=built.role_ids)
    genome = make_genome("2000.1", seed=50)  # a training genome: real hits
    pro = [f.protein_translation for f in genome.pegs]
    a = KmerApplyEngine(built, min_hits=3).call_proteins(pro)
    b = KmerApplyEngine(plain, min_hits=3).call_proteins(pro)
    assert a == b
    assert any(r is not None for r in a)


def test_cli_weighted(tmp_path):
    import os
    import subprocess
    import sys
    from fixtures import write_role_files

    genomes = [make_genome(f"400{i}.1", seed=20 + i) for i in range(2)]
    gto_dir = tmp_path / "gtos"
    gto_dir.mkdir()
    for g in genomes:
        g.save(str(gto_dir / f"{g.id}.gto"))
    role_file, use_file = write_role_files(tmp_path)
    db_file = str(tmp_path / "weighted.tbl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(os.path.abspath(
                       __file__))), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run(
        [sys.executable, "-m", "kmers_anno_tpu", "build",
         "--weights", "balance", "-o", db_file, role_file, use_file,
         str(gto_dir)], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "kmers_anno_tpu", "apply", "--weighted",
         "--format", "VERIFY", "--min-weight", "2.0", db_file, use_file,
         str(gto_dir)], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) > 10  # header + called pegs


def test_dense_and_sort_votes_agree():
    import jax.numpy as jnp
    from kmers_anno_tpu.ops.vote import (weighted_vote_dense,
                                         weighted_vote_flat)
    rng = np.random.default_rng(11)
    t, n_seqs, n_roles = 4096, 64, 17
    roles = rng.integers(-1, n_roles, t).astype(np.int32)
    weights = rng.random(t).astype(np.float32) * 2
    seg = rng.integers(0, n_seqs, t).astype(np.int32)
    valid = rng.random(t) < 0.8
    args = (jnp.asarray(roles), jnp.asarray(weights), jnp.asarray(seg),
            jnp.asarray(valid), jnp.float32(1.0))
    r1, t1 = weighted_vote_flat(*args, n_seqs=n_seqs)
    r2, t2 = weighted_vote_dense(*args, n_seqs=n_seqs, n_roles=n_roles)
    assert (np.asarray(r1) == np.asarray(r2)).all()
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-5)
