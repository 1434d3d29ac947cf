"""Chip smoke test: every engine once, through the CLI, on a GPU.

    python chip_smoke.py           # one GPU: the five single-device phases
    python chip_smoke.py --multi   # four GPUs: the multi-device CLI paths

Each phase builds its data from ``--seed``, drives the path a user runs
(``kmers_anno_tpu.commands.app.main``, in this process: a second JAX
process could not get the card's memory) and compares the result with a
plain reference; integer results must be exactly equal.  One line per
phase gives its size, wall time and parity.  The last line is one JSON
object, ``{"ok": true, "device": {...}}``, printed only when every phase
passed.  Without a GPU the script fails before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, replace

import numpy as np

K = 8                  # SEEDtk's default protein kmer size
MIN_HITS = 5           # apply -m default


@dataclass(frozen=True)
class Sizes:
    chrom_genes: int = 4100        # ~4.5 Mb chromosome
    plasmid_genes: int = 100       # ~0.1 Mb plasmid
    n_close: int = 10              # SEEDtk maxGenomes
    batch_genomes: int = 3
    apply_keys: int = 1_000_000
    apply_roles: int = 2000
    apply_genomes: int = 20
    apply_proteins: int = 4000
    big_keys: int = 10_000_000
    big_queries: int = 4_000_000
    dna_keys: int = 2_000_000
    dna_bases: int = 4_000_000
    hash_genomes: int = 4
    hash_proteins: int = 1500
    hash_protos: int = 32768


FULL = Sizes()
# the --multi paths: same widths, fewer and smaller genomes per run
MULTI = replace(FULL, chrom_genes=1000, plasmid_genes=25, batch_genomes=4,
                apply_genomes=8, hash_genomes=8, hash_protos=8192)


class SmokeFailure(RuntimeError):
    """A phase's result disagreed with its reference."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cli(*argv: str) -> None:
    from kmers_anno_tpu.commands.app import main

    rc = main(list(argv))
    check(rc == 0, f"CLI {argv[0]} exited {rc}")


@contextlib.contextmanager
def captured(logger: str, pattern: str):
    """Collect the regex groups of matching records of one logger."""
    found: list[tuple] = []
    rx = re.compile(pattern)

    class Grab(logging.Handler):
        def emit(self, record):
            m = rx.search(record.getMessage())
            if m:
                found.append(tuple(int(g) for g in m.groups()))

    log = logging.getLogger(logger)
    h = Grab()
    log.addHandler(h)
    try:
        yield found
    finally:
        log.removeHandler(h)


def _no_network(url, *a, **kw):
    raise SmokeFailure(f"attempted a network fetch: {url}")


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

def protein_genome(gid: str, proteins: list[str], function: str):
    from kmers_anno_tpu.genome.gto import Genome

    feats = [{"id": f"fig|{gid}.peg.{i + 1}", "type": "CDS",
              "function": function,
              "location": [["c1", str(10 * i + 1), "+", 3 * len(p) + 3]],
              "protein_translation": p, "annotations": [], "aliases": []}
             for i, p in enumerate(proteins)]
    return Genome({"id": gid, "scientific_name": "Testus", "genetic_code": 11,
                   "domain": "Bacteria", "features": feats,
                   "contigs": [{"id": "c1", "dna": "acgt" * 25}],
                   "close_genomes": [], "subsystems": []})


def projection_setup(rng, sz: Sizes, work: str):
    """Cache dir of close genomes + the new genomes' GTOs."""
    from kmers_anno_tpu.utils.synthetic import make_projection_workload

    n_bases, olds, new_genome = make_projection_workload(
        rng, (sz.chrom_genes, sz.plasmid_genes), sz.n_close, lo_cod=60,
        hi_cod=600, spacer=(50, 250), protein_mutation=0.02)
    cache = os.path.join(work, "cache")
    os.makedirs(cache)
    for gid, g in olds.items():
        g.save(os.path.join(cache, f"{gid}.gto"))
    return n_bases, olds, new_genome, cache


def feature_rows(genome):
    return [(f.id, f.function, f.location.contig_id, f.location.strand,
             f.location.left, f.location.right, f.protein_translation)
            for f in genome.features]


def normalized_gto(path: str) -> dict:
    """GTO JSON with the annotation-event epoch (the one field that
    varies from run to run) zeroed."""
    with open(path) as fh:
        d = json.load(fh)
    for f in d["features"]:
        for a in f.get("annotations", []):
            a[2] = 0
    return d


def write_batch(work: str, tag: str, genomes) -> tuple[str, list[str]]:
    d = os.path.join(work, tag)
    os.makedirs(d)
    outs = []
    with open(os.path.join(d, "batch.tbl"), "w") as fh:
        for g in genomes:
            g.save(os.path.join(d, f"{g.id}.in.gto"))
            fh.write(f"{g.id}.in.gto\t{g.id}.out.gto\n")
            outs.append(os.path.join(d, f"{g.id}.out.gto"))
    return os.path.join(d, "batch.tbl"), outs


def apply_setup(rng, sz: Sizes, work: str):
    """Signature table (binary, with fp16-exact weights), roles file and
    a GTO directory of planted-role proteins."""
    from kmers_anno_tpu.engine.signature import SignatureTable
    from kmers_anno_tpu.utils.synthetic import make_workload, planted_proteins

    protos, lo, hi, role = make_workload(rng, sz.apply_keys, sz.apply_roles, K)
    weights = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0]), size=len(lo))
    role_ids = [f"Role{r}" for r in range(sz.apply_roles)]
    table = SignatureTable(k=K, key_lo=lo, key_hi=hi, role_idx=role,
                           role_ids=role_ids, weights=weights)
    db = os.path.join(work, "apply.kdb")
    table.save_binary(db)
    roles_file = os.path.join(work, "roles.in.use")
    with open(roles_file, "w") as fh:
        fh.write("".join(r + "\n" for r in role_ids))
    gto_dir = os.path.join(work, "apply_gtos")
    os.makedirs(gto_dir)
    proteins = {}
    for i in range(sz.apply_genomes):
        gid = f"{600 + i}.1"
        prots = planted_proteins(rng, protos, sz.apply_proteins, 150, 450)
        g = protein_genome(gid, prots, "hypothetical protein")
        g.save(os.path.join(gto_dir, f"{gid}.gto"))
        proteins.update((f.id, f.protein_translation) for f in g.features)
    return table, db, roles_file, gto_dir, proteins


def hash_setup(rng, sz: Sizes, work: str):
    """A genome directory of point-mutated copies of one protein pool and
    an annotation file of prototypes drawn from the pool."""
    from kmers_anno_tpu.utils.synthetic import AA

    aa = np.frombuffer(AA.encode(), np.uint8)

    def mutate(p: bytes, n: int) -> str:
        b = bytearray(p)
        for i in rng.integers(0, len(b), n):
            b[i] = aa[rng.integers(0, len(aa))]
        return b.decode()

    pool = [aa[rng.integers(0, len(aa), 250)].tobytes()
            for _ in range(sz.hash_proteins)]
    gto_dir = os.path.join(work, "hash_gtos")
    os.makedirs(gto_dir)
    genomes = {}
    for gi in range(sz.hash_genomes):
        gid = f"{500 + gi}.1"
        prots = [mutate(p, 3) for p in pool]
        protein_genome(gid, prots, "hypothetical protein").save(
            os.path.join(gto_dir, f"{gid}.gto"))
        genomes[gid] = prots
    anno = os.path.join(work, "annos.tbl")
    protos = []
    with open(anno, "w") as fh:
        fh.write("protein\tannotation\n")
        for i in range(sz.hash_protos):
            p = mutate(pool[int(rng.integers(0, len(pool)))],
                       int(rng.integers(0, 8)))
            protos.append(p)
            fh.write(f"{p}\tRole {i}\n")
    return gto_dir, anno, genomes, protos


def verify_calls(path: str) -> dict:
    """VERIFY report → {peg id: (role, hits)}."""
    out = {}
    with open(path) as fh:
        next(fh)
        for line in fh:
            _, peg, role, hits, _ = line.rstrip("\n").split("\t")
            out[peg] = (role, float(hits))
    return out


def timed_median(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# single-device phases: each returns its one-line size description
# ---------------------------------------------------------------------------

def phase_projection(sz: Sizes, rng, work: str) -> str:
    import jax
    import jax.numpy as jnp

    from kmers_anno_tpu.engine.projection import (ProjectionAnnotator,
                                                  StreamWindowIndex,
                                                  genome_stream)
    from kmers_anno_tpu.genome.gto import Genome
    from kmers_anno_tpu.ops.contig_kmers import (frame_kmers_by_base,
                                                 scan_stream)
    from kmers_anno_tpu.ops.encode import encode_dna, reverse_complement_codes
    from kmers_anno_tpu.ops.translate import codon_lut

    n_bases, olds, new_genome, cache = projection_setup(rng, sz, work)
    genome = new_genome()

    # (a) the device scan, segment by segment, against the per-frame
    # reference
    idx = StreamWindowIndex.build(genome, K)
    lo, hi, valid = (np.asarray(x) for x in (idx.d_lo, idx.d_hi,
                                             idx.d_valid))
    for start, ci, strand in zip(idx.seg_start, idx.seg_contig,
                                 idx.seg_strand):
        codes = encode_dna(genome.contigs[ci].sequence)
        if strand:
            codes = reverse_complement_codes(codes)
        wlo, whi, wvalid = frame_kmers_by_base(codes, K, genome.genetic_code)
        sl = slice(start, start + len(wvalid))
        check(np.array_equal(valid[sl], wvalid)
              and np.array_equal(lo[sl][wvalid].astype(np.uint32),
                                 wlo[wvalid])
              and np.array_equal(hi[sl][wvalid].astype(np.uint32),
                                 whi[wvalid]),
              f"scan_stream != reference on contig {ci} strand {strand}")

    # (b) the CLI `kmers` against the host-index engine
    in_gto = os.path.join(work, "new.gto")
    out_gto = os.path.join(work, "new.out.gto")
    genome.save(in_gto)
    counters = (r"(\d+) proposals made, (\d+) merged, (\d+) rejected, "
                r"(\d+) too weak, (\d+) too little evidence, (\d+) kept")
    keys = ("made", "merged", "rejected", "weak", "small", "kept")
    with captured("kmers_anno_tpu.engine.projection", counters) as got:
        cli("kmers", "--cache", cache, "-i", in_gto, "-o", out_gto)
    host = ProjectionAnnotator(engine="host")
    ref = new_genome()
    stats = host.annotate_genome(ref, olds.get)
    check(got == [tuple(stats[k] for k in keys)],
          f"kmers counters {got} != host engine {stats}")
    check(feature_rows(Genome.load(out_gto)) == feature_rows(ref),
          "kmers features differ from the host engine's")
    check(stats["pegs"] > 0.9 * (sz.chrom_genes + sz.plasmid_genes),
          f"only {stats['pegs']} features called")

    # `batch` over distinct close variants of the genome
    variants = [new_genome(f"{401 + i}.1", snp_rate=0.002, seed=i + 1)
                for i in range(sz.batch_genomes)]
    listing, outs = write_batch(work, "batch", variants)
    with captured("kmers_anno_tpu.engine.projection", counters) as got:
        cli("batch", "--cache", cache, listing)
    for i, out in enumerate(outs):
        ref = new_genome(f"{401 + i}.1", snp_rate=0.002, seed=i + 1)
        stats = host.annotate_genome(ref, olds.get)
        check(got[i] == tuple(stats[k] for k in keys),
              f"batch genome {i} counters {got[i]} != host {stats}")
        check(feature_rows(Genome.load(out)) == feature_rows(ref),
              f"batch genome {i} features differ from the host engine's")

    # timings: the jitted scan alone, and the warm device engine
    stream, _, _ = genome_stream(genome, K)
    d_stream = jax.device_put(stream)
    d_lut = jnp.asarray(codon_lut(11))
    jax.block_until_ready(scan_stream(d_stream, d_lut, K))
    t_scan = timed_median(
        lambda: jax.block_until_ready(scan_stream(d_stream, d_lut, K)), 5)
    annot = ProjectionAnnotator()
    fresh = [new_genome() for _ in range(4)]
    annot.annotate_genome(fresh.pop(), olds.get)
    t_genome = timed_median(
        lambda: annot.annotate_genome(fresh.pop(), olds.get), 3)
    print(f"  scan_stream: {len(stream) - 3 * K + 1} windows, median of 5 "
          f"warm calls {t_scan * 1e3:.3f} ms; warm annotate_genome "
          f"{t_genome:.3f} s/genome (median of 3); scan share "
          f"{100 * t_scan / t_genome:.2f}%", flush=True)
    return (f"{n_bases / 1e6:.2f} Mb genome (2 contigs, "
            f"{sz.chrom_genes + sz.plasmid_genes} genes) x {sz.n_close} "
            f"close genomes: scan vs frame reference, kmers + batch x"
            f"{sz.batch_genomes} vs host engine")


def phase_apply(sz: Sizes, rng, work: str) -> str:
    from kmers_anno_tpu import native
    from kmers_anno_tpu.engine.signature import pack_kmers_np, unpack_kmer_np
    from kmers_anno_tpu.ops.encode import (PROT_PAD, decode_protein,
                                           encode_protein)
    from kmers_anno_tpu.ops.hashtable import build_table

    table, db, roles_file, gto_dir, proteins = apply_setup(rng, sz, work)
    out = os.path.join(work, "apply.tbl")
    cli("apply", "--format", "VERIFY", "-m", str(MIN_HITS), "-o", out, db,
        roles_file, gto_dir)
    calls = {peg: role for peg, (role, _) in verify_calls(out).items()}

    pegs = list(proteins)
    texts = [proteins[p] for p in pegs]
    width = max(len(t) for t in texts)
    codes = np.full((len(texts), width), PROT_PAD, np.uint8)
    for i, t in enumerate(texts):
        codes[i, :len(t)] = encode_protein(t)
    t8, mp = build_table(table.key_lo, table.key_hi,
                         table.role_idx.astype(np.uint32))
    compiled = native.apply_baseline(codes, t8, mp, K, MIN_HITS)
    check(compiled is not None, "native library unavailable")
    kmer_texts = [decode_protein(r) for r in
                  unpack_kmer_np(table.key_lo, table.key_hi, K)]
    jb = native.JavaDataflowBaseline(kmer_texts, table.role_idx, K)
    java = jb.apply(texts, K, MIN_HITS)
    jb.close()
    for name, ref in (("compiled", compiled), ("java-dataflow", java)):
        want = {p: table.role_ids[r] for p, r in zip(pegs, ref) if r >= 0}
        check(calls == want, f"apply calls differ from the {name} baseline "
                             f"({len(calls)} vs {len(want)} called)")
    check(len(calls) > 0.5 * len(pegs), f"only {len(calls)} calls")

    # weighted best-tally vote vs a NumPy tally in float64
    wout = os.path.join(work, "apply_w.tbl")
    cli("apply", "--format", "VERIFY", "--weighted", "--min-weight",
        str(MIN_HITS), "-o", wout, db, roles_file, gto_dir)
    wcalls = verify_calls(wout)
    keys = (table.key_hi.astype(np.uint64) << np.uint64(32)) | table.key_lo
    order = np.argsort(keys)
    skeys = keys[order]
    pid, qkeys = [], []
    for i, c in enumerate(codes):
        n = len(texts[i]) - K + 1
        qlo, qhi = pack_kmers_np(c[:len(texts[i])], K)
        pid.append(np.full(n, i, np.int64))
        qkeys.append((qhi.astype(np.uint64) << np.uint64(32)) | qlo)
    pid = np.concatenate(pid)
    qkeys = np.concatenate(qkeys)
    pos = np.minimum(np.searchsorted(skeys, qkeys), len(skeys) - 1)
    hit = skeys[pos] == qkeys
    row = order[pos[hit]]
    n_roles = len(table.role_ids)
    pair = pid[hit] * n_roles + table.role_idx[row]
    upair, inv = np.unique(pair, return_inverse=True)
    tally = np.bincount(inv, weights=table.weights[row].astype(np.float64))
    prot, role = upair // n_roles, upair % n_roles
    best = np.lexsort((role, -tally, prot))      # per protein: max, low role
    first = best[np.r_[True, prot[best][1:] != prot[best][:-1]]]
    want = {pegs[p]: (table.role_ids[r], t) for p, r, t in
            zip(prot[first], role[first], tally[first]) if t >= MIN_HITS}
    check(set(wcalls) == set(want) and all(
        wcalls[p][0] == want[p][0]
        and np.isclose(wcalls[p][1], want[p][1], rtol=1e-6, atol=0)
        for p in want), "weighted calls or tallies differ from the NumPy "
                        "reference")
    return (f"{len(table)}-entry table, {sz.apply_genomes} genomes x "
            f"{sz.apply_proteins} proteins: calls vs compiled + "
            f"java-dataflow cores; weighted vs NumPy tally")


def phase_big_table(sz: Sizes, rng, work: str) -> str:
    import jax.numpy as jnp

    from kmers_anno_tpu.ops.hashtable import build_table, probe_table
    from kmers_anno_tpu.ops.sliced_probe import (probe_table_sliced,
                                                 windowed_table)

    combined = np.unique(rng.integers(0, 1 << 59, sz.big_keys + 200_000,
                                      dtype=np.uint64))[:sz.big_keys]
    rng.shuffle(combined)
    key_lo = (combined & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    key_hi = (combined >> np.uint64(30)).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, len(key_lo)).astype(np.uint32)
    table, max_probes = build_table(key_lo, key_hi, vals)
    wt = windowed_table(table, max_probes)
    # half the queries are stored keys, half random (almost all misses)
    q = rng.integers(0, len(key_lo), sz.big_queries)
    qlo, qhi = key_lo[q].copy(), key_hi[q].copy()
    miss = rng.random(sz.big_queries) < 0.5
    qlo[miss] = rng.integers(0, 1 << 30, miss.sum(), dtype=np.uint32)
    qhi[miss] = rng.integers(0, 1 << 29, miss.sum(), dtype=np.uint32)
    valid = rng.random(sz.big_queries) < 0.99
    qc = (qhi.astype(np.uint64) << np.uint64(30)) | qlo
    order = np.argsort(combined)
    srt = combined[order]
    pos = np.minimum(np.searchsorted(srt, qc), len(srt) - 1)
    found = srt[pos] == qc
    where = order[pos]
    truth = np.where(valid & found, vals[where].astype(np.int64), -1)

    d = [jnp.asarray(x) for x in (qlo, qhi, valid)]
    plain = np.asarray(probe_table(jnp.asarray(table), *d, max_probes))
    d_wt = jnp.asarray(wt)
    sliced = np.asarray(probe_table_sliced(d_wt, *d, max_probes))
    seg = np.arange(sz.big_queries, dtype=np.int32)
    pv, pp = probe_table_sliced(d_wt, *d, max_probes,
                                payload=jnp.asarray(seg))
    pv, pp = np.asarray(pv), np.asarray(pp)
    by_query = np.full(sz.big_queries, -2, np.int64)
    by_query[pp] = pv
    check(np.array_equal(plain, truth), "plain gather walk != NumPy truth")
    check(np.array_equal(sliced, plain), "sliced probe != plain walk")
    check(np.array_equal(by_query, plain),
          "sliced payload-mode probe != plain walk")
    return (f"{sz.big_keys} keys ({wt.nbytes / 1e9:.2f} GB windowed), "
            f"{sz.big_queries} queries: sliced (+payload) vs plain walk "
            f"vs NumPy")


def phase_dna(sz: Sizes, rng, work: str) -> str:
    from kmers_anno_tpu import native
    from kmers_anno_tpu.engine.signature import SignatureTable
    from kmers_anno_tpu.genome.gto import Genome
    from kmers_anno_tpu.ops.dna_kmers import pack_dna_np
    from kmers_anno_tpu.ops.encode import reverse_complement_codes
    from kmers_anno_tpu.ops.hashtable import build_table

    k = 15
    src = rng.integers(0, 4, size=sz.dna_keys + k - 1).astype(np.uint8)
    lo, hi = pack_dna_np(src, k)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    _, idx = np.unique(key, return_index=True)
    idx = np.sort(idx)
    role = (idx // 2000).astype(np.int32)           # runs of one role
    role_ids = [f"DnaRole{r}" for r in range(int(role.max()) + 1)]
    table = SignatureTable(k=k, key_lo=lo[idx], key_hi=hi[idx],
                           role_idx=role, role_ids=role_ids, alphabet="dna")
    db = os.path.join(work, "dna.kdb")
    table.save_binary(db)
    roles_file = os.path.join(work, "dna_roles.in.use")
    with open(roles_file, "w") as fh:
        fh.write("".join(r + "\n" for r in role_ids))

    # 4 contigs: random DNA with 5 kb stretches copied from the key source
    contigs = []
    per = sz.dna_bases // 4
    for _ in range(4):
        c = rng.integers(0, 4, size=per).astype(np.uint8)
        for s in range(0, per - 5000, 12_500):
            o = int(rng.integers(0, len(src) - 5000))
            c[s: s + 5000] = src[o: o + 5000]
        contigs.append(c)
    gto_dir = os.path.join(work, "dna_gtos")
    os.makedirs(gto_dir)
    chars = np.frombuffer(b"tcag", np.uint8)
    Genome({"id": "700.1", "scientific_name": "Dnaus", "genetic_code": 11,
            "domain": "Bacteria", "features": [],
            "contigs": [{"id": f"d{i + 1}",
                         "dna": chars[c].tobytes().decode("ascii")}
                        for i, c in enumerate(contigs)],
            "close_genomes": [], "subsystems": []}).save(
        os.path.join(gto_dir, "700.1.gto"))
    out = os.path.join(work, "dna.tbl")
    cli("apply", "--format", "VERIFY", "-m", "1", "-o", out, db, roles_file,
        gto_dir)
    hits = int(sum(h for _, h in verify_calls(out).values()))

    t8, mp = build_table(table.key_lo, table.key_hi, role.astype(np.uint32))
    want = 0
    for c in contigs:
        for s in (c, reverse_complement_codes(c)):
            n = native.dna_baseline(s, t8, mp, k)
            check(n is not None, "native library unavailable")
            want += n
    check(hits == want, f"DNA hit count {hits} != compiled core {want}")
    check(hits > 0.1 * sz.dna_bases, f"only {hits} hits")
    return (f"K={k}, {len(table)}-key table, {sz.dna_bases} contig bases "
            f"(both strands): {hits} hits vs compiled core")


def phase_hashanno(sz: Sizes, rng, work: str) -> str:
    from kmers_anno_tpu import native

    gto_dir, anno, genomes, protos = hash_setup(rng, sz, work)
    out_dir = os.path.join(work, "Annotations")
    cli("hashAnno", "-K", str(K), "-D", out_dir, anno, gto_dir)
    n_called = 0
    for gid, prots in genomes.items():
        with open(os.path.join(out_dir, f"{gid}.anno.tbl")) as fh:
            next(fh)
            got = np.array([float(line.split("\t")[1]) for line in fh])
        hb = native.HashAnnoBaseline(prots, K, 0.0125)
        hb.score(protos)
        sim, _ = hb.best()
        hb.close()
        check(np.array_equal(got, sim),
              f"hashAnno best_sim differs from the compiled core in {gid}")
        n_called += int((sim > 0).sum())
    check(n_called > 0.5 * sz.hash_genomes * sz.hash_proteins,
          f"only {n_called} proteins matched")
    return (f"{sz.hash_genomes} genomes x {sz.hash_proteins} proteins vs "
            f"{sz.hash_protos} prototypes: best_sim vs compiled core")


# ---------------------------------------------------------------------------
# multi-device phases (--multi): each CLI path against its one-device run
# ---------------------------------------------------------------------------

def phase_mesh_apply(sz: Sizes, rng, work: str) -> str:
    _, db, roles_file, gto_dir, _ = apply_setup(rng, sz, work)
    single = os.path.join(work, "single.tbl")
    cli("apply", "--format", "VERIFY", "-o", single, db, roles_file, gto_dir)
    with open(single, "rb") as fh:
        want = fh.read()
    meshes = (("4x1", "auto"), ("2x2", "pmax"), ("1x4", "routed"))
    for mesh, mode in meshes:
        out = os.path.join(work, f"mesh_{mesh}_{mode}.tbl")
        cli("apply", "--format", "VERIFY", "--mesh", mesh, "--table-mode",
            mode, "-o", out, db, roles_file, gto_dir)
        with open(out, "rb") as fh:
            check(fh.read() == want,
                  f"apply --mesh {mesh} ({mode}) report != single device")
    return (f"{sz.apply_keys}-entry table, {sz.apply_genomes} genomes: "
            + ", ".join(f"--mesh {m} {t}" for m, t in meshes)
            + " vs one device")


def phase_batch_dp(sz: Sizes, rng, work: str) -> str:
    n_bases, _, new_genome, cache = projection_setup(rng, sz, work)
    genomes = [new_genome(f"{401 + i}.1", snp_rate=0.002, seed=i + 1)
               for i in range(sz.batch_genomes)]
    seq_list, seq_outs = write_batch(work, "seq", genomes)
    par_list, par_outs = write_batch(work, "par", genomes)
    cli("batch", "--cache", cache, seq_list)
    cli("batch", "--cache", cache, "--data-parallel", "4", par_list)
    for a, b in zip(seq_outs, par_outs):
        check(normalized_gto(a) == normalized_gto(b),
              f"batch --data-parallel 4 output {os.path.basename(b)} "
              "differs from the sequential run")
    return (f"{sz.batch_genomes} genomes of {n_bases / 1e6:.2f} Mb x "
            f"{sz.n_close} close: batch --data-parallel 4 vs sequential")


def phase_hashanno_dp(sz: Sizes, rng, work: str) -> str:
    gto_dir, anno, genomes, _ = hash_setup(rng, sz, work)
    seq, par = os.path.join(work, "seq"), os.path.join(work, "par")
    cli("hashAnno", "-K", str(K), "-D", seq, "--batch", "2", anno, gto_dir)
    cli("hashAnno", "-K", str(K), "-D", par, "--batch", "2",
        "--data-parallel", "4", anno, gto_dir)
    for name in [f"{gid}.anno.tbl" for gid in genomes] + ["changes.tbl"]:
        with open(os.path.join(seq, name)) as a, \
                open(os.path.join(par, name)) as b:
            check(a.read() == b.read(),
                  f"hashAnno --data-parallel 4 {name} != sequential")
    return (f"{sz.hash_genomes} genomes x {sz.hash_proteins} proteins vs "
            f"{sz.hash_protos} prototypes: --data-parallel 4 vs sequential")


SINGLE_PHASES = (("projection", phase_projection), ("apply", phase_apply),
                 ("big_table", phase_big_table), ("dna_apply", phase_dna),
                 ("hashAnno", phase_hashanno))
MULTI_PHASES = (("mesh_apply", phase_mesh_apply),
                ("batch_data_parallel", phase_batch_dp),
                ("hashAnno_data_parallel", phase_hashanno_dp))


def run(phases, sz: Sizes, seed: int) -> list[str]:
    """Run every phase, one line each; returns the names of those that
    failed (each failure's traceback goes to stderr)."""
    import traceback

    import jax

    from kmers_anno_tpu.genome import p3api

    p3api._http_json = _no_network
    compile_s = [0.0]

    def on_duration(event, secs, **kw):
        if event.startswith("/jax/core/compile/"):
            compile_s[0] += secs

    jax.monitoring.register_event_duration_secs_listener(on_duration)
    failed = []
    t_all = time.perf_counter()
    for i, (name, fn) in enumerate(phases):
        rng = np.random.default_rng([seed, i])
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory() as work:
                desc = fn(sz, rng, work)
        except Exception as exc:              # reported, and fails the run
            traceback.print_exc()
            failed.append(name)
            print(f"phase {name}: FAILED ({type(exc).__name__}: {exc}) | "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            continue
        print(f"phase {name}: {desc} | {time.perf_counter() - t0:.1f} s | "
              "parity: ok", flush=True)
    wall = time.perf_counter() - t_all
    print(f"compile (summed over threads): {compile_s[0]:.1f} s of "
          f"{wall:.1f} s wall ({100 * compile_s[0] / wall:.1f}%)", flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the multi-device CLI paths on four GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cuda"       # no silent CPU fallback
    os.environ.setdefault("KMERS_ANNO_LOG", "off")
    import jax

    from kmers_anno_tpu import native
    from kmers_anno_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform}")
    count = 4 if args.multi else 1
    if len(devs) < count:
        raise SystemExit(f"--multi needs 4 GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    for line in smi[:count]:
        print(line)
    print(f"jax {jax.__version__}; native library built: "
          f"{native.available()}", flush=True)
    failed = run(MULTI_PHASES if args.multi else SINGLE_PHASES,
                 MULTI if args.multi else FULL, args.seed)
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
