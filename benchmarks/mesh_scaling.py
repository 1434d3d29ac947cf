"""Mesh scaling harness: strong + weak scaling and the routed-vs-
replicated crossover, on a virtual 8-device CPU mesh.

bench.py launches this with JAX_PLATFORMS=cpu and
--xla_force_host_platform_device_count=8.  Virtual devices share the
host's physical cores, so ABSOLUTE throughput means nothing; every
section reports TIME RATIOS against its own 1-device (or replicated)
baseline, which isolate the compiled program's sharding/collective
overhead — the measurable stand-in for the BASELINE ≥80 % scaling
target until a multi-GPU host is available (parallel/mesh.py is the
same code either way).  Honest-reporting notes (r3 verdict):

* strong (fixed TOTAL work, sharded n ways): devices share cores, so
  the ideal ratio t(n)/t(1) is 1.0; above 1.0 = sharding overhead.
  Ratios slightly below 1.0 are host-scheduling noise, not speedup.
* weak (fixed work PER device): total work grows n×, all of it lands on
  the same shared cores, so the pure-compute ideal for t(n)/t(1) is n×
  core-count effects; the column to read is weak_overhead_n =
  t(n) / (n·t(1)) — 1.0 means the sharded program added nothing over
  running the work n times, > 1.0 is collective/partition overhead.
* routed vs replicated: same work on a (data, table) mesh — the
  all_to_all-routed sharded-table step vs the replicated-table step.
  ratio > 1.0 = routing costs more than replication at that table size
  (expected for small tables; the routed mode exists for tables too big
  to replicate — SURVEY §5.8).

Prints one JSON line with sections {"strong": …, "weak": …,
"routed_vs_replicated": …}.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K = 8
N_PROT = 1024
PLEN = 300
N_BATCH = 4


def make_table(rng, n_roles, pad_to=None):
    from kmers_anno_tpu.engine.signature import pack_kmers_np
    from kmers_anno_tpu.ops.hashtable import build_table

    protos = rng.integers(0, 20, size=(n_roles, 120)).astype(np.uint8)
    lo_all, hi_all, role_all = [], [], []
    for r in range(n_roles):
        lo, hi = pack_kmers_np(protos[r], K)
        lo_all.append(lo)
        hi_all.append(hi)
        role_all.append(np.full(len(lo), r, np.int32))
    if pad_to:
        fill = rng.integers(0, 20, size=pad_to + K - 1).astype(np.uint8)
        flo, fhi = pack_kmers_np(fill, K)
        lo_all.append(flo)
        hi_all.append(fhi)
        role_all.append(rng.integers(0, n_roles, len(flo)).astype(np.int32))
    lo = np.concatenate(lo_all)
    hi = np.concatenate(hi_all)
    role = np.concatenate(role_all)
    _, idx = np.unique((hi.astype(np.uint64) << np.uint64(32)) | lo,
                       return_index=True)
    table, max_probes = build_table(lo[idx], hi[idx],
                                    role[idx].astype(np.uint32))
    return protos, lo[idx], hi[idx], role[idx], table, max_probes


def genome_stream(rng, protos, n_roles, n_rows):
    prot = rng.integers(0, 20, size=(n_rows, N_PROT, PLEN)).astype(np.uint8)
    prot[:, :, 100:220] = protos[
        rng.integers(0, n_roles, size=(n_rows, N_PROT))]
    codes = prot.reshape(n_rows, -1)
    seg = np.broadcast_to(
        np.repeat(np.arange(N_PROT, dtype=np.int32), PLEN),
        codes.shape).copy()
    valid = np.ones(codes.shape, bool)
    for i in range(1, N_PROT + 1):
        valid[:, i * PLEN - K + 1: i * PLEN] = False
    return codes, seg, valid


def _median(times):
    import statistics

    return statistics.median(times)


def time_groups(step, d_table, groups, reps=3):
    import jax.numpy as jnp

    def run_all():
        acc = 0
        for args in groups:
            out = step(d_table, *args, jnp.int32(5))
            acc += int(jnp.sum(out[1]))
        return acc

    assert run_all() > 0  # compile + warm + sanity
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_all()
        times.append(time.perf_counter() - t0)
    return _median(times)


def main():
    import jax
    import jax.numpy as jnp

    from kmers_anno_tpu.parallel.mesh import (
        make_mesh, replicated_apply_step, routed_apply_step,
        shard_signature_table, sharded_apply_step,
        split_tokens_for_table_axis)

    assert len(jax.devices()) >= 8, jax.devices()
    rng = np.random.default_rng(11)
    protos, key_lo, key_hi, roles, table, max_probes = make_table(rng, 200)
    d_table = jnp.asarray(table)

    # ---- strong scaling: fixed total work (8 rows), sharded n ways ----
    strong = {}
    total_rows = 8
    batches = [genome_stream(rng, protos, 200, total_rows)
               for _ in range(N_BATCH)]
    for n_data in (1, 2, 4, 8):
        mesh = make_mesh(n_data, 1)
        step = replicated_apply_step(mesh, k=K, max_probes=max_probes,
                                     n_seqs=N_PROT)
        groups = []
        for c, s, v in batches:
            for i in range(0, total_rows, n_data):
                groups.append(tuple(jnp.asarray(a[i: i + n_data])
                                    for a in (c, s, v)))
        strong[str(n_data)] = time_groups(step, d_table, groups)
    strong_out = {
        f"t{n}_over_t1": round(strong[str(n)] / strong["1"], 3)
        for n in (2, 4, 8)}
    strong_out["ideal"] = 1.0
    strong_out["note"] = ("fixed total work on shared host cores; "
                          "> 1.0 = sharding overhead")

    # ---- weak scaling: fixed work PER device (2 rows each) ----
    weak = {}
    per_dev = 2
    for n_data in (1, 2, 4, 8):
        mesh = make_mesh(n_data, 1)
        step = replicated_apply_step(mesh, k=K, max_probes=max_probes,
                                     n_seqs=N_PROT)
        groups = []
        for _ in range(N_BATCH):
            c, s, v = genome_stream(rng, protos, 200, per_dev * n_data)
            groups.append(tuple(jnp.asarray(a) for a in (c, s, v)))
        weak[str(n_data)] = time_groups(step, d_table, groups)
    weak_out = {
        f"overhead_{n}": round(weak[str(n)] / (n * weak["1"]), 3)
        for n in (2, 4, 8)}
    weak_out["ideal"] = 1.0
    weak_out["note"] = ("fixed work per device on shared host cores: "
                        "t(n)/(n*t(1)); 1.0 = the sharded program adds "
                        "nothing over running the work n times; the "
                        "deficit below 1.0 is host-core parallelism")

    # ---- routed vs replicated at two table sizes (4 data x 2 table) ----
    rvr = {}
    n_data, n_table = 4, 2
    mesh = make_mesh(n_data, n_table)
    for label, pad_to in (("24k_keys", None), ("300k_keys", 280_000)):
        p2, lo2, hi2, r2, tab2, mp2 = make_table(
            np.random.default_rng(17), 200, pad_to=pad_to)
        c, s, v = genome_stream(np.random.default_rng(19), p2, 200, n_data)

        rstep = replicated_apply_step(mesh, k=K, max_probes=mp2,
                                      n_seqs=N_PROT)
        t_rep = time_groups(rstep, jnp.asarray(tab2),
                            [tuple(jnp.asarray(a) for a in (c, s, v))]
                            * N_BATCH)

        tables, mp_sh = shard_signature_table(lo2, hi2, r2, n_table)
        rows = [split_tokens_for_table_axis(
            c[i], s[i], v[i], n_table, K, N_PROT, 31)
            for i in range(n_data)]
        sc = jnp.asarray(np.stack([r[0] for r in rows]))
        ss = jnp.asarray(np.stack([r[1] for r in rows]))
        sv = jnp.asarray(np.stack([r[2] for r in rows]))
        tstep = routed_apply_step(mesh, k=K, max_probes=mp_sh,
                                  n_seqs=N_PROT)

        def time_routed():
            def run_all():
                acc = 0
                for _ in range(N_BATCH):
                    ro, h, ovf = tstep(jnp.asarray(tables), sc, ss, sv,
                                       jnp.int32(5))
                    assert int(ovf) == 0
                    acc += int(jnp.sum(h))
                return acc

            assert run_all() > 0
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run_all()
                times.append(time.perf_counter() - t0)
            return _median(times)

        t_rt = time_routed()
        rvr[label] = {"routed_over_replicated": round(t_rt / t_rep, 3),
                      "table_mb": round(tab2.nbytes / 1e6, 1)}
    rvr["note"] = ("(data=4, table=2) mesh; > 1.0 = all_to_all routing "
                   "costs more than replication at that table size — "
                   "routing pays off only when the table cannot be "
                   "replicated")

    # ---- config 5: 100M-entry sharded build -> routed apply ----
    config5 = config5_section(jax, jnp)

    # ---- batch projection data-parallel fan-out ----
    batch_dp = batch_dp_section()

    print(json.dumps({"strong": strong_out, "weak": weak_out,
                      "routed_vs_replicated": rvr,
                      "config5": config5,
                      "batch_dp": batch_dp,
                      "platform": "cpu-virtual-8"}))


def batch_dp_section():
    """`batch --data-parallel` wall-clock ratio on the virtual mesh.

    Lanes are device-pinned threads sharing this host's 2 physical
    cores, so the ideal here is bounded by core count, not lane count —
    the number to read is that fan-out helps at all (outputs are
    byte-identical; tests assert that).  On a real multi-chip host each
    lane owns a chip and the device compute overlaps fully."""
    import shutil
    import tempfile

    from kmers_anno_tpu.commands.app import main
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from tests.fixtures import make_projection_pair

    def setup(td, tag):
        d = os.path.join(td, tag)
        cache = os.path.join(d, "cache")
        os.makedirs(cache)
        jobs = []
        for i in range(6):
            new_g, olds = make_projection_pair(
                seed=500 + i, n_genes=100, new_id=f"41{i}.1",
                old_id=f"31{i}.1")
            new_g.save(os.path.join(d, f"in{i}.gto"))
            for gid, og in olds.items():
                og.save(os.path.join(cache, f"{gid}.gto"))
            jobs.append((f"in{i}.gto", f"out{i}.gto"))
        listing = os.path.join(d, "batch.tbl")
        with open(listing, "w") as fh:
            fh.writelines(f"{a}\t{b}\n" for a, b in jobs)
        return listing, cache

    td = tempfile.mkdtemp()
    try:
        out = {}
        for tag, extra in (("seq", []),
                           ("dp2", ["--data-parallel", "2"]),
                           ("dp4", ["--data-parallel", "4"])):
            # first lap warms each lane device's executables (jax caches
            # compiled programs PER DEVICE); the second lap is timed
            for lap in range(2):
                listing, cache = setup(td, f"{tag}{lap}")
                t0 = time.perf_counter()
                rc = main(["batch", "--cache", cache] + extra + [listing])
                assert rc == 0
                out[tag] = time.perf_counter() - t0
        return {
            "genomes": 6,
            "seq_s": round(out["seq"], 2),
            "dp2_s": round(out["dp2"], 2),
            "dp4_s": round(out["dp4"], 2),
            "dp2_speedup": round(out["seq"] / out["dp2"], 2),
            "dp4_speedup": round(out["seq"] / out["dp4"], 2),
            "note": ("lanes share 2 host cores on the virtual mesh; "
                     "byte-identical outputs are asserted by "
                     "tests/test_fused_scan.py")}
    finally:
        shutil.rmtree(td, ignore_errors=True)


CONFIG5_KEYS = int(os.environ.get("KAN_CONFIG5_KEYS", 100_000_000))


def config5_section(jax, jnp):
    """The ≥100M-entry sharded path, end to end on the virtual mesh
    (SURVEY §5.8, §7 step 6): hash-partitioned shard tables built from
    real kmer windows, routed apply over (data=4, table=2), calls
    byte-identical to a single-device probe of the unsharded table on a
    subsample.  CPU-virtual timing — the number that matters here is
    that the path RUNS at this scale; per-shard sizing documents why
    sharding exists (8 shards × one replica beat 8 full replicas on
    HBM: a 100M-entry 8-slot table is ~3.2 GB, so replicating it 8×
    costs ~26 GB of device memory vs ~3.2 GB sharded)."""
    import gc

    from kmers_anno_tpu.engine.apply_engine import apply_flat
    from kmers_anno_tpu.ops.hashtable import build_table
    from kmers_anno_tpu.parallel.mesh import (
        make_mesh, routed_apply_step, shard_signature_table,
        split_tokens_for_table_axis)
    from kmers_anno_tpu.engine.signature import pack_kmers_np

    rng = np.random.default_rng(41)
    n_data, n_table = 4, 2
    t0 = time.perf_counter()
    protos = rng.integers(0, 20, size=(200, 120)).astype(np.uint8)
    blob = rng.integers(0, 20, size=CONFIG5_KEYS + K - 1).astype(np.uint8)
    lo, hi = pack_kmers_np(blob, K)
    del blob
    plo, phi, prole = [], [], []
    for r in range(200):
        a, b = pack_kmers_np(protos[r], K)
        plo.append(a)
        phi.append(b)
        prole.append(np.full(len(a), r, np.int32))
    lo = np.concatenate([lo] + plo)
    hi = np.concatenate([hi] + phi)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    ukey, idx = np.unique(key, return_index=True)
    del key
    lo, hi = lo[idx], hi[idx]
    role = rng.integers(0, 200, len(lo)).astype(np.int32)
    # plant the proto kmers' true roles so planted segments CALL
    pk = [(b.astype(np.uint64) << np.uint64(32)) | a
          for a, b in zip(plo, phi)]
    pos = np.searchsorted(ukey, np.concatenate(pk))
    role[pos] = np.concatenate(prole)
    del ukey
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    tables, mp = shard_signature_table(lo, hi, role, n_table)
    t_shard_build = time.perf_counter() - t0
    shard_bytes = int(tables[0].nbytes)

    codes, seg, valid = genome_stream(rng, protos, 200, n_data)
    rows = [split_tokens_for_table_axis(codes[i], seg[i], valid[i],
                                        n_table, K, N_PROT, 31)
            for i in range(n_data)]
    sc = jnp.asarray(np.stack([r[0] for r in rows]))
    ss = jnp.asarray(np.stack([r[1] for r in rows]))
    sv = jnp.asarray(np.stack([r[2] for r in rows]))
    mesh = make_mesh(n_data, n_table)
    step = routed_apply_step(mesh, k=K, max_probes=mp, n_seqs=N_PROT)
    d_tables = jnp.asarray(tables)
    del tables
    gc.collect()
    roles_m, hits_m, ovf = step(d_tables, sc, ss, sv, jnp.int32(5))
    assert int(ovf) == 0
    times = []
    for _ in range(1):   # a scale PROOF, not a perf claim: one timed
        t0 = time.perf_counter()   # rep keeps the harness in budget
        r2, h2, ovf = step(d_tables, sc, ss, sv, jnp.int32(5))
        int(jnp.sum(h2))
        times.append(time.perf_counter() - t0)
    roles_m = np.asarray(roles_m).reshape(n_data, N_PROT)
    del d_tables
    gc.collect()

    # byte-identical subsample check vs the unsharded single-device probe
    t0 = time.perf_counter()
    ftab, fmp = build_table(lo, hi, role.astype(np.uint32))
    t_full_build = time.perf_counter() - t0
    r1, _ = apply_flat(jnp.asarray(ftab), jnp.asarray(codes[0]),
                       jnp.asarray(seg[0]), jnp.asarray(valid[0]),
                       jnp.int32(5), k=K, max_probes=fmp, n_seqs=N_PROT)
    identical = bool(np.array_equal(np.asarray(r1), roles_m[0]))
    called = int((roles_m >= 0).sum())
    return dict(
        table_entries=int(len(lo)),
        shards=n_table, data_axis=n_data,
        per_shard_bytes=shard_bytes,
        full_table_bytes=int(ftab.nbytes),
        sharded_build_s=round(t_shard_build, 1),
        full_build_s=round(t_full_build, 1),
        keygen_s=round(t_gen, 1),
        routed_step_s=round(_median(times), 3),
        routed_tokens_per_s=round(codes.size / _median(times), 0),
        calls=called, subsample_identical=identical,
        note=("cpu-virtual mesh: proves the >=100M-entry sharded path "
              "runs and matches the unsharded probe; on real chips "
              "routing pays when replicas would not fit device memory or "
              "replica broadcast dominates — at this size a replica is "
              "~3.2 GB/chip vs ~0.4 GB/chip sharded over 8"))


if __name__ == "__main__":
    main()
