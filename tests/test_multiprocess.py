"""Two-process jax.distributed smoke test (SURVEY §5.8 multi-host).

Spawns two real OS processes wired by jax.distributed over localhost, each
owning 2 virtual CPU devices, and runs the mesh ``apply`` CLI on a 4x1
mesh.  The primary's report must be byte-identical to a single-process
run; the secondary must write nothing.
"""

import os
import socket
import subprocess
import sys

import pytest

from fixtures import make_genome, write_role_files

_WORKER = """
import sys
from kmers_anno_tpu.commands.app import main
main(sys.argv[1:])
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, port: int, n_dev: int = 2) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=8", "").strip()
        + f" --xla_force_host_platform_device_count={n_dev}").strip()
    env["KAN_COORDINATOR"] = f"127.0.0.1:{port}"
    env["KAN_NUM_PROCESSES"] = "2"
    env["KAN_PROCESS_ID"] = str(rank)
    return env


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    role_file, use_file = write_role_files(tmp)
    gdir = tmp / "gtos"
    gdir.mkdir()
    for i in range(8):
        make_genome(f"77{i}.1", seed=100 + i).save(
            str(gdir / f"77{i}.1.gto"))
    # build the signature DB once (single process)
    db = str(tmp / "kmer.db")
    env = _env(0, 0)
    for k in ("KAN_COORDINATOR", "KAN_NUM_PROCESSES", "KAN_PROCESS_ID"):
        env.pop(k)
    r = subprocess.run(
        [sys.executable, "-m", "kmers_anno_tpu", "build", "-K", "8",
         "-o", db, str(role_file), str(use_file), str(gdir)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    # single-process reference run on a 2x1 mesh (2 virtual devices)
    r = subprocess.run(
        [sys.executable, "-m", "kmers_anno_tpu", "apply", "--mesh", "2x1",
         "-m", "3", "--format", "VERIFY", db, str(use_file), str(gdir)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(r.stdout.strip().splitlines()) > 1
    return dict(db=db, use_file=str(use_file), gdir=str(gdir),
                want=r.stdout)


@pytest.mark.slow
def test_two_process_mesh_apply(workload, tmp_path):
    port = _free_port()
    outs = [str(tmp_path / f"out{r}.tbl") for r in (0, 1)]
    procs = []
    for rank in (0, 1):
        args = [sys.executable, "-c", _WORKER, "apply", "--mesh", "4x1",
                "-m", "3", "--format", "VERIFY", "-o", outs[rank],
                workload["db"], workload["use_file"], workload["gdir"]]
        procs.append(subprocess.Popen(
            args, env=_env(rank, port), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    rets = [p.wait(timeout=600) for p in procs]
    errs = [p.stderr.read() for p in procs]
    assert rets == [0, 0], (errs[0][-3000:], errs[1][-3000:])
    with open(outs[0]) as fh:
        got = fh.read()
    assert got == workload["want"]
    # secondary wrote an empty report (header only, no genome rows)
    with open(outs[1]) as fh:
        other = fh.read()
    assert len(other.strip().splitlines()) <= 1
