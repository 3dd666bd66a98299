"""Multi-process (jax.distributed) test of the sharded GCPS pipeline: two
processes x 4 virtual CPU devices = one 8-device global mesh, with the
all_to_all key routing and remote row fetches crossing the process
boundary.  This is the multi-host path the VERDICT required to exist
before hardware does; on real GPUs the same code rides NVLink/NCCL."""

import os
import socket
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_gcps(tmp_path):
    # paired input files for the distributed-ingest leg of the worker
    import numpy as np
    rng = np.random.default_rng(5)
    bases = "ACGT"
    with open(tmp_path / "m1.fastq", "w") as fa, \
         open(tmp_path / "m2.fastq", "w") as fb:
        for i in range(211):   # odd count -> exercises padding rows
            s1 = "".join(bases[c] for c in rng.integers(0, 4, 60))
            s2 = "".join(bases[c] for c in rng.integers(0, 4, 60))
            fa.write(f"@a{i}\n{s1}\n+\n{'I'*60}\n")
            fb.write(f"@b{i}\n{s2}\n+\n{'I'*60}\n")

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)          # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    env["ALGA_TEST_INGEST_F1"] = str(tmp_path / "m1.fastq")
    env["ALGA_TEST_INGEST_F2"] = str(tmp_path / "m2.fastq")
    worker = os.path.join(_ROOT, "tests", "multihost_worker.py")

    procs = [
        subprocess.Popen([sys.executable, worker, str(pid), "2", str(port)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=840)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "OK edges=" in out
        assert "INGEST OK" in out


def test_two_process_distributed_e2e(tmp_path):
    """One command runs ingest -> sharded graph phases -> contigs across 2
    processes; contigs.fasta is byte-identical to single-process assemble
    on the same files, and identical across processes (VERDICT r3 item 2)."""
    import numpy as np

    from tests.simulate import random_genome, simulate_paired

    rng = np.random.default_rng(31)
    genome = random_genome(rng, 12_000)
    r1, r2 = simulate_paired(genome, rng, read_len=100, insert=300,
                             coverage=10.0)
    for name, rs in (("e1", r1), ("e2", r2)):
        with open(tmp_path / f"{name}.fastq", "w") as f:
            for i, r in enumerate(rs):
                f.write(f"@p{i}\n{r}\n+\n{'I' * len(r)}\n")

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["ALGA_TEST_E2E_F1"] = str(tmp_path / "e1.fastq")
    env["ALGA_TEST_E2E_F2"] = str(tmp_path / "e2.fastq")
    env["ALGA_TEST_E2E_OUT"] = str(tmp_path / "dist.fasta")
    worker = os.path.join(_ROOT, "tests", "multihost_worker.py")

    procs = [
        subprocess.Popen([sys.executable, worker, str(pid), "2", str(port)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=840)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost e2e workers timed out\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "E2E OK" in out

    # single-process reference on the same files
    from alga_tpu.config import AssemblyConfig
    from alga_tpu.pipeline import assemble_to_file

    single = tmp_path / "single.fasta"
    assemble_to_file(AssemblyConfig(file1=str(tmp_path / "e1.fastq"),
                                    file2=str(tmp_path / "e2.fastq"),
                                    output=str(single)))
    want = single.read_bytes()
    assert len(want) > 0
    # process 0 owns the contig phase and must match byte-for-byte; other
    # processes return empty (the O(N/d) contract, VERDICT r4 item 3: the
    # packed store is never gathered to non-0 hosts)
    got0 = (tmp_path / "dist.fasta.proc0").read_bytes()
    assert got0 == want, "proc 0 contigs differ from single-process"
    got1 = (tmp_path / "dist.fasta.proc1").read_bytes()
    assert got1 == b"", "non-0 process unexpectedly produced contigs"
    import re
    rows = {}
    for out in outs:
        for m in re.finditer(r"proc (\d+): E2E OK contigs=(\d+) "
                             r"store_rows=(\d+)", out):
            rows[int(m.group(1))] = int(m.group(3))
    assert set(rows) == {0, 1}, f"missing store_rows reports: {outs}"
    # proc 1's host watermark = its own shard + one gather chunk — strictly
    # below proc 0's (which ends holding every kept row)
    assert rows[1] < rows[0], rows


def test_virtual_mesh_distributed_e2e(tmp_path):
    """assemble_distributed over a single-process 8-device virtual mesh:
    sharded mark + slot-id GCPS + renumber + sharded simplify + process-0
    contigs, byte-identical to the host pipeline (VERDICT r4 item 3)."""
    import numpy as np

    from alga_tpu.config import AssemblyConfig
    from alga_tpu.parallel.distributed import assemble_distributed
    from alga_tpu.parallel.mesh import make_mesh
    from alga_tpu.pipeline import assemble_to_file
    from tests.simulate import random_genome, simulate_paired

    rng = np.random.default_rng(37)
    genome = random_genome(rng, 9_000)
    r1, r2 = simulate_paired(genome, rng, read_len=100, insert=300,
                             coverage=12.0)
    for name, rs in (("m1", r1), ("m2", r2)):
        with open(tmp_path / f"{name}.fastq", "w") as f:
            for i, r in enumerate(rs):
                f.write(f"@p{i}\n{r}\n+\n{'I' * len(r)}\n")

    mesh = make_mesh(8)
    dist = tmp_path / "dist.fasta"
    assemble_distributed(
        AssemblyConfig(file1=str(tmp_path / "m1.fastq"),
                       file2=str(tmp_path / "m2.fastq"),
                       output=str(dist)), mesh=mesh)
    single = tmp_path / "single.fasta"
    assemble_to_file(AssemblyConfig(file1=str(tmp_path / "m1.fastq"),
                                    file2=str(tmp_path / "m2.fastq"),
                                    output=str(single)))
    assert dist.read_bytes() == single.read_bytes()
    assert len(dist.read_bytes()) > 0


def test_mark_prefix_sharded_parity(rng):
    """Sharded duplicate/prefix marking == host mark on mixed-length reads
    with injected duplicates and strict prefixes."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from alga_tpu.io import fastx
    from alga_tpu.parallel.mesh import make_mesh
    from alga_tpu.parallel.sharded_gcps import _put
    from alga_tpu.parallel.sharded_preprocess import mark_prefix_sharded
    from tests.simulate import random_genome

    g = random_genome(rng, 5000)
    reads = []
    for _ in range(600):
        L = int(rng.integers(40, 100))
        p = int(rng.integers(0, 5000 - L))
        reads.append(g[p : p + L])
    reads += [reads[0], reads[1][:50], reads[2][:30], reads[3]]
    b = fastx.build_read_batch(reads, trim_left=0, trim_right=0)
    want = fastx.mark_prefix_reads(b)

    mesh = make_mesh(8)
    n = len(b)
    npad = -(-n // 32) * 32
    packed = np.asarray(b.packed)
    packed_pad = np.vstack(
        [packed, np.zeros((npad - n, packed.shape[1]), packed.dtype)])
    lengths = np.concatenate([b.lengths, np.zeros(npad - n, np.int64)])
    valid = np.concatenate([b.valid, np.zeros(npad - n, bool)])
    pd = _put(packed_pad, NamedSharding(mesh, P("r", None)))
    got = mark_prefix_sharded(mesh, pd, lengths, valid)[:n]
    assert np.array_equal(got, want)
    assert want.any()
