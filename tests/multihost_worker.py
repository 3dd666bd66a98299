"""Worker for the 2-process jax.distributed CPU test (run by
tests/test_multihost.py).  Each process owns 4 virtual CPU devices of an
8-device global mesh; the de-replicated sharded GCPS runs over the global
mesh, with all_to_all traffic crossing the process boundary — the
fake-backend analogue of a multi-host GPU cluster (SURVEY.md §4-d).

Usage: python tests/multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4").strip()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nproc, process_id=pid)

    import numpy as np
    from alga_tpu.core import packing  # also sets the compile cache
    from alga_tpu.graph import prefsuf
    from alga_tpu.parallel import mesh as mesh_mod
    from alga_tpu.parallel.sharded_gcps import gcps_graph_sharded

    assert len(jax.devices()) == 4 * nproc
    assert len(jax.local_devices()) == 4
    mesh = mesh_mod.make_mesh()

    rng = np.random.default_rng(2)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=400))
    seqs = [genome[i: i + 48] for i in range(0, 400 - 48, 4)]
    packed, lengths = packing.pack_strings(seqs)
    n = len(seqs)

    g_sharded = gcps_graph_sharded(mesh, packed, lengths, n, 20, 500, 35)
    g_single = prefsuf.build_gcps_graph(packed, lengths, n, 20, 500, 35)
    assert g_sharded.edge_set() == g_single.edge_set(), \
        "multi-process sharded pipeline diverged from single-device graph"
    assert g_sharded.num_edges > 0
    print(f"proc {pid}: OK edges={g_sharded.num_edges}", flush=True)

    # --- multi-host sharded ingest (SURVEY P7): each process fills only
    # its own record slice; the gathered global batch must equal the
    # single-process load_read_batch on the same files -------------------
    f1 = os.environ.get("ALGA_TEST_INGEST_F1")
    f2 = os.environ.get("ALGA_TEST_INGEST_F2") or None
    if f1:
        from jax.experimental import multihost_utils
        from alga_tpu.io import fastx
        from alga_tpu.io.multihost import load_read_batch_distributed

        pk, ln, vd, nrows = load_read_batch_distributed(mesh, f1, f2)
        pk_h = np.asarray(multihost_utils.process_allgather(pk, tiled=True))
        ln_h = np.asarray(multihost_utils.process_allgather(ln, tiled=True))
        vd_h = np.asarray(multihost_utils.process_allgather(vd, tiled=True))
        ref = fastx.load_read_batch(f1, f2)
        assert nrows == len(ref), (nrows, len(ref))
        w = min(pk_h.shape[1], ref.packed.shape[1])
        assert np.array_equal(pk_h[:nrows, :w], ref.packed[:, :w])
        assert not pk_h[:nrows, w:].any() and not ref.packed[:, w:].any()
        assert np.array_equal(ln_h[:nrows], ref.lengths)
        assert np.array_equal(vd_h[:nrows], ref.valid)
        assert not vd_h[nrows:].any()          # padding rows invalid
        print(f"proc {pid}: INGEST OK rows={nrows}", flush=True)

    # --- distributed END-TO-END: multi-process ingest -> sharded GCPS /
    # simplify / contract discovery -> contigs, every process writing its
    # own copy for the parent's byte-parity check vs single-process
    # assemble() (VERDICT r3 item 2) ------------------------------------
    e1 = os.environ.get("ALGA_TEST_E2E_F1")
    if e1:
        from alga_tpu.config import AssemblyConfig
        from alga_tpu.parallel.distributed import assemble_distributed
        from alga_tpu.utils.timers import counters_report

        e2 = os.environ.get("ALGA_TEST_E2E_F2") or None
        outp = os.environ["ALGA_TEST_E2E_OUT"] + f".proc{pid}"
        cfg = AssemblyConfig(file1=e1, file2=e2, output=outp)
        res = assemble_distributed(cfg, write_output=False)
        from alga_tpu.io import output as output_mod
        output_mod.write_contigs(res.contigs, outp)
        # O(N/d) contract (VERDICT r4 item 3): non-0 processes never
        # materialize the packed store host-side — report the watermark
        rows = counters_report().get("dist_store_host_rows", 0)
        print(f"proc {pid}: E2E OK contigs={len(res.contigs)} "
              f"store_rows={rows}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
