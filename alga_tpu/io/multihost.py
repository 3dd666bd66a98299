"""Multi-host sharded ingest (SURVEY §2.9 P7 — the accelerator equivalent of the
reference's parallel strided file reading, ref src/IO/InputReader.cpp:272-391
where T threads each open the file and read every T-th record).

Here every PROCESS of a jax.distributed job:
  1. scans the input file(s) with the cheap native pass-1 line count
     (native.fastx_scan) so all processes agree on the global record count
     and max length without coordination,
  2. fills ONLY the record slice whose SeqBatch rows land on its own
     devices (native.fastx_fill_range),
  3. preprocesses + packs that slice with the fused native pass
     (trim / N-drop / STR filter / revcomp interleave — identical layout to
     the single-host fastx.load_read_batch),
  4. assembles the GLOBAL sharded (packed, lengths, valid) device arrays
     with jax.make_array_from_process_local_data — no process ever holds
     the whole read store.

Differential contract: the gathered global arrays equal the single-process
load_read_batch() on the same files, padding rows aside
(tests/test_multihost.py::test_two_process_distributed_ingest)."""

from __future__ import annotations

import numpy as np

from alga_tpu.core import packing
from alga_tpu.io.fastx import detect_format


def load_read_batch_distributed(mesh, file1: str, file2: str | None = None,
                                *, trim_left: int = 3, trim_right: int = 3,
                                rna: bool = False, str_period: int = 20):
    """Returns (packed, lengths, valid, n_rows): jax Arrays sharded
    NamedSharding(mesh, P('r'[, None])) with n_rows real rows (the rest is
    padding with length 0 / valid False)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from alga_tpu import native

    step = 4 if file2 else 2
    d = int(mesh.devices.size)

    def _scan(path):
        buf = np.memmap(path, dtype=np.uint8, mode="r")
        buf = np.asarray(buf) if len(buf) else np.zeros(1, np.uint8)[:0]
        if len(buf) == 0:
            return buf, "my_input", 0, 0, None, 0
        fmt = detect_format(path)
        m, maxlen, meta, nch = native.fastx_scan(buf, fmt)
        return buf, fmt, m, maxlen, meta, nch

    buf1, fmt1, m1, len1, meta1, nch1 = _scan(file1)
    if file2:
        buf2, fmt2, m2, len2, meta2, nch2 = _scan(file2)
        assert m1 == m2, "mate files must align"
        lpad = max(len1, len2)
    else:
        lpad = len1
    lpad = max(1, lpad)
    wpad = packing.words_for(lpad)

    # global row layout: rows per device divisible by `step` so no record's
    # row block straddles a device (or process) boundary
    nrows = step * m1
    gran = d * step
    npad = max(gran, -(-nrows // gran) * gran)
    per = npad // d

    sharding = NamedSharding(mesh, P("r", None))
    # contiguous row range owned by this process's devices
    idx_map = sharding.addressable_devices_indices_map((npad, wpad))
    row_ranges = sorted((sl[0].start or 0, sl[0].stop or npad)
                        for sl in idx_map.values())
    row_lo = row_ranges[0][0]
    row_hi = row_ranges[-1][1]
    for (a0, a1), (b0, b1) in zip(row_ranges, row_ranges[1:]):
        assert a1 == b0, "process's device rows must be contiguous"
    assert row_lo % step == 0 and row_hi % step == 0

    rec_lo = row_lo // step
    rec_hi = min(row_hi // step, m1)
    m_local = max(0, rec_hi - rec_lo)
    local_rows = row_hi - row_lo

    packed_l = np.zeros((local_rows, wpad), dtype=np.uint32)
    lengths_l = np.zeros(local_rows, dtype=np.int32)
    dropped_l = np.ones(local_rows, dtype=np.uint8)   # padding rows invalid

    if m_local:
        kw = dict(trim_left=trim_left, trim_right=trim_right, rna=rna,
                  str_period=str_period, out_step=step,
                  out_packed=packed_l, out_lengths=lengths_l,
                  out_dropped=dropped_l)
        r1, rl1 = native.fastx_fill_range(buf1, fmt1, lpad, rec_lo, rec_hi,
                                          meta1, nch1)
        native.preprocess_pack(r1, rl1, out_base=1, **kw)
        if file2:
            r2, rl2 = native.fastx_fill_range(buf2, fmt2, lpad, rec_lo,
                                              rec_hi, meta2, nch2)
            native.preprocess_pack(r2, rl2, out_base=3, **kw)
    # rows past the filled records stay dropped (padding)
    dropped_l[step * m_local:] = 1

    sh1 = NamedSharding(mesh, P("r"))
    packed_g = jax.make_array_from_process_local_data(
        sharding, packed_l, (npad, wpad))
    lengths_g = jax.make_array_from_process_local_data(
        sh1, lengths_l, (npad,))
    valid_g = jax.make_array_from_process_local_data(
        sh1, ~dropped_l.astype(bool), (npad,))
    return packed_g, lengths_g, valid_g, nrows
