"""The port's IBD text writer (fastsmc_tpu_torch.io.writers, with the
writer-thread repair, its pool of workers and one gzip member per chunk)
and the writer counters its FastSMC carries across checkpoints."""

import gzip
import os
import threading
import time
import zlib

import numpy as np
import pytest

from fastsmc_tpu.io import writers as jax_writers
from fastsmc_tpu import native as jax_native

import fastsmc_tpu_torch
from fastsmc_tpu_torch import native
from fastsmc_tpu_torch.config import DecodingParams
from fastsmc_tpu_torch.io import writers
from fastsmc_tpu_torch.io.writers import IbdTextWriter
from fastsmc_tpu_torch.utils.timer import SpanRecorder


def _block(n, seed):
    rng = np.random.default_rng(seed)
    ind = rng.integers(0, 4, (2, n))
    return (ind[0], 1 + rng.integers(0, 2, n), ind[1],
            1 + rng.integers(0, 2, n), rng.integers(1, 10**6, n),
            rng.integers(10**6, 10**7, n),
            rng.random(n).astype(np.float32), rng.random(n),
            rng.random(n).astype(np.float32), rng.random(n).astype(np.float32))


def _open(cls, path):
    return cls(str(path), [f"f{i}" for i in range(4)],
               [f"i{i}" for i in range(4)], 1)


def _workers(monkeypatch, w):
    """W = ``w``, through the core count the writer reads."""
    monkeypatch.setattr(writers, "_usable_cores", lambda: w + 1)
    assert writers.pool_workers() == w


def _members(data):
    """Each gzip member's compressed length and text, walked with zlib
    alone; every member must be complete."""
    out = []
    while data:
        d = zlib.decompressobj(31)
        text = d.decompress(data) + d.flush()
        assert d.eof, "a member is cut short"
        out.append((len(data) - len(d.unused_data), text))
        data = d.unused_data
    return out


def _close_within(writer, seconds):
    """Run ``writer.close()`` on a thread; return (finished, error)."""
    box = {}

    def run():
        try:
            writer.close()
        except BaseException as e:      # handed to the test
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    return not t.is_alive(), box.get("err")


@pytest.mark.parametrize("case", ["every block, one worker",
                                  "one chunk of eight, four workers"])
def test_formatter_failure_makes_close_raise(case, tmp_path, monkeypatch):
    """A formatter that returns None fails the chunk it was given; the
    chunks queued behind it are still taken, so close() raises the error
    within 10 s instead of waiting forever. One worker: three one-chunk
    blocks all refused (the JAX writer's hang). Four workers: one block of
    eight chunks, the third refused, the others formatted."""
    # the threaded path needs only get_lib() to answer
    monkeypatch.setattr(native, "get_lib", lambda: object())
    gate = threading.Event()
    many = case.startswith("one chunk")
    _workers(monkeypatch, 4 if many else 1)
    monkeypatch.setattr(writers, "CHUNK_RECORDS", 5)

    def refuse(id_blob, id_off, ind1, hap1, ind2, hap2, pos_start, *rest):
        gate.wait(10)                   # let every chunk queue first
        if many and pos_start[0] != 10:
            return b"record\n" * len(ind1)
        return None

    monkeypatch.setattr(native, "format_ibd", refuse)
    w = _open(IbdTextWriter, tmp_path / "x.ibd.gz")
    for seed in range(1 if many else 3):
        b = list(_block(40 if many else 5, seed))
        b[4] = np.arange(len(b[0]))     # chunk k starts at 5 k
        w.write_block(*b)
    gate.set()
    finished, err = _close_within(w, 10)
    assert finished, "close() hung"
    assert isinstance(err, RuntimeError) and "formatter" in str(err), err


# blocks of several chunks at CHUNK_RECORDS = 16, and blocks smaller than
# one that share a member with their neighbours
SIZES = (50, 3, 64, 5, 78, 2, 40)


def _write_mixed(w, mod, monkeypatch):
    """Blocks of SIZES records through the native formatter, with blocks
    through the Python fallback between them: the
    library is missing for the calling thread while it writes those (the
    writer threads still format the blocks queued before)."""
    lib, main = mod.get_lib(), threading.current_thread()
    fallback = [False]
    monkeypatch.setattr(mod, "get_lib", lambda: None if fallback[0] and
                        threading.current_thread() is main else lib)
    for seed, n in enumerate(SIZES):
        fallback[0] = seed % 3 == 1
        b = _block(n, seed)
        if seed == 4:                   # columns left out
            b = b[:6] + (None, b[7], None, b[9])
        w.write_block(*b)
    fallback[0] = False


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_writer_output_equals_jax_writer(workers, tmp_path, monkeypatch):
    """On the normal path the port's writer writes the JAX package's
    decompressed bytes, whatever W, with blocks of several chunks, blocks
    smaller than one, and the Python fallback's records in their place
    among them; one complete member per chunk of CHUNK_RECORDS records,
    cut across the blocks' edges, the last holding the rest."""
    _workers(monkeypatch, workers)
    monkeypatch.setattr(writers, "CHUNK_RECORDS", 16)
    paths = []
    for cls, mod in ((IbdTextWriter, native),
                     (jax_writers.IbdTextWriter, jax_native)):
        path = tmp_path / f"{cls.__module__}.ibd.gz"
        w = _open(cls, path)
        _write_mixed(w, mod, monkeypatch)
        w.close()
        paths.append(path)
    a, b = (gzip.open(p, "rb").read() for p in paths)
    assert a == b and a.count(b"\n") == sum(SIZES)
    members = _members(paths[0].read_bytes())
    assert len(members) == -(-sum(SIZES) // 16)
    assert [t.count(b"\n") for _, t in members[:-1]] == \
        [16] * (len(members) - 1)
    assert b"".join(t for _, t in members) == a


def test_checkpoint_offset_is_a_member_boundary(synthetic_panel_root,
                                                tmp_path, monkeypatch):
    """The offset _write_progress records ends the last complete member of
    every chunk queued before it; cut back there after a crash (records
    written past it, half a member), the file resumes in append mode to
    the decompressed bytes of an uninterrupted writer."""
    _workers(monkeypatch, 4)
    monkeypatch.setattr(writers, "CHUNK_RECORDS", 16)
    root, dq_path, _ = synthetic_panel_root
    params = DecodingParams.fastsmc_defaults(
        root, dq_path, str(tmp_path / "ck"), use_known_seed=True)
    f = fastsmc_tpu_torch.FastSMC(params, device="cpu")
    blocks = [_block(60 + seed, seed) for seed in range(6)]
    f._open_writer()
    for b in blocks[:3]:
        f._writer.write_block(*b)
    f._write_progress(3)
    out = params.ibd_output_path()
    with open(out + ".progress") as fh:
        offset = int(fh.read().split()[2])
    head = open(out, "rb").read()
    assert len(head) == offset
    assert sum(n for n, _ in _members(head)) == offset
    for b in blocks[3:5]:
        f._writer.write_block(*b)
    f._writer.close()
    with open(out, "ab") as fh:         # a member cut short by the crash
        fh.write(open(out, "rb").read()[offset:offset + 40])
    with open(out, "ab") as fh:
        fh.truncate(offset)
    f._open_writer(append=True)
    for b in blocks[3:]:
        f._writer.write_block(*b)
    f._writer.close()

    want = tmp_path / "whole.ibd.gz"
    w = IbdTextWriter(str(want), f.data.fam_id_list, f.data.iid_list,
                      f.data.chr_number)
    for b in blocks:
        w.write_block(*b)
    w.close()
    assert gzip.open(out, "rb").read() == gzip.open(want, "rb").read()
    # each part's last chunk is closed at its checkpoint: 183 + 192
    assert len(_members(open(out, "rb").read())) == 12 + 12


def test_pool_spans_and_counters(tmp_path, monkeypatch):
    """At W = 4, every chunk's FORMAT and DEFLATE spans run on a worker
    thread with the emit that queued its block as parent, the emit's self
    time keeps none of them, the members land in chunk order though the
    first of every four chunks finishes last, CHUNKS counts the members
    written, and the workers' busy wall is at most their thread-seconds
    (and, with formatters sleeping side by side, well below them)."""
    _workers(monkeypatch, 4)
    monkeypatch.setattr(writers, "CHUNK_RECORDS", 10)
    threads = set()

    def slow(id_blob, id_off, ind1, hap1, ind2, hap2, pos_start, *rest):
        threads.add(threading.current_thread().name)
        time.sleep(0.08 if pos_start[0] // 10 % 4 == 0 else 0.02)
        return b"".join(b"%d\n" % p for p in pos_start)

    monkeypatch.setattr(native, "get_lib", lambda: object())
    monkeypatch.setattr(native, "format_ibd", slow)
    rec = SpanRecorder()
    w = writers.IbdTextWriter(str(tmp_path / "x.ibd.gz"),
                              [f"f{i}" for i in range(4)],
                              [f"i{i}" for i in range(4)], 1, spans=rec)
    for seed in range(3):
        b = list(_block(40, seed))
        b[4] = np.arange(40 * seed, 40 * seed + 40)
        with rec.span("fastsmc.emit"):
            w.write_block(*b)
    w.close()
    st = rec.stats()
    assert st[writers.FORMAT].parents == {"fastsmc.emit": 12}
    assert st[writers.DEFLATE].parents == {"fastsmc.emit": 12}
    assert threads and all(t.startswith("fastsmc-deflate") for t in threads)
    assert st["fastsmc.emit"].self_s == st["fastsmc.emit"].total_s < 0.1
    members = _members(open(tmp_path / "x.ibd.gz", "rb").read())
    assert b"".join(t for _, t in members) == \
        b"".join(b"%d\n" % p for p in range(120))
    assert rec.counter(writers.CHUNKS) == len(members) == 12
    busy = rec.counter(writers.BUSY)
    work = rec.total_s(writers.FORMAT) + rec.total_s(writers.DEFLATE)
    assert work >= 0.4 and 0 < busy <= work and busy < 0.75 * work


def test_full_queue_blocks_the_emit(tmp_path, monkeypatch):
    """Back-pressure: with MAX_CHUNKS_IN_FLIGHT chunks waiting on a stuck
    formatter, write_block waits instead of queueing more, and goes on
    once the workers move."""
    _workers(monkeypatch, 2)
    monkeypatch.setattr(writers, "CHUNK_RECORDS", 5)
    monkeypatch.setattr(writers, "MAX_CHUNKS_IN_FLIGHT", 3)
    gate = threading.Event()

    def stuck(id_blob, id_off, ind1, *rest):
        gate.wait(10)
        return b"record\n" * len(ind1)

    monkeypatch.setattr(native, "get_lib", lambda: object())
    monkeypatch.setattr(native, "format_ibd", stuck)
    w = _open(IbdTextWriter, tmp_path / "x.ibd.gz")
    t = threading.Thread(target=w.write_block, args=_block(50, 0),
                         daemon=True)
    t.start()
    t.join(0.5)
    assert t.is_alive(), "ten chunks queued past a bound of three"
    gate.set()
    t.join(10)
    assert not t.is_alive()
    finished, err = _close_within(w, 10)
    assert finished and err is None
    assert gzip.open(tmp_path / "x.ibd.gz", "rb").read() == b"record\n" * 50


def test_members_near_one_stream_in_size(tmp_path, monkeypatch):
    """Real chunks (CHUNK_RECORDS, the native formatter where it loads):
    every member walks with zlib, and the file is within 1 % of the same
    text deflated at level 6 as one stream."""
    _workers(monkeypatch, 4)
    path = tmp_path / "x.ibd.gz"
    w = _open(IbdTextWriter, path)
    for seed in range(2):
        w.write_block(*_block(3 * writers.CHUNK_RECORDS // 2, seed))
    w.close()
    data = path.read_bytes()
    members = _members(data)
    assert len(members) == 3
    text = b"".join(t for _, t in members)
    assert text.count(b"\n") == 3 * writers.CHUNK_RECORDS
    one = len(zlib.compress(text, 6))
    assert one < len(data) <= 1.01 * one


def test_checkpoint_carries_final_writer_counters(synthetic_panel_root,
                                                  tmp_path, monkeypatch):
    """_write_progress carries the FORMAT/DEFLATE totals from the closed
    writer to the reopened one, read after close() has drained the queue:
    a slow formatter leaves blocks queued when the checkpoint starts."""
    root, dq_path, _ = synthetic_panel_root
    params = DecodingParams.fastsmc_defaults(
        root, dq_path, str(tmp_path / "ck"), use_known_seed=True)
    f = fastsmc_tpu_torch.FastSMC(params, device="cpu")

    def slow(id_blob, id_off, ind1, *rest):
        time.sleep(0.05)
        return b"record\n" * len(ind1)

    monkeypatch.setattr(native, "get_lib", lambda: object())
    monkeypatch.setattr(native, "format_ibd", slow)
    f._open_writer()
    old = f._writer
    assert isinstance(old, IbdTextWriter)
    for seed in range(4):
        old.write_block(*_block(20, seed))
    f._write_progress(1)
    spans = old.spans
    fmt_s, deflate_s = (spans.total_s(writers.FORMAT),
                        spans.total_s(writers.DEFLATE))
    assert fmt_s >= 0.15
    assert f._writer is not old
    assert (f._writer.spans.total_s(writers.FORMAT),
            f._writer.spans.total_s(writers.DEFLATE)) == (fmt_s, deflate_s)
    f._writer.close()
