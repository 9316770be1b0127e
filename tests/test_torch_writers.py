"""The port's IBD text writer (fastsmc_tpu_torch.writers) and the writer
counters its FastSMC carries across checkpoints."""

import gzip
import threading
import time

import numpy as np

from fastsmc_tpu import native
from fastsmc_tpu.config import DecodingParams
from fastsmc_tpu.io import writers as jax_writers

import fastsmc_tpu_torch
from fastsmc_tpu_torch.writers import IbdTextWriter


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


def test_formatter_failure_makes_close_raise(tmp_path, monkeypatch):
    """A formatter that returns None fails the writer thread; the two
    blocks queued behind it are still marked done, so close() raises the
    error within 10 s instead of waiting forever in Queue.join()."""
    # the threaded path needs only get_lib() to answer
    monkeypatch.setattr(native, "get_lib", lambda: object())
    gate = threading.Event()

    def refuse(*args, **kwargs):
        gate.wait(10)                   # let all three blocks queue first
        return None

    monkeypatch.setattr(native, "format_ibd", refuse)
    w = _open(IbdTextWriter, tmp_path / "x.ibd.gz")
    for seed in range(3):
        w.write_block(*_block(5, seed))
    gate.set()
    finished, err = _close_within(w, 10)
    assert finished, "close() hung"
    assert isinstance(err, RuntimeError) and "formatter" in str(err), err


def test_writer_output_equals_jax_writer(tmp_path):
    """On the normal path the subclass writes the JAX package's bytes."""
    paths = []
    for cls in (IbdTextWriter, jax_writers.IbdTextWriter):
        path = tmp_path / f"{cls.__module__}.ibd.gz"
        w = _open(cls, path)
        for seed in range(3):
            w.write_block(*_block(50, seed))
        w.close()
        paths.append(path)
    a, b = (gzip.open(p, "rb").read() for p in paths)
    assert a == b and a.count(b"\n") == 150


def test_checkpoint_carries_final_writer_counters(synthetic_panel_root,
                                                  tmp_path, monkeypatch):
    """_write_progress carries fmt_s/deflate_s from the closed writer to the
    reopened one, read after close() has drained the queue: a slow
    formatter leaves blocks queued when the checkpoint starts."""
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
    assert old.fmt_s >= 0.15
    assert f._writer is not old
    assert (f._writer.fmt_s, f._writer.deflate_s) == \
        (old.fmt_s, old.deflate_s)
    f._writer.close()
