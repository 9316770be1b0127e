"""The trace's reduction: device time by kernel, busy time as the union of
device operations inside the window, idle gaps put down to the innermost
benchmark span around them."""

import pytest

from gpubench.trace import summarize_events


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_idle_and_names():
    events = [
        ev("user_annotation", "gpubench.window", 100.0, 1000.0),
        ev("user_annotation", "gpubench.asmc.decode", 100.0, 500.0),
        ev("user_annotation", "gpubench.asmc.write", 600.0, 500.0),
        ev("kernel", "void fastsmc::(anonymous namespace)::hmm_backward_"
           "kernel<2>(float const*)", 150.0, 200.0),
        ev("kernel", "void fastsmc::hmm_forward_kernel<1>(float)", 300.0,
           100.0),                            # overlaps the one before
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1050.0, 100.0),
        ev("kernel", "outside", 0.0, 50.0),   # before the window
        ev("cpu_op", "aten::mm", 200.0, 10.0),
    ]
    s = summarize_events(events)
    assert s["window_s"] == pytest.approx(1e-3)
    # [150, 400) and [1050, 1100) inside the window
    assert s["busy_s"] == pytest.approx(300e-6)
    names = dict(s["device_ops"])
    assert names["fastsmc::hmm_backward_kernel<2>"] == pytest.approx(200e-6)
    assert names["Memcpy DtoH"] == pytest.approx(50e-6)
    assert "outside" not in names
    assert any("hmm_backward_kernel" in k for k in s["device_s"])
    gaps = dict(s["idle_gaps"])
    # [100, 150) and [400, 600) in decode; [600, 1050) in write
    assert gaps["gpubench.asmc.decode"] == pytest.approx(250e-6)
    assert gaps["gpubench.asmc.write"] == pytest.approx(450e-6)


def test_no_window_raises():
    with pytest.raises(RuntimeError):
        summarize_events([ev("kernel", "k", 0.0, 1.0)])
