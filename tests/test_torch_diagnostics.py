"""The port's profiler helpers (diagnostics.trace_annotated, profile_trace,
device_op_times, device_idle_share) on the CPU: a real capture of annotated
host work, and the device arithmetic on Chrome traces with known
intervals."""

import json

import pytest
import torch

from pyc2ray_torch.diagnostics import (device_idle_share, device_op_times,
                                       profile_trace, trace_annotated)


def test_profile_trace_captures_annotated_host_work(tmp_path):
    double = trace_annotated("double the field", lambda x: 2.0 * x)
    with profile_trace(tmp_path / "prof") as p:
        p["sync"] = double(torch.ones(64))
    assert torch.equal(p["sync"], torch.full((64,), 2.0))
    events = json.load(open(p["path"]))["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert "double the field" in names and "aten::mul" in names
    # nothing ran on a device here: no device times, no idle share
    assert device_op_times(tmp_path / "prof") == {}
    with pytest.raises(ValueError, match="no device operation"):
        device_idle_share(tmp_path / "prof")


def _write_trace(path, events):
    path.write_text(json.dumps({"traceEvents": [
        dict(ph="X", pid=0, tid=0, **e) for e in events]}))


def test_device_times_and_idle_share_of_known_traces(tmp_path):
    """Two captures: device operations overlapping, nested and apart, host
    events around them; times per name summed in ms, sorted; the idle share
    from the union of the device intervals over the windows."""
    _write_trace(tmp_path / "a.json", [
        dict(cat="cpu_op", name="aten::add_", ts=0.0, dur=100.0),
        dict(cat="kernel", name="sweep", ts=10.0, dur=20.0),
        dict(cat="kernel", name="rates", ts=20.0, dur=20.0),     # overlaps
        dict(cat="kernel", name="sweep", ts=22.0, dur=5.0),      # nested
        dict(cat="gpu_memcpy", name="Memcpy HtoD", ts=60.0, dur=10.0),
        dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=5.0, dur=1.0),
        dict(cat="user_annotation", name="trace", ts=0.0, dur=100.0)])
    (tmp_path / "sub").mkdir()
    _write_trace(tmp_path / "sub" / "b.json", [
        dict(cat="cpu_op", name="aten::mul", ts=1000.0, dur=50.0),
        dict(cat="kernel", name="rates", ts=1040.0, dur=20.0)])   # outlasts
    times = device_op_times(tmp_path)
    assert list(times) == ["rates", "sweep", "Memcpy HtoD"]
    assert times == pytest.approx({"rates": 0.040, "sweep": 0.025,
                                   "Memcpy HtoD": 0.010})
    assert device_op_times(tmp_path, top=1) == {"rates": pytest.approx(0.04)}
    # busy: [10, 40] + [60, 70] = 40 of 100 us; [1040, 1060] = 20 of 60 us
    assert device_idle_share(tmp_path) == pytest.approx(1.0 - 60.0 / 160.0)
