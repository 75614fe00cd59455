"""The reading of a profile: kernel names, the union of device intervals,
idle time by span, and the rule that a profile counts only where it holds
a record of every launch the program counted."""

import collections
import types

import pytest
import torch
from conftest import REPO

from lbmbench import harness, readers, spec, tracing

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, device, start_ns, dur_ns):
        self._v = (name, device, start_ns, dur_ns)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return False


def profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


T0 = 1_792_000_000_000_000_000  # the profiler's clock: ns since the epoch

EVENTS = [
    Event("bench:window", CPU, T0, 100_000),
    Event("bench:runtime.Simulator.run", CPU, T0 + 10_000, 60_000),
    Event("bench:runtime.Simulator.compiled", CPU, T0 + 10_000, 10_000),
    Event("bench:runtime.expand_fields", CPU, T0 + 60_000, 10_000),
    Event("void spin_kernel(long)", CUDA, T0 - 1_000, 500),
    Event("lbm_temporal_kernel(float const*, float*)", CUDA, T0 + 20_000, 20_000),
    Event("av_reduce_kernel(float const*, int)", CUDA, T0 + 40_000, 5_000),
    Event("lbm_temporal_kernel(float const*, float*)", CUDA, T0 + 42_000, 10_000),
    Event("av_reduce_kernel(float const*, int)", CUDA, T0 + 52_000, 3_000),
    Event("Memcpy DtoH (Device -> Pinned)", CUDA, T0 + 55_000, 2_000),
]
LAUNCH_MAP = spec.Spec.load(REPO).launches()


def test_short_names():
    assert tracing.short_name("void at::native::vectorized_elementwise_kernel<4, "
                              "at::native::FillFunctor<float>>(int, float)") == \
        "vectorized_elementwise_kernel"
    assert tracing.short_name("(anonymous namespace)::copy_kernel((anonymous "
                              "namespace)::CopyRow const*)") == "copy_kernel"
    assert tracing.short_name("lbm_multi_bands_kernel(int, float*)") == "lbm_multi_bands_kernel"


def test_a_whole_profile_is_read():
    device = tracing.read_profile(profile(EVENTS), {"lbm_temporal_step": 2}, LAUNCH_MAP)
    assert device.whole, device.why_not_whole
    assert device.window.seconds == pytest.approx(100e-6)
    # 20 + (5 + 10 overlapping by 3) + 3 + 2 us: the union, not the sum.
    assert device.busy() == pytest.approx(37e-6)
    assert [op.name for op in device.in_spans("runtime.Simulator.run")] == [
        "lbm_temporal_kernel", "av_reduce_kernel", "lbm_temporal_kernel", "av_reduce_kernel"]
    idle = device.idle_by_span()
    assert idle["harness"] == pytest.approx(10e-6 + 30e-6)
    assert idle["runtime.Simulator.compiled"] == pytest.approx(10e-6)
    assert idle["runtime.Simulator.run"] == pytest.approx(3e-6)
    assert idle["runtime.expand_fields"] == pytest.approx(10e-6)
    assert sum(idle.values()) == pytest.approx(100e-6 - 37e-6)


@pytest.mark.parametrize("launches, why", [
    ({"lbm_temporal_step": 3}, "lacks records"),
    ({"lbm_temporal_step": 2, "lbm_new_step": 1}, "lbm_new_step"),
    ({}, "counted no kernel"),
])
def test_a_profile_missing_launches_is_not_read(launches, why):
    device = tracing.read_profile(profile(EVENTS), launches, LAUNCH_MAP)
    assert not device.whole and why in device.why_not_whole
    run = types.SimpleNamespace(entry="solve", device=device)
    assert readers.idle_pct(run, "solve") is None


def test_idle_pct_and_roofline_from_a_whole_profile(tiny_root):
    bench = spec.Spec.load(tiny_root)
    cell = bench.cell("tiny.solve")
    device = tracing.read_profile(profile(EVENTS), {"lbm_temporal_step": 2}, LAUNCH_MAP)
    peaks = {"fp32_flop_per_s": 67e12, "memory_byte_per_s": 3.35e12}
    run = harness.RunRecord(cell, "card", peaks, 1.0, 1.0, 1, 0,
                            [types.SimpleNamespace(updates=1)], device=device)
    assert bench.reader("device.idle_pct.solve")(run) == pytest.approx(63.0)
    assert bench.reader("device.idle_pct.cli")(run) is None
    least = 104 * 48 * 32 * 400 / 67e12
    assert bench.reader("kernels.roofline_pct")(run) == pytest.approx(100 * least / 38e-6)


def test_launch_files_name_each_counter_once():
    kernels = collections.Counter(m["kernel"] for m in LAUNCH_MAP.values())
    assert LAUNCH_MAP["lbm_temporal_step"] == {"kernel": "lbm_temporal_kernel",
                                              "then": ["av_reduce_kernel"]}
    assert LAUNCH_MAP["lbm_multi_bands_step"]["then"] == []
    assert max(kernels.values()) == 1
