"""The frozen byte counts reproduce the bounds PERF.md gives, and a
kernel's share reads alike however many launches a call takes."""

import pytest

from portbench import readers, rooflines
from portbench.harness import Context
from portbench.tracing import TraceSummary


def test_window_reduce_bytes_at_the_1m_config():
    # The 1M bench configuration (bench.py, seed 42): nnz 2,384,321, 1,000,000 faces onto 512^2 cells, E = 20.
    assert rooflines.window_reduce_bytes(2_384_321, 1_000_000, 512 * 512, 20) == 120_046_088


def share(launches_per_call: int, seconds_per_launch: float) -> float:
    trace = TraceSummary(calls=4, window_s=1.0, busy_s=0.5)
    trace.kernels["window_reduce_kernel<float>"] = [4 * launches_per_call, 4 * launches_per_call * seconds_per_launch]
    counts = {"window_reduce": {"nnz": 1000, "m": 10_000, "n": 500, "E": 300}}
    return readers.window_reduce_share(Context([], 1.0, 0.0, trace, counts))


def test_share_of_a_call_in_slabs_counts_each_launch_its_slab():
    # One launch of E = 300 against three of E = 100 taking a third of its
    # time each: the three read the nnz bytes three times.
    one = share(1, 3e-6)
    assert one == pytest.approx(rooflines.share_pct(rooflines.window_reduce_bytes(1000, 10_000, 500, 300), 3e-6))
    three = share(3, 1e-6)
    assert three == pytest.approx(rooflines.share_pct(rooflines.window_reduce_bytes(1000, 10_000, 500, 100), 1e-6))
    assert three > one


def test_share_is_the_bound_over_the_time():
    # 3.35e9 bytes take 1 ms at 3.35 TB/s: 50 % of 2 ms.
    assert rooflines.share_pct(3.35e9, 2e-3) == pytest.approx(50.0)
