"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a small size, once for each fault a cell can have."""

import pytest

from portbench.tests.small import run_cpu, small_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("faults"))


def stale_regrid(monkeypatch):
    """Every call returns the first call's result (state left unchanged)."""
    from xugrid_tpu_torch.regrid import regridder

    original, first = regridder.BaseRegridder.regrid, {}

    def regrid(self, data, device=None):
        if "out" not in first:
            first["out"] = original(self, data, device)
        return first["out"]

    monkeypatch.setattr(regridder.BaseRegridder, "regrid", regrid)


def half_windows(monkeypatch):
    """Every other slot of each target's window left out: the mean is
    taken over the rest."""
    from xugrid_tpu_torch.regrid import regridder

    original = regridder.apply_weights

    def apply_weights(weights, source, reduction, target_size, dtype=None, plan_cache=None):
        kept = weights.weights.copy()
        kept[:, 1::2] = 0.0
        half = weights._replace(weights=kept)
        return original(half, source, reduction, target_size, dtype)

    monkeypatch.setattr(regridder, "apply_weights", apply_weights)


def altered_answer(monkeypatch):
    """One value of each result changed where it is produced."""
    from xugrid_tpu_torch.regrid import regridder

    original = regridder.apply_weights

    def apply_weights(*args, **kwargs):
        out = original(*args, **kwargs)
        out.reshape(-1)[out.numel() // 2] += 1.0
        return out

    monkeypatch.setattr(regridder, "apply_weights", apply_weights)


def stale_weights(monkeypatch):
    """Every new regridder keeps the first one's weights."""
    from xugrid_tpu_torch.regrid import regridder

    original, first = regridder.OverlapRegridder._compute_weights, {}

    def compute(self, source, target, tolerance=None):
        if "weights" not in first:
            first["weights"] = original(self, source, target, tolerance)
        return first["weights"]

    monkeypatch.setattr(regridder.OverlapRegridder, "_compute_weights", compute)


FAULTS = [
    ("lhm250.heads_year", stale_regrid),
    ("lhm250.heads_year", half_windows),
    ("lhm250.heads_year", altered_answer),
    ("lhm250.one_field", stale_regrid),
    ("lhm250.one_field", half_windows),
    ("lhm250.one_field", altered_answer),
    ("lhm250.new_map", stale_weights),
    ("lhm250.new_map", half_windows),
    ("lhm250.new_map", altered_answer),
]


@pytest.mark.parametrize("workload, fault", FAULTS, ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(root, monkeypatch, workload, fault):
    fault(monkeypatch)
    result, lines = run_cpu(root, workload, seed=2147483659)
    assert not result["correct"], lines
    assert result["failed"] == 0, lines
