"""Closed-loop labelled regrids by the median (``method`` "median", in
the traffic and the configuration) through one weight build onto the
configuration's raster, as ``regrid_loop`` makes them (``per_call``
"variable": call k regrids the whole variable k % variables), judged
against the median over each map cell's window of overlapping faces
(``reference/select.py``).

Each call records the port's spans (``portbench/spans.py``), so that
``counters()`` gives the call's ``select.*`` counts and its
``apply.select`` spans; a port without them gives zeros.

Traffic parameters: ``method``, ``per_call``, ``warmup_calls``,
``keep_calls``, ``trace``, ``limits`` (``median_rel_err``,
``nan_mismatch``, ``form_errors``)."""

from __future__ import annotations

import torch

from portbench import spans
from portbench.generators import common, regrid_loop
from portbench.reference import overlap, select

#: Records one call's spans hold (a regrid, its apply, three per slab).
SPAN_CAPACITY = 256
#: The method and its percentile.
METHOD, P = "median", 50.0


class Generator(regrid_loop.Generator):
    def __init__(self, run):
        super().__init__(run)
        if run.traffic["method"] != METHOD or run.config.get("method", METHOD) != METHOD:
            raise ValueError(f"regrid_select takes the method {METHOD!r} in the traffic and the configuration")
        self.records = None
        self.width = None
        self.window = None

    def setup(self) -> None:
        super().setup()
        self.width = int(self.regridder._padded.indices.shape[1])

    def call(self, k: int):
        recording = spans.start(SPAN_CAPACITY)
        try:
            return super().call(k)
        finally:
            self.records = spans.collect() if recording else None

    def counters(self) -> dict:
        """The last call's ``select.*`` counts, and its ``apply.select``
        spans: how many and their us in all."""
        records = self.records or []
        select_spans = [r for r in records if r.name == "apply.select" and r.end_ns is not None]
        return {
            "select": {
                "windows": sum(r.counts.get("select.windows", 0) for r in records),
                "walk_launches": sum(r.counts.get("select.walk_launches", 0) for r in records),
                "spans": len(select_spans),
                "span_us": sum(spans.duration_ns(r) for r in select_spans) * 1e-3,
            }
        }

    def counts(self) -> dict:
        """The shapes of one call's ``window_select`` work, E its slices;
        nnz is the reference's count of overlapping pairs."""
        shapes = super().counts().get("window_reduce")
        return {} if shapes is None else {"window_select": shapes}

    def windows(self) -> torch.Tensor:
        if self.window is None:
            triplets = overlap.overlap_triplets(self.mesh.nodes, self.mesh.faces, self.raster, self.run.device)
            self.nnz = len(triplets[0])
            self.window = select.windows(triplets, self.raster.size)
        return self.window

    def expected(self, k: int, dtype=torch.float64) -> torch.Tensor:
        return select.percentile(self.windows(), self.payload.pool[self.selection(k).rows], P, dtype)

    def check(self, kept: list) -> dict:
        """The worst of every kept call: the largest gap over the largest
        reference value (``median_rel_err``), places NaN in one and not
        the other, and the form of each labelled result."""
        worst = {"median_rel_err": 0.0, "nan_mismatch": 0, "form_errors": 0}
        for k, out in kept:
            if not isinstance(out, torch.Tensor):
                worst["form_errors"] += common.form_errors(out, self.raster, self.selection(k), self.run.device)
            expected = self.expected(k)
            got = torch.as_tensor(getattr(out, "data", out))
            if got.numel() != expected.numel():
                worst["nan_mismatch"] += expected.numel()
                continue
            got = got.reshape(expected.shape)
            gap = scale = 0.0
            for start in range(0, expected.shape[0], 256):  # float64 in blocks, to keep the copies small
                e, g = expected[start : start + 256], got[start : start + 256].double()
                nan_got, nan_expected = torch.isnan(g), torch.isnan(e)
                worst["nan_mismatch"] += int((nan_got != nan_expected).sum())
                both = ~nan_got & ~nan_expected
                if bool(both.any()):
                    scale = max(scale, float(e[both].abs().max()))
                    gap = max(gap, float((g[both] - e[both]).abs().max()))
            worst["median_rel_err"] = max(worst["median_rel_err"], gap / scale if scale else gap)
        limits = self.run.traffic["limits"]
        return {name: (value, limits[name]) for name, value in worst.items()}

    def control_output(self, k: int, dtype) -> torch.Tensor:
        """Call k's result from the reference computed in ``dtype``."""
        return self.expected(k, dtype)

    def notes(self) -> list:
        return [f"window_select: padded window width w {self.width}"]
