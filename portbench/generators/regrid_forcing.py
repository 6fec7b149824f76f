"""Closed-loop labelled regrids of raster forcing onto the mesh through
one weight build, ``OverlapRegridder(raster, mesh, method)``: the
configuration's ``variables``, each (time, y, x) over its raster, lie
in one (variables x time, y x x) pool on the device, variable-major,
each variable a DataArray over a view of it with ``y`` (north first
when descending), ``x``, ``dx`` and ``dy`` as ``common.port_raster``
gives them.  With ``per_call`` "variable", call k regrids the whole
variable k % variables onto the mesh, a (time, face) UgridDataArray,
judged against the mean over each face of the map cells that overlap it
(``reference/forcing.py``).

Each call records the port's spans (``portbench/spans.py``), so that
``counters()`` gives its ``regrid.wrap`` spans and its
``wrap.coord_bytes``; a port without them gives zeros.

Traffic parameters: ``method``, ``per_call``, ``warmup_calls``,
``keep_calls``, ``trace``, ``limits`` (``mean_rel_err``,
``nan_mismatch``, ``form_errors``)."""

from __future__ import annotations

import torch

from portbench import inputs, spans
from portbench.generators import common
from portbench.harness import synchronize
from portbench.reference import forcing

#: Records one call's spans hold (a regrid, its apply, two per slab, the wrap).
SPAN_CAPACITY = 256
WRAP = "regrid.wrap"
COORD_BYTES = "wrap.coord_bytes"


class Generator:
    def __init__(self, run):
        self.run = run
        if run.traffic["per_call"] != "variable":
            raise ValueError(f"regrid_forcing takes per_call 'variable', not {run.traffic['per_call']!r}")
        payload = run.config["payload"]
        self.variables, self.time = payload["variables"], payload["time"]
        self.records = None
        self.triplets = None
        self.width = None

    def rows(self, k: int) -> slice:
        start = (k % self.variables) * self.time
        return slice(start, start + self.time)

    def make_inputs(self) -> None:
        """The mesh, the raster and the payload pool over its cells on the
        device."""
        config, run = self.run.config, self.run
        payload = config["payload"]
        self.mesh = common.mesh_of(config, run.seed)
        self.raster = common.raster_of(config, self.mesh)
        self.pool = inputs.payload_pool(
            self.variables * self.time, self.raster.size, payload["nan_share"], run.seed, run.device,
            getattr(torch, payload["dtype"]),
        )

    def setup(self) -> None:
        import xugrid_tpu_torch as xt

        run = self.run
        run.mark("import the port")
        self.make_inputs()
        run.mark("inputs")
        self.grid = common.port_grid(xt, self.mesh)
        self.face_dimension = self.grid.face_dimension
        coords = common.port_raster(xt, self.raster).coords.variables
        shape = (self.time, self.raster.ny, self.raster.nx)
        self.forcing = [
            xt.xdata.DataArray(self.pool[self.rows(v)].view(shape), coords=coords, dims=("time", "y", "x"), name="forcing")
            for v in range(self.variables)
        ]
        self.regridder = xt.OverlapRegridder(self.forcing[0], self.grid, method=run.traffic["method"])
        self.width = int(self.regridder._padded.indices.shape[1])
        run.mark("weights")
        for k in range(run.traffic["warmup_calls"]):
            self.call(k)
            if k == 0:
                synchronize(run.device)
                run.mark("first call")
        synchronize(run.device)
        run.mark("warm-up")

    def call(self, k: int):
        recording = spans.start(SPAN_CAPACITY)
        try:
            return self.regridder.regrid(self.forcing[k % self.variables]), self.time
        finally:
            self.records = spans.collect() if recording else None

    def counters(self) -> dict:
        """The last call's ``regrid.wrap`` spans, how many and their us in
        all, and its ``wrap.coord_bytes``."""
        records = self.records or []
        wraps = [r for r in records if r.name == WRAP and r.end_ns is not None]
        return {
            "wrap": {
                "spans": len(wraps),
                "span_us": sum(spans.duration_ns(r) for r in wraps) * 1e-3,
                "coord_bytes": sum(r.counts.get(COORD_BYTES, 0) for r in records),
            }
        }

    def counts(self) -> dict:
        """The shapes of one call's ``window_reduce`` work, E its slices;
        nnz is the reference's count of overlapping pairs."""
        if self.triplets is None:
            return {}
        nnz = len(self.triplets[0])
        return {"window_reduce": {"nnz": nnz, "m": self.raster.size, "n": len(self.mesh.faces), "E": self.time}}

    def release(self) -> None:
        self.regridder = self.forcing = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def face_triplets(self) -> tuple:
        if self.triplets is None:
            self.triplets = forcing.face_triplets(self.mesh.nodes, self.mesh.faces, self.raster, self.run.device)
        return self.triplets

    def form_errors(self, out) -> int:
        """How many of the result's dims, shape, device, grid face count
        and face dimension differ from what a regrid onto the mesh gives."""
        n_face = len(self.mesh.faces)
        grid = getattr(out, "grid", None)
        face_dimension = getattr(grid, "face_dimension", None)
        errors = 0
        errors += face_dimension != self.face_dimension
        errors += getattr(out, "dims", None) != ("time", face_dimension)
        errors += tuple(getattr(out, "shape", ())) != (self.time, n_face)
        data = getattr(out, "data", None)
        errors += not isinstance(data, torch.Tensor) or data.device.type != self.run.device.type
        errors += getattr(grid, "n_face", None) != n_face
        return int(errors)

    def check(self, kept: list) -> dict:
        """The worst of every kept call: the largest gap over the largest
        reference value (``mean_rel_err``), places NaN in one and not the
        other, and the form of each labelled result (a bare tensor's form
        is not judged)."""
        worst = {"mean_rel_err": 0.0, "nan_mismatch": 0, "form_errors": 0}
        triplets, n_face = self.face_triplets(), len(self.mesh.faces)
        for k, out in kept:
            if not isinstance(out, torch.Tensor):
                worst["form_errors"] += self.form_errors(out)
            got = torch.as_tensor(getattr(out, "data", out))
            if got.numel() != self.time * n_face:
                worst["nan_mismatch"] += self.time * n_face
                continue
            got = got.reshape(self.time, n_face)
            gap = scale = 0.0
            for start, e in forcing.face_means(triplets, self.pool[self.rows(k)], n_face):
                g = got[start : start + e.shape[0]].double()
                nan_got, nan_expected = torch.isnan(g), torch.isnan(e)
                worst["nan_mismatch"] += int((nan_got != nan_expected).sum())
                both = ~nan_got & ~nan_expected
                if bool(both.any()):
                    scale = max(scale, float(e[both].abs().max()))
                    gap = max(gap, float((g[both] - e[both]).abs().max()))
            worst["mean_rel_err"] = max(worst["mean_rel_err"], gap / scale if scale else gap)
        limits = self.run.traffic["limits"]
        return {name: (value, limits[name]) for name, value in worst.items()}

    def control_output(self, k: int, dtype) -> torch.Tensor:
        """Call k's result from the reference computed in ``dtype``, kept
        as float32 (a lower precision's values are float32 values)."""
        n_face = len(self.mesh.faces)
        out = torch.empty((self.time, n_face), dtype=torch.float32, device=self.run.device)
        for start, block in forcing.face_means(self.face_triplets(), self.pool[self.rows(k)], n_face, dtype):
            out[start : start + block.shape[0]] = block
        return out

    def notes(self) -> list:
        return [f"window_reduce: padded window width w {self.width}"]
