"""Closed-loop labelled regrids through one weight build onto the
configuration's raster.  With ``per_call`` "variable", call k regrids
the whole variable k % variables, (time, layer, face); with "field", it
regrids one (face) field, ``uda.isel(time=t, layer=l)``, the fields of
the variables taken in turn.

Traffic parameters: ``method``, ``per_call``, ``warmup_calls``,
``keep_calls``, ``trace``, ``limits``."""

from __future__ import annotations

import torch

from portbench.generators import common
from portbench.harness import synchronize
from portbench.reference import overlap


class Generator:
    def __init__(self, run):
        self.run = run
        self.per_call = run.traffic["per_call"]
        if self.per_call not in ("variable", "field"):
            raise ValueError(f"per_call is 'variable' or 'field', not {self.per_call!r}")
        self.nnz = None

    def selection(self, k: int) -> common.Selection:
        if self.per_call == "variable":
            return self.payload.variable(k)
        return self.payload.field(k)[1]

    def make_inputs(self) -> None:
        """The mesh, the payload pool on the device and the raster."""
        config, run = self.run.config, self.run
        self.mesh = common.mesh_of(config, run.seed)
        self.payload = common.Payload(config, len(self.mesh.faces), run.seed, run.device)
        self.raster = common.raster_of(config, self.mesh)

    def setup(self) -> None:
        import xugrid_tpu_torch as xt

        run = self.run
        run.mark("import the port")
        self.make_inputs()
        run.mark("inputs")
        self.udas = self.payload.port_variables(xt, common.port_grid(xt, self.mesh))
        self.regridder = xt.OverlapRegridder(self.udas[0], common.port_raster(xt, self.raster), method=run.traffic["method"])
        run.mark("weights")
        for k in range(run.traffic["warmup_calls"]):
            self.call(k)
            if k == 0:
                synchronize(run.device)
                run.mark("first call")
        synchronize(run.device)
        run.mark("warm-up")

    def call(self, k: int):
        if self.per_call == "variable":
            source = self.udas[k % len(self.udas)]
        else:
            (v, t, layer), _ = self.payload.field(k)
            source = self.udas[v].isel(time=t, layer=layer)
        return self.regridder.regrid(source), self.selection(k).slices

    def counters(self):
        return None

    def counts(self) -> dict:
        """The shapes of one call's ``window_reduce`` work, E its slices;
        nnz is the reference's count of overlapping pairs."""
        if self.nnz is None:
            return {}
        E = self.selection(0).slices
        return {"window_reduce": {"nnz": self.nnz, "m": len(self.mesh.faces), "n": self.raster.size, "E": E}}

    def release(self) -> None:
        self.regridder = self.udas = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, kept: list) -> dict:
        judge = common.RasterJudge(self.mesh, self.payload.pool, self.run.device)
        triplets = None
        for k, out in kept:
            triplets = judge.judge(out, self.raster, self.selection(k), triplets)
        self.nnz = len(triplets[0]) if triplets is not None else None
        return judge.readings(self.run.traffic["limits"])

    def control_output(self, k: int, dtype) -> torch.Tensor:
        """Call k's result from the reference computed in ``dtype``."""
        if getattr(self, "triplets", None) is None:
            self.triplets = overlap.overlap_triplets(self.mesh.nodes, self.mesh.faces, self.raster, self.run.device)
        return overlap.weighted_mean(self.triplets, self.payload.pool[self.selection(k).rows], self.raster.size, dtype)

    def notes(self) -> list:
        return []
