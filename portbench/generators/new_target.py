"""Closed-loop jobs onto new rasters: job k moves the configuration's
raster by a sub-cell shift drawn from the seed, builds
``OverlapRegridder(uda, raster)`` and regrids the whole variable
k % variables onto it.  What the port caches on the source grid stays,
as in a user's session.

Traffic parameters: ``method``, ``warmup_calls``, ``keep_calls``,
``trace``, ``limits``."""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.generators import common
from portbench.harness import synchronize
from portbench.reference import overlap

#: Port stages each job records (``utils.profiling.timings``).
STAGES = (
    "grid_hash.query_boxes",
    "celltree.exact_overlap_areas",
    "regridder.padded_csr",
    "sparse.csr_from_triplet",
    "structured.to_ugrid2d",
)


class Generator:
    def __init__(self, run):
        self.run = run

    def raster_of(self, k: int) -> inputs.Raster:
        cell = self.run.config["raster"]["cell"]
        return common.raster_of(self.run.config, self.mesh, inputs.subcell_shift(cell, self.run.seed, k))

    def make_inputs(self) -> None:
        """The mesh and the payload pool on the device."""
        config, run = self.run.config, self.run
        self.mesh = common.mesh_of(config, run.seed)
        self.payload = common.Payload(config, len(self.mesh.faces), run.seed, run.device)

    def setup(self) -> None:
        import xugrid_tpu_torch as xt
        from xugrid_tpu_torch.utils.profiling import timings

        run = self.run
        self.xt, self.timings = xt, timings
        run.mark("import the port")
        self.make_inputs()
        run.mark("inputs")
        self.udas = self.payload.port_variables(xt, common.port_grid(xt, self.mesh))
        # Warm-up jobs take numbers the window never reaches, so that no
        # raster of the window was seen before it.
        for k in range(run.traffic["warmup_calls"]):
            self.call(-1 - k)
            synchronize(run.device)
            run.mark(f"warm-up job {k}")

    def call(self, k: int):
        self.timings.reset()
        raster = common.port_raster(self.xt, self.raster_of(k))
        source = self.udas[k % len(self.udas)]
        regridder = self.xt.OverlapRegridder(source, raster, method=self.run.traffic["method"])
        return regridder.regrid(source), 1

    def counters(self) -> dict:
        summary = self.timings.summary()
        return {"stages": {name: summary[name]["total_s"] for name in STAGES if name in summary}}

    def counts(self) -> dict:
        return {}

    def release(self) -> None:
        self.udas = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, kept: list) -> dict:
        judge = common.RasterJudge(self.mesh, self.payload.pool, self.run.device)
        for k, out in kept:
            judge.judge(out, self.raster_of(k), self.payload.variable(k))
        return judge.readings(self.run.traffic["limits"])

    def control_output(self, k: int, dtype) -> torch.Tensor:
        """Job k's result from the reference computed in ``dtype``."""
        raster = self.raster_of(k)
        triplets = overlap.overlap_triplets(self.mesh.nodes, self.mesh.faces, raster, self.run.device)
        return overlap.weighted_mean(triplets, self.payload.pool[self.payload.variable(k).rows], raster.size, dtype)

    def notes(self) -> list:
        return []
