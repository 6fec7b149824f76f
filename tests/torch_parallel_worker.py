"""
One rank of the sharded-port cases of ``tests/test_torch_parallel.py``.

    python -m tests.torch_parallel_worker RANK WORLD STORE INPUTS OUT_DIR

Joins a gloo world of WORLD processes through the file store STORE,
computes every case on the CPU from the arrays in INPUTS (an .npz the
test writes) and saves this rank's results to OUT_DIR/rank{RANK}.npz.
Imports torch and xugrid_tpu_torch only (no jax).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist


def run_cases(rank: int, world: int, inputs) -> dict:
    from xugrid_tpu_torch.core.sparse import PaddedCSR
    from xugrid_tpu_torch.parallel import (
        NeighborExchangePlan,
        ShardedRegrid,
        halo_exchange,
        sharded_cg_solve,
        sharded_laplace_smooth,
    )
    from xugrid_tpu_torch.regrid import reduce

    out = {}
    median = reduce.ABSOLUTE_OVERLAP_METHODS["median"]

    def padded(prefix):
        indices, weights = inputs[prefix + "_indices"], inputs[prefix + "_weights"]
        n, m = (int(v) for v in inputs[prefix + "_shape"])
        return PaddedCSR(indices, weights, n, m, indices.shape[1])

    for name in ("random", "overlap", "faces"):
        kwargs = {}
        if f"plan_{name}_source_size" in inputs:
            kwargs["source_size"] = int(inputs[f"plan_{name}_source_size"])
        plan = NeighborExchangePlan(None, inputs[f"plan_{name}"], device="cpu", **kwargs)
        out[f"plan_{name}_send_slots"] = plan.send_slots
        out[f"plan_{name}_lookup"] = plan.lookup
        out[f"plan_{name}_numbers"] = np.array(
            [plan.R, plan.n_remote, plan.n_unique_remote, plan.exchanged_bytes_f32, plan.block, plan.req_block]
        )

    # The JAX shard_map body's neighbour gather against the halo gather of
    # the regrid (``extend`` indexed by the lookup).
    plan = NeighborExchangePlan(None, inputs["plan_faces"], device="cpu")
    values = np.concatenate([inputs["faces_values"], np.full(plan.block * world - plan.n, np.nan)])
    v_local = torch.from_numpy(values[rank * plan.block : (rank + 1) * plan.block])
    send_local = plan.send_slots[rank * world : (rank + 1) * world]
    out["gather_neighbors"] = plan.gather_neighbors(v_local, send_local, plan.lookup_local, plan.exchange).numpy()
    lookup = torch.from_numpy(plan.lookup_local).long()
    halo = plan.extend(v_local[None])[0][torch.clamp(lookup, min=0)]
    out["gather_neighbors_halo"] = torch.where(lookup < 0, torch.nan, halo).numpy()

    weights = padded("overlap")
    for method in ("halo", "allgather"):
        for label, red in (("mean", reduce.mean), ("median", median)):
            sharded = ShardedRegrid(None, weights, red, method=method, device="cpu")
            out[f"regrid_{method}_{label}"] = sharded.gather(sharded(inputs["overlap_field"])).numpy()
            out[f"regrid_{method}_{label}_stack"] = sharded.gather(sharded(inputs["overlap_stack"])).numpy()
            out[f"regrid_{method}_{label}_local"] = sharded(inputs["overlap_field"]).numpy()
            out[f"regrid_{method}_numbers"] = np.array(
                [sharded.method == method, sharded.exchanged_bytes, sharded.rows, sharded.block]
            )

    for name in ("aligned", "scattered"):
        sharded = ShardedRegrid(None, padded(name), device="cpu")
        out[f"auto_{name}_halo"] = np.array(sharded.method == "halo")
        out[f"auto_{name}_bytes"] = np.array([sharded.exchanged_bytes, sharded.m_padded])
        out[f"auto_{name}"] = sharded.gather(sharded(inputs[f"{name}_field"])).numpy()

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.xdata import DataArray

    sv, sf, tv, tf = (inputs[k] for k in ("regridder_sv", "regridder_sf", "regridder_tv", "regridder_tf"))
    grid = xt.Ugrid2d(sv[:, 0], sv[:, 1], -1, sf)
    src = xt.UgridDataArray(DataArray(inputs["regridder_values"], dims=(grid.face_dimension,), name="v"), grid)
    target = xt.UgridDataArray.from_data(np.zeros(len(tf)), xt.Ugrid2d(tv[:, 0], tv[:, 1], -1, tf), facet="face")
    regridder = xt.OverlapRegridder(src, target, method="mean")
    sharded = ShardedRegrid.from_regridder(None, regridder, device="cpu")
    out["from_regridder"] = sharded.gather(sharded(inputs["regridder_values"].astype(np.float32))).numpy()

    x, k = sharded_cg_solve(
        None, inputs["cg_indices"], inputs["cg_weights"], inputs["cg_diag"], inputs["cg_b"],
        atol=1e-10, maxiter=2000, device="cpu",
    )
    out["cg_x"], out["cg_iterations"] = x, np.array(k)

    for method in ("halo", "allgather"):
        out[f"smooth_{method}"] = sharded_laplace_smooth(
            None, inputs["smooth_neighbors"], inputs["smooth_values"], n_steps=3, method=method, device="cpu"
        )
    out["smooth_chain"] = sharded_laplace_smooth(
        None, inputs["chain_neighbors"], inputs["chain_values"], n_steps=4, device="cpu"
    )

    block = torch.arange(6.0) + 10.0 * rank
    out["halo_0"] = halo_exchange(None, block, 0).numpy()
    out["halo_2"] = halo_exchange(None, block, 2).numpy()
    try:
        halo_exchange(None, block, 7)
        out["halo_7_raised"] = np.array(False)
    except ValueError:
        out["halo_7_raised"] = np.array(True)

    # A 2 x 2 layout of the ranks: shard over "x" (ranks with the same
    # y), one subgroup per y, as over one axis of a 2-axis JAX mesh.
    if world == 4:
        groups = [dist.new_group([0, 2]), dist.new_group([1, 3])]
        group = groups[rank % 2]
        sharded = ShardedRegrid(group, padded("multi"), method="allgather", device="cpu")
        out["subgroup"] = sharded.gather(sharded(inputs["multi_field"])).numpy()
        out["subgroup_size"] = np.array(sharded.exchange.size)
    return out


def main(argv) -> int:
    rank, world, store, inputs_path, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        with np.load(inputs_path) as data:
            inputs = dict(data)
        out = run_cases(rank, world, inputs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
