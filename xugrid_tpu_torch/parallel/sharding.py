"""
Multi-process execution on ``torch.distributed``: the face dimension of
UGRID data block-sharded over the ranks of a process group, as
``xugrid_tpu/parallel/sharding.py`` shards it over a JAX device mesh.

* Faces are ordered along the Hilbert curve (``partition_order``, the
  partitioner's curve), so each rank holds a spatially compact block.
* ``ShardedRegrid`` splits the target rows of a regrid's weights over the
  ranks; each rank receives the source rows its windows reference (one
  ``all_to_all_single`` of a ``NeighborExchangePlan``'s send rows) or
  gathers the whole source, and applies its windows with the port's
  kernels (``regrid/apply.py:apply_weights``: ``window_reduce``, or
  ``window_select`` for mode and percentiles) over the extended source.
* ``sharded_laplace_smooth`` is the same exchange per Jacobi step, its
  stencil mean a ``window_reduce`` launch; ``sharded_cg_solve`` is a
  Jacobi PCG whose SpMV is one ``csr_matvec`` launch over the rank's
  rows (the diagonal folded into its CSR) and whose dot products ride
  ``all_reduce``.

A JAX mesh and axis name become a process group (``group=None`` is the
default world; a subgroup of ``dist.new_group`` shards over its ranks
only).  The API is SPMD: every rank of the group calls with the same
host inputs, and ``ShardedRegrid.gather`` and the solvers return the
whole result on every rank.

The collectives go through the group's backend on the rank's device,
except for one named path: a gloo group with CUDA tensors stages every
message through host memory (gloo's collectives are not relied on to
take CUDA tensors), and ``Exchange.staged_bytes`` counts the bytes
copied.  With one rank the ring of ``halo_exchange`` is a local copy
(no rank sends to itself).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from xugrid_tpu_torch.core.sparse import MatrixCSR, PaddedCSR
from xugrid_tpu_torch.regrid import reduce as reductions
from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec
from xugrid_tpu_torch.regrid.apply import apply_weights
from xugrid_tpu_torch.ugrid.partitioning import hilbert_distance
from xugrid_tpu_torch.utils.device import resolve_device


def partition_order(coordinates: np.ndarray) -> np.ndarray:
    """Hilbert-curve ordering of entities: contiguous slices are compact
    spatial blocks, the layout used to shard the face dimension."""
    return np.argsort(hilbert_distance(np.asarray(coordinates)), kind="stable")


def hilbert_layout(
    source_centroids: np.ndarray,
    target_centroids: np.ndarray,
    target_index: np.ndarray,
    source_index: np.ndarray,
    weights: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, PaddedCSR]:
    """
    Hilbert-order both sides of a weight matrix and build its float32
    ``PaddedCSR`` in that order.

    Returns ``(sorder, torder, padded)``: contiguous row blocks of
    ``padded`` are spatially compact (ranks exchange only a perimeter
    halo), and ``padded.indices`` are positions in the reordered source
    field ``field[..., sorder]``.  Triplets grouped by ascending target,
    as the overlap builders emit them, are laid out in one native pass
    (``padded_layout``) that keeps each window's entry order; otherwise
    (or without the native library) through a stable sort by target.
    """
    from xugrid_tpu_torch.utils.native import padded_layout_native

    sorder = partition_order(source_centroids)
    torder = partition_order(target_centroids)
    sremap = np.empty(len(sorder), np.int64)
    sremap[sorder] = np.arange(len(sorder))
    n = len(torder)
    m = len(sorder)
    native = padded_layout_native(target_index, source_index, weights, torder, sremap, n)
    if native is not None:
        indices, w32 = native
        return sorder, torder, PaddedCSR(indices, w32, n, m, indices.shape[1])
    tremap = np.empty(n, np.int64)
    tremap[torder] = np.arange(n)
    csr = MatrixCSR.from_triplet(tremap[target_index], sremap[source_index], weights, n=n, m=m)
    return sorder, torder, PaddedCSR.from_csr(csr, dtype=np.float32)


def _pad_to_multiple(array: np.ndarray, multiple: int, fill) -> np.ndarray:
    n = array.shape[0]
    n_pad = (-n) % multiple
    if n_pad == 0:
        return array
    pad_shape = (n_pad,) + array.shape[1:]
    return np.concatenate([array, np.full(pad_shape, fill, array.dtype)])


class Exchange:
    """
    The collectives of one process group for tensors on ``device``.

    ``staged`` (a gloo group with CUDA tensors): every message is copied
    to host memory before the collective and back after it, and
    ``staged_bytes`` counts the bytes of both copies.
    """

    def __init__(self, group, device: torch.device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)
        self.staged = self.device.type == "cuda" and dist.get_backend(group) == "gloo"
        self.staged_bytes = 0

    def _global_rank(self, group_rank: int) -> int:
        return group_rank if self.group is None else dist.get_global_rank(self.group, group_rank)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if self.staged:
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        if self.staged:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(self.device)
        return t

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """Rows ``[r * R, (r + 1) * R)`` of ``send`` go to rank r; the result
        holds rank o's rows for this rank at ``[o * R, (o + 1) * R)``."""
        send = self._out(send)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return self._in(recv)

    def all_gather(self, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``local`` concatenated along ``dim`` in rank order."""
        local = self._out(local)
        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local, group=self.group)
        return self._in(torch.cat(parts, dim=dim))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``."""
        t = self._out(t.clone())
        dist.all_reduce(t, group=self.group)
        return self._in(t)

    def ring(self, to_right: torch.Tensor, to_left: torch.Tensor):
        """Send ``to_right`` to the next rank and ``to_left`` to the
        previous one on a ring; returns (from the previous rank, from the
        next rank).  With one rank both come back from this rank."""
        if self.size == 1:
            return to_right.clone(), to_left.clone()
        right = self._global_rank((self.rank + 1) % self.size)
        left = self._global_rank((self.rank - 1) % self.size)
        to_right, to_left = self._out(to_right), self._out(to_left)
        from_left, from_right = torch.empty_like(to_right), torch.empty_like(to_left)
        ops = [
            dist.P2POp(dist.isend, to_right, right, self.group, 0),
            dist.P2POp(dist.irecv, from_left, left, self.group, 0),
            dist.P2POp(dist.isend, to_left, left, self.group, 1),
            dist.P2POp(dist.irecv, from_right, right, self.group, 1),
        ]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        return self._in(from_left), self._in(from_right)


class NeighborExchangePlan:
    """
    Precomputed distributed neighbour-gather plan (the halo machinery).

    The indexed (source) dimension is block-sharded over the group's
    ranks, and so are the requesting rows; the two may have different
    lengths (``source_size``), e.g. regrid target windows indexing a
    source field.  At setup every remote reference is resolved to (owner
    rank, local slot) and deduplicated into fixed-size per-rank-pair send
    lists, with vectorized sort/group-by; the host build is the JAX
    package's, so ``send_slots``, ``lookup``, ``R`` and
    ``exchanged_bytes_f32`` are equal for the same inputs and shard
    count.  At run time one ``all_to_all_single`` moves exactly the
    referenced rows (``extend``).

    ``send_slots`` (D * D, R) and ``lookup`` (D * req_block, k) are the
    whole plan on the host; this rank's parts are ``send_local`` (its
    (D * R,) send slots, on ``device``) and ``lookup_local`` (its rows'
    indices into ``[local block | received rows]``, -1 for none).
    """

    def __init__(self, group, neighbor_indices: np.ndarray, source_size: int | None = None, device=None):
        self.device = resolve_device(None, device)
        self.exchange = Exchange(group, self.device)
        n_devices = self.exchange.size
        idx = np.asarray(neighbor_indices, dtype=np.int64)
        n = idx.shape[0]
        n_req_block = -(-n // n_devices)
        idx = _pad_to_multiple(idx, n_devices, -1)
        m = n if source_size is None else int(source_size)
        block = -(-m // n_devices)  # source rows per rank

        valid = idx >= 0
        owner = np.where(valid, idx // block, -1)
        slot = np.where(valid, idx % block, 0)
        row_device = np.repeat(np.arange(n_devices), n_req_block)[:, None]
        is_remote = valid & (owner != row_device)

        # Dedup of remote (owner, requester, slot) triples in one sorted
        # unique pass; triples of one (owner, requester) land contiguously,
        # so the in-group position is a running offset from its start.
        ro = owner[is_remote]
        rs = slot[is_remote]
        rr = np.broadcast_to(row_device, owner.shape)[is_remote]
        key = (ro * n_devices + rr) * block + rs
        uniq, inverse = np.unique(key, return_inverse=True)
        u_slot = uniq % block
        u_group = uniq // block  # owner * n_devices + requester
        group_start = np.flatnonzero(np.diff(u_group, prepend=np.int64(-1)) != 0)
        starts_per_uniq = np.repeat(group_start, np.diff(np.append(group_start, len(uniq))))
        u_pos = np.arange(len(uniq)) - starts_per_uniq
        group_sizes = (
            np.bincount(u_group.astype(np.int64), minlength=n_devices * n_devices)
            if len(uniq)
            else np.zeros(n_devices * n_devices, np.int64)
        )
        R = max(int(group_sizes.max()) if len(uniq) else 0, 1)

        # send_slots[o * D + r, :]: local slots rank o sends to requester r.
        send_slots = np.zeros((n_devices * n_devices, R), dtype=np.int32)
        send_slots[u_group, u_pos] = u_slot
        # Combined lookup into [local (block) | received (D * R)]: after the
        # all_to_all, received row o * R + p is owner o's p-th requested row.
        lookup = np.full(idx.shape, -1, dtype=np.int32)
        local_mask = valid & ~is_remote
        lookup[local_mask] = slot[local_mask]
        u_owner = u_group // n_devices
        lookup[is_remote] = (block + u_owner * R + u_pos)[inverse]

        self.n = n
        self.m = m
        self.block = block
        self.req_block = n_req_block
        self.R = R
        self.n_remote = int(is_remote.sum())
        self.n_unique_remote = int(len(uniq))
        #: bytes moved per exchange of a float32 field (the all_to_all's
        #: payload over all ranks, send and receive counted once).
        self.exchanged_bytes_f32 = n_devices * n_devices * R * 4
        self.send_slots = send_slots
        self.lookup = lookup
        rank = self.exchange.rank
        self.send_local = torch.from_numpy(
            send_slots[rank * n_devices : (rank + 1) * n_devices].reshape(-1).astype(np.int64)
        ).to(self.device)
        self.lookup_local = lookup[rank * n_req_block : (rank + 1) * n_req_block]

    def gather_neighbors(self, v_local, send_slots_local, lookup_local, exchange: Exchange) -> torch.Tensor:
        """(req_block, k) neighbour values of this rank's rows, NaN for -1:
        the JAX package's ``shard_map`` body with its communicator passed
        as ``exchange`` (this plan's is ``self.exchange``).

        ``v_local`` is this rank's (block,) source block,
        ``send_slots_local`` its (D, R) send slots and ``lookup_local`` its
        rows' indices into [local block | received rows]."""
        send_slots_local = torch.as_tensor(send_slots_local, device=v_local.device).long()
        send = v_local[send_slots_local.reshape(-1)].reshape(send_slots_local.shape)  # (D, R)
        recv = exchange.all_to_all(send)  # row o: the rows this rank asked owner o for
        extended = torch.cat([v_local, recv.reshape(-1)])
        lookup = torch.as_tensor(lookup_local, device=v_local.device).long()
        return torch.where(lookup < 0, torch.nan, extended[torch.clamp(lookup, min=0)])

    def extend(self, source_local: torch.Tensor) -> torch.Tensor:
        """This rank's (E, block) source block followed by the (E, D * R)
        rows the other ranks sent it: the source ``lookup_local`` indexes."""
        send = source_local[:, self.send_local].t()  # (D * R, E)
        recv = self.exchange.all_to_all(send)
        return torch.cat([source_local, recv.t()], dim=1)


class ShardedRegrid:
    """
    A regrid apply sharded over the ranks of a process group.

    Target rows (the ``PaddedCSR`` windows) and the source field are
    split into contiguous blocks, one per rank.  Two exchanges:

    * ``"halo"``: a ``NeighborExchangePlan`` moves only the deduplicated
      remote source rows each rank's windows reference, in one
      ``all_to_all_single``: O(perimeter) bytes when the source and
      target orders are spatially aligned (Hilbert or raster order);
    * ``"allgather"``: every rank gathers the whole source, O(m) bytes,
      the right call when remote references are dense.

    ``"auto"`` (default) builds the plan and takes the halo when it moves
    fewer rows than a gather (``2 * D * R < m_padded``).  Either way each
    rank applies its windows with ``apply_weights`` on ``device`` (the
    card by default): one launch of ``window_reduce`` (``window_select``
    for mode and percentiles) over the extended (E, m_local) source.
    """

    def __init__(
        self,
        group,
        weights: PaddedCSR,
        reduction: Callable = reductions.mean,
        method: str = "auto",
        device=None,
    ):
        if method not in ("auto", "halo", "allgather"):
            raise ValueError(f"method must be 'auto', 'halo' or 'allgather', got {method}")
        self.group = group
        self.device = resolve_device(None, device)
        self.exchange = Exchange(group, self.device)
        self.reduction = reduction
        n_devices, rank = self.exchange.size, self.exchange.rank

        indices = _pad_to_multiple(weights.indices, n_devices, -1)
        values = _pad_to_multiple(weights.weights, n_devices, 0.0)
        m_pad = (-weights.m) % n_devices
        self.n_target = weights.n
        self.m_source = weights.m
        self.m_padded = weights.m + m_pad
        #: source columns and target rows per rank
        self.block = self.m_padded // n_devices
        self.rows = len(indices) // n_devices
        rows = slice(rank * self.rows, (rank + 1) * self.rows)

        self.plan: NeighborExchangePlan | None = None
        if method in ("auto", "halo"):
            plan = NeighborExchangePlan(group, indices, source_size=self.m_padded, device=self.device)
            # Halo moves D * R rows out and D * R in per rank; the gather
            # brings in about m_padded.  Halo when strictly cheaper, or asked.
            if method == "halo" or 2 * n_devices * plan.R < self.m_padded:
                plan.exchange = self.exchange  # one count of staged bytes
                self.plan = plan
        self.method = "halo" if self.plan is not None else "allgather"
        #: bytes moved per float32 apply of one slice (scale checks).
        self.exchanged_bytes = self.plan.exchanged_bytes_f32 if self.plan is not None else self.m_padded * 4
        if self.plan is not None:
            local_indices = self.plan.lookup_local
            m_local = self.block + n_devices * self.plan.R
        else:
            local_indices = indices[rows]
            m_local = self.m_padded
        #: this rank's windows over its extended source
        self.local_weights = PaddedCSR(local_indices, values[rows], self.rows, m_local, indices.shape[1])
        self._device_weights = {}

    @classmethod
    def from_regridder(cls, group, regridder, reduction: Callable | None = None, method: str = "auto", device=None):
        """
        Shard a built regridder's weights over the group's ranks.

        ``regridder`` is any regridder with ``PaddedCSR`` weights (e.g.
        ``OverlapRegridder``); its reduction is reused unless overridden.
        Apply with source fields in the source grid's face order; sort
        both grids spatially (``partition_order``) before building the
        regridder for an O(perimeter) halo exchange.
        """
        if reduction is None:
            reduction = regridder._reduction
        return cls(group, regridder._padded, reduction=reduction, method=method, device=device)

    def put_source(self, source) -> torch.Tensor:
        """This rank's block of a source field (..., m): padded with NaN to
        ``m_padded`` and cut to (..., block), on the rank's device.
        Integers become float64."""
        source = torch.as_tensor(source)
        if not source.is_floating_point():
            source = source.to(torch.float64)
        if source.shape[-1] != self.m_source:
            raise ValueError(f"source has {source.shape[-1]} values along its last axis, expected {self.m_source}")
        start = self.exchange.rank * self.block
        local = source[..., start : min(start + self.block, self.m_source)].to(self.device)
        n_pad = self.block - local.shape[-1]
        if n_pad:
            pad = torch.full(local.shape[:-1] + (n_pad,), torch.nan, dtype=local.dtype, device=self.device)
            local = torch.cat([local, pad], dim=-1)
        return local.contiguous()

    def __call__(self, source) -> torch.Tensor:
        """Apply the sharded regrid; returns this rank's (..., rows) block
        of the target field.  ``source`` is a host array or a tensor of
        the whole field (..., m), or this rank's block from
        ``put_source`` (..., block)."""
        if not isinstance(source, torch.Tensor) or source.shape[-1] != self.block:
            source = self.put_source(source)
        source = source.to(self.device)
        leading = tuple(source.shape[:-1])
        local = source.reshape(-1, self.block)
        if self.plan is not None:
            full = self.plan.extend(local)
        else:
            full = self.exchange.all_gather(local, dim=1)
        out = apply_weights(self.local_weights, full, self.reduction, self.rows, plan_cache=self._device_weights)
        return out.reshape(leading + (self.rows,))

    def gather(self, out: torch.Tensor) -> torch.Tensor:
        """The whole target field (..., n) on every rank, unpadded, on the
        rank's device."""
        return self.exchange.all_gather(out, dim=-1)[..., : self.n_target]


def halo_exchange(group, local: torch.Tensor, halo: int) -> torch.Tensor:
    """
    Ring halo exchange: this rank's block extended with ``halo`` rows
    from both ring neighbours, ``[previous rank's last rows | local |
    next rank's first rows]``, along the first axis.  Every rank of the
    group calls it with its own block.
    """
    if halo <= 0:
        return local
    if halo > local.shape[0]:
        raise ValueError(f"halo ({halo}) exceeds the local block ({local.shape[0]})")
    exchange = Exchange(group, local.device)
    from_left, from_right = exchange.ring(local[-halo:], local[:halo])
    return torch.cat([from_left, local, from_right], dim=0)


def sharded_laplace_smooth(
    group,
    neighbor_indices: np.ndarray,
    values: np.ndarray,
    n_steps: int = 1,
    method: str = "halo",
    device=None,
) -> np.ndarray:
    """
    Jacobi smoothing over face adjacency, SPMD over the group's ranks:
    per step ``0.5 * v + 0.5 * nanmean(neighbours and v)``.

    neighbor_indices: (n_face, k) global face indices (-1 padded).

    method="halo" (default) exchanges only the referenced boundary rows
    per step (one ``all_to_all_single`` of a ``NeighborExchangePlan``);
    method="allgather" gathers the whole field.  The stencil mean is one
    ``window_reduce`` launch per step (unit weights over the neighbours
    and the face itself).  Returns the (n,) float64 result on every rank.
    """
    if method not in ("halo", "allgather"):
        raise ValueError(f"method must be 'halo' or 'allgather', got {method}")
    device = resolve_device(None, device)
    exchange = Exchange(group, device)
    n_devices, rank = exchange.size, exchange.rank
    n = len(values)
    vals = _pad_to_multiple(np.asarray(values, dtype=np.float64), n_devices, np.nan)
    rows = len(vals) // n_devices
    own = slice(rank * rows, (rank + 1) * rows)
    local = torch.from_numpy(vals[own]).to(device)[None]
    if method == "halo":
        plan = NeighborExchangePlan(group, neighbor_indices, device=device)
        window, self_index = plan.lookup_local, np.arange(rows)
        m_local = plan.block + n_devices * plan.R
    else:
        plan = None
        window = _pad_to_multiple(np.asarray(neighbor_indices, dtype=np.int64), n_devices, -1)[own]
        self_index, m_local = np.arange(own.start, own.stop), len(vals)
    indices = np.concatenate([window, self_index[:, None]], axis=1).astype(np.int32)
    stencil = PaddedCSR(indices, (indices >= 0).astype(np.float64), rows, m_local, indices.shape[1])
    cache = {}
    for _ in range(n_steps):
        full = plan.extend(local) if plan is not None else exchange.all_gather(local, dim=1)
        local = 0.5 * local + 0.5 * apply_weights(stencil, full, reductions.mean, rows, plan_cache=cache)
    return exchange.all_gather(local, dim=1)[0, :n].cpu().numpy()


def sharded_cg_solve(
    group,
    indices: np.ndarray,
    weights: np.ndarray,
    diag: np.ndarray,
    b: np.ndarray,
    x0: Optional[np.ndarray] = None,
    rtol: float = 0.0,
    atol: float = 1e-6,
    maxiter: int = 500,
    device=None,
):
    """
    Distributed Jacobi-preconditioned CG over the group's ranks.

    The system is windowed: row i is ``diag[i] * x[i] + sum_j
    weights[i, j] * x[indices[i, j]]`` (``indices`` global, -1 padded).
    Rows, diagonal and right-hand side are block-sharded; each matvec
    moves only the referenced boundary rows (one ``all_to_all_single`` of
    a ``NeighborExchangePlan``) and is one ``csr_matvec`` launch over the
    rank's CSR rows (diagonal first, then the window's entries) on the
    extended vector.  The dot products ride ``all_reduce`` (r.z and r.r
    in one), and the loop syncs the host once per iteration, for its
    test ``sqrt(r.r) > max(atol, rtol * |b|)``.

    Returns (solution (n,) float64 on every rank, iterations).
    """
    device = resolve_device(None, device)
    exchange = Exchange(group, device)
    n_devices, rank = exchange.size, exchange.rank
    n = len(b)
    idxp = _pad_to_multiple(np.asarray(indices, np.int64), n_devices, -1)
    wp = _pad_to_multiple(np.asarray(weights, np.float64), n_devices, 0.0)
    diagp = _pad_to_multiple(np.asarray(diag, np.float64), n_devices, 1.0)
    bp = _pad_to_multiple(np.asarray(b, np.float64), n_devices, 0.0)
    x0p = np.zeros_like(bp) if x0 is None else _pad_to_multiple(np.asarray(x0, np.float64), n_devices, 0.0)
    plan = NeighborExchangePlan(group, idxp, device=device)
    tol = max(float(atol), float(rtol) * float(np.linalg.norm(bp)))

    rows = plan.req_block
    own = slice(rank * rows, (rank + 1) * rows)
    lookup = plan.lookup_local
    cols = np.concatenate([np.arange(rows)[:, None], lookup], axis=1)
    data = np.concatenate([diagp[own][:, None], wp[own]], axis=1)
    keep = np.concatenate([np.ones((rows, 1), bool), lookup >= 0], axis=1)
    indptr = np.zeros(rows + 1, np.int32)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    indptr_d = torch.from_numpy(indptr).to(device)
    cols_d = torch.from_numpy(cols[keep].astype(np.int32)).to(device)
    data_d = torch.from_numpy(data[keep]).to(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a[own])).to(device)

    def matvec(v):
        return csr_matvec(indptr_d, cols_d, data_d, plan.extend(v[None]).reshape(-1, 1))[:, 0]

    def dots(r, z):  # (r.z, r.r) over all ranks
        return exchange.all_reduce(torch.stack([torch.dot(r, z), torch.dot(r, r)]))

    diag_l = put(diagp)
    minv = torch.where(diag_l != 0.0, 1.0 / diag_l, 1.0)
    x = put(x0p)
    r = put(bp) - matvec(x)
    z = minv * r
    p = z.clone()
    rz, rr = dots(r, z)
    k = 0
    while k < maxiter and bool(torch.sqrt(rr) > tol):
        Ap = matvec(p)
        pAp = exchange.all_reduce(torch.dot(p, Ap))
        alpha = torch.where(pAp != 0.0, rz / torch.where(pAp == 0.0, 1.0, pAp), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv * r
        rz_new, rr = dots(r, z)
        beta = torch.where(rz != 0.0, rz_new / torch.where(rz == 0.0, 1.0, rz), 0.0)
        p = p * beta + z
        rz = rz_new
        k += 1
    return exchange.all_gather(x)[:n].cpu().numpy(), k
