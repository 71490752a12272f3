"""Device meshes and the collectives of the sharded EM, in one process.

Counterpart: ``metamaps_tpu/parallel/mesh.py``. The JAX mesh is
single-controller: one process holds ``jax.devices()[:n]`` reshaped to
(shard, data), and ``shard_map`` runs one body per device. Here a
:class:`Mesh` is an array of ``torch.device`` with axis names, the bodies
run one rank after another in the calling thread (launches are
asynchronous until a host copy), and each collective is a host-ordered
reduction:

- axis "data": read batches and EM lines split data-parallel; the EM's
  two ``psum``s become sums over the ranks in rank order on the first
  rank's device (exact where each read lives on one rank, deterministic
  everywhere);
- axis "shard": the contig-partitioned index; the per-read union of
  candidates happens on the host (``sharded_engine``).

A device list may repeat a device: eight ranks on ``"cpu"`` or on
``"cuda:0"`` run the mesh where there is one device, as the JAX tests run
eight virtual CPU devices.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..device import require_cuda


class Mesh:
    """``devices``: an array of ``torch.device``, one axis per name."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} mesh axes, names {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


def _mesh_devices(n: int, devices=None) -> List[torch.device]:
    """``n`` rank devices: ``cuda:0 .. cuda:n-1`` when ``devices`` is None
    (raises without CUDA or with fewer cards), else the given list of
    length ``n``, in which a device may repeat (each CUDA device in it must
    exist)."""
    if devices is None:
        require_cuda("cuda")
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"the mesh needs {n} CUDA devices, have {have}")
        return [torch.device("cuda", i) for i in range(n)]
    out = [torch.device(d) for d in devices]
    if len(out) != n:
        raise ValueError(f"the mesh needs {n} devices, {len(out)} given")
    for d in out:
        require_cuda(d)
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"{d}: only {torch.cuda.device_count()} CUDA "
                               "devices")
    return out


def _device_array(devs: List[torch.device], shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def make_mesh(n_devices: int, devices=None, data_axis: str = "data") -> Mesh:
    """A 1-D mesh of ``n_devices`` ranks on axis ``data_axis``."""
    return Mesh(_device_array(_mesh_devices(n_devices, devices),
                              (n_devices,)), (data_axis,))


def make_mesh_2d(n_shard: int, n_data: int, devices=None,
                 axes=("shard", "data")) -> Mesh:
    """2-D mesh: index partitions along ``axes[0]``, reads data-parallel
    along ``axes[1]``; rank s * n_data + d is (shard s, data d), the layout
    of the JAX package's ``make_mesh_2d``."""
    n = n_shard * n_data
    return Mesh(_device_array(_mesh_devices(n, devices), (n_shard, n_data)),
                axes)


def partition_lines_read_atomic(read_of_line: np.ndarray, n_parts: int):
    """Device boundaries over the mapping lines such that every read's
    lines land on ONE device (reads are the atomic unit of the E-step's
    per-read normalization). read_of_line is nondecreasing; boundaries are
    the read starts nearest to equal line counts. Returns n_parts+1 line
    offsets (some chunks may be empty when reads are few/skewed)."""
    L = int(len(read_of_line))
    if L == 0:
        return [0] * (n_parts + 1)
    n_reads = int(read_of_line[-1]) + 1
    read_starts = np.searchsorted(read_of_line, np.arange(n_reads + 1))
    bounds = [0]
    for d in range(1, n_parts):
        t = L * d // n_parts
        i = int(np.searchsorted(read_starts, t, side="left"))
        b = int(read_starts[min(i, n_reads)])
        bounds.append(max(b, bounds[-1]))
    bounds.append(L)
    return bounds


class _RankLines:
    """One rank's block of mapping lines on its device. Both of the round's
    sums are CSR segment sums (``torch.segment_reduce``): the per-read sums
    over the lines, which are grouped by read (``read_of_line`` is
    nondecreasing, and so is each rank's slice of it), and the per-taxon
    sums over the lines in a stable taxon order fixed once here. Unlike
    ``index_add_``, whose CUDA atomics change the order of a float64 sum
    from run to run, these give the same bits in every round and every run
    on one card."""

    def __init__(self, device, read, tax, inv_loc, mapq, n_reads: int,
                 n_tax: int):
        dev = torch.device(device)
        self.device = dev
        self.read = torch.as_tensor(read.astype(np.int64), device=dev)
        self.tax = torch.as_tensor(tax.astype(np.int64), device=dev)
        f64 = dict(dtype=torch.float64, device=dev)
        self.inv_loc = torch.as_tensor(inv_loc, **f64)
        self.mapq = torch.as_tensor(mapq, **f64)
        self.read_len = torch.as_tensor(
            np.bincount(read, minlength=n_reads), device=dev)
        self.by_tax = torch.as_tensor(np.argsort(tax, kind="stable"),
                                      device=dev)
        self.tax_len = torch.as_tensor(
            np.bincount(tax, minlength=n_tax), device=dev)


def _rank_sum(parts, dev) -> torch.Tensor:
    """The sum of per-rank tensors in rank order on ``dev`` (the psum)."""
    total = parts[0].to(dev)
    for x in parts[1:]:
        total = total + x.to(dev)
    return total


def _em_round(ranks: List[_RankLines], f: np.ndarray):
    """One EM round over the ranks: (f_next, ll, per_read), tensors on the
    first rank's device. Each rank sums its lines per read and per taxon;
    the per-read sums are summed over the ranks before the responsibilities,
    the per-taxon sums after them."""
    dev0 = ranks[0].device
    ls, per_read_parts = [], []
    for rk in ranks:
        f_dev = torch.as_tensor(f, dtype=torch.float64, device=rk.device)
        l = f_dev[rk.tax] * rk.inv_loc * rk.mapq  # em_iterate's order
        ls.append(l)
        per_read_parts.append(
            torch.segment_reduce(l, "sum", lengths=rk.read_len))
    per_read = _rank_sum(per_read_parts, dev0)
    ll = torch.log(per_read).sum()
    f_parts = []
    for rk, l in zip(ranks, ls):
        p = l / per_read.to(rk.device)[rk.read]
        f_parts.append(
            torch.segment_reduce(p[rk.by_tax], "sum", lengths=rk.tax_len))
    f_tot = _rank_sum(f_parts, dev0)
    return f_tot / f_tot.sum(), ll, per_read


def make_em_iterate_sharded(table, devices):
    """Data-parallel EM rounds over the ranks ``devices`` (a list; a device
    may repeat): the mapping lines partitioned read-atomically, one block
    per rank in float64 on its device; per-read normalizers and per-taxon
    sufficient statistics summed over the ranks in rank order (the
    TPU-native OpenMP-parallel-for + per-thread-accumulator merge,
    fEM.h:512-600). Returns step: f -> (f_next, ll) as host float64 numpy
    and a float. On one rank this is the EM round on one device
    (``engine/em.py:make_em_iterate_torch``)."""
    devs = [torch.device(d) for d in devices]
    n_reads = len(table.read_ids)
    n_tax = len(table.taxon_list)
    bounds = partition_lines_read_atomic(table.read_of_line, len(devs))
    ranks = [
        _RankLines(dev, table.read_of_line[lo:hi], table.taxon_of_line[lo:hi],
                   table.inv_locations[lo:hi], table.mapq[lo:hi], n_reads,
                   n_tax)
        for dev, lo, hi in zip(devs, bounds[:-1], bounds[1:])
    ]

    def step(f: np.ndarray):
        f_next, ll, per_read = _em_round(ranks, f)
        # one copy to the host: f_next, then ll and the smallest per-read sum
        host = torch.cat([f_next, ll[None], per_read.min()[None]]).cpu().numpy()
        assert host[-1] > 0, "read with zero total location probability"
        return host[:-2], float(host[-2])

    return step


def sharded_em_step(mesh: Mesh, read_of_line, taxon_of_line, mapq, invloc, f,
                    n_reads):
    """One EM round with lines data-parallel over the 1-D ``mesh``.

    Contract: lines of one read live on one device (reads are atomic units
    — the host feeder guarantees this); the lines split into equal
    contiguous blocks, one per rank, so their count must divide the mesh
    size (pad with mapq=0 lines). Per-read normalizers and per-taxon
    sufficient statistics are summed over the ranks. read_of_line uses
    GLOBAL read ids; n_reads is the global read count. Computes in float64;
    returns (f_next, ll) as numpy and a float."""
    devs = list(mesh.devices.ravel())
    n_lines = len(read_of_line)
    if n_lines % len(devs):
        raise ValueError(f"{n_lines} lines do not split over {len(devs)} "
                         "ranks")
    n_tax = int(np.shape(f)[0])
    per = n_lines // len(devs)
    cols = [np.asarray(a) for a in (read_of_line, taxon_of_line, invloc,
                                    mapq)]
    ranks = []
    for r, dev in enumerate(devs):
        block = [c[r * per:(r + 1) * per] for c in cols]
        by_read = np.argsort(block[0], kind="stable")  # the CSR layout
        ranks.append(_RankLines(dev, *(c[by_read] for c in block),
                                int(n_reads), n_tax))
    f_next, ll, _ = _em_round(ranks, np.asarray(f, np.float64))
    return f_next.cpu().numpy(), float(ll)
