"""Device meshes and data-parallel sharding of batch-leading trees.

Counterpart of ``legged_gym_dev_tpu/parallel/mesh.py``. The parallel axis
is the scenario / env batch ("dp"): solver scenarios and env state shard
over it, network parameters replicate. A per-scenario network (a module
with ``per_scenario`` set, as ``tube.models.MLP`` of ``(B, in, out)``
weights) is batch data and shards along its scenario axis instead.

JAX shards one global array over the mesh and XLA partitions the program.
PyTorch has no such array, so the port shards the way one process drives
several devices: a sharded tree is one tree per mesh device (``Sharded``),
per-shard work is issued shard by shard (``map_shards``; launches are
asynchronous, so several cards overlap), and the one cross-shard step of a
program is explicit code (``gather``, or a sum over shards). A mesh may
list one device more than once: ``make_mesh(4, devices=[cpu] * 4)`` is the
counterpart of the JAX tests' virtual host devices, and a k-shard mesh of
one card exercises every cross-shard step on that card.

A tree is nested dataclasses, NamedTuples, tuples, lists and dicts; its
leaves are tensors, modules, generators and plain values. Not ported: the
JAX module's HLO parsers (``parse_replica_groups``,
``hlo_collective_crosses_hosts``), which read XLA's compiled program text;
the port compiles no HLO.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out in named axes, as ``jax.sharding.Mesh``."""

    devices: np.ndarray            # object array of torch.device
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def extent(self, axis) -> int:
        """Shards along ``axis`` (a name or a tuple of names). The batch
        shards over every axis of the mesh: a name list that leaves one
        out (replicas along it) raises."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in names if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} not in the mesh's "
                             f"{self.axis_names}")
        if sorted(names) != sorted(self.axis_names):
            raise ValueError(f"the batch shards over every mesh axis "
                             f"{self.axis_names}, not {names}")
        return self.size


def _device_array(devs: Sequence, shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        arr[i] = d
    return arr.reshape(shape)


def _devices(devices):
    """``devices`` as a list, or every CUDA device (raises without one:
    a mesh asked of the card never lands on the CPU)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices= "
                           "(e.g. [torch.device('cpu')] * n) to run on the "
                           "CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices=None) -> Mesh:
    """A 1-axis mesh of ``n_devices`` (default: all) of ``devices``
    (default: every CUDA device)."""
    devs = _devices(devices)
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(f"need {n} devices for a mesh of {n}, have "
                         f"{len(devs)}")
    return Mesh(_device_array(devs[:n], (n,)), (axis,))


def make_host_mesh(n_hosts: int, chips_per_host: int,
                   devices=None) -> Mesh:
    """A 2-axis ``(dcn, ici)`` mesh modelling hosts of chips: axis 0 the
    host boundary, axis 1 the chips of a host (consecutive devices). The
    batch shards over their product."""
    devs = _devices(devices)
    n = n_hosts * chips_per_host
    if len(devs) < n:
        raise ValueError(f"need {n} devices for a ({n_hosts}, "
                         f"{chips_per_host}) mesh, have {len(devs)}")
    return Mesh(_device_array(devs[:n], (n_hosts, chips_per_host)),
                ("dcn", "ici"))


class Sharded:
    """One tree per shard of ``mesh``: shard i lives on
    ``mesh.devices.flat[i]``. ``batch_size`` is the global batch the
    shards split, where known; ``split`` (from ``shard_batch``) says leaf
    by leaf whether it was split or replicated."""

    def __init__(self, shards: Sequence, mesh: Mesh,
                 batch_size: Optional[int] = None,
                 split: Optional[List[bool]] = None):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size}")
        self.shards = list(shards)
        self.mesh = mesh
        self.batch_size = batch_size
        self.split = split

    def __len__(self) -> int:
        return len(self.shards)

    def __getitem__(self, i):
        return self.shards[i]

    def __iter__(self):
        return iter(self.shards)


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of ``tree``, the structure rebuilt only where a
    leaf changed (an unchanged subtree is returned as it is, so objects
    that cache per device, such as a robot model, are kept)."""
    if isinstance(tree, (torch.Tensor, torch.nn.Module, torch.Generator,
                         Sharded)):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {}
        for f in dataclasses.fields(tree):
            if not f.init:
                continue
            v = getattr(tree, f.name)
            nv = tree_map(fn, v)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(tree, **changes) if changes else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        new = [tree_map(fn, v) for v in tree]
        changed = any(a is not b for a, b in zip(new, tree))
        return type(tree)(*new) if changed else tree
    if isinstance(tree, (tuple, list)):
        new = [tree_map(fn, v) for v in tree]
        changed = any(a is not b for a, b in zip(new, tree))
        return type(tree)(new) if changed else tree
    if isinstance(tree, dict):
        new = {k: tree_map(fn, v) for k, v in tree.items()}
        changed = any(new[k] is not tree[k] for k in tree)
        return type(tree)(new) if changed else tree
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []

    def visit(x):
        out.append(x)
        return x

    tree_map(visit, tree)
    return out


def _module_device(m: torch.nn.Module):
    for t in list(m.parameters()) + list(m.buffers()):
        return t.device
    return None


def _rows(x):
    """The leading (batch) extent of a leaf: a tensor's first dim, a
    per-scenario module's scenario count; None for anything else."""
    if isinstance(x, torch.Tensor):
        return x.shape[0] if x.ndim >= 1 else None
    if isinstance(x, torch.nn.Module) and getattr(x, "per_scenario", False):
        return x.batch_size
    return None


def place(tree, device):
    """``tree`` on ``device``: tensors moved (kept where they are already
    there), modules elsewhere copied there, a function that holds its
    tensors (``device`` and ``to`` attributes, as a heightfield sampler)
    rebuilt there; other leaves as they are."""
    device = torch.device(device)

    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, torch.nn.Module):
            dev = _module_device(x)
            return x if dev in (None, device) else copy.deepcopy(x).to(device)
        if callable(x) and isinstance(getattr(x, "device", None),
                                      torch.device) and hasattr(x, "to"):
            return x if x.device == device else x.to(device)
        return x

    return tree_map(put, tree)


def shard_batch(tree, mesh: Mesh, axis="dp",
                batch_size: Optional[int] = None) -> Sharded:
    """Shard every tensor leaf whose leading dim divides by the mesh extent
    over ``axis`` (a name or a tuple of names, e.g. ``("dcn", "ici")``)
    and, given ``batch_size``, equals it: shard i takes rows [i b, (i+1) b)
    as its own copy on its device. A per-scenario module (``_rows``) is
    split the same way along its scenario axis (``select``). Every other
    leaf replicates (``place``): with ``batch_size`` an LSTM state shaped
    (2, B nj, 8), a (4, 2) command-range table or a shared tube network
    stays whole on every shard."""
    k = mesh.extent(axis)

    def splits(x):
        rows = _rows(x)
        return (rows is not None and rows % k == 0
                and (batch_size is None or rows == batch_size))

    split = [splits(x) for x in tree_leaves(tree)]
    sizes = {_rows(x) for x, s in zip(tree_leaves(tree), split) if s}
    shards = []
    for i, dev in enumerate(mesh.devices.flat):
        def put(x, i=i, dev=dev):
            if splits(x):
                b = _rows(x) // k
                if isinstance(x, torch.nn.Module):
                    return x.select(slice(i * b, (i + 1) * b)).to(dev)
                return x[i * b:(i + 1) * b].to(dev, copy=True)
            return place(x, dev)

        shards.append(tree_map(put, tree))
    return Sharded(shards, mesh, batch_size if batch_size is not None
                   else (sizes.pop() if len(sizes) == 1 else None), split)


def replicate(tree, mesh: Mesh) -> Sharded:
    """``tree`` on every device of the mesh. Tensors are values and are
    shared where they already lie on a shard's device; a module is state
    that an update changes in place, so every shard but the first gets a
    copy of its own."""
    shards = []
    for i, dev in enumerate(mesh.devices.flat):
        def put(x, i=i, dev=dev):
            if isinstance(x, torch.nn.Module) and i > 0:
                return copy.deepcopy(x).to(dev)
            return place(x, dev)

        shards.append(tree_map(put, tree))
    return Sharded(shards, mesh)


def gather(sharded: Sharded, batch_size: Optional[int] = None):
    """The sharded batch as one tree on ``mesh.devices.flat[0]``: tensor
    leaves of the batch (and per-scenario modules, ``cat``) concatenated
    in shard order, every other leaf
    shard 0's. The batch leaves are those ``shard_batch`` split; given
    ``batch_size`` (or, for the shards of a computation, the one
    ``sharded`` records), those whose leading dim is it over the mesh
    size."""
    mesh = sharded.mesh
    dev0 = mesh.devices.flat[0]
    leaves = [tree_leaves(s) for s in sharded]
    batch = sharded.split if batch_size is None else None
    if batch is None:
        B = batch_size if batch_size is not None else sharded.batch_size
        if B is None:
            raise ValueError("gather needs the batch size of a Sharded "
                             "that shard_batch did not make")
        per = B // mesh.size
        batch = [_rows(x) == per for x in leaves[0]]
    it = iter(range(len(leaves[0])))

    def cat(x):
        j = next(it)
        if batch[j]:
            parts = [leaves[i][j] for i in range(len(leaves))]
            if isinstance(x, torch.nn.Module):
                return type(x).cat(parts, device=dev0)
            return torch.cat([t.to(dev0) for t in parts])
        return place(x, dev0)

    return tree_map(cat, sharded[0])


@contextlib.contextmanager
def _on_device(device):
    """Makes ``device`` the current CUDA device inside the block (a
    no-op for the CPU), so that an entry point called with ``device=None``
    runs on that shard's card."""
    device = torch.device(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


def map_shards(fn: Callable, *args, **kwargs) -> Sharded:
    """``fn`` on each shard: ``Sharded`` arguments give shard i's tree,
    the others pass as they are; shard i runs with its device current
    (``_on_device``). All ``Sharded`` arguments share one mesh."""
    sh = [a for a in list(args) + list(kwargs.values())
          if isinstance(a, Sharded)]
    if not sh:
        raise ValueError("map_shards needs a Sharded argument")
    mesh = sh[0].mesh
    if any(s.mesh is not mesh for s in sh):
        raise ValueError("Sharded arguments of different meshes")
    out = []
    for i, dev in enumerate(mesh.devices.flat):
        a = [x[i] if isinstance(x, Sharded) else x for x in args]
        kw = {k: v[i] if isinstance(v, Sharded) else v
              for k, v in kwargs.items()}
        with _on_device(dev):
            out.append(fn(*a, **kw))
    return Sharded(out, mesh, sh[0].batch_size)


def shard_generators(mesh: Mesh, seed: int) -> List[torch.Generator]:
    """One ``torch.Generator`` per shard on its device. Shard 0 is seeded
    with ``seed`` itself, as an unsharded run's generator, so a 1-device
    mesh reproduces the unsharded run; shard i > 0 from (seed, i)."""
    gens = []
    for i, dev in enumerate(mesh.devices.flat):
        g = torch.Generator(device=dev)
        g.manual_seed(seed if i == 0 else int(
            np.random.SeedSequence([seed, i]).generate_state(
                1, np.uint64)[0] >> np.uint64(1)))
        gens.append(g)
    return gens


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors (a module counts its parameters and
    buffers): the gradient traffic an all-reduce of it would move."""
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            total += sum(t.numel() * t.element_size()
                         for t in list(x.parameters()) + list(x.buffers()))
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return int(total)
