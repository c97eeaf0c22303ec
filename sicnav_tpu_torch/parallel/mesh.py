"""Data-parallel mesh over processes (twin of ``sicnav_tpu/parallel/mesh.py``).

The reference shards one process's arrays over a 1-D ``jax.sharding.Mesh``
and XLA inserts the collectives. In torch the same takes N processes
(ranks) on ``torch.distributed``: each rank holds its contiguous rows of
the leading batch axis (``shard_batch``), parameters are broadcast from
rank 0 (``replicate``), and the ranks exchange rows (``gather_batch``) or
average (``all_mean``) where the reference's XLA program would.

The backend follows one rule (``plan``): NCCL when each rank has a card of
its own (rank r on ``cuda:r``), gloo when ranks share a card or run on the
CPU. NCCL refuses two ranks on one device, so on a one-card machine the
ranks share it over gloo. gloo runs broadcast and all_reduce on CUDA
tensors; ``gather_batch`` copies a CUDA tensor through the host for gloo's
all_gather and back (staging: the ranks' compute stays on the card).

``launch(fn, n, *args)`` runs ``fn(mesh, *args)`` in n spawned ranks that
meet through a ``FileStore`` in a temporary directory (several launches
may run at once on one host without sharing a port), and joins them with
a deadline. ``fn`` must be a top-level function of a module the ranks can
import without JAX, since a spawned rank imports its function's module.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from sicnav_tpu_torch.device import resolve_device

# the process group's timeout: a collective that waits longer raises
GROUP_TIMEOUT_S = 60
# launch's default deadline for every rank to report
LAUNCH_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a 1-D data-parallel mesh: its rank, the mesh's
    size, the process group (None for a one-rank mesh outside
    ``torch.distributed``), the rank's device and the group's backend."""
    rank: int
    size: int
    group: object
    device: torch.device
    backend: str
    axis: str = "data"

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a leading axis of n."""
        if n % self.size:
            raise ValueError(f"a leading axis of {n} does not divide over a "
                             f"mesh of {self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def plan(n: int, device=None):
    """(backend, each rank's device) for n ranks on ``device`` (CUDA unless
    named): NCCL with rank r on ``cuda:r`` when there are n cards, else
    gloo with every rank on ``device``."""
    device = resolve_device(device)
    if device.type == "cuda":
        if torch.cuda.device_count() >= n:
            return "nccl", [torch.device("cuda", r) for r in range(n)]
        device = torch.device("cuda", device.index or 0)
    return "gloo", [device] * n


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device=None) -> Mesh:
    """The mesh over the running ``torch.distributed`` world, or a one-rank
    mesh on ``device`` (CUDA unless named) outside one. ``n_devices``, if
    given, must be the world's size: a mesh is every rank."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}) outside a "
                             "torch.distributed world; run the ranks with "
                             "parallel.mesh.launch")
        return Mesh(0, 1, None, resolve_device(device), "none", axis)
    size = dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(f"make_mesh({n_devices}) in a world of {size} ranks")
    return Mesh(dist.get_rank(), size, dist.group.WORLD,
                resolve_device(device), dist.get_backend(), axis)


def _tree_map(fn, tree):
    if isinstance(tree, tuple):
        out = [_tree_map(fn, x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _batched(x):
    return torch.is_tensor(x) and x.dim() > 0


def shard_batch(tree, mesh: Optional[Mesh]):
    """This rank's contiguous rows of every tensor leaf with a leading axis
    (tuples, NamedTuples and dicts are nodes); other leaves are kept.
    Without a mesh, or on one rank, the tree itself."""
    if mesh is None or mesh.size == 1:
        return tree
    return _tree_map(lambda x: x[mesh.rows(x.shape[0])] if _batched(x)
                     else x, tree)


def gather_batch(tree, mesh: Optional[Mesh]):
    """Undo ``shard_batch``: every rank gets every tensor leaf's full
    leading axis, the ranks' rows in rank order."""
    if mesh is None or mesh.size == 1:
        return tree

    def gather(x):
        if not _batched(x):
            return x
        # gloo exchanges no bool; its all_gather is staged through the host
        y = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
        if mesh.backend == "gloo" and y.device.type == "cuda":
            y = y.cpu()
        parts = [torch.empty_like(y) for _ in range(mesh.size)]
        dist.all_gather(parts, y, group=mesh.group)
        return torch.cat(parts).to(x.device, x.dtype)

    return _tree_map(gather, tree)


def replicate(tree, mesh: Mesh):
    """Every tensor leaf broadcast in place from rank 0 (a ``state_dict``'s
    tensors share the parameters' storage, so replicating one replicates
    the module). Returns the tree."""
    if mesh.size == 1:
        return tree

    def bcast(x):
        if not torch.is_tensor(x):
            return x
        if x.dtype == torch.bool:
            y = x.to(torch.uint8)
            dist.broadcast(y, 0, group=mesh.group)
            x.copy_(y.bool())
        else:
            dist.broadcast(x, 0, group=mesh.group)
        return x

    with torch.no_grad():
        return _tree_map(bcast, tree)


def all_mean(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the ranks of ``tensor`` (a new tensor, the same bits
    on every rank)."""
    if mesh.size == 1:
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out / mesh.size


def all_mean_grads(params, mesh: Mesh) -> None:
    """Every gradient of ``params`` replaced in place by its mean over the
    ranks, all of them in one all_reduce."""
    if mesh.size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_mean(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _to_host(tree):
    """``tree`` pickled to bytes, its tensors on the CPU: a queue would pass
    a tensor as a handle to the rank's memory, gone once the rank ends."""
    return pickle.dumps(_tree_map(
        lambda x: x.detach().cpu() if torch.is_tensor(x) else x, tree))


def _rank_main(fn, rank, n, store_path, backend, device, args, results):
    """One rank: join the group, run fn(mesh, *args), report (rank, ok,
    value or traceback); tensors in the value come back on the CPU."""
    try:
        device = torch.device(device)
        # the ranks of a launch share one host: gloo meets over loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if device.type == "cpu":
            # the CPU's batched LU hangs with more than one intra-op
            # thread on matrices over ~128 rows
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            value = _to_host(fn(make_mesh(n, device=device), *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def launch(fn, n: int, *args, device=None,
           timeout: float = LAUNCH_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` in n spawned ranks on ``device`` (CUDA
    unless named; ``plan`` picks the backend and each rank's device) and
    return rank 0's value. Raises with the rank's traceback if a rank
    fails or dies, and when ``timeout`` seconds pass before every rank has
    reported; every rank is ended before it returns or raises."""
    import multiprocessing

    backend, devices = plan(n, device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    done = {}
    with tempfile.TemporaryDirectory(prefix="sicnav_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, store, backend, str(devices[r]),
                                   args, results), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"launch: ranks {sorted(set(range(n)) - set(done))} "
                        f"did not report within {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in done and p.exitcode is not None:
                            raise RuntimeError(
                                f"launch: rank {r} exited with code "
                                f"{p.exitcode} before reporting")
                    continue
                if not ok:
                    raise RuntimeError(f"launch: rank {rank} of {n} failed:"
                                       f"\n{value}")
                # bytes written by _rank_main in this launch's ranks
                done[rank] = pickle.loads(value)
        finally:
            # a rank left waiting in a collective would wait out the
            # group's timeout: end it now
            for p in procs:
                if len(done) < n and p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return done[0]
