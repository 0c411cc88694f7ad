"""Data parallelism over ``torch.distributed``; counterpart of
``image_segmentation_tpu/parallel/mesh.py`` (distributed_init :31, the
``data`` axis of make_mesh :68).

In JAX the batch is sharded over the mesh's ``data`` axis and XLA inserts
every collective itself: the gradient all-reduce, and the sums behind the
BatchNorm statistics and the losses, which JAX takes over the GLOBAL batch
(its Trainer, engine/train.py:18-21).  Here each rank is one process with
its rows of every global batch, and the collectives are explicit.  This
module and ``parallel/tensor.py`` (the model axis) are the only places
that call ``torch.distributed``:

- :func:`distributed_init` joins the process group (torchrun's environment
  or explicit arguments; ``nccl`` for a card, ``gloo`` for the CPU);
- :func:`rank`, :func:`world_size`, :func:`is_main`; :func:`make_grid` and
  its :func:`data_size`, :func:`data_rank`, :func:`model_size`,
  :func:`model_rank`, :func:`model_group` (below);
- :func:`all_reduce_sum`, differentiable (its backward is the sum
  all-reduce of the cotangents, which is the VJP of a sum over ranks), and
  :func:`global_sum` / :func:`global_mean` on it: the batch-wide sums of
  the BatchNorm statistics, the losses and the metrics;
- :func:`reduce_sum_` (in place, no autograd) for the kernel blocks' own
  backward, :func:`average_gradients`, :func:`broadcast_`,
  :func:`broadcast_object`, :func:`all_gather_floats` and :func:`barrier`;
- :func:`local`: a context in which every helper acts as at world size 1,
  for work that each rank does on the whole batch (the replicated
  remainder batch, a reference step on one rank).

At world size 1, and inside :func:`local`, every helper is the identity
(``global_sum``/``global_mean`` the plain ``sum``/``mean``) and launches no
collective, so a one-process run is the one-device path bit for bit.

The tensor-parallel ``model`` axis (``make_mesh`` :68 with ``n_model``,
``shard_params_tp`` :105): :func:`make_grid` lays the R ranks out as JAX's
row-major mesh, rank r at ``(data r // M, model r % M)``, and makes the
process groups of both axes.  The helpers above take a ``group``, by
default the DATA group (the ranks of one model index across the D data
rows): the statistics, the losses, the gradient average and :func:`rows`
are over the data axis, so the M ranks of a data row hold the same rows.
At M = 1 the data group is the world group and every call is the one
without a grid.  The model group's own collectives, and the sharded
parameters, are ``parallel/tensor.py``'s; :func:`local` leaves them on
(a sharded model cannot run without them).
"""

from __future__ import annotations

import contextlib
import os
import socket
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch

_local_depth = 0


@dataclass(frozen=True)
class Grid:
    """The (data, model) layout of the ranks (:func:`make_grid`).  A group
    of None is the world group; ``model_group`` is None at M = 1."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: Any = None
    model_group: Any = None


_grid: Optional[Grid] = None
# process groups by M: ``new_group`` is collective, so each layout's groups
# are made once, in the same order on every rank
_groups: Dict[int, tuple] = {}


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return _dist().get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return _dist().get_rank() if is_initialized() else 0


def is_main() -> bool:
    """Rank 0: the one that writes artifacts (JAX engine/train.py:228)."""
    return rank() == 0


def make_grid(n_model: int = 1) -> Grid:
    """The R ranks as a ``(data=R/M, model=M)`` grid, rank r at ``(data
    r // M, model r % M)``: JAX's row-major ``make_mesh`` (:68-82), whose
    device d sits on data row ``d // n_model``.  Every rank makes every
    data group and every model group (``torch.distributed.new_group``, in
    the same order), once per M.  Unlike JAX, which leaves the devices
    past ``(R // M) * M`` out of its mesh, an R that M does not divide
    raises ``ValueError``: a rank has no idle place to go.  The grid is
    this process's until the next call (or :func:`shutdown`)."""
    global _grid
    size, r = world_size(), rank()
    if n_model < 1 or size % n_model:
        raise ValueError(f"{size} ranks do not divide into model groups of {n_model}")
    n_data = size // n_model
    if n_model == 1:
        _grid = Grid(n_data, 1, r, 0)
        return _grid
    if n_model not in _groups:
        dist = _dist()
        data = [dist.new_group([d * n_model + m for d in range(n_data)]) for m in range(n_model)]
        model = [dist.new_group([d * n_model + m for m in range(n_model)]) for d in range(n_data)]
        _groups[n_model] = (data, model)
    data, model = _groups[n_model]
    _grid = Grid(n_data, n_model, r // n_model, r % n_model, data[r % n_model],
                 model[r // n_model])
    return _grid


def grid() -> Grid:
    """The grid of the last :func:`make_grid`, else every rank a data row."""
    return _grid if _grid is not None else Grid(world_size(), 1, rank(), 0)


def data_size() -> int:
    """D: the data rows (the world size at M = 1)."""
    return grid().n_data


def data_rank() -> int:
    """This rank's data row."""
    return grid().data_rank


def model_size() -> int:
    """M: the ranks that share one data row's rows."""
    return grid().n_model


def model_rank() -> int:
    """This rank's place in its model group."""
    return grid().model_rank


def model_group():
    """This rank's model group (None at M = 1)."""
    return grid().model_group


def _group_size(group) -> int:
    return data_size() if group is None else _dist().get_world_size(group)


def _data(group):
    """``group``, or the data group for None."""
    return grid().data_group if group is None else group


def active() -> bool:
    """Whether the helpers reduce across the data axis: more than one data
    row and not inside :func:`local`."""
    return _local_depth == 0 and data_size() > 1


def _world_active() -> bool:
    """Whether the world-wide helpers (broadcasts, gathers, the barrier)
    reach the other ranks: world size above 1 and not inside :func:`local`."""
    return _local_depth == 0 and world_size() > 1


@contextlib.contextmanager
def local():
    """Every helper acts as at world size 1 inside this context."""
    global _local_depth
    _local_depth += 1
    try:
        yield
    finally:
        _local_depth -= 1


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distributed_init(
    force: bool = False,
    *,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group, as ``jax.distributed.initialize`` does in the
    JAX package (:31-65).

    Explicit ``coordinator_address`` ("HOST:PORT"), ``num_processes`` and
    ``process_id`` join directly.  Otherwise torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) is read;
    without it, or with ``WORLD_SIZE=1``, one process is a no-op unless
    ``force`` starts a group of one on a free localhost port.  ``backend``:
    ``nccl`` when a card is present, else ``gloo``; with ``nccl`` each
    process takes the card ``LOCAL_RANK`` (or its rank) modulo the cards.
    A second call is tolerated, as JAX's is."""
    if is_initialized():
        return
    global _grid
    _grid = None
    dist = _dist()
    env = os.environ
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        init, size, rk = f"tcp://{coordinator_address}", num_processes, process_id
    elif "WORLD_SIZE" in env and "MASTER_ADDR" in env and (int(env["WORLD_SIZE"]) > 1 or force):
        init, size, rk = "env://", int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
    elif force:
        init, size, rk = f"tcp://localhost:{free_port()}", 1, 0
    else:
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        local_rank = int(env.get("LOCAL_RANK", rk))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=size, rank=rk)


def shutdown() -> None:
    """Leave the process group, if there is one, and forget the grid."""
    global _grid
    _grid = None
    _groups.clear()
    if is_initialized():
        _dist().destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; the backward sums the cotangents
    over them, the VJP of a sum whose every rank's result is used."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.detach().clone()
        _dist().all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone()
        _dist().all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (the data group),
    differentiable; ``t`` itself when not :func:`active`."""
    return _AllReduceSum.apply(t, _data(group)) if active() else t


def global_sum(t: torch.Tensor, dims=None, group=None) -> torch.Tensor:
    """``t.sum(dims)`` over the global batch: the local sum, summed over
    the data group."""
    s = t.sum() if dims is None else t.sum(dims)
    return all_reduce_sum(s, group)


def global_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``t``'s elements over every data row's ``t`` (any
    number of elements a rank); ``t.mean()`` when not :func:`active`."""
    if not active():
        return t.mean()
    s = all_reduce_sum(torch.stack([t.sum(), t.new_tensor(float(t.numel()))]), group)
    return s[0] / s[1]


def reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the data group in place (no autograd) and returned."""
    if active():
        _dist().all_reduce(t, group=_data(group))
    return t


def average_gradients(params: Sequence[torch.Tensor], group=None) -> None:
    """Every ``p.grad`` replaced by its mean over the data group, in one
    all-reduce of one flat buffer.  A sharded parameter's gradient is its
    slice's, the same slice on every rank of the group."""
    if not active():
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    _dist().all_reduce(flat, group=_data(group))
    flat /= _group_size(group)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Rank ``src``'s values copied into every rank's ``tensors``, in one
    broadcast of one flat buffer per dtype."""
    if not _world_active():
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        _dist().broadcast(flat, src)
        i = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[i:i + t.numel()].view_as(t))
                i += t.numel()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank; ``obj`` itself
    when not :func:`active`."""
    if not _world_active():
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src)
    return box[0]


def all_gather_floats(values: Sequence[float]) -> List[List[float]]:
    """Every rank's ``values`` (the same count on each), by rank."""
    if not _world_active():
        return [[float(v) for v in values]]
    device = "cuda" if _dist().get_backend() == "nccl" else "cpu"  # gloo gathers on the host
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    out = [torch.empty_like(t) for _ in range(world_size())]
    _dist().all_gather(out, t)
    return [o.tolist() for o in out]


def barrier() -> None:
    if _world_active():
        _dist().barrier()


def rows(n: int, rank_: Optional[int] = None, size: Optional[int] = None) -> slice:
    """The rows ``[r*n/D, (r+1)*n/D)`` of an n-row global batch that data
    row r holds (by default this rank's, of the D data rows): those JAX's
    batch-sharded array places on data row r (data/pipeline.py:137-161),
    the same for the M ranks of the row.  ``n`` must divide by D."""
    r = data_rank() if rank_ is None else rank_
    size = data_size() if size is None else size
    if n % size:
        raise ValueError(f"a batch of {n} rows does not divide over {size} ranks")
    per = n // size
    return slice(r * per, (r + 1) * per)


def launch(target: str, world: int, args: Sequence = (), *, backend: str = "gloo",
           timeout: float = 600.0) -> List:
    """Run ``target`` ("package.module:function") in ``world`` new
    processes, rank r of a process group at a free localhost port, as
    torchrun would start them; returns each rank's JSON-able result, by
    rank.  ``args`` (JSON-able) go to every rank's call.  A rank that fails
    raises here with its error output."""
    import json
    import subprocess
    import sys
    import tempfile
    import time

    port = free_port()
    code = ("import sys\nfrom image_segmentation_tpu_torch.parallel.mesh import _launched\n"
            "_launched(*sys.argv[1:])\n")
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, target, json.dumps(list(args)), backend,
                 os.path.join(tmp, f"rank{r}.json")],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        try:
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                # one rank's failure leaves the others waiting in a collective
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {target} exited {p.returncode}:\n{text[-4000:]}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return results


def _launched(target: str, args: str, backend: str, out: str) -> None:
    """One rank of :func:`launch`: join the group, call, write the result."""
    import importlib
    import json

    distributed_init(backend=backend)
    module, fn = target.split(":")
    result = getattr(importlib.import_module(module), fn)(*json.loads(args))
    barrier()
    with open(out, "w") as f:
        json.dump(result, f)
    shutdown()
