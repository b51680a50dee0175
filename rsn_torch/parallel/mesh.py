"""The port's data-parallel mesh (port of rsn.parallel.mesh).

rsn runs one controller over a `data` mesh: shard_map over the train
step, params replicated, each device's own ray batch, gradients pmean-ed
over the axis (DDP's average, reflect_sampling_nerf_pipeline.py:73-77).
The port takes PyTorch's idiom: one rank per device.  Each rank is a
process that owns one device (cuda:<local rank> on a card, the CPU when
the caller asks for it), holds a full replica, draws its own batch and
averages with the others through one all-reduce: NCCL on a card, gloo on
the CPU.

    world = num_processes * local_ranks
    rank  = process_id * local_ranks + local_rank

A group starts in one of three ways, each ending in init_mesh:
  - launch(fn, local_ranks, ...): one spawned process per local rank, its
    rendezvous at coordinator_address (127.0.0.1 and a free port by
    default); fn(mesh, *args) runs in each, and launch returns each local
    rank's result.
  - init_mesh(coordinator_address=, num_processes=, process_id=): one rank
    per process, as rsn's jax.distributed.initialize with its three flags
    (the train CLI's --multihost).
  - init_mesh() in a process that torchrun started: its environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK), the
    counterpart of jax.distributed.initialize()'s autodetection.

Nothing shares a card or drops to one device quietly: more ranks than
visible cards raise, NCCL asked for where torch has none raises, and
ranks share a card only where the caller names it (device="cuda:0") with
backend="gloo" (NCCL refuses two ranks on one device).  gloo's collectives
take CPU tensors here: a rank on a card hands them CPU copies.

Nothing here touches torch.distributed at import.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from rsn_torch.utils import env as env_lib

# a rank that waits this long in a collective raises (a rank that died
# leaves the others waiting)
TIMEOUT_S = 1800
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclasses.dataclass
class Mesh:
    """One rank of a process group: its global rank and the world's size,
    its index among its process's ranks, its device, the backend and the
    group (torch.distributed's default group).  reached: the patterns of
    reached parameters that average_gradients has checked."""
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str
    group: Any = None
    reached: set = dataclasses.field(default_factory=set)

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def local_ranks_for(num_devices: int, num_processes: int = 1,
                    device="cuda") -> int:
    """rsn's num_devices (the global mesh size; 0: every device) -> the
    ranks one of num_processes processes owns: every visible card on a
    card, one rank on the CPU, for 0; else num_devices / num_processes,
    which must divide."""
    if num_devices <= 0:
        if torch.device(device).type == "cuda":
            return torch.cuda.device_count()
        return 1
    if num_devices % num_processes:
        raise ValueError(f"num_devices={num_devices} does not split into "
                         f"{num_processes} processes")
    return num_devices // num_processes


def _rank_device(device, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:  # the caller's card, shared by its ranks
        return dev
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(
            f"local rank {local_rank} has no card: torch sees {count}, "
            "and the mesh runs one rank per card")
    return torch.device("cuda", local_rank)


def _check_backend(dev: torch.device, backend: Optional[str]) -> str:
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL runs between cards: CPU ranks use gloo")
        if not dist.is_nccl_available():
            raise RuntimeError(
                "NCCL is not available in this torch build, and the "
                "mesh does not fall back to gloo on the card by itself "
                "(pass backend='gloo' to ask for it)")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    return backend


def init_mesh(device="cuda", *, coordinator_address: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None,
              backend: Optional[str] = None) -> Mesh:
    """Join this rank's process group -> its Mesh.  With
    coordinator_address ("host:port" of process 0), num_processes and
    process_id: rank process_id of num_processes, one rank per process;
    without them, torchrun's environment (which launch sets for each of
    its ranks).  device: "cuda" (the card of the local rank), "cuda:i"
    (that card, for ranks that share it over gloo) or "cpu"."""
    if dist.is_initialized():
        raise RuntimeError("this process is already a rank of a group")
    local_rank = 0
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        rank, world = process_id, num_processes
        init_method = f"tcp://{coordinator_address}"
    else:
        missing = [k for k in TORCHRUN_VARS if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no group to join: {', '.join(missing)} unset.  Pass "
                "coordinator_address, num_processes and process_id (the "
                "train CLI's --multihost and its three flags), or start "
                "the ranks with torchrun or mesh.launch")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        init_method = "env://"
    dev = _rank_device(device, local_rank)
    backend = _check_backend(dev, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Mesh(rank=rank, world=world, local_rank=local_rank, device=dev,
                backend=backend, group=dist.group.WORLD)


def close(mesh: Optional[Mesh]) -> None:
    """Leave the group (after a barrier of every rank)."""
    if mesh is not None and dist.is_initialized():
        barrier(mesh)
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(local_rank: int, fn: Callable, args: tuple, spec: dict,
              out_dir: str) -> None:
    """A spawned rank: its environment, its group, fn(mesh, *args), its
    result saved for launch."""
    host, port = spec["coordinator_address"].rsplit(":", 1)
    k = spec["local_ranks"]
    env_lib.apply_rank_env(env_lib.rank_env(
        rank=spec["process_id"] * k + local_rank,
        world=spec["num_processes"] * k, local_rank=local_rank,
        local_world=k, master_addr=host, master_port=int(port),
        cpu=torch.device(spec["device"]).type == "cpu"))
    mesh = init_mesh(spec["device"], backend=spec["backend"])
    result = fn(mesh, *args)
    torch.save(result, os.path.join(out_dir, f"{local_rank}.pt"))
    close(mesh)


def launch(fn: Callable, local_ranks: int, args: tuple = (), *,
           device="cuda", backend: Optional[str] = None,
           coordinator_address: Optional[str] = None, num_processes: int = 1,
           process_id: int = 0) -> List[Any]:
    """Spawn one process per local rank (torch.multiprocessing, spawn),
    each running fn(mesh, *args) in the group, and wait for them all ->
    [each local rank's result].  fn must be importable by name (a
    module's top-level function); a rank that raises ends the others and
    raises here with its traceback.  Without coordinator_address the group
    is this process's ranks alone, its rendezvous on 127.0.0.1."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            count = torch.cuda.device_count()
            if local_ranks > count:
                raise RuntimeError(
                    f"{local_ranks} ranks and {count} visible card(s): the "
                    "mesh runs one rank per card")
        elif local_ranks > 1 and (backend or "nccl") == "nccl":
            raise ValueError(
                f"{local_ranks} ranks on {dev}: NCCL takes one rank per "
                "card; ranks that share a card need backend='gloo'")
    _check_backend(dev, backend)
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError("a group of several processes needs their "
                             "coordinator_address")
        coordinator_address = f"127.0.0.1:{free_port()}"
    spec = dict(coordinator_address=coordinator_address,
                local_ranks=local_ranks, num_processes=num_processes,
                process_id=process_id, device=str(dev), backend=backend)
    with tempfile.TemporaryDirectory(prefix="rsn_ranks_") as out:
        torch.multiprocessing.start_processes(
            _run_rank, args=(fn, args, spec, out), nprocs=local_ranks,
            start_method="spawn", join=True)
        return [torch.load(os.path.join(out, f"{i}.pt"), weights_only=False)
                for i in range(local_ranks)]


# ---- collectives ---------------------------------------------------------

def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor the backend takes: a CPU copy for gloo."""
    return t.cpu() if mesh.backend == "gloo" else t


def barrier(mesh: Mesh) -> None:
    """Block until every rank reaches this point."""
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def all_reduce_mean(mesh: Mesh, tensors: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """rsn's pmean: each tensor's mean over the ranks, through one flat
    fp32 buffer (SUM, then / world: gloo has no AVG) -> new tensors in
    each input's dtype and on its device.  Every rank gets the same
    bits."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    buf = _staged(mesh, flat)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    buf = buf.to(flat.device) / mesh.world
    return [part.view(t.shape).to(t.dtype) for part, t in zip(
        torch.split(buf, [t.numel() for t in tensors]), tensors)]


def average_gradients(mesh: Mesh, params: Sequence[torch.Tensor]) -> None:
    """Replace each param's .grad by its mean over the ranks, in one
    all_reduce_mean, with no host sync.  A .grad that is None (a param
    this rank's graph did not reach, such as a head no loss reads) stays
    None, as a single device leaves it, and adds zeros to the sum.  The
    model's graph has no data-dependent branch, so every rank reaches the
    same params; the first call with a new pattern of reached params
    checks that on every rank (one more all-reduce, and a sync) and
    raises where they differ."""
    params = list(params)
    present = tuple(p.grad is not None for p in params)
    if present not in mesh.reached:
        flags = torch.tensor(present, dtype=torch.float32,
                             device=params[0].device)
        (mean,) = all_reduce_mean(mesh, [flags])
        if not torch.equal(mean, flags):
            raise RuntimeError("the ranks' graphs reached different "
                               "parameters")
        mesh.reached.add(present)
    means = all_reduce_mean(mesh, [
        p.grad if here else torch.zeros_like(p)
        for p, here in zip(params, present)])
    for p, g, here in zip(params, means, present):
        p.grad = g if here else None


def all_reduce_max(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the ranks -> a new tensor on x's
    device."""
    buf = _staged(mesh, x.detach().clone())
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.group)
    return buf.to(x.device)


def broadcast_(mesh: Mesh, tensors: Sequence[torch.Tensor],
               src: int = 0) -> None:
    """Overwrite each tensor, in place, with rank src's."""
    with torch.no_grad():
        for t in tensors:
            buf = _staged(mesh, t.detach()).contiguous()
            dist.broadcast(buf, src=src, group=mesh.group)
            t.copy_(buf)


def broadcast_module(mesh: Mesh, module: torch.nn.Module,
                     src: int = 0) -> None:
    """Rank src's parameters and buffers into every rank's module."""
    broadcast_(mesh, list(module.state_dict().values()), src)


def broadcast_object(mesh: Mesh, obj: Any = None, src: int = 0) -> Any:
    """Rank src's picklable object -> on every rank (rsn's
    multihost_utils.broadcast_one_to_all)."""
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(box, src=src, group=mesh.group,
                               device=_object_device(mesh))
    return box[0]


def all_gather_object(mesh: Mesh, obj: Any) -> List[Any]:
    """Every rank's picklable object, in rank order, on every rank."""
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _object_device(mesh: Mesh) -> Optional[torch.device]:
    return mesh.device if mesh.backend == "nccl" else None


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's (n_r, ...) tensor, the row counts free to differ ->
    [rank 0's, rank 1's, ...] on t's device (rsn's process_allgather).
    gloo gathers CPU tensors, so a gloo rank on a card gathers CPU copies;
    NCCL gathers on the card."""
    stage = torch.device("cpu") if mesh.backend == "gloo" else t.device
    rows = torch.tensor([t.shape[0]], dtype=torch.int64, device=stage)
    counts = [torch.empty_like(rows) for _ in range(mesh.world)]
    dist.all_gather(counts, rows, group=mesh.group)
    counts = [int(c) for c in counts]
    top = max(counts)
    pad = torch.zeros((top,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=stage)
    pad[:t.shape[0]] = t
    outs = [torch.empty_like(pad) for _ in range(mesh.world)]
    dist.all_gather(outs, pad, group=mesh.group)
    return [o[:c].to(t.device) for o, c in zip(outs, counts)]
