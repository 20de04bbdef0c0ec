"""The ('data', 'model') mesh over `torch.distributed`.

Counterpart of `gsavatar/parallel/mesh.py` (`initialize_distributed` :31,
`factorize` :60, `make_mesh` :71). The ranks are processes in PyTorch's
usual layout: one process per GPU, a `torch.distributed` process group
and `torchrun`'s environment variables (`MASTER_ADDR`, `MASTER_PORT`,
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`). Rank r of a
D x M mesh sits at (data, model) = (r // M, r % M), data-major as JAX's
`reshape(data, model)` (:78) lays out its devices. The axes:

  * `data`: independent frames (and subjects); the ranks of one `model`
    column sum their gradients over their `data` group;
  * `model`: within one frame, the tile grid of the compositor
    (`ops/rasterizer/composite.py:make_composite_pairs_sharded`); the
    ranks of one `data` row render the same frames and put their tile
    ranges together over their `model` group.

Every collective is an `all_reduce` (SUM) or a `broadcast`: gloo runs both
on CUDA tensors, which lets two ranks share one card over gloo. A 1 x 1
mesh needs no process group, and its collectives are identities."""
from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

_ENV = ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE')


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join this process's process group; returns whether one is up.

    The arguments default to `torchrun`'s environment (`init_method`
    'env://', `WORLD_SIZE`, `RANK`). With neither arguments nor those
    variables it returns False: a single process, as the JAX function
    returns at `mesh.py:47-51`. Idempotent. The backend is NCCL when CUDA
    is available, each rank on its own GPU, `cuda:LOCAL_RANK` (made the
    current device), and gloo without CUDA; ranks that share a card name
    'gloo' themselves. More ranks on this host than GPUs raise."""
    if dist.is_initialized():
        return True
    if init_method is None and world_size is None \
            and not any(k in os.environ for k in _ENV):
        return False
    world_size = int(os.environ['WORLD_SIZE'] if world_size is None
                     else world_size)
    rank = int(os.environ['RANK'] if rank is None else rank)
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
        local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world_size))
        if backend == 'nccl' and local_world > torch.cuda.device_count():
            raise ValueError(
                f"{local_world} ranks on this host but "
                f"{torch.cuda.device_count()} GPUs: NCCL needs a GPU per "
                f"rank; pass backend='gloo' for ranks that share a card")
    if backend == 'nccl':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', rank)))
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            world_size=world_size, rank=rank)
    return True


def world_size() -> int:
    """The ranks of this process's group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device() -> Optional[torch.device]:
    """This rank's GPU under NCCL (`cuda:LOCAL_RANK`), else None: the
    caller names the device."""
    if dist.is_initialized() and dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return None


def require_world(n: int, what: str) -> None:
    """Raise JAX's ValueError (`gsavatar/train.py:509-513`) unless the n
    ranks that `what` asks for are this world's ranks."""
    world = world_size()
    if n > world:
        raise ValueError(
            f"{what} = {n} exceeds the {world} visible devices: start {n} "
            f"ranks, with `torchrun --nproc_per_node={n} -m "
            f"gsavatar_torch.train ...` or with `python -m "
            f"gsavatar_torch.train ...`, which starts one rank per GPU")
    if n < world:
        raise ValueError(f"{what} = {n} does not match the {world} ranks "
                         f"of the process group")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now, for a new
    process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def factorize(n: int) -> tuple:
    """Split n devices into (data, model) as square as possible,
    data-major."""
    best = (n, 1)
    for d in range(1, n + 1):
        if n % d == 0:
            m = n // d
            if abs(math.log(d / m)) < abs(math.log(best[0] / best[1])):
                best = (d, m)
    return best


def mesh_coords(rank: int, data: int, model: int) -> Dict[str, int]:
    """Rank `rank`'s (data, model) coordinates in a data x model mesh."""
    if not 0 <= rank < data * model:
        raise ValueError(f"rank {rank} outside a {data} x {model} mesh")
    return {'data': rank // model, 'model': rank % model}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: its `shape` ({'data': D, 'model': M}),
    its global `rank` and `coords`, and per axis the process group of the
    ranks that differ from it only along that axis (None where the axis
    has one rank). `host` is the device that carries host data in a
    collective (the rank's GPU under NCCL, else the CPU)."""
    shape: Dict[str, int]
    rank: int
    groups: Dict[str, Optional[object]]
    host: torch.device

    @property
    def coords(self) -> Dict[str, int]:
        return mesh_coords(self.rank, self.shape['data'], self.shape['model'])

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum `x` in place over this rank's `axis` group; returns x."""
        if self.shape[axis] > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.groups[axis])
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Global rank `src`'s `x` into `x` on every rank, in place; bool
        tensors travel as bytes, and CPU tensors through `host`."""
        if self.shape['data'] * self.shape['model'] == 1:
            return x
        y = x.view(torch.uint8) if x.dtype == torch.bool else x
        if y.device != self.host and self.host.type == 'cuda':
            z = y.to(self.host)
            dist.broadcast(z, src)
            y.copy_(z)
        else:
            dist.broadcast(y, src)
        return x

    def broadcast_bytes(self, payload: Optional[bytes], src: int) -> bytes:
        """Global rank `src`'s `payload` on every rank."""
        n = torch.tensor([len(payload) if self.rank == src else 0],
                         dtype=torch.int64, device=self.host)
        self.broadcast(n, src)
        buf = torch.empty(int(n), dtype=torch.uint8, device=self.host)
        if self.rank == src:
            buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
        self.broadcast(buf, src)
        return payload if self.rank == src else buf.cpu().numpy().tobytes()

    def gather_rows(self, rows: Dict[int, dict], n: int) -> List[dict]:
        """The n rows of a table whose rows this rank's `data` group holds
        one owner each: `rows` maps the indices this rank owns to dicts of
        floats, ints and lists of them (the same keys and lengths in every
        row). Returns all n rows, in float64 on the way, on every rank."""
        mine = next(iter(rows.values()))
        # (key, the type of its values, its list length or 0 for a scalar)
        layout = [(k, type(v[0]), len(v)) if isinstance(v, list)
                  else (k, type(v), 0) for k, v in mine.items()]
        width = sum(max(size, 1) for _, _, size in layout)
        table = torch.zeros((n, width), dtype=torch.float64)
        for i, row in rows.items():
            table[i] = torch.tensor(
                [x for k, _, size in layout for x in
                 (row[k] if size else [row[k]])], dtype=torch.float64)
        table = self.all_reduce(table.to(self.host), 'data').cpu().tolist()
        out = []
        for values in table:
            row, at = {}, 0
            for k, kind, size in layout:
                if size:
                    row[k] = [kind(x) for x in values[at:at + size]]
                else:
                    row[k] = kind(values[at])
                at += max(size, 1)
            out.append(row)
        return out


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: Optional[int] = None) -> Mesh:
    """This rank's ('data', 'model') mesh over the whole process group:
    `n_devices` (default the world size) split as `factorize` splits it
    unless `data` and `model` are given. Every rank makes the groups of
    both axes, in one order."""
    world = world_size()
    n = n_devices or world
    if data is None or model is None:
        data, model = factorize(n)
    if data * model != n:
        raise ValueError(f"data x model = {data} x {model} is not {n}")
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of "
                         f"{world}")
    groups: Dict[str, Optional[object]] = {'data': None, 'model': None}
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n > 1:
        for axis, size, lines in (
                ('data', data, [[d * model + m for d in range(data)]
                                for m in range(model)]),
                ('model', model, [[d * model + m for m in range(model)]
                                  for d in range(data)])):
            if size == 1:
                continue
            for ranks in lines:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
    host = torch.device('cpu')
    if dist.is_initialized() and dist.get_backend() == 'nccl':
        host = torch.device('cuda', torch.cuda.current_device())
    return Mesh(shape={'data': data, 'model': model}, rank=rank,
                groups=groups, host=host)
