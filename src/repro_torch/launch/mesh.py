"""Meshes: the production mesh, small host meshes, and the ranks that
hold them.

A ``DeviceMesh`` needs a process group. ``make_host_mesh`` starts one from
``env://`` (torchrun's variables) when none runs: NCCL on the card by
default, gloo for ``device="cpu"``; a failed start raises and nothing
falls back. A caller with its own ranks (``run_ranks``) starts the group
itself, with the backend it names: two ranks sharing one card run gloo,
as NCCL refuses two ranks on one device, and call
``stage_gloo_cuda_gathers`` first. ``AbstractMesh`` carries only a shape
and axis names, for the partition-spec arithmetic
(``distributed/sharding.py``, ``distributed/specs.py``), which reads
nothing else.

``run_ranks`` spawns the ranks of a multi-rank run (``spawn``, a
``file://`` rendezvous, a bounded ``init_process_group`` timeout), joins
them with a deadline and kills them after it, so a deadlocked collective
fails its caller instead of hanging it.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import MeshConfig

PRODUCTION_WORLD_SIZES = (256, 512)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, without devices (JAX's
    ``jax.sharding.AbstractMesh``)."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def ndim(self) -> int:
        return len(self.sizes)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    """Single pod: 16 x 16 = 256 ranks (data, model). Multi-pod: 2 pods =
    512 with a leading 'pod' axis."""
    if multi_pod:
        return MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))
    return MeshConfig(shape=(16, 16), axes=("data", "model"))


def make_host_mesh(shape: Optional[Tuple[int, ...]] = None,
                   axes: Optional[Tuple[str, ...]] = None, *,
                   device: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` (default: every rank on
    one 'data' axis) on ``device`` ("cuda" unless asked; "cpu" runs
    gloo). Starts the process group from ``env://`` when none runs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = "cuda" if device is None else str(device)
    if dev.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass "
                               "device='cpu' to run the mesh on the CPU")
        dev = "cuda"
    elif dev != "cpu":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                                init_method="env://")
    n = dist.get_world_size()
    if dev == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    if shape is None:
        shape, axes = (n,), axes or ("data",)
    if axes is None or len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} needs one axis name a dim, "
                         f"got {axes}")
    size = 1
    for s in shape:
        size *= s
    if size != n:
        raise ValueError(f"mesh {shape} holds {size} ranks, the process "
                         f"group {n}")
    return init_device_mesh(dev, tuple(shape), mesh_dim_names=tuple(axes))


_STAGED_LIB = None


def stage_gloo_cuda_gathers() -> None:
    """Route the functional all-gather of CUDA tensors
    (``_c10d_functional::all_gather_into_tensor``, what DTensor's
    redistributions call) through host copies, for a process whose ranks
    share one card over gloo: gloo's own path for it crashes the process
    on torch 2.11 while its all-reduce, reduce-scatter and all-to-all of
    CUDA tensors and ``dist.all_gather_into_tensor`` of host tensors run.
    Replaces the operator's CUDA kernel for the whole process, so such a
    process runs gloo groups only: the staged gather raises on any other."""
    global _STAGED_LIB
    if _STAGED_LIB is not None:
        return
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather(inp, group_size: int, group_name: str):
        pg = _resolve_process_group(group_name)
        if dist.get_backend(pg) != "gloo":
            raise RuntimeError(
                f"the staged all-gather serves gloo groups only; group "
                f"{group_name} runs {dist.get_backend(pg)}")
        host = inp.detach().to("cpu").contiguous()
        out = torch.empty((group_size * host.shape[0],)
                          + tuple(host.shape[1:]), dtype=host.dtype)
        dist.all_gather_into_tensor(out, host, group=pg)
        return out.to(inp.device)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    _STAGED_LIB = lib


def make_mesh_from_config(cfg: MeshConfig, **kw):
    return make_host_mesh(tuple(cfg.shape), tuple(cfg.axes), **kw)


def make_production_mesh(*, multi_pod: bool = False, **kw):
    """The production mesh (``mesh_config``) over the running process
    group, which must hold 256 or 512 ranks."""
    import torch.distributed as dist
    cfg = mesh_config(multi_pod=multi_pod)
    n = dist.get_world_size() if dist.is_initialized() else None
    if n not in PRODUCTION_WORLD_SIZES or n != cfg.n_devices:
        raise RuntimeError(
            f"the production mesh {cfg.shape} needs a process group of "
            f"{cfg.n_devices} ranks (one of {PRODUCTION_WORLD_SIZES}); "
            f"running: {n}")
    return make_mesh_from_config(cfg, **kw)


# --------------------------------------------------------------------------
# spawning ranks
# --------------------------------------------------------------------------

def _rank_main(rank: int, world: int, fn: Callable, args: tuple,
               store: str, out_dir: str, backend: str,
               timeout_s: float) -> None:
    import torch.distributed as dist
    result: Dict[str, Any]
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        result = {"ok": True, "value": fn(rank, world, *args)}
    except BaseException as e:           # reported to the parent
        result = {"ok": False, "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world: int, args: Sequence = (), *,
              backend: str = "gloo", deadline_s: float = 300.0,
              timeout_s: float = 60.0, workdir: Optional[str] = None
              ) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    share a process group (``backend``; a ``file://`` store in
    ``workdir``). ``fn`` must be importable by name (a module-level
    function of a module that is not ``__main__``). Returns each rank's
    value, rank order. A rank that raises, or a run that outlasts
    ``deadline_s`` (every rank is killed then), raises ``RuntimeError``
    with the ranks' errors."""
    import torch.multiprocessing as mp
    work = workdir or tempfile.mkdtemp(prefix="ranks")
    os.makedirs(work, exist_ok=True)
    store = os.path.join(work, f"store{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, fn, tuple(args), store, work,
                               backend, timeout_s), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    results, errors = [], []
    for r in range(world):
        path = os.path.join(work, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code "
                          f"{procs[r].exitcode})")
            results.append(None)
            continue
        with open(path, "rb") as f:
            res = pickle.load(f)
        os.remove(path)
        if not res["ok"]:
            errors.append(f"rank {r}: {res['error']}\n{res['traceback']}")
        results.append(res.get("value"))
    if late:
        errors.insert(0, f"ranks {late} still running after "
                         f"{deadline_s:.0f} s: killed")
    if errors:
        raise RuntimeError("multi-rank run failed:\n" + "\n".join(errors))
    return results
