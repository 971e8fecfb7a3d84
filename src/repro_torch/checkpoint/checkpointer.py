"""Checkpointing with atomic writes and an asynchronous save: the JAX
package's ``repro/checkpoint/checkpointer.py`` for a state of torch
tensors.

Format: one ``ckpt_<step>.npz`` a checkpoint step, keys the leaves' tree
paths as ``jax.tree_util.keystr`` renders them (``['master']['embed']``,
``repro_torch.tree``): an uncompressed zip of .npy members, as
``np.savez`` writes and ``np.load`` reads it. Each tensor is copied to
host numpy before writing (a Python int leaf, the state's host step,
becomes a 0-d int64), and ``restore`` puts every leaf back on the device
of the template's leaf.

Speed, same format: a card's tensors are copied into pinned host buffers
that the Checkpointer keeps for its next saves (a save waits for the
previous write before it reuses them: 0.24 s for a 12.86 GB state
against 5.6 s by ``.cpu()`` on the H100's machine); each member is
written with one write of its bytes, and read back with one read from
its offset in the file, its zip CRC checked on a thread pool (``np.load``
reads 0.60 GB/s there; ``scripts/probe_checkpoint_io.py``).

Atomicity: write to ``<dir>/tmp.<step>`` then ``os.replace``, so a crashed
save never corrupts the latest checkpoint. Async: the device-to-host copy
happens synchronously, the file write runs on a worker thread, and a write
failure surfaces at the next ``wait()`` as CheckpointWriteError, the type
TrainRunner catches to fall back to the previous checkpoint instead of
spending a restart on it.

A state of DTensors (a sharded run) is gathered whole on every rank of
its mesh (a collective: every rank calls ``save``), and rank 0 writes it;
``restore(..., shardings=)`` places each leaf on a mesh by a tree of
``NamedSharding`` (``distributed/specs.to_shardings``), which may differ
from the mesh that saved: the elastic re-mesh.

The dropout contract (checkpoint/contract.py) rides inside the same .npz
under a ``__dropout_contract__`` key, so the atomic replace covers params
and contract together: a checkpoint never holds params from one schedule
and the contract of another.
"""
from __future__ import annotations

import json
import os
import re
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, tree_map, unflatten_like

_STEP_RE = re.compile(r"^ckpt_(\d+)\.npz$")

# non-leaf payload keys (metadata riding inside the .npz); restore filters
# them out of the state tree
_META_PREFIX = "__"
_CONTRACT_KEY = "__dropout_contract__"


class CheckpointWriteError(RuntimeError):
    """An async checkpoint write failed (disk full, permission, an injected
    crash). The latest checkpoint on disk is still the previous one: the
    atomic tmp + replace published no partial file."""


def _check_dtype(leaf) -> None:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        raise TypeError("a bf16 tensor has no numpy dtype; the train state "
                        "keeps its master and moments in f32")


def _write_npz(f, arrays: Dict[str, np.ndarray]) -> None:
    """An uncompressed .npz of ``arrays`` (``np.load`` reads it), each
    member's bytes written at once."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            arr = np.require(arr, requirements="C")   # keeps a 0-d array
            with zf.open(key + ".npy", "w", force_zip64=True) as m:
                np.lib.format.write_array_header_1_0(
                    m, np.lib.format.header_data_from_array_1_0(arr))
                m.write(memoryview(arr.reshape(-1)).cast("B"))


_READ_HEADER = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


def _crc_ok(head: bytes, arr: np.ndarray, want: int) -> bool:
    return zlib.crc32(arr, zlib.crc32(head)) == want


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every member of an .npz, each uncompressed one read with one read
    from its offset in the file and held to its zip CRC (a member of
    another form goes through numpy's reader). The CRCs run on a thread
    pool while the next members are read (``zlib.crc32`` releases the
    GIL)."""
    out, checks = {}, []
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f, \
            ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        for info in zf.infolist():
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            f.seek(info.header_offset)
            head = f.read(30)
            start = (info.header_offset + 30
                     + int.from_bytes(head[26:28], "little")
                     + int.from_bytes(head[28:30], "little"))
            f.seek(start)
            version = np.lib.format.read_magic(f)
            read_header = _READ_HEADER.get(version)
            if info.compress_type != zipfile.ZIP_STORED or \
                    read_header is None:
                with zf.open(info) as m:
                    out[name] = np.lib.format.read_array(m)
                continue
            shape, fortran, dtype = read_header(f)
            n_head = f.tell() - start
            f.seek(start)
            head = f.read(n_head)
            arr = np.fromfile(f, dtype=dtype, count=int(np.prod(shape)))
            if n_head + arr.nbytes != info.file_size:
                raise ValueError(f"checkpoint {path}: member {name} is "
                                 "short")
            checks.append((name, pool.submit(_crc_ok, head, arr, info.CRC)))
            out[name] = arr.reshape(shape, order="F" if fortran else "C")
        for name, ok in checks:
            if not ok.result():
                raise ValueError(f"checkpoint {path}: member {name} fails "
                                 "its CRC")
    return out


def _writes_here(state) -> bool:
    """False on the ranks of a sharded state that do not write (all but
    rank 0 of the process group)."""
    import torch.distributed as dist
    sharded = any(hasattr(leaf, "device_mesh")
                  for _, leaf in leaves_with_paths(state))
    return not (sharded and dist.is_initialized() and dist.get_rank() != 0)


def _leaf_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _restored(arr: np.ndarray, tmpl):
    """``arr`` in the template leaf's form: a tensor on its device, or a
    Python int for an int leaf."""
    if hasattr(tmpl, "device_mesh"):      # a DTensor: placed by shardings
        return torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(tmpl, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(tmpl.device)
    if isinstance(tmpl, int):
        return int(arr)
    return arr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # pinned host copies of a card's leaves, by path, reused by every
        # save once the previous write has finished
        self._pinned: Dict[str, torch.Tensor] = {}
        os.makedirs(directory, exist_ok=True)

    # -- save --------------------------------------------------------------

    def save(self, step: int, state, contract=None) -> None:
        """Write checkpoint ``step``. ``contract`` is an optional
        DropoutContract embedded in the same atomic .npz so restore can
        verify the mask lineage."""
        self.wait()  # one outstanding async save at a time
        host_state = self._gather(state)
        if not _writes_here(state):
            return
        if contract is not None:
            host_state[_CONTRACT_KEY] = np.frombuffer(
                contract.to_json().encode(), dtype=np.uint8)
        if self.async_save:
            self._worker = threading.Thread(
                target=self._write, args=(step, host_state), daemon=True)
            self._worker.start()
        else:
            self._write(step, host_state)

    def _gather(self, state) -> Dict[str, np.ndarray]:
        """The state as host numpy arrays: a card's tensors copied into
        the pinned buffers, a CPU tensor copied, an int as a 0-d array."""
        out, on_card = {}, False
        for path, leaf in leaves_with_paths(state):
            _check_dtype(leaf)
            if hasattr(leaf, "full_tensor"):      # a DTensor: whole here
                leaf = leaf.full_tensor()
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
                buf = self._pinned.get(path)
                if buf is None or buf.shape != leaf.shape or \
                        buf.dtype != leaf.dtype:
                    buf = self._pinned[path] = torch.empty(
                        leaf.shape, dtype=leaf.dtype, pin_memory=True)
                buf.copy_(leaf.detach(), non_blocking=True)
                out[path], on_card = buf.numpy(), True
            elif isinstance(leaf, torch.Tensor):
                out[path] = leaf.detach().to("cpu", copy=True).numpy()
            else:
                out[path] = np.asarray(leaf)
        if on_card:
            torch.cuda.synchronize()
        return out

    def _write(self, step: int, host_state: Dict[str, np.ndarray]):
        try:
            tmp = os.path.join(self.directory, f"tmp.{step}")
            final = os.path.join(self.directory, f"ckpt_{step}.npz")
            with open(tmp, "wb") as f:
                _write_npz(f, host_state)
            os.replace(tmp, final)
            meta = os.path.join(self.directory, "latest")
            with open(meta + ".tmp", "w") as f:
                json.dump({"step": step}, f)
            os.replace(meta + ".tmp", meta)
            self._gc()
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def wait(self) -> None:
        """Join the outstanding async write; re-raise its failure as
        CheckpointWriteError (callers tell "the save failed, the previous
        checkpoint is still good" from a training crash)."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            if isinstance(err, CheckpointWriteError):
                raise err
            raise CheckpointWriteError(
                f"async checkpoint write failed: {err!r}") from err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            try:
                os.remove(os.path.join(self.directory, f"ckpt_{s}.npz"))
            except OSError:
                pass

    # -- restore -----------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """Newest restorable step: the atomically written ``latest`` meta
        file when its step's .npz exists (a stale or corrupt meta falls
        through), else a scan of the directory."""
        meta = os.path.join(self.directory, "latest")
        try:
            with open(meta) as f:
                step = int(json.load(f)["step"])
            if os.path.exists(os.path.join(self.directory,
                                           f"ckpt_{step}.npz")):
                return step
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError):
            pass
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_contract(self, step: int):
        """The DropoutContract saved with ``step``, or None for a
        checkpoint saved without one."""
        from repro_torch.checkpoint.contract import DropoutContract
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        with np.load(path) as z:
            if _CONTRACT_KEY not in z.files:
                return None
            blob = z[_CONTRACT_KEY].tobytes().decode()
        return DropoutContract.from_json(blob)

    def restore(self, step: int, template, shardings=None):
        """Restore into the structure of ``template``, each leaf on the
        device of the template's leaf -- or, with ``shardings`` (a
        matching tree of ``NamedSharding``), placed on that leaf's mesh by
        its spec, each rank keeping its slices: the elastic re-mesh (the
        mesh may differ from the one that saved). Shapes and dtypes must
        match the template: a silent dtype cast would change the numerics
        of a bitwise replay."""
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        arrays = {k: v for k, v in _read_npz(path).items()
                  if not k.startswith(_META_PREFIX)}
        flat = []
        for key, tmpl in leaves_with_paths(template):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = arrays[key]
            shape = tuple(getattr(tmpl, "shape", np.shape(tmpl)))
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs "
                    f"template {shape}")
            tdt = _leaf_dtype(tmpl)
            if np.dtype(arr.dtype) != tdt:
                raise ValueError(
                    f"checkpoint dtype drift for leaf {key}: ckpt "
                    f"{arr.dtype} vs template {tdt} — refusing to cast "
                    "silently; restore with a matching template or convert "
                    "the checkpoint explicitly")
            flat.append(arr)
        if shardings is None and any(hasattr(t, "device_mesh")
                                     for _, t in leaves_with_paths(template)):
            raise ValueError("a sharded template restores with shardings= "
                             "(distributed.specs.to_shardings)")
        state = unflatten_like(template, [
            _restored(arr, tmpl) for arr, (_, tmpl) in
            zip(flat, leaves_with_paths(template))])
        if shardings is None:
            return state
        from repro_torch.distributed.sharding import distribute
        return tree_map(
            lambda t, sh: distribute(
                t.to(sh.mesh.device_type), sh.spec, sh.mesh)
            if isinstance(t, torch.Tensor) else t, state, shardings)
