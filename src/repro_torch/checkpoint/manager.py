"""Crash-consistent checkpointing of the port (mirror of
``repro.checkpoint.manager``): async double-buffered saves, a CRC32 per
piece, two-phase commit, and the JAX package's on-disk format, so either
package restores the other's checkpoints.

Layout (one directory per step):
    <dir>/step_000000100/
        shard_00000.npz             # rank 0's pieces of every leaf
        shard_00000.SHARD_COMMITTED # written (and fsync'd) after its npz
        shard_00001.npz             # rank 1's pieces ...
        shard_00001.SHARD_COMMITTED
        manifest.json               # format 2: paths, shapes, dtypes,
                                    #   per-shard index + CRC32, data step,
                                    #   state layout
        COMMITTED                   # written only when every shard landed
        GOOD                        # optional: promoted to last-known-good

Each rank of a data-parallel run (``comm``) has its own manager on the same
directory and writes ``shard_<rank>.npz``: its :class:`Piece` leaves (its
rows of the ZeRO-sharded momentum and slot stripes, with their ``index``
along ``L``; its error-feedback residual as row ``rank`` of the JAX
package's ``(N, *shape)`` leaf) and, on rank 0 only, the replicated leaves.
Its ``SHARD_COMMITTED`` marker holds the JSON of its pieces (index, shape,
CRC32). Rank 0 writes the manifest and ``COMMITTED`` once every rank's
marker has landed (a barrier on the file system, so the writer threads
never touch the process group), then renames the step into place. This is
the JAX package's format 2 with ``n_shards = N``. Leaves are keyed by their
tree path (``repro_torch.core.types.tree_paths``), which equals the JAX
package's, and stored as ``leaf_<i>`` in tree order; a restore reads every
rank's file and hands each :class:`Piece` of its template back its window.

bf16 on disk: JAX writes an ``ml_dtypes`` bfloat16 array as a 2-byte
``'<V2'`` array with ``"dtype": "bfloat16"`` in the manifest. The port
writes the tensor's bits through a ``uint16`` view under the same ``'<V2'``
header, so each ``leaf_<i>.npy`` member holds the bytes JAX writes, and it
reads ``'<V2'`` back through the same view, never through float32.

Commit protocol (two-phase):
  1. per rank: write + fsync ``shard_r.npz``, then ``shard_r.SHARD_COMMITTED``;
  2. rank 0, once every marker exists: write + fsync ``manifest.json``
     (with a CRC32 per piece), then ``COMMITTED``;
  3. rank 0: rename the ``.tmp_step_*`` directory into place (``os.replace``).
With more than one rank the n-th write of every rank goes to
``.tmp_step_<step>.<n>``, so two saves of one step never share a directory; a watchdog's emergency save commits
only when every rank's watchdog has written its shard. A crash before (3)
leaves only a ``.tmp_step_*`` directory, which a new manager on the same
directory removes (rank 0's, before the others pass a barrier); a
``COMMITTED`` step missing a ``SHARD_COMMITTED`` marker is corruption and
never restored.

Integrity: bit-rot, a truncated or missing shard and a torn manifest each
raise :class:`CheckpointCorruptionError` naming the checkpoint and the leaf
path, shard rank or file; ``restore_latest`` warns with that name and falls
back to the previous committed step.

Async double-buffered writer: ``save()`` copies the state into one of two
preallocated host buffers (pinned for CUDA tensors, filled on a side stream
that first waits for the current stream, with an event recorded after the
copies) and returns; a writer thread waits on the event, then serializes,
checksums and fsyncs from the buffer. The step is out-of-place, so the loop
may drop its last reference to the saved tensors while the copy is in
flight: the buffer keeps references to them until the event has fired.
Backpressure: one write in flight at most; the next ``save()`` waits for it.
A failed async write is raised by the next ``save()``, ``wait()`` or
``emergency_save()``; nothing falls back to another path.
``snapshot()`` fills a buffer without writing (the watchdog-armed loop calls
it every step) and ``emergency_save()`` persists the last snapshot from the
host buffer, with no device access.

Retention (rank 0's) keeps the ``keep`` newest steps, the newest
last-known-good step and any step that is being restored.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
import zipfile
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import map_with_path, tree_paths

# manifest dtype name -> (torch dtype, numpy dtype of the stored bits)
_DTYPES = {
    "float32": (torch.float32, np.dtype(np.float32)),
    "float64": (torch.float64, np.dtype(np.float64)),
    "float16": (torch.float16, np.dtype(np.float16)),
    "bfloat16": (torch.bfloat16, np.dtype(np.uint16)),
    "int8": (torch.int8, np.dtype(np.int8)),
    "uint8": (torch.uint8, np.dtype(np.uint8)),
    "int16": (torch.int16, np.dtype(np.int16)),
    "int32": (torch.int32, np.dtype(np.int32)),
    "int64": (torch.int64, np.dtype(np.int64)),
    "bool": (torch.bool, np.dtype(np.bool_)),
}
_NAMES = {tdt: name for name, (tdt, _) in _DTYPES.items()}
_BF16_DESCR = "<V2"  # what numpy writes for ml_dtypes.bfloat16
_COMMIT_TIMEOUT_S = 600.0  # rank 0's wait for the other ranks' shards


class CheckpointCorruptionError(RuntimeError):
    """A committed checkpoint failed integrity verification on restore
    (checksum mismatch, truncated or missing shard, torn manifest or
    multi-rank commit). The message names the checkpoint and the leaf path,
    shard rank or file."""


def _dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a torch dtype (numpy's name of the same type)."""
    if dtype not in _NAMES:
        raise TypeError(f"no checkpoint format for dtype {dtype}")
    return _NAMES[dtype]


def _fsync(path: Path) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _bytes(arr: np.ndarray):
    """The array's bytes in C order, without a copy where it is contiguous."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(_bytes(arr)) & 0xFFFFFFFF


def _host_bits(buf: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bits as the numpy array that goes on disk (bf16 as
    ``uint16``), sharing its memory."""
    if buf.dtype == torch.bfloat16:
        return buf.view(torch.int16).numpy().view(np.uint16)
    return buf.numpy()


def _write_npy(f, arr: np.ndarray, descr: Optional[str]) -> None:
    """``numpy.lib.format.write_array`` with the header's ``descr`` replaced
    (``'<V2'`` for bf16 bits), bytes as they lie in memory."""
    header = np.lib.format.header_data_from_array_1_0(arr)
    if descr is not None:
        header["descr"] = descr
    np.lib.format.write_array_header_1_0(f, header)
    f.write(_bytes(arr))


def savez(path: Path, arrays: Dict[str, Tuple[np.ndarray, Optional[str]]]) -> None:
    """``numpy.savez`` (stored, zip64 members) of ``name -> (array,
    descr)``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, (arr, descr) in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                _write_npy(f, arr, descr)


def to_tensor(arr: np.ndarray, name: str, device) -> torch.Tensor:
    """Stored bits of dtype ``name`` as a tensor on ``device``."""
    if name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if torch.device(device).type != "cpu" else t


class Piece:
    """One rank's part of a leaf: ``tensor`` is the window ``index``
    (``[start, stop]`` per dimension) of a global leaf of ``shape``; a
    window one long on a leading dimension the tensor lacks is squeezed
    (a rank's row of a stacked residual). As a save leaf it is written by
    this rank; as a restore template it gets its window back."""

    def __init__(self, tensor: torch.Tensor, shape, index):
        self.tensor = tensor
        self.shape = tuple(int(d) for d in shape)
        self.index = [[int(a), int(b)] for a, b in index]

    @property
    def dtype(self):
        return self.tensor.dtype

    @classmethod
    def rows(cls, tensor: torch.Tensor, rank: int, world: int) -> "Piece":
        """Rows ``[rank * l, (rank + 1) * l)`` of a leaf of ``world * l``
        rows (a ZeRO shard of a stacked buffer)."""
        n = tensor.shape[0]
        shape = (world * n,) + tuple(tensor.shape[1:])
        return cls(tensor, shape, [[rank * n, (rank + 1) * n]]
                   + [[0, d] for d in tensor.shape[1:]])

    @classmethod
    def row(cls, tensor: torch.Tensor, rank: int, world: int) -> "Piece":
        """Row ``rank`` of a ``(world, *tensor.shape)`` leaf."""
        return cls(tensor, (world,) + tuple(tensor.shape),
                   [[rank, rank + 1]] + [[0, d] for d in tensor.shape])


def _global_shape(leaf) -> Tuple[int, ...]:
    return leaf.shape if isinstance(leaf, Piece) else tuple(leaf.shape)


def leaf_from(entry: Tuple[np.ndarray, str], like) -> torch.Tensor:
    """A restored leaf for its template: the whole array for a tensor, the
    window for a :class:`Piece`, on the template's device."""
    arr, name = entry
    if isinstance(like, Piece):
        arr = arr[tuple(slice(a, b) for a, b in like.index)]
        return to_tensor(np.ascontiguousarray(arr), name,
                          like.tensor.device).reshape(like.tensor.shape)
    return to_tensor(arr, name, like.device).reshape(like.shape)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 comm=None):
        """``comm`` (a ``repro_torch.distributed.comm.Comm``) makes this the
        manager of one rank of a data-parallel run; rank 0 commits once every
        rank's shard has landed, or fails the write after
        ``_COMMIT_TIMEOUT_S``."""
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.rank = comm.rank if comm is not None else 0
        self.world = comm.world if comm is not None else 1
        # writes started so far: every rank numbers its saves alike
        self._writes = 0
        # writer handshake: _cv guards everything below; _inflight is True
        # from the moment a job is submitted (or a blocking write starts)
        # until its _write returns; backpressure keeps it to one at a time
        self._cv = threading.Condition()
        self._inflight = False
        self._pending: Optional[dict] = None
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # double buffer: two host-side slots; the slot referenced by the
        # submitted/in-flight job is pinned, fills go to the other one
        self._slots: List[Optional[dict]] = [None, None]
        self._busy_slot: Optional[int] = None
        self._last_slot: Optional[int] = None
        self._last_snapshot: Optional[dict] = None
        self._streams: Dict[Any, Any] = {}
        # steps currently being restored: retention must not delete them
        self._reading: Dict[int, int] = {}
        self._read_lock = threading.Lock()
        # directory-scan and parsed-manifest caches, invalidated on save,
        # prune and mark_good and keyed on file stats
        self._cache_lock = threading.Lock()
        self._scan_cache: Optional[Tuple[int, List[str]]] = None
        self._manifest_cache: Dict[str, Tuple[int, int, dict]] = {}
        if self.rank == 0:
            self._sweep_torn_writes()
        if comm is not None and self.world > 1:
            comm.barrier()  # no rank writes before the sweep is done

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:09d}"

    def _sweep_torn_writes(self) -> None:
        """Remove the ``.tmp_step_*`` directories of writes that a dead
        process left behind: they were never committed and never will be."""
        torn = sorted(p.name for p in self.dir.glob(".tmp_step_*"))
        for name in torn:
            shutil.rmtree(self.dir / name, ignore_errors=True)
        if torn:
            warnings.warn(f"removed uncommitted checkpoint writes {', '.join(torn)}",
                          RuntimeWarning, stacklevel=3)

    # ------------------------------------------------------------------
    # host snapshot buffers
    # ------------------------------------------------------------------
    def _pick_slot(self) -> int:
        for s in (0, 1):
            if s != self._busy_slot and s != self._last_slot:
                return s
        return next(s for s in (0, 1) if s != self._busy_slot)

    def _stream(self, device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    @staticmethod
    def _copied(slot: dict) -> None:
        """Wait until the slot's device->host copies have landed, then drop
        the references that kept their sources alive."""
        event = slot.get("event")
        if event is not None:
            event.synchronize()
        slot["event"] = None
        slot["keep"] = None

    def _fill(self, slot_idx: int, state: Any) -> None:
        """Copy this rank's part of ``state`` into buffer ``slot_idx``,
        reusing its host tensors when the structure matches: its
        :class:`Piece` leaves, and on rank 0 the whole of every other leaf.
        CUDA leaves go on a side stream into pinned memory; the call returns
        once the copies are enqueued."""
        flat = []
        for path, leaf in tree_paths(state):
            if isinstance(leaf, Piece):
                flat.append((path, leaf.tensor, leaf.shape, leaf.index))
            else:
                t = leaf
                index = [[0, int(d)] for d in t.shape] if self.rank == 0 else None
                flat.append((path, t, tuple(t.shape), index))
        sig = tuple((path, _dtype_name(t.dtype), shape, str(index), str(t.device))
                    for path, t, shape, index in flat)
        slot = self._slots[slot_idx]
        if slot is not None:
            self._copied(slot)  # an earlier copy into it must land first
        if slot is None or slot["sig"] != sig:
            slot = {"sig": sig, "event": None, "keep": None,
                    "leaves": [{"path": path, "shape": [int(d) for d in shape],
                                "dtype": _dtype_name(t.dtype), "index": index,
                                "buf": (torch.empty(t.shape, dtype=t.dtype,
                                                    pin_memory=t.is_cuda)
                                        if index is not None else None)}
                               for path, t, shape, index in flat]}
            self._slots[slot_idx] = slot
        mine = [(leaf["buf"], t) for leaf, (_, t, _, _) in zip(slot["leaves"], flat, strict=True)
                if leaf["buf"] is not None]
        for buf, t in mine:
            if not t.is_cuda:
                buf.copy_(t)
        on_card = [(buf, t) for buf, t in mine if t.is_cuda]
        if on_card:
            device = on_card[0][1].device
            stream = self._stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for buf, t in on_card:
                    buf.copy_(t, non_blocking=True)
                slot["event"] = torch.cuda.Event()
                slot["event"].record(stream)
            slot["keep"] = [t for _, t in on_card]
        self._last_slot = slot_idx

    def _make_job(self, step: int, slot_idx: int,
                  data_step: Optional[int], layout: Optional[dict]) -> dict:
        return {"step": int(step),
                "data_step": int(data_step if data_step is not None else step),
                "time": time.time(), "layout": layout, "slot": slot_idx}

    def _numbered(self, job: dict) -> dict:
        """Called with ``_cv`` held: ``job`` with the next write number."""
        job = dict(job, seq=self._writes)
        self._writes += 1
        return job

    def _raise_failed_write(self) -> None:
        """Called with ``_cv`` held: re-raise a failed async write once."""
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"an async checkpoint write failed: {err!r}") from err

    # ------------------------------------------------------------------
    # save / snapshot / emergency save
    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, data_step: Optional[int] = None,
             block: bool = False, layout: Optional[dict] = None):
        """``state``: a tree of tensors. ``layout`` (JSON,
        ``repro_torch.distributed.elastic.state_layout``) records what the
        state is laid out for. Async (the default): the caller waits for
        any write in flight, enqueues the copy into a host buffer and
        returns; the writer thread does the rest. ``block=True`` writes on
        the calling thread."""
        with self._cv:
            while self._inflight or self._pending is not None:
                self._cv.wait()
            self._raise_failed_write()
            slot = self._pick_slot()
            self._fill(slot, state)
            job = self._numbered(self._make_job(step, slot, data_step, layout))
            self._last_snapshot = job
            self._inflight = True
            self._busy_slot = slot
            if self.async_save and not block:
                self._pending = job
                self._ensure_writer()
                self._cv.notify_all()
                return
        try:
            self._write(job)
        finally:
            with self._cv:
                self._inflight = False
                self._busy_slot = None
                self._cv.notify_all()

    def snapshot(self, step: int, state: Any,
                 data_step: Optional[int] = None,
                 layout: Optional[dict] = None) -> None:
        """Fill a host buffer from ``state`` without writing anything, so
        :meth:`emergency_save` can persist it later without touching the
        device. Never waits for an in-flight write: the double buffer
        always has a free slot."""
        with self._cv:
            slot = self._pick_slot()
            self._fill(slot, state)
            self._last_snapshot = self._make_job(step, slot, data_step, layout)

    def emergency_save(self) -> Optional[int]:
        """Synchronously persist the most recent :meth:`snapshot` or
        :meth:`save` buffer if it is newer than the newest committed step.
        Returns the step written, or None. Called from the watchdog's timer
        thread: it drains any in-flight write first, then writes from the
        host buffer."""
        with self._cv:
            while self._inflight or self._pending is not None:
                self._cv.wait()
            self._raise_failed_write()
            job = self._last_snapshot
            if job is None:
                return None
            latest = self.latest_step()
            if latest is not None and job["step"] <= latest:
                return None
            job = self._numbered(job)
            self._inflight = True
            self._busy_slot = job["slot"]
        try:
            self._write(job)
        finally:
            with self._cv:
                self._inflight = False
                self._busy_slot = None
                self._cv.notify_all()
        return job["step"]

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(target=self._writer_loop, daemon=True,
                                            name="checkpoint-writer")
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while self._pending is None:
                    self._cv.wait()
                job = self._pending
                self._pending = None
            try:
                self._write(job)
            except BaseException as e:  # noqa: BLE001 — raised by the next save/wait
                with self._cv:
                    self._error = e
            finally:
                with self._cv:
                    self._inflight = False
                    self._busy_slot = None
                    self._cv.notify_all()

    def wait(self):
        """Drain: block until no write is pending or in flight; raise if the
        last async write failed."""
        with self._cv:
            while self._inflight or self._pending is not None:
                self._cv.wait()
            self._raise_failed_write()

    # ------------------------------------------------------------------
    # the writer (runs on the writer thread, or the caller when blocking)
    # ------------------------------------------------------------------
    def _write(self, job: dict) -> None:
        slot = self._slots[job["slot"]]
        self._copied(slot)
        step = job["step"]
        # one rank: the JAX package's name; more: the n-th write of each
        # rank shares .tmp_step_<step>.<n>, so two saves of a step never mix
        tmp = self.dir / (f".tmp_step_{step:09d}"
                          + (f".{job['seq']}" if self.world > 1 else ""))
        if self.world == 1 and tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True, exist_ok=True)
        # phase 1: this rank's shard file and its marker, which lists the
        # pieces (leaf, window, CRC32) for rank 0's manifest
        arrays, pieces = {}, []
        for i, leaf in enumerate(slot["leaves"]):
            if leaf["buf"] is None:
                continue
            arr = _host_bits(leaf["buf"])
            arrays[f"leaf_{i}"] = (arr, _BF16_DESCR if leaf["dtype"] == "bfloat16" else None)
            pieces.append({"leaf": i, "index": leaf["index"],
                           "shape": [int(d) for d in arr.shape], "crc32": _crc(arr)})
        spath = tmp / f"shard_{self.rank:05d}.npz"
        savez(spath, arrays)
        _fsync(spath)
        marker = tmp / f"shard_{self.rank:05d}.SHARD_COMMITTED"
        marker.write_text(json.dumps(pieces))
        _fsync(marker)
        if self.rank != 0:
            return
        # phase 2 (rank 0): every rank's marker, then the manifest (with
        # per-piece CRCs) and the global marker
        by_leaf: List[List[dict]] = [[] for _ in slot["leaves"]]
        for rank, listed in enumerate(self._await_markers(tmp, step)):
            for pc in listed:
                by_leaf[pc["leaf"]].append({"rank": rank, "index": pc["index"],
                                            "shape": pc["shape"], "crc32": pc["crc32"]})
        leaves_manifest = [{"path": leaf["path"], "shape": leaf["shape"],
                            "dtype": leaf["dtype"], "shards": by_leaf[i]}
                           for i, leaf in enumerate(slot["leaves"])]
        manifest = {"format": 2, "step": step, "data_step": job["data_step"],
                    "time": job["time"], "n_shards": self.world,
                    "leaves": leaves_manifest}
        if job["layout"] is not None:
            manifest["layout"] = job["layout"]
        mpath = tmp / "manifest.json"
        mpath.write_text(json.dumps(manifest))
        _fsync(mpath)
        cpath = tmp / "COMMITTED"
        cpath.write_text("ok")
        _fsync(cpath)
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._invalidate()
        self._prune()

    def _await_markers(self, tmp: Path, step: int) -> List[list]:
        """Rank 0's barrier: wait for every rank's ``SHARD_COMMITTED`` and
        return each one's list of pieces, in rank order."""
        deadline = time.time() + _COMMIT_TIMEOUT_S
        out = []
        for r in range(self.world):
            marker = tmp / f"shard_{r:05d}.SHARD_COMMITTED"
            while True:
                try:
                    out.append(json.loads(marker.read_text()))
                    break
                except (OSError, ValueError):  # not there, or still being written
                    if time.time() > deadline:
                        raise RuntimeError(
                            f"checkpoint step {step}: rank {r} did not commit its "
                            f"shard within {_COMMIT_TIMEOUT_S} s") from None
                    time.sleep(0.005)
        return out

    # ------------------------------------------------------------------
    # directory scan (cached) + retention
    # ------------------------------------------------------------------
    def _invalidate(self) -> None:
        with self._cache_lock:
            self._scan_cache = None
            self._manifest_cache.clear()

    def _read_manifest(self, d: Path) -> dict:
        """Parse ``d/manifest.json`` with a stat-keyed cache: a manifest
        rewritten in place re-parses, an unchanged one comes from the
        cache."""
        mpath = d / "manifest.json"
        st = mpath.stat()
        key = d.name
        with self._cache_lock:
            hit = self._manifest_cache.get(key)
            if hit is not None and hit[0] == st.st_mtime_ns and hit[1] == st.st_size:
                return hit[2]
        manifest = json.loads(mpath.read_text())
        with self._cache_lock:
            self._manifest_cache[key] = (st.st_mtime_ns, st.st_size, manifest)
        return manifest

    def _committed_steps(self) -> List[int]:
        """Steps with a COMMITTED marker and a parseable manifest. A torn
        manifest is treated like a missing commit marker: a named warning,
        and the step is skipped. The listing is cached on the directory's
        mtime and each parse on its file's stat, so in-place damage to a
        manifest still re-parses (and warns) on every call."""
        try:
            mt = self.dir.stat().st_mtime_ns
        except OSError:
            mt = None
        with self._cache_lock:
            cached = (list(self._scan_cache[1])
                      if mt is not None and self._scan_cache is not None
                      and self._scan_cache[0] == mt else None)
        names = cached if cached is not None else sorted(
            p.name for p in self.dir.glob("step_*"))
        if cached is None and mt is not None:
            with self._cache_lock:
                self._scan_cache = (mt, list(names))
        out = []
        for name in names:
            p = self.dir / name
            if not (p / "COMMITTED").exists():
                continue
            try:
                self._read_manifest(p)
            except (OSError, ValueError) as e:
                warnings.warn(
                    f"checkpoint {p.name}: torn/unparseable manifest.json "
                    f"({e}) — treating like a missing commit marker",
                    RuntimeWarning, stacklevel=2)
                continue
            out.append(int(name.split("_")[1]))
        return out

    def _prune(self) -> None:
        if not self.keep or self.rank != 0:
            return
        steps = self._committed_steps()
        # the newest last-known-good step (the rewind target) and any step
        # being restored are pinned; all writes go through the one writer
        # handshake, so prune (the tail of _write) cannot race a write
        with self._read_lock:
            reading = set(self._reading)
        keepers = set(steps[-self.keep:]) | set(self.good_steps()[-1:]) | reading
        pruned = False
        for s in steps:
            if s not in keepers:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                pruned = True
        if pruned:
            self._invalidate()

    def latest_step(self) -> Optional[int]:
        steps = self._committed_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    # last-known-good: the driver promotes a committed step after a health
    # window of anomaly-free steps; the rewind ladder restores the newest
    # good step, never merely the newest step
    # ------------------------------------------------------------------
    def mark_good(self, step: int) -> None:
        """Promote a committed step to last-known-good (idempotent; rank 0's
        to write, a no-op on the other ranks)."""
        self.wait()
        if self.rank != 0:
            return
        d = self._step_dir(step)
        if not (d / "COMMITTED").exists():
            raise ValueError(f"cannot mark step {step} good: no committed "
                             f"checkpoint at {d}")
        (d / "GOOD").write_text("ok")
        self._invalidate()

    def good_steps(self) -> List[int]:
        return [s for s in self._committed_steps()
                if (self._step_dir(s) / "GOOD").exists()]

    def latest_good_step(self) -> Optional[int]:
        good = self.good_steps()
        return good[-1] if good else None

    def read_layout(self, step: int) -> Optional[dict]:
        """The state layout written at save time
        (``repro_torch.distributed.elastic.state_layout``), or None."""
        return self._read_manifest(self._step_dir(step)).get("layout")

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def _validate(self, step: int, manifest: dict, like: Any) -> None:
        """The template against the manifest: tree, shapes and dtypes must
        agree, and a mismatch names the leaf and both sides. A dtype is
        never cast."""
        flat = tree_paths(like)
        man = manifest["leaves"]
        if len(flat) != len(man):
            raise ValueError(
                f"checkpoint step {step} holds {len(man)} leaves but the "
                f"restore template has {len(flat)} — different state "
                f"structure (model / optimizer mismatch?)")
        for (path, leaf), m in zip(flat, man, strict=True):
            if m["path"] != path:
                raise ValueError(
                    f"checkpoint step {step}: tree mismatch — checkpoint "
                    f"leaf {m['path']!r} where the template has {path!r}")
            if tuple(m["shape"]) != _global_shape(leaf):
                raise ValueError(
                    f"checkpoint step {step}: leaf {path!r} was saved with "
                    f"shape {tuple(m['shape'])} but the template expects "
                    f"{_global_shape(leaf)} — a bucketed-state mismatch like this "
                    f"usually means another shard size (see read_layout)")
            if m["dtype"] != _dtype_name(leaf.dtype):
                raise ValueError(
                    f"checkpoint step {step}: leaf {path!r} was saved as "
                    f"{m['dtype']} but the template expects "
                    f"{_dtype_name(leaf.dtype)} — refusing to cast optimizer "
                    f"state silently")

    def _load_arrays(self, d: Path, manifest: dict) -> List[np.ndarray]:
        """Reassemble every leaf from the per-rank shard files, verifying
        the commit markers and every piece's CRC32. Raises
        :class:`CheckpointCorruptionError` naming the checkpoint, leaf path
        and shard rank on any integrity failure. A bf16 leaf comes back as
        its ``uint16`` bits."""
        if int(manifest.get("format", 1)) < 2:
            raise CheckpointCorruptionError(
                f"checkpoint {d.name}: manifest format {manifest.get('format', 1)} "
                f"predates the sharded format 2, which is all the port reads")
        n_shards = int(manifest.get("n_shards", 1))
        for r in range(n_shards):
            if not (d / f"shard_{r:05d}.SHARD_COMMITTED").exists():
                raise CheckpointCorruptionError(
                    f"checkpoint {d.name}: shard rank {r} is missing its "
                    f"SHARD_COMMITTED marker under a global COMMITTED — "
                    f"torn multi-rank commit")
        zs: Dict[int, Any] = {}
        files: List[Any] = []
        try:
            for r in range(n_shards):
                spath = d / f"shard_{r:05d}.npz"
                if not spath.exists():
                    raise CheckpointCorruptionError(
                        f"checkpoint {d.name}: missing shard file "
                        f"shard_{r:05d}.npz (rank {r})")
                try:
                    files.append(open(spath, "rb"))  # closed below, even when np.load fails
                    zs[r] = np.load(files[-1])
                except (OSError, ValueError, zipfile.BadZipFile) as e:
                    raise CheckpointCorruptionError(
                        f"checkpoint {d.name}: shard rank {r} is "
                        f"truncated/unreadable ({e})") from e
            arrays = []
            for i, leaf in enumerate(manifest["leaves"]):
                if leaf["dtype"] not in _DTYPES:
                    raise ValueError(f"checkpoint {d.name}: leaf {leaf['path']!r} has "
                                     f"dtype {leaf['dtype']}, which the port cannot hold")
                bits = _DTYPES[leaf["dtype"]][1]
                shape = tuple(leaf["shape"])
                out = None
                for sh in leaf["shards"]:
                    rank = int(sh["rank"])
                    try:
                        piece = zs[rank][f"leaf_{i}"]
                    except KeyError as e:
                        raise CheckpointCorruptionError(
                            f"checkpoint {d.name}: leaf {leaf['path']!r} "
                            f"is missing from shard rank {rank}") from e
                    except (OSError, ValueError, EOFError,
                            zipfile.BadZipFile, zlib.error) as e:
                        raise CheckpointCorruptionError(
                            f"checkpoint {d.name}: leaf {leaf['path']!r} "
                            f"shard rank {rank} is truncated/unreadable "
                            f"({e})") from e
                    if list(piece.shape) != list(sh["shape"]):
                        raise CheckpointCorruptionError(
                            f"checkpoint {d.name}: leaf {leaf['path']!r} "
                            f"shard rank {rank} has shape {tuple(piece.shape)} "
                            f"but the manifest records {tuple(sh['shape'])} — "
                            f"truncated shard")
                    crc = _crc(piece)
                    if crc != int(sh["crc32"]):
                        raise CheckpointCorruptionError(
                            f"checkpoint {d.name}: checksum mismatch on "
                            f"leaf {leaf['path']!r} shard rank {rank} "
                            f"(stored {int(sh['crc32']):#010x}, recomputed "
                            f"{crc:#010x}) — bit-rot or torn write")
                    piece = piece.view(bits)
                    if [list(ix) for ix in sh["index"]] == [[0, n] for n in shape]:
                        out = piece  # one piece holds the whole leaf
                        continue
                    if out is None:
                        out = np.empty(shape, bits)
                    out[tuple(slice(a, b) for a, b in sh["index"])] = piece
                arrays.append(out if out is not None else np.empty(shape, bits))
            return arrays
        finally:
            for z in zs.values():
                z.close()
            for f in files:
                f.close()

    def read_arrays(self, step: int, like: Any = None
                    ) -> Tuple[Dict[str, Tuple[np.ndarray, str]], int]:
        """Every leaf of a checkpoint, whole and verified: ``({path: (bits,
        dtype name)}, data_step)``, bf16 as ``uint16`` bits; with ``like``
        the template is checked against the manifest first. The step is
        pinned against retention while it is read."""
        d = self._step_dir(step)
        with self._read_lock:
            self._reading[step] = self._reading.get(step, 0) + 1
        try:
            try:
                manifest = self._read_manifest(d)
            except ValueError as e:
                raise CheckpointCorruptionError(
                    f"checkpoint {d.name}: torn/unparseable manifest.json ({e})") from e
            if like is not None:
                self._validate(step, manifest, like)
            arrays = self._load_arrays(d, manifest)
        finally:
            with self._read_lock:
                self._reading[step] -= 1
                if not self._reading[step]:
                    del self._reading[step]
        return ({m["path"]: (a, m["dtype"])
                 for m, a in zip(manifest["leaves"], arrays, strict=True)},
                int(manifest["data_step"]))

    def restore(self, step: int, like: Any) -> Tuple[Any, int]:
        """Restore into the structure of ``like`` (a tree of tensors and
        :class:`Piece` templates whose paths, global shapes and dtypes must
        match the manifest; a tensor gets its leaf whole, a Piece its window
        as a tensor, each on its template's device); returns (state,
        data_step)."""
        by_path, data_step = self.read_arrays(step, like)
        return map_with_path(lambda path, t: leaf_from(by_path[path], t), like), data_step

    def restore_latest(self, like: Any) -> Optional[Tuple[Any, int, int]]:
        """Restore the newest committed step, falling back to the previous
        one (with a named warning) when a checkpoint turns out unreadable or
        corrupt. Template mismatches (``_validate``'s ValueError) propagate:
        an older step would not fix them."""
        for step in reversed(self._committed_steps()):
            try:
                state, data_step = self.restore(step, like)
            except (OSError, zipfile.BadZipFile, CheckpointCorruptionError) as e:
                warnings.warn(
                    f"checkpoint step_{step:09d} is unreadable ({e}) — "
                    f"falling back to the previous committed step",
                    RuntimeWarning, stacklevel=2)
                continue
            return state, step, data_step
        return None
