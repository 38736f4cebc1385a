"""
Sharded, asynchronous checkpoints in the `dedalus-sharded-v1` format
(counterpart of dedalus_tpu/tools/dcheckpoint.py).

Format: one checkpoint = one directory

    ckpt_<seq>_i<iteration>/
        <name>.shard0000.npy     raw np.save of one shard's block
        MANIFEST.json            written LAST, atomically

  * **Shards.** Each array is written as its shards with their global
    indices; a tensor on one device is one shard covering the whole
    array, so a checkpoint written by the JAX package on any device count
    restores here, and the reverse, bit for bit.
  * **blake2b digests.** The manifest records a digest, the byte count
    and the global index of every shard; restore verifies each shard
    before using it.
  * **Manifest written last.** Shard files are fsync'd, then the
    manifest is committed (tmp + fsync + replace), then the directory
    entry is fsync'd. A directory without a valid manifest is torn and
    is quarantined (renamed `quarantine_*`) at restore, with a fallback
    to the previous checkpoint.
  * **Asynchronous writes.** A step writes its state in place (a
    replayed CUDA graph writes into static buffers), so a checkpoint
    cannot hold references: `ShardedCheckpointer.save` in async mode
    clones each tensor on the device, in the order of the current
    stream, records an event and returns; the background writer waits
    for that event, copies the clones to the host on a stream of its own
    and writes. No step waits for the copy. A bounded in-flight budget
    caps the clones held (a save beyond it blocks: the overrun barrier),
    and the blocked time is the step loop's only stall.

Consumer: tools/resilience.ResilientLoop (`[resilience]
CHECKPOINT_FORMAT = sharded`, `CHECKPOINT_ASYNC`). tools/chaos.py's
`torn_shard_write` and `corrupt_shard` drive the quarantine and fallback
branches.
"""

import hashlib
import json
import logging
import os
import pathlib
import re
import shutil
import threading
import time

import numpy as np

from .exceptions import CheckpointError

logger = logging.getLogger(__name__)

__all__ = ["FORMAT", "ShardedCheckpointer", "list_checkpoints",
           "load_checkpoint", "read_manifest", "restore_latest",
           "shard_blocks", "write_checkpoint"]

FORMAT = "dedalus-sharded-v1"
MANIFEST = "MANIFEST.json"
_CKPT_RE = re.compile(r"^ckpt_(\d+)(?:_i\d+)?$")
_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]+$")


def _copy_out(block):
    """Host copy of one shard as a C-contiguous numpy array (a tensor
    leaves its device here; the copy waits for that device's stream)."""
    if hasattr(block, "detach"):
        block = block.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(block))


def _digest(arr):
    """blake2b of a C-contiguous array's raw bytes."""
    return hashlib.blake2b(arr.data, digest_size=16).hexdigest()


def shard_blocks(arr):
    """`(index, host_block)` for each shard of `arr`: `index` a
    per-dimension `(start, stop)` tuple into the global shape. A tensor
    (one device) or a host array is one full-extent block."""
    a = _copy_out(arr)
    yield tuple((0, s) for s in a.shape), a


def _fsync_dir(path):
    try:
        fd = os.open(str(path), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass   # not all filesystems support directory fsync


def list_checkpoints(directory):
    """Committed-or-torn checkpoint directories under `directory`,
    oldest first by sequence number (quarantined ones excluded)."""
    directory = pathlib.Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for entry in directory.iterdir():
        m = _CKPT_RE.match(entry.name)
        if m is not None and entry.is_dir():
            out.append((int(m.group(1)), entry))
    return [path for _, path in sorted(out)]


def read_manifest(path):
    """Parse and validate one checkpoint's manifest. Raises
    CheckpointError on a missing, torn or foreign manifest (an
    uncommitted write: the manifest is written last)."""
    path = pathlib.Path(path)
    mpath = path / MANIFEST
    try:
        manifest = json.loads(mpath.read_text())
    except OSError as exc:
        raise CheckpointError(
            f"checkpoint {path} has no readable manifest (torn write?): "
            f"{exc}", path=path) from exc
    except ValueError as exc:
        raise CheckpointError(
            f"checkpoint {path} manifest is not valid JSON: {exc}",
            path=path) from exc
    if not isinstance(manifest, dict) \
            or manifest.get("format") != FORMAT \
            or not isinstance(manifest.get("arrays"), dict):
        raise CheckpointError(
            f"checkpoint {path} manifest is not a {FORMAT} manifest",
            path=path)
    return manifest


def write_checkpoint(directory, arrays, meta=None, shard_hook=None):
    """
    Write one checkpoint under `directory` (created if needed) and commit
    it manifest-last. `arrays` maps names to tensors or host arrays;
    `meta` is a JSON-able dict stored in the manifest. `shard_hook(n)`,
    when given, runs after each shard file lands (the chaos harness tears
    or slows a write with it). Returns the committed path.
    """
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    existing = list_checkpoints(directory)
    seq = 1
    if existing:
        seq = int(_CKPT_RE.match(existing[-1].name).group(1)) + 1
    iteration = int((meta or {}).get("iteration", 0))
    path = directory / f"ckpt_{seq:08d}_i{iteration:08d}"
    path.mkdir()
    manifest = {"format": FORMAT, "seq": seq, "ts": round(time.time(), 3),
                "meta": dict(meta or {}), "arrays": {}}
    shards_written = 0
    for name, arr in arrays.items():
        if not _NAME_RE.match(name):
            raise ValueError(f"unsafe checkpoint array name {name!r}")
        entry = {"shape": None, "dtype": None, "shards": []}
        for k, (index, block) in enumerate(shard_blocks(arr)):
            entry["shape"] = [int(s) for s in block.shape]
            entry["dtype"] = str(block.dtype)
            fname = f"{name}.shard{k:04d}.npy"
            with open(path / fname, "wb") as f:
                np.save(f, block)
                f.flush()
                os.fsync(f.fileno())
            entry["shards"].append({
                "file": fname,
                "index": [[int(a), int(b)] for a, b in index],
                "blake2b": _digest(block),
                "nbytes": int(block.nbytes),
            })
            shards_written += 1
            if shard_hook is not None:
                shard_hook(shards_written)
        manifest["arrays"][name] = entry
    # commit: manifest last, atomically, then the directory entry synced
    tmp = path / (MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path / MANIFEST)
    _fsync_dir(path)
    _fsync_dir(directory)
    return path


def load_checkpoint(path):
    """
    Load one committed checkpoint: the manifest, then every shard's
    blake2b digest and block shape, before assembling the global arrays.
    Returns `(arrays, meta)`, arrays as host numpy arrays. Raises
    CheckpointError naming the first bad shard.
    """
    path = pathlib.Path(path)
    manifest = read_manifest(path)
    arrays = {}
    for name, entry in manifest["arrays"].items():
        shape = tuple(entry["shape"])
        dtype = np.dtype(entry["dtype"])
        # zeros, not empty: a coverage gap must never hand back garbage,
        # and the element count below catches the gap itself
        out = np.zeros(shape, dtype)
        covered = 0
        for shard in entry["shards"]:
            fpath = path / shard["file"]
            try:
                block = np.load(fpath)
            except (OSError, ValueError) as exc:
                raise CheckpointError(
                    f"checkpoint {path}: shard {shard['file']} unreadable "
                    f"(truncated/corrupt?): {exc}", path=path) from exc
            block = np.ascontiguousarray(block)
            if _digest(block) != shard["blake2b"]:
                raise CheckpointError(
                    f"checkpoint {path}: shard {shard['file']} checksum "
                    f"mismatch (silent corruption)", path=path)
            index = tuple(slice(a, b) for a, b in shard["index"])
            expect = tuple(b - a for a, b in shard["index"])
            if block.shape != expect or block.dtype != dtype:
                raise CheckpointError(
                    f"checkpoint {path}: shard {shard['file']} "
                    f"shape/dtype {block.shape}/{block.dtype} does not "
                    f"match its manifest entry {expect}/{dtype}",
                    path=path)
            out[index] = block
            covered += block.size
        if covered != out.size:
            raise CheckpointError(
                f"checkpoint {path}: array {name!r} shards cover "
                f"{covered} of {out.size} elements (incomplete coverage)",
                path=path)
        arrays[name] = out
    return arrays, manifest.get("meta", {})


def _quarantine(path):
    """Move a torn or corrupt checkpoint aside (forensic evidence,
    excluded from later walks). Best effort."""
    target = path.parent / f"quarantine_{path.name}"
    n = 0
    while target.exists():
        n += 1
        target = path.parent / f"quarantine_{path.name}_{n}"
    try:
        path.rename(target)
        return target
    except OSError as exc:
        logger.warning(f"could not quarantine {path}: {exc}")
        return None


def restore_latest(directory, quarantine=True):
    """
    The newest valid checkpoint under `directory`: walks the sequence
    newest first, quarantining torn and checksum-failed checkpoints and
    falling back to the previous manifest. Returns `{"path", "seq",
    "arrays", "meta", "fallbacks", "validated"}`, or None when the
    directory holds no checkpoint (a fresh start). Raises CheckpointError
    when checkpoints exist but none loads.
    """
    directory = pathlib.Path(directory)
    candidates = list_checkpoints(directory)
    if not candidates:
        return None
    rejected = []
    validated = 0
    for path in reversed(candidates):
        validated += 1
        try:
            arrays, meta = load_checkpoint(path)
        except CheckpointError as exc:
            logger.warning(f"sharded checkpoint {path} rejected: {exc}")
            entry = {"path": str(path), "reason": str(exc)}
            if quarantine:
                moved = _quarantine(path)
                if moved is not None:
                    entry["quarantined"] = str(moved)
            rejected.append(entry)
            continue
        seq = int(_CKPT_RE.match(path.name).group(1))
        logger.info(
            f"restored sharded checkpoint {path} (seq {seq})"
            + (f" after skipping {len(rejected)} bad checkpoint(s)"
               if rejected else ""))
        return {"path": str(path), "seq": seq, "arrays": arrays,
                "meta": meta, "fallbacks": rejected, "validated": validated}
    raise CheckpointError(
        f"no loadable sharded checkpoint under {directory} "
        f"({len(rejected)} rejected: "
        f"{'; '.join(r['reason'] for r in rejected)})", path=directory)


def _device_copies(arrays):
    """Clones of the tensors of `arrays` in the order of their device's
    current stream, and an event recorded after them (None when no
    tensor is on a CUDA device). Host values pass through."""
    out = {}
    event = None
    for name, arr in arrays.items():
        if hasattr(arr, "detach"):
            arr = arr.detach().clone()
            if arr.is_cuda and event is None:
                import torch
                event = torch.cuda.Event()
        out[name] = arr
    if event is not None:
        event.record()
    return out, event


class ShardedCheckpointer:
    """
    Write side (dedalus_tpu/tools/dcheckpoint.py:381): sequential
    checkpoints under one directory, synchronous or asynchronous, with
    bounded retention.

    Async mode: `save(arrays, meta)` clones the tensors on the device,
    enqueues the job and returns; the writer thread waits for the clones'
    event, copies them to the host on its own stream and writes. A save
    beyond the in-flight budget blocks until the writer catches up (the
    overrun barrier). `stall_sec` sums the time every save held its
    caller (sync mode: the whole write); `max_inflight` records the
    deepest queue seen.

    A write that dies leaves a manifest-less directory (harmless by the
    commit protocol) and lands in `errors`; `drain()` waits for the queue
    and returns the errors so far. Writer exceptions never reach the
    step loop. `io_retry` (a tools/resilience.RetryPolicy) wraps each
    whole commit.
    """

    def __init__(self, directory, async_write=False, inflight=2, keep=2,
                 io_retry=None, shard_hook=None):
        self.directory = pathlib.Path(directory)
        self.async_write = bool(async_write)
        self.inflight = max(int(inflight), 1)
        self.keep = max(int(keep), 1)
        self.io_retry = io_retry
        self.shard_hook = shard_hook
        self.written = 0
        self.submitted = 0
        self.stall_sec = 0.0
        self.max_inflight = 0
        self.bytes_written = 0
        self.errors = []
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._drained = threading.Condition(self._lock)
        self._pending = []
        self._closed = False
        self._thread = None
        self._copy_stream = None

    # ------------------------------------------------------------- write

    def _commit(self, arrays, meta):
        def write():
            return write_checkpoint(self.directory, arrays, meta,
                                    shard_hook=self.shard_hook)
        try:
            if self.io_retry is not None:
                path = self.io_retry.call(write, label="sharded checkpoint")
            else:
                path = write()
        except Exception as exc:
            logger.error(f"sharded checkpoint write failed: {exc}")
            self.errors.append(exc)
            return None
        self.written += 1
        self.bytes_written += sum(
            s["nbytes"] for e in read_manifest(path)["arrays"].values()
            for s in e["shards"])
        self._prune()
        return path

    def _prune(self):
        """Retention: keep the newest `keep` committed checkpoints, and
        drop uncommitted directories older than the newest committed
        one."""
        committed = [p for p in list_checkpoints(self.directory)
                     if (p / MANIFEST).exists()]
        for path in committed[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)
        if committed:
            newest = committed[-1].name
            for path in list_checkpoints(self.directory):
                if not (path / MANIFEST).exists() and path.name < newest:
                    shutil.rmtree(path, ignore_errors=True)

    def _host_arrays(self, arrays, event):
        """The job's clones on the host: wait for their event, then copy
        on the writer's own stream (no step waits for it)."""
        if event is None:
            return {k: _copy_out(v) for k, v in arrays.items()}
        import torch
        event.synchronize()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream()
        with torch.cuda.stream(self._copy_stream):
            return {k: _copy_out(v) for k, v in arrays.items()}

    def _worker(self):
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._drained.wait(timeout=0.5)
                if not self._pending:
                    if self._closed:
                        return
                    continue
                arrays, meta, event = self._pending[0]
            try:
                host = self._host_arrays(arrays, event)
            except Exception as exc:
                logger.error(f"sharded checkpoint copy-out failed: {exc}")
                self.errors.append(exc)
                host = None
            del arrays
            if host is not None:
                self._commit(host, meta)
            with self._lock:
                self._pending.pop(0)
                self._not_full.notify_all()
                self._drained.notify_all()

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            with self._lock:
                self._closed = False
            self._thread = threading.Thread(
                target=self._worker, name="dcheckpoint-writer", daemon=True)
            self._thread.start()

    def save(self, arrays, meta=None):
        """Write (sync) or enqueue (async) one checkpoint. Returns the
        committed path in sync mode, None in async mode (drain() before
        trusting durability)."""
        meta = dict(meta or {})
        t0 = time.perf_counter()
        self.submitted += 1
        if not self.async_write:
            path = self._commit(dict(arrays), meta)
            self.stall_sec += time.perf_counter() - t0
            if path is None and self.errors:
                # synchronous callers see the failure; async ones get it
                # from drain()/close()
                raise self.errors[-1]
            return path
        self._ensure_thread()
        with self._not_full:
            while len(self._pending) >= self.inflight:
                self._not_full.wait()   # the overrun barrier
        copies, event = _device_copies(arrays)
        with self._lock:
            self._pending.append((copies, meta, event))
            self.max_inflight = max(self.max_inflight, len(self._pending))
            self._drained.notify_all()
        del copies
        self.stall_sec += time.perf_counter() - t0
        return None

    def drain(self, timeout=60.0):
        """Block until every enqueued checkpoint has committed (or
        `timeout` expires). Returns the accumulated write errors."""
        deadline = time.monotonic() + float(timeout)
        with self._drained:
            while self._pending:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    logger.warning(
                        f"checkpoint drain timed out with "
                        f"{len(self._pending)} write(s) still pending")
                    break
                self._drained.wait(timeout=min(remaining, 0.5))
        return list(self.errors)

    def close(self, timeout=60.0):
        """Drain and stop the writer thread."""
        errors = self.drain(timeout=timeout)
        with self._lock:
            self._closed = True
            self._drained.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        return errors

    @property
    def pending(self):
        with self._lock:
            return len(self._pending)

    def summary(self):
        """Compact stats block for telemetry records."""
        return {
            "format": "sharded",
            "async": self.async_write,
            "written": self.written,
            "submitted": self.submitted,
            "stall_sec": round(self.stall_sec, 6),
            "max_inflight": self.max_inflight,
            "bytes_written": self.bytes_written,
            "errors": len(self.errors),
        }
