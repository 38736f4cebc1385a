"""
Deterministic fault injection for the resilient loop (counterpart of the
solver half of dedalus_tpu/tools/chaos.py, :112-450).

Fault tolerance that has never seen a fault is a hypothesis. This module
injects the faults tools/resilience.py and tools/dcheckpoint.py claim to
absorb, deterministically from a seed and a config, so every recovery
branch is an ordinary reproducible test:

  * NaN poisoning of a named field at iteration N,
  * a transient OSError on the Nth checkpoint write,
  * a SIGTERM to this process at iteration N,
  * checkpoint-file truncation or corruption (`corrupt_checkpoint`),
  * ONE flipped mantissa bit of one state element at iteration N
    (`flip_bit_iteration`: seed-chosen element and bit; the value stays
    finite and plausible, so only the SDC sentinel can catch it),
  * a torn sharded-checkpoint write (`torn_shard_write` +
    `torn_after_shards`: the writer dies after K shard files, before the
    manifest commits), post-commit shard corruption (`corrupt_shard`),
    and `slow_shard_sec` to stretch writes.

The element, bit and corruption bytes come from the same numpy
generators as the JAX package's, so one seed injects the same fault in
both packages. Each armed fault fires once (a rewind replays the
triggering iteration) and is logged when it fires. Test machinery only:
never constructed by the production path.
"""

import errno
import logging
import os
import signal
import time

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["ChaosInjector", "corrupt_checkpoint", "corrupt_shard"]


def _field_slice(solver, name):
    """(offset, size) of one named state variable inside the gathered
    (G, S) pencil state."""
    from ..core.subsystems import state_key
    offset = 0
    for v in solver.variables:
        size = solver.layout.slot_size(v.domain, v.tensorsig)
        if state_key(v) == name or v.name == name:
            return offset, size
        offset += size
    raise KeyError(f"no state variable named {name!r}")


def corrupt_checkpoint(path, mode="truncate", seed=0):
    """
    Damage a checkpoint file in place the way a crash or bad disk would:
      truncate — cut the file to half length (kill mid-write: the HDF5
                 superblock/objects become unreadable),
      zero     — overwrite the middle third with zeros (silent media
                 corruption; the file may still open but datasets break),
      garbage  — overwrite the middle third with seeded random bytes.
    """
    path = os.fspath(path)
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    elif mode in ("zero", "garbage"):
        start, stop = size // 3, 2 * size // 3
        blob = (bytes(stop - start) if mode == "zero"
                else np.random.default_rng(seed).bytes(stop - start))
        with open(path, "r+b") as f:
            f.seek(start)
            f.write(blob)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    logger.warning(f"chaos: corrupted checkpoint {path} (mode={mode})")


def corrupt_shard(ckpt_dir, shard=0, mode="garbage", seed=0):
    """
    Damage one shard file of a COMMITTED sharded checkpoint
    (tools/dcheckpoint.py) the way silent media corruption would — after
    the manifest's checksums were recorded, so restore must catch it:
      garbage  — overwrite the middle third of the payload with seeded
                 random bytes (np header left intact: the file loads,
                 the blake2b mismatches — true silent corruption),
      truncate — cut the file in half (np.load fails: torn file),
      delete   — remove the shard file entirely (lost block).
    Returns the damaged file's path.
    """
    ckpt_dir = os.fspath(ckpt_dir)
    files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npy"))
    if not files:
        raise FileNotFoundError(f"no shard files under {ckpt_dir}")
    path = os.path.join(ckpt_dir, files[int(shard) % len(files)])
    size = os.path.getsize(path)
    if mode == "garbage":
        start, stop = max(size // 3, 128), max(2 * size // 3, 192)
        blob = np.random.default_rng(seed).bytes(stop - start)
        with open(path, "r+b") as f:
            f.seek(start)
            f.write(blob)
    elif mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    elif mode == "delete":
        os.remove(path)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    logger.warning(f"chaos: corrupted shard {path} (mode={mode})")
    return path


class ChaosInjector:
    """
    Seed/config-driven fault injector driven by ResilientLoop hooks
    (`before_step`/`after_step`) or attached manually. Faults:

      nan_field + nan_iteration   — poison the named field's pencil
          slice with NaN after completing iteration N (the next health
          probe sees a non-finite state).
      fail_checkpoint_write       — raise a transient OSError (EIO) on
          the Nth durable checkpoint write (1-based), succeeding on
          retry.
      sigterm_iteration           — deliver a real SIGTERM to this
          process after completing iteration N.
      flip_bit_iteration          — flip ONE seed-chosen mantissa bit of
          one element of the state after completing iteration N: silent
          data corruption (finite, plausible, invisible to the health
          probe) that only the SDC sentinel's redundant re-execution can
          detect.
      torn_shard_write + torn_after_shards — kill the Nth sharded
          checkpoint write (1-based) after K shard files have landed,
          BEFORE the manifest commits (a crash/disk-full mid-write; the
          manifest-last protocol must make the torn directory invisible
          to restore). Requires `wire_checkpointer(ckpt)` — the
          ResilientLoop wires it automatically when built with chaos.
      slow_shard_sec              — sleep after every shard file write:
          stretches checkpoint IO so async overrun barriers and
          kill-mid-write windows are deterministic, not timing luck.

    `fired` records what fired and when, for test assertions.
    """

    def __init__(self, seed=0, nan_field=None, nan_iteration=None,
                 fail_checkpoint_write=None, sigterm_iteration=None,
                 flip_bit_iteration=None, torn_shard_write=None, torn_after_shards=1,
                 slow_shard_sec=None):
        self.seed = int(seed)
        self.nan_field = nan_field
        self.nan_iteration = nan_iteration
        self.fail_checkpoint_write = fail_checkpoint_write
        self.sigterm_iteration = sigterm_iteration
        self.flip_bit_iteration = flip_bit_iteration
        self.torn_shard_write = torn_shard_write
        self.torn_after_shards = int(torn_after_shards)
        self.slow_shard_sec = slow_shard_sec
        self.fired = []
        self._checkpoint_writes = 0
        self._armed = set()
        if nan_field is not None and nan_iteration is not None:
            self._armed.add("nan")
        if sigterm_iteration is not None:
            self._armed.add("sigterm")
        if fail_checkpoint_write is not None:
            self._armed.add("io")
        if flip_bit_iteration is not None:
            self._armed.add("flip")
        if torn_shard_write is not None:
            self._armed.add("torn")

    def attach(self, loop):
        """Wire the IO fault into the loop's checkpoint path: the Nth
        write attempt raises a transient OSError BEFORE touching the
        file (retry then finds clean ground)."""
        if "io" not in self._armed:
            return
        handler_write = loop.write_checkpoint

        def chaotic_write():
            self._checkpoint_writes += 1
            if ("io" in self._armed
                    and self._checkpoint_writes == self.fail_checkpoint_write):
                self._armed.discard("io")
                self._fire("io", attempt=self._checkpoint_writes)
                raise OSError(errno.EIO, "chaos: injected transient IO fault")
            return handler_write()

        loop.write_checkpoint = chaotic_write

    def wire_checkpointer(self, checkpointer):
        """Wire the sharded-write faults into a
        dcheckpoint.ShardedCheckpointer: the per-shard hook tears the
        `torn_shard_write`-th checkpoint after `torn_after_shards` files
        (the manifest never commits) and/or sleeps `slow_shard_sec` per
        shard. Called by ResilientLoop when built with a
        chaos injector."""
        if "torn" not in self._armed and self.slow_shard_sec is None:
            return

        state = {"write": 0, "shards": 0}

        def hook(shards_written):
            if shards_written == 1:
                state["write"] += 1
            state["shards"] = shards_written
            if self.slow_shard_sec:
                time.sleep(float(self.slow_shard_sec))
            if ("torn" in self._armed
                    and state["write"] == self.torn_shard_write
                    and shards_written >= self.torn_after_shards):
                self._armed.discard("torn")
                self._fire("torn_shard", write=state["write"],
                           shards=shards_written)
                # NOT an OSError: a crash mid-write is not retryable, so
                # the fault must bypass the transient-IO RetryPolicy and
                # leave the directory exactly as the crash would
                raise RuntimeError("chaos: writer died mid-checkpoint "
                                   "(torn sharded write)")

        checkpointer.shard_hook = hook

    def _fire(self, kind, **info):
        info["kind"] = kind
        self.fired.append(info)
        logger.warning(f"chaos: fired {info}")

    # ------------------------------------------------------- loop hooks

    def before_step(self, solver):
        """No pre-step faults currently; hook kept so injectors can be
        subclassed without touching the loop."""

    def after_step(self, solver):
        it = int(solver.iteration)
        if "nan" in self._armed and it >= self.nan_iteration:
            self._armed.discard("nan")
            self.poison_field(solver, self.nan_field)
            self._fire("nan", iteration=it, field=self.nan_field)
        if "sigterm" in self._armed and it >= self.sigterm_iteration:
            self._armed.discard("sigterm")
            self._fire("sigterm", iteration=it)
            os.kill(os.getpid(), signal.SIGTERM)
        if "flip" in self._armed and it >= self.flip_bit_iteration:
            self._armed.discard("flip")
            index, bit = self.flip_bit(solver)
            self._fire("flip_bit", iteration=it, index=index, bit=bit)

    # ----------------------------------------------------- fault bodies

    def poison_field(self, solver, name):
        """Overwrite the named field's slice of the gathered state with
        NaN, on a copy of the state on the device (no host wait), as a
        diverging nonlinearity would."""
        offset, size = _field_slice(solver, name)
        X = solver.X.clone()
        X[:, offset:offset + size] = float("nan")
        solver.X = X
        # the fields' lazy pulls still reference the clean X; re-install
        # against the poisoned state so harness code sees what the
        # solver sees
        solver.defer_scatter(solver.X)
        solver.snapshot_versions()

    def flip_bit(self, solver):
        """Flip one seed-chosen mantissa bit of one element of the state:
        finite and invisible to the NaN/growth health probe, the
        canonical silent data corruption. The element and bit come from
        the injector seed (the JAX package's draws). The flip is an XOR
        on the element's bits (a complex element's real part) in a copy
        of the state on the device: no host read. Returns (index, bit)."""
        import torch
        X = solver.X
        rng = np.random.default_rng(self.seed)
        index = tuple(int(rng.integers(n)) for n in X.shape)
        itemsize = X.element_size() // (2 if X.is_complex() else 1)
        mantissa = {4: 23, 8: 52}[itemsize]
        bit = int(rng.integers(mantissa))
        X = X.clone()
        words = torch.view_as_real(X) if X.is_complex() else X
        words = words.view({4: torch.int32, 8: torch.int64}[itemsize])
        words[index + ((0,) if X.is_complex() else ())] ^= 1 << bit
        solver.X = X
        solver.defer_scatter(solver.X)
        solver.snapshot_versions()
        return index, bit
