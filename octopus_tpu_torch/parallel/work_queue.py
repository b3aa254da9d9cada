"""Multi-host region work queue.

The reference has no distributed backend (SURVEY.md section 2.15); its
documented scale-out is per-region multi-process runs merged afterwards.
This module makes that first-class for TPU pods: genome windows become
tasks in a queue coordinated through the shared filesystem (the natural
DCN-adjacent channel for preemptible pod jobs) — each host atomically
claims tasks, writes its shard, and marks completion; any host (or a rerun
after preemption) can finish the merge.  Static `--shard-index/--num-shards`
striping is also supported for schedulers that prefer fixed partitions.
"""

from __future__ import annotations

import json
import os
import socket
import time
from dataclasses import dataclass


@dataclass
class Task:
    key: str
    payload: dict


class RegionWorkQueue:
    def __init__(self, directory: str, worker_id: str | None = None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.worker_id = worker_id or f"{socket.gethostname()}.{os.getpid()}"

    def _claim_path(self, key: str) -> str:
        return os.path.join(self.dir, key + ".claim")

    def _done_path(self, key: str) -> str:
        return os.path.join(self.dir, key + ".done")

    def try_claim(self, key: str, stale_after_s: float = 3600.0) -> bool:
        """Atomically claim a task; reclaims stale leases (preempted hosts)."""
        if os.path.exists(self._done_path(key)):
            return False
        path = self._claim_path(key)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                age = time.time() - os.path.getmtime(path)
            except OSError:
                return False
            if age < stale_after_s:
                return False
            # stale lease: steal by rewriting (last writer wins; completion
            # markers are the source of truth, so double work is safe)
            try:
                with open(path, "w") as fh:
                    fh.write(self.worker_id)
                return True
            except OSError:
                return False
        with os.fdopen(fd, "w") as fh:
            fh.write(self.worker_id)
        return True

    def mark_done(self, key: str, result: dict | None = None) -> None:
        tmp = self._done_path(key) + f".tmp.{self.worker_id}"
        with open(tmp, "w") as fh:
            json.dump({"worker": self.worker_id, "result": result or {}}, fh)
        os.replace(tmp, self._done_path(key))

    def is_done(self, key: str) -> bool:
        return os.path.exists(self._done_path(key))

    def result(self, key: str) -> dict | None:
        try:
            return json.load(open(self._done_path(key)))
        except OSError:
            return None

    def pending(self, keys: list[str]) -> list[str]:
        return [k for k in keys if not self.is_done(k)]

    def wait_all(self, keys: list[str], poll_s: float = 2.0,
                 timeout_s: float | None = None) -> bool:
        t0 = time.time()
        while True:
            if all(self.is_done(k) for k in keys):
                return True
            if timeout_s is not None and time.time() - t0 > timeout_s:
                return False
            time.sleep(poll_s)


def stripe(keys: list[str], shard_index: int, num_shards: int) -> list[str]:
    """Static partition of tasks across hosts."""
    return [k for i, k in enumerate(keys) if i % num_shards == shard_index]


__all__ = ["RegionWorkQueue", "Task", "stripe"]
