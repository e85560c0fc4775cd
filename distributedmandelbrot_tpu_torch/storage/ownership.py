"""Per-level ownership locks for a data directory.

The reference keeps a process-global claimed-levels set so two
Distributers can never serve the same level (``Distributer.cs:14,109-115``)
— but that guard lives in one process's memory.  Here coordinators are
independent processes that may be pointed at the same data directory, so
the claim is an OS-level ``flock`` on a per-level file inside ``Data/``:
a second coordinator claiming an overlapping level fails loudly at
startup instead of silently duplicating work and index entries.

``flock`` rather than pid files: the kernel drops the lock the instant
the owning process dies, so there is no stale-lock state and no
reclaim logic to race (a pid-file scheme needs read-check-unlink, and
two concurrent claimants reclaiming the same stale file can both
"win").  The lock file itself is never unlinked — unlinking a path
others may be flocking reintroduces exactly that race (lock-by-inode vs
claim-by-path).  The owning pid is written into the file purely for the
error message.  Caveat: flock is advisory and historically unreliable
on NFS; the data dir is expected to be a local filesystem (the
reference makes the same assumption for its index file locking).
"""

from __future__ import annotations

import errno
import fcntl
import logging
import os

logger = logging.getLogger("dmtpu.storage")


class LevelOwnedError(RuntimeError):
    """Another live coordinator already owns one of the requested levels."""


def _lock_path(data_dir: str, level: int, namespace: str = "") -> str:
    return os.path.join(data_dir, f"_level_{level}{namespace}.lock")


class LevelClaims:
    """Holds flocks on the coordinator's level files; release() on stop.

    ``namespace`` scopes the claim to one ring shard: N sharded
    coordinators legitimately share every level of one data directory
    (each owning a disjoint keyspace slice), so each claims
    ``_level_<n>-sKofN.lock`` — exclusive against a restarted self,
    not against its peers or against differently-sharded launches.
    """

    def __init__(self, data_dir: str, levels: list[int], *,
                 namespace: str = "") -> None:
        self.data_dir = data_dir
        self.namespace = namespace
        self._fds: dict[int, int] = {}
        try:
            for level in levels:
                self._claim_one(level)
        except BaseException:
            self.release()
            raise

    def _claim_one(self, level: int) -> None:
        path = _lock_path(self.data_dir, level, self.namespace)
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            owner = self._read_owner(fd)
            os.close(fd)
            if e.errno not in (errno.EACCES, errno.EAGAIN):
                raise
            raise LevelOwnedError(
                f"level {level} is already owned by a live coordinator"
                + (f" (pid {owner})" if owner else "")
                + f" — lock {path}; two coordinators on one data "
                "directory would duplicate work and index entries"
            ) from None
        # Register BEFORE the diagnostic pid write: if the write failed
        # (e.g. disk full) with the fd unregistered, release() could
        # never drop the flock and the level would stay locked for the
        # life of this process.  Ownership is the flock, not the content.
        self._fds[level] = fd
        try:
            os.ftruncate(fd, 0)
            os.write(fd, str(os.getpid()).encode())
        except OSError:
            logger.warning("could not record pid in %s (lock still held)",
                           path, exc_info=True)

    @staticmethod
    def _read_owner(fd: int) -> int | None:
        try:
            data = os.pread(fd, 64, 0)
            pid = int(data.decode().strip())
            return pid if pid > 0 else None
        except (OSError, ValueError):
            return None

    def release(self) -> None:
        """Drop every held flock (idempotent; the files stay behind —
        see the module docstring for why they are never unlinked)."""
        for level, fd in list(self._fds.items()):
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            except OSError:
                pass
            try:
                os.close(fd)
            except OSError:
                pass
            del self._fds[level]
