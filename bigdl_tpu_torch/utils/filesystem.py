"""URI-scheme filesystem dispatch for checkpoints (counterpart of
`bigdl_tpu/utils/filesystem.py`).

The port covers plain local paths, `file://` URIs and `memory://`, an
in-process store that stands in for a remote one in tests. Any other
scheme (`hdfs://`, `s3://`, `gs://`) raises `ImportError` at its first
operation, as the reference does when the scheme's backend is not
installed, and the IO retry policy classifies that as permanent.

Every operation on a `memory://` path runs under the IO `RetryPolicy`
(`io_retry_policy`, swapped with `set_io_retry_policy`) and passes the
`fs.remote_io` fault site on each attempt, as the reference's remote
operations do. Local paths bypass both.
"""

from __future__ import annotations

import fnmatch
import io
import os
import posixpath
import threading
from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.resilience import faults

_IO_RETRY = None


def io_retry_policy():
    """The RetryPolicy of remote operations (3 retries, 0.2 s base
    full-jitter backoff, 5 s cap). Beyond the defaults, ImportError (a
    missing backend) and FileNotFoundError (a definitive answer) are
    permanent."""
    global _IO_RETRY
    if _IO_RETRY is None:
        from bigdl_tpu_torch.resilience.retry import (DEFAULT_PERMANENT,
                                                      RetryPolicy)
        _IO_RETRY = RetryPolicy(
            max_retries=3, base_delay_s=0.2, max_delay_s=5.0,
            permanent=DEFAULT_PERMANENT + (ImportError,
                                           FileNotFoundError),
            name="fs.remote_io")
    return _IO_RETRY


def set_io_retry_policy(policy) -> None:
    """Replace the remote-IO RetryPolicy (None restores the default)."""
    global _IO_RETRY
    _IO_RETRY = policy


def _remote(op: str, path, fn):
    """One remote call under the IO retry policy, through the
    `fs.remote_io` fault site on every attempt."""
    def attempt():
        faults.fire("fs.remote_io", op=op, path=str(path))
        return fn()
    return io_retry_policy().call(attempt)


def is_uri(path: str) -> bool:
    """True for scheme-qualified paths (``scheme://...``)."""
    return "://" in str(path)


def _split(path: str) -> Tuple[Optional[str], str]:
    """(scheme or None, the path within its filesystem)."""
    path = str(path)
    if not is_uri(path):
        return None, path
    scheme, rest = path.split("://", 1)
    scheme = scheme.lower()
    if scheme == "file":
        return None, "/" + rest.lstrip("/")
    return scheme, path


class _MemoryFS:
    """The `memory://` store: files as bytes under normalised posix keys
    ("/a/b"), plus the set of directories. One lock guards both."""

    def __init__(self):
        self.files: Dict[str, bytes] = {}
        self.dirs = {"/"}
        self.lock = threading.Lock()

    @staticmethod
    def key(path: str) -> str:
        rest = str(path).split("://", 1)[-1]
        return posixpath.normpath("/" + rest.lstrip("/"))

    def _parents(self, key: str):
        while key != "/":
            key = posixpath.dirname(key)
            yield key

    def exists(self, key):
        return key in self.files or key in self.dirs

    def isdir(self, key):
        return key in self.dirs

    def makedirs(self, key, exist_ok=True):
        with self.lock:
            if key in self.files:
                raise FileExistsError(key)
            if key in self.dirs and not exist_ok:
                raise FileExistsError(key)
            self.dirs.add(key)
            self.dirs.update(self._parents(key))

    def listdir(self, key):
        with self.lock:
            if key not in self.dirs:
                raise FileNotFoundError(key)
            children = {p for p in list(self.files) + list(self.dirs)
                        if p != key and posixpath.dirname(p) == key}
        return sorted(posixpath.basename(p) for p in children)

    def read(self, key) -> bytes:
        with self.lock:
            if key not in self.files:
                raise FileNotFoundError(key)
            return self.files[key]

    def write(self, key, data: bytes):
        with self.lock:
            parent = posixpath.dirname(key)
            if parent not in self.dirs:
                raise FileNotFoundError(parent)
            self.files[key] = data

    def remove(self, key):
        with self.lock:
            if key not in self.files:
                raise FileNotFoundError(key)
            del self.files[key]

    def _under(self, key):
        pre = key.rstrip("/") + "/"
        return ([p for p in self.files if p.startswith(pre)],
                [d for d in self.dirs if d.startswith(pre)])

    def rmtree(self, key):
        with self.lock:
            if key not in self.dirs:
                raise FileNotFoundError(key)
            files, dirs = self._under(key)
            for p in files:
                del self.files[p]
            self.dirs.difference_update(dirs)
            self.dirs.discard(key)

    def rename(self, src, dst):
        """Move a file or a directory tree at once (under the lock)."""
        with self.lock:
            if src in self.files:
                self.files[dst] = self.files.pop(src)
                return
            if src not in self.dirs:
                raise FileNotFoundError(src)
            files, dirs = self._under(src)
            for p in files:
                self.files[dst + p[len(src):]] = self.files.pop(p)
            for d in dirs:
                self.dirs.discard(d)
                self.dirs.add(dst + d[len(src):])
            self.dirs.discard(src)
            self.dirs.add(dst)
            self.dirs.update(self._parents(dst))

    def glob(self, key):
        """Paths matching `key`, one path component per pattern component
        (a wildcard never crosses a "/")."""
        want = key.split("/")
        with self.lock:
            names = list(self.files) + list(self.dirs)
        return sorted(p for p in names if len(p.split("/")) == len(want)
                      and all(fnmatch.fnmatchcase(a, b)
                              for a, b in zip(p.split("/"), want)))


_MEMORY = _MemoryFS()


class _MemoryWriter(io.BytesIO):
    """A binary file on the memory store, published at close."""

    def __init__(self, key: str):
        super().__init__()
        self._key = key

    def close(self):
        if not self.closed:
            _MEMORY.write(self._key, self.getvalue())
        super().close()


def _fs(scheme: str) -> _MemoryFS:
    """The store for a scheme: `memory://`, or an ImportError naming the
    backend that is missing, as the reference raises."""
    if scheme == "memory":
        return _MEMORY
    raise ImportError(
        f"URI scheme {scheme}:// needs a filesystem backend that is not "
        f"installed; local file paths and memory:// need nothing extra")


def join(base: str, *parts: str) -> str:
    """Path join that keeps URI schemes intact."""
    scheme, _ = _split(base)
    if scheme is None:
        return os.path.join(base, *parts)
    return posixpath.join(str(base), *parts)


def open_file(path: str, mode: str = "rb"):
    scheme, local = _split(path)
    if scheme is None:
        return open(local, mode)

    def op():
        fs, key = _fs(scheme), _MemoryFS.key(path)
        if "w" in mode:
            f = _MemoryWriter(key)
        else:
            f = io.BytesIO(fs.read(key))
        return f if "b" in mode else io.TextIOWrapper(f, encoding="utf-8")
    return _remote("open", path, op)


def exists(path: str) -> bool:
    scheme, local = _split(path)
    if scheme is None:
        return os.path.exists(local)
    return _remote("exists", path,
                   lambda: _fs(scheme).exists(_MemoryFS.key(path)))


def isdir(path: str) -> bool:
    scheme, local = _split(path)
    if scheme is None:
        return os.path.isdir(local)
    return _remote("isdir", path,
                   lambda: _fs(scheme).isdir(_MemoryFS.key(path)))


def makedirs(path: str, exist_ok: bool = True) -> None:
    scheme, local = _split(path)
    if scheme is None:
        os.makedirs(local, exist_ok=exist_ok)
    else:
        _remote("makedirs", path, lambda: _fs(scheme).makedirs(
            _MemoryFS.key(path), exist_ok=exist_ok))


def listdir(path: str) -> List[str]:
    """Child basenames, as os.listdir gives them."""
    scheme, local = _split(path)
    if scheme is None:
        return os.listdir(local)
    return _remote("listdir", path,
                   lambda: _fs(scheme).listdir(_MemoryFS.key(path)))


def remove(path: str) -> None:
    scheme, local = _split(path)
    if scheme is None:
        os.remove(local)
    else:
        _remote("remove", path,
                lambda: _fs(scheme).remove(_MemoryFS.key(path)))


def rename(src: str, dst: str) -> None:
    """Rename a file or a directory tree. Locally os.rename, atomic within
    a filesystem, which makes the checkpoint's commit-by-rename durable;
    on the memory store one step under its lock."""
    scheme, local_src = _split(src)
    _, local_dst = _split(dst)
    if scheme is None:
        os.rename(local_src, local_dst)
        return
    _remote("rename", src, lambda: _fs(scheme).rename(
        _MemoryFS.key(src), _MemoryFS.key(dst)))


def rmtree(path: str) -> None:
    """Remove a directory tree."""
    scheme, local = _split(path)
    if scheme is None:
        import shutil
        shutil.rmtree(local)
    else:
        _remote("rmtree", path,
                lambda: _fs(scheme).rmtree(_MemoryFS.key(path)))


def glob(pattern: str) -> List[str]:
    """Scheme-aware glob; remote results keep their scheme prefix."""
    scheme, local = _split(pattern)
    if scheme is None:
        import glob as _glob
        return sorted(_glob.glob(local))
    keys = _remote("glob", pattern,
                   lambda: _fs(scheme).glob(_MemoryFS.key(pattern)))
    return [f"{scheme}://{k}" for k in keys]
