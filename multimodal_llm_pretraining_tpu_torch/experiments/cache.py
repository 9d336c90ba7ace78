"""Content-addressed step cache (counterpart of ``experiments/cache.py``).

The method search caches every step of every experiment, keyed by a hash of
the function's name, its version and its arguments, so that a sweep resumes
where it stopped:

- ``@step(cacheable=True, version="001")`` turns a function into a lazy
  ``StepCall`` factory.
- A StepCall's unique id hashes (name, version, the arguments' stable
  reprs); a StepCall argument enters by its own id (graph hashing), so a
  step runs again when its version or any input upstream changes.
- Results are pickled (the standard library's ``pickle``) under
  ``$MLPT_WORKSPACE_DIR/torch``: a directory of its own inside the one the
  JAX package uses, so that TPU and GPU results never share a file. Without
  the variable the workspace is in memory.

A failed step is cached as a ``StepFailure`` carrying its cause. The JAX
package leaves an ``InfrastructureError`` (a remote TPU backend's fault)
uncached; the port has no such backend, so every failure is the arm's.
"""

import dataclasses
import functools
import hashlib
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Callable

from ..utils import get_logger

logger = get_logger()

WORKSPACE_SUBDIR = "torch"


@dataclass(frozen=True)
class StepFailure:
    """Cached record of a failed step: its exception's class and message, so
    that ``Sweep.results()`` says why, and "failed" differs from "not yet
    run"."""

    error_type: str
    message: str

    def __repr__(self) -> str:  # keep cache keys and tables readable
        return f"StepFailure({self.error_type}: {self.message[:120]})"


class StepAlreadyRunning(Exception):
    """Another live process holds this step's running claim."""


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def stable_repr(value: Any) -> str:
    """Deterministic repr for hashing: a dataclass hashes by its repr, with
    the fields marked ``cache_omit_default`` left out while they hold their
    declared default, so that a search dimension added later re-keys only
    the arms that set it."""
    if isinstance(value, StepCall):
        return f"StepCall({value.unique_id()})"
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        parts = []
        for f in dataclasses.fields(value):
            if not f.repr:
                continue
            v = getattr(value, f.name)
            if f.metadata.get("cache_omit_default") and f.default is not dataclasses.MISSING and v == f.default:
                continue
            parts.append(f"{f.name}={stable_repr(v)}")
        return f"{type(value).__name__}({', '.join(parts)})"
    if isinstance(value, dict):
        return "{" + ",".join(f"{stable_repr(k)}:{stable_repr(v)}"
                              for k, v in sorted(value.items(), key=lambda kv: str(kv[0]))) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ",".join(stable_repr(v) for v in value) + "]"
    return repr(value)


class Workspace:
    """Directory-backed result store."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, uid: str) -> str:
        return os.path.join(self.root, uid + ".pkl")

    def contains(self, uid: str) -> bool:
        return os.path.exists(self._path(uid))

    def load(self, uid: str) -> Any:
        with open(self._path(uid), "rb") as f:
            return pickle.load(f)

    def store(self, uid: str, result: Any) -> None:
        tmp = self._path(uid) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, self._path(uid))

    def release(self, uid: str) -> None:
        """Drop this process's running claim on ``uid``."""
        try:
            os.remove(self._path(uid) + ".running")
        except FileNotFoundError:
            pass

    def _holder(self, uid: str) -> int | None:
        try:
            with open(self._path(uid) + ".running") as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            return None

    def try_claim(self, uid: str) -> bool:
        """Atomically claim ``uid`` for this process. False when a live other
        process holds the claim; a claim left by a process that died is
        taken over."""
        p = self._path(uid) + ".running"
        for _ in range(16):
            try:
                fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                return True
            except FileExistsError:
                pid = self._holder(uid)
                if pid is not None and pid != os.getpid() and _pid_alive(pid):
                    return False
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
        return False

    def is_running(self, uid: str) -> bool:
        pid = self._holder(uid)
        return pid is not None and _pid_alive(pid)


class MemoryWorkspace(Workspace):
    def __init__(self):
        self._data: dict[str, Any] = {}
        self._running: set[str] = set()

    def contains(self, uid):
        return uid in self._data

    def load(self, uid):
        return self._data[uid]

    def store(self, uid, result):
        self._data[uid] = result

    def release(self, uid):
        self._running.discard(uid)

    def try_claim(self, uid):
        if uid in self._running:
            return False
        self._running.add(uid)
        return True

    def is_running(self, uid):
        return uid in self._running


_default_workspace: Workspace | None = None


def get_workspace() -> Workspace:
    """The workspace in ``$MLPT_WORKSPACE_DIR/torch``, or in memory without
    the variable."""
    global _default_workspace
    if _default_workspace is None:
        root = os.environ.get("MLPT_WORKSPACE_DIR")
        _default_workspace = Workspace(os.path.join(root, WORKSPACE_SUBDIR)) if root else MemoryWorkspace()
    return _default_workspace


def set_workspace(ws: Workspace) -> None:
    global _default_workspace
    _default_workspace = ws


@dataclass
class StepCall:
    fn: Callable
    name: str
    version: str
    cacheable: bool
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)

    def unique_id(self) -> str:
        payload = f"{self.name}|{self.version}|{stable_repr(self.args)}|{stable_repr(self.kwargs)}"
        return f"{self.name}-{self.version}-" + hashlib.sha256(payload.encode()).hexdigest()[:16]

    def is_cached(self, workspace: Workspace | None = None) -> bool:
        ws = workspace or get_workspace()
        return self.cacheable and ws.contains(self.unique_id())

    def is_running(self, workspace: Workspace | None = None) -> bool:
        ws = workspace or get_workspace()
        return ws.is_running(self.unique_id())

    def result(self, workspace: Workspace | None = None, record_failure: bool = False) -> Any:
        ws = workspace or get_workspace()
        uid = self.unique_id()
        if self.cacheable and ws.contains(uid):
            return ws.load(uid)
        resolved_args = tuple(a.result(ws, record_failure) if isinstance(a, StepCall) else a for a in self.args)
        resolved_kwargs = {k: (v.result(ws, record_failure) if isinstance(v, StepCall) else v)
                           for k, v in self.kwargs.items()}
        # a failed upstream step fails this one too, and the failure is
        # cached, so the whole graph ends "failed", never half run
        upstream = [v for v in (*resolved_args, *resolved_kwargs.values()) if isinstance(v, StepFailure)]
        if upstream:
            failure = StepFailure("UpstreamStepFailure", f"{upstream[0].error_type}: {upstream[0].message}")
            if self.cacheable:
                ws.store(uid, failure)
            return failure
        if not ws.try_claim(uid):
            raise StepAlreadyRunning(uid)
        logger.info(f"Running step {uid}")
        try:
            out = self.fn(*resolved_args, **resolved_kwargs)
        except Exception as e:
            if record_failure and self.cacheable:
                ws.store(uid, StepFailure(type(e).__name__, str(e)))
            raise
        finally:
            ws.release(uid)
        if self.cacheable:
            ws.store(uid, out)
        return out


def step(cacheable: bool = True, version: str = "001"):
    """Decorator: calling the function builds a lazy, cacheable StepCall."""

    def decorate(fn: Callable):
        @functools.wraps(fn)
        def make(*args, **kwargs) -> StepCall:
            return StepCall(fn=fn, name=fn.__name__, version=version, cacheable=cacheable, args=args, kwargs=kwargs)

        make.__wrapped_step__ = fn  # type: ignore[attr-defined]
        return make

    return decorate
