"""The serve→train loop (counterpart of ``sheeprl_tpu/serve/flywheel.py``).

Every :class:`~sheeprl_tpu_torch.serve.server.PolicyServer` replica logs its
served ``(obs, action, reward feedback, done)`` rows into a shared spool
directory; a supervised **learner process** (``run --from-serve <dir>``)
tails the spools, trains on the rows through the algorithm's registered
learner-ingest (SAC: the device ring and its resident train step,
:mod:`sheeprl_tpu_torch.algos.sac.flywheel`), and publishes checkpoints back
into the served checkpoint directory, where the servers' watchers adopt them.

Serving never degrades because learning is slow, wedged or dead:

- **logging is best-effort and counted**: the scheduler worker stages each
  completed transition into a preallocated block ring; a writer thread
  drains shipped blocks to disk; with no free block or a full transport
  queue the staged rows are SHED (``rows_shed``), never waited for, and a
  logging error of any kind is counted, not raised;
- **feedback pairs on the server**: a request's ``reward``/``done`` grade the
  PREVIOUS action of its stream (a session, a connection, an in-process
  client); the transition is ``(prev_obs, prev_action, reward, done,
  next_obs=obs)``; requests without feedback serve as before and their rows
  count ``feedback_missing``;
- **the learner is a supervised process**: its heartbeat is the mtime of the
  ``learner_status.json`` it rewrites every pass and every frame it trains
  on, so a SIGSTOPped learner
  misses its lease and is SIGKILLed and respawned
  (:class:`LearnerSupervisor`, the ``kill-learner``/``hang-learner`` drills)
  while serving goes on.

Spool format, byte for byte the JAX package's (one file per replica
generation, ``<replica>.<pid>.spool``): a JSON header line, then frames of
``<III`` (magic, n_rows, payload bytes) followed by ``n_rows`` rows of
``row_width`` float32, each row ``[obs, action, reward, done, next_obs]``.
The reader tails files by offset, attributes rows to the header's replica,
waits out torn tails and quarantines a corrupt file.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "FlywheelConfigError",
    "TrajectoryLog",
    "SpoolReader",
    "flywheel_row_width",
    "split_rows",
    "read_learner_status",
    "write_learner_status",
    "learner_command",
    "LearnerSupervisor",
    "run_flywheel_learner",
    "SPOOL_MAGIC",
    "FRAME_MAGIC",
    "ROW_KEYS",
]

SPOOL_MAGIC = "sheeprl-flywheel/1"
SPOOL_SUFFIX = ".spool"
FRAME_MAGIC = 0x57594C46  # "FLYW"
_FRAME = struct.Struct("<III")  # magic, n_rows, payload bytes
STATUS_NAME = "learner_status.json"
#: the row's columns, in order: the SAC ring's keys
ROW_KEYS = ("observations", "actions", "rewards", "terminated", "next_observations")


class FlywheelConfigError(ValueError):
    """``serve.flywheel`` enabled for an algorithm without a registered
    learner-ingest, or without a usable spool directory; raised when the
    server is built, before a socket binds."""


def flywheel_row_width(obs_dim: int, act_dim: int) -> int:
    """Columns of one logged transition: obs + action + reward + done + next_obs."""
    return 2 * int(obs_dim) + int(act_dim) + 2


def split_rows(rows: np.ndarray, obs_dim: int, act_dim: int) -> Dict[str, np.ndarray]:
    """``(m, row_width)`` float32 rows -> the ring's column dict."""
    od, ad = int(obs_dim), int(act_dim)
    return {
        "observations": rows[:, :od],
        "actions": rows[:, od : od + ad],
        "rewards": rows[:, od + ad : od + ad + 1],
        "terminated": rows[:, od + ad + 1 : od + ad + 2],
        "next_observations": rows[:, od + ad + 2 :],
    }


# -- the server side: the trajectory log -------------------------------------------
class TrajectoryLog:
    """One replica's staging and spool writer.

    The scheduler worker calls :meth:`observe` after resolving a request.
    Completed transitions go into a block of a fixed ring (``queue_blocks +
    2`` blocks of ``block_rows`` rows: a block in the transport queue is
    never written); full blocks ship through a bounded queue to the writer
    thread. No free block or a full queue sheds the staged rows, counted.
    ``observe`` never raises: a failure counts ``errors`` and returns."""

    def __init__(self, directory: "str | Path", obs_spec: Dict[str, Tuple[tuple, Any]], action_dim: int, *,
                 replica: str = "replica", block_rows: int = 256, queue_blocks: int = 8, flush_s: float = 0.25,
                 max_streams: int = 4096) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.replica = str(replica)
        self._keys = tuple(sorted(obs_spec))
        self.obs_dim = int(sum(int(np.prod(shape)) for shape, _ in obs_spec.values()))
        self.act_dim = int(action_dim)
        self.row_width = flywheel_row_width(self.obs_dim, self.act_dim)
        self.block_rows = max(1, int(block_rows))
        self.flush_s = float(flush_s)
        self.max_streams = max(1, int(max_streams))

        base = f"{self.replica}.{os.getpid()}"
        path = self.directory / (base + SPOOL_SUFFIX)
        i = 1
        while path.exists():  # the same replica and pid opened again in-process
            path = self.directory / f"{base}.{i}{SPOOL_SUFFIX}"
            i += 1
        self.path = path
        self._file = open(self.path, "wb")
        header = {"magic": SPOOL_MAGIC, "replica": self.replica, "row_width": self.row_width,
                  "obs_dim": self.obs_dim, "act_dim": self.act_dim, "keys": list(ROW_KEYS)}
        self._file.write((json.dumps(header) + "\n").encode())
        self._file.flush()

        n_blocks = max(2, int(queue_blocks)) + 2
        self._free: "collections.deque[np.ndarray]" = collections.deque(
            np.empty((self.block_rows, self.row_width), np.float32) for _ in range(n_blocks)
        )
        self._q: "queue.Queue[Tuple[np.ndarray, int]]" = queue.Queue(maxsize=max(2, int(queue_blocks)))
        self._cur = self._free.popleft()
        self._cursor = 0
        self._last_ship = time.monotonic()
        self._pending: "collections.OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "rows_logged": 0,
            "rows_shed": 0,
            "blocks_shed": 0,
            "blocks_shipped": 0,
            "feedback_missing": 0,
            "feedback_orphans": 0,
            "rows_spooled": 0,
            "frames": 0,
            "spool_bytes": 0,
            "errors": 0,
        }
        self._stop = threading.Event()
        self._closed = False
        self._writer = threading.Thread(target=self._writer_loop, name="flywheel-spool", daemon=True)
        self._writer.start()

    # -- the scheduler's hook ----------------------------------------------------
    def observe(self, obs: Dict[str, np.ndarray], n: int, actions: Any, reward: Any, done: Any,
                stream: Optional[str]) -> None:
        """Pair this request with its stream's pending action and stage the
        completed transitions. Never raises (errors are counted)."""
        try:
            self._observe(obs, int(n), actions, reward, done, stream)
        except Exception:
            with self._lock:
                self.counters["errors"] += 1

    def _observe(self, obs, n, actions, reward, done, stream) -> None:
        if self._closed:
            return
        stream = str(stream) if stream is not None else "anonymous"
        flat = np.concatenate([np.asarray(obs[k], np.float32).reshape(n, -1) for k in self._keys], axis=1)
        acts = np.asarray(actions, np.float32).reshape(n, -1)[:, : self.act_dim]
        with self._lock:
            prev = self._pending.pop(stream, None)
            if reward is None:
                if prev is not None:  # the previous action's feedback never came
                    self.counters["feedback_missing"] += len(prev[0])
            elif prev is None or len(prev[0]) != n:  # nothing to pair with
                self.counters["feedback_orphans"] += n
            else:
                prev_obs, prev_act = prev
                od, ad = self.obs_dim, self.act_dim
                rows = np.empty((n, self.row_width), np.float32)
                rows[:, :od] = prev_obs
                rows[:, od : od + ad] = prev_act
                rows[:, od + ad] = np.asarray(reward, np.float32).reshape(-1)[:n]
                rows[:, od + ad + 1] = np.asarray(done, np.float32).reshape(-1)[:n] if done is not None else 0.0
                rows[:, od + ad + 2 :] = flat
                self._emit_locked(rows)
            self._pending[stream] = (flat.copy(), acts.copy())
            while len(self._pending) > self.max_streams:  # the LRU: an evicted stream's action stays ungraded
                _, (evicted, _a) = self._pending.popitem(last=False)
                self.counters["feedback_missing"] += len(evicted)

    def _emit_locked(self, rows: np.ndarray) -> None:
        m, done = len(rows), 0
        while done < m:
            take = min(m - done, self.block_rows - self._cursor)
            self._cur[self._cursor : self._cursor + take] = rows[done : done + take]
            self._cursor += take
            done += take
            self.counters["rows_logged"] += take
            if self._cursor >= self.block_rows:
                self._ship_locked()
        if self._cursor and time.monotonic() - self._last_ship > self.flush_s:
            self._ship_locked()

    def _shed_locked(self) -> None:
        self.counters["rows_shed"] += self._cursor
        self.counters["blocks_shed"] += 1

    def _ship_locked(self) -> None:
        """The staged block into the transport queue, or shed: the dispatch
        path never waits for the writer."""
        if self._cursor == 0:
            return
        if not self._free or self._q.full():
            self._shed_locked()
        else:
            block, self._cur = self._cur, self._free.popleft()
            try:
                self._q.put_nowait((block, self._cursor))
                self.counters["blocks_shipped"] += 1
            except queue.Full:  # raced the writer's drain
                self._shed_locked()
                self._free.append(block)
        self._cursor = 0
        self._last_ship = time.monotonic()

    # -- the writer thread -------------------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            try:
                block, n = self._q.get(timeout=min(max(self.flush_s, 0.05), 0.25))
            except queue.Empty:
                if self._stop.is_set():
                    break
                self._flush_partial()
                continue
            self._write_frame(block[:n])
            with self._lock:
                self._free.append(block)
        while True:  # what shipped before the stop
            try:
                block, n = self._q.get_nowait()
            except queue.Empty:
                break
            self._write_frame(block[:n])
            with self._lock:
                self._free.append(block)
        self._flush_partial(force=True)
        try:
            self._file.flush()
            self._file.close()
        except OSError:
            pass

    def _flush_partial(self, force: bool = False) -> None:
        """Spool a stale partial block: a quiet tail of traffic reaches the
        learner within about ``flush_s``."""
        with self._lock:
            if not (self._cursor and (force or time.monotonic() - self._last_ship > self.flush_s)):
                return
            rows = self._cur[: self._cursor].copy()
            self._cursor = 0
            self._last_ship = time.monotonic()
        self._write_frame(rows)

    def _write_frame(self, rows: np.ndarray) -> None:
        if not len(rows):
            return
        try:
            payload = np.ascontiguousarray(rows, np.float32).tobytes()
            self._file.write(_FRAME.pack(FRAME_MAGIC, len(rows), len(payload)))
            self._file.write(payload)
            self._file.flush()
            with self._lock:
                self.counters["rows_spooled"] += len(rows)
                self.counters["frames"] += 1
                self.counters["spool_bytes"] += _FRAME.size + len(payload)
        except (OSError, ValueError):
            with self._lock:
                self.counters["errors"] += 1

    # -- introspection and lifecycle ---------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self.counters)
            out["pending_streams"] = len(self._pending)
            out["staged_rows"] = self._cursor
        out["transport_depth"] = self._q.qsize()
        out["path"] = str(self.path)
        return out

    def close(self, abandon: bool = False) -> None:
        """Flush and stop the writer. ``abandon`` drops the staged and queued
        rows (what a SIGKILL would lose) and closes the file where it stands."""
        if self._closed:
            return
        self._closed = True
        if abandon:
            with self._lock:
                self._cursor = 0
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
        self._stop.set()
        self._writer.join(timeout=10.0)


# -- the learner side: the spool reader ---------------------------------------------
class SpoolReader:
    """Tail every ``*.spool`` of a directory, frame by frame. Offsets persist
    across polls; rows are attributed to the replica its file's header names
    (``consumed_rows`` per replica). A torn tail (a header or frame still
    being written, or cut short by a killed writer) is waited out without
    moving the offset (``pending_bytes``); a corrupt frame (bad magic, wrong
    width) quarantines its file."""

    def __init__(self, directory: "str | Path", row_width: int) -> None:
        self.directory = Path(directory)
        self.row_width = int(row_width)
        self._files: Dict[str, Dict[str, Any]] = {}
        self.consumed_rows: Dict[str, int] = {}
        self.frames = 0
        self.corrupt_files = 0

    @property
    def total_consumed(self) -> int:
        return sum(self.consumed_rows.values())

    def pending_bytes(self) -> int:
        """Bytes on disk past every healthy file's parse offset."""
        total = 0
        for name, st in self._files.items():
            if st.get("corrupt"):
                continue
            try:
                total += max(0, os.path.getsize(self.directory / name) - st["offset"])
            except OSError:
                continue
        return total

    def _quarantine(self, st: Dict[str, Any]) -> None:
        st["corrupt"] = True
        self.corrupt_files += 1

    def poll(self) -> List[Tuple[str, np.ndarray]]:
        """One pass over the directory: the ``(replica, rows)`` batches new
        since the last poll."""
        out: List[Tuple[str, np.ndarray]] = []
        try:
            paths = sorted(p for p in self.directory.glob("*" + SPOOL_SUFFIX) if p.is_file())
        except OSError:
            return out
        for path in paths:
            st = self._files.setdefault(path.name, {"offset": 0, "replica": None, "corrupt": False})
            if st["corrupt"]:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(st["offset"])
                    buf = f.read()
            except OSError:
                continue
            pos = 0
            if st["replica"] is None:
                nl = buf.find(b"\n")
                if nl < 0:  # the header is still being written
                    continue
                try:
                    header = json.loads(buf[:nl].decode())
                    if header.get("magic") != SPOOL_MAGIC or int(header["row_width"]) != self.row_width:
                        raise ValueError("spool header mismatch")
                    st["replica"] = str(header.get("replica") or path.stem)
                except (ValueError, KeyError, UnicodeDecodeError):
                    self._quarantine(st)
                    continue
                pos = nl + 1
            row_bytes = self.row_width * 4
            while len(buf) - pos >= _FRAME.size:
                magic, n, payload = _FRAME.unpack_from(buf, pos)
                if magic != FRAME_MAGIC or payload != n * row_bytes:
                    self._quarantine(st)
                    break
                if len(buf) - pos - _FRAME.size < payload:
                    break  # a torn tail: wait for the writer
                rows = np.frombuffer(buf, np.float32, count=n * self.row_width,
                                     offset=pos + _FRAME.size).reshape(n, self.row_width).copy()
                out.append((st["replica"], rows))
                self.consumed_rows[st["replica"]] = self.consumed_rows.get(st["replica"], 0) + n
                self.frames += 1
                pos += _FRAME.size + payload
            st["offset"] += pos
        return out


# -- the learner's status file (its heartbeat) ---------------------------------------
def write_learner_status(directory: "str | Path", status: Dict[str, Any]) -> None:
    """Rewrite ``learner_status.json`` atomically: its mtime is the
    learner's heartbeat, its content the health probe's data."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / (STATUS_NAME + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(status, f)
    os.replace(tmp, directory / STATUS_NAME)


def read_learner_status(directory: "str | Path") -> Optional[Dict[str, Any]]:
    """The learner's status with its ``staleness_s``; None when absent or
    being replaced."""
    path = Path(directory) / STATUS_NAME
    try:
        with open(path, "r", encoding="utf-8") as f:
            status = json.load(f)
        status["staleness_s"] = max(0.0, time.time() - os.path.getmtime(path))
        return status
    except (OSError, ValueError):
        return None


# -- the supervised learner process ---------------------------------------------------
def learner_command(cfg: Any, flywheel_dir: "str | Path") -> List[str]:
    """The learner's ``run --from-serve`` command line: the same checkpoint,
    the spool directory, and the scalar flywheel knobs that survive a command
    line."""
    fly = dict((cfg.get("serve", {}) or {}).get("flywheel", {}) or {})
    cmd = [
        sys.executable,
        "-m",
        "sheeprl_tpu_torch",
        "run",
        "--from-serve",
        str(flywheel_dir),
        f"checkpoint_path={cfg.checkpoint_path}",
        f"fabric.accelerator={(cfg.get('fabric') or {}).get('accelerator', 'auto')}",
    ]
    if cfg.get("seed") is not None:
        cmd.append(f"seed={int(cfg['seed'])}")
    for key in ("poll_s", "publish_rows", "max_rows", "buffer_size", "ingest_rows", "grad_max", "replay_ratio",
                "learning_starts_rows"):
        if fly.get(key) is not None:
            cmd.append(f"serve.flywheel.{key}={fly[key]}")
    return cmd


class LearnerSupervisor:
    """The serve process's supervision of the learner. :meth:`tick`, called
    from the serve loop, feeds the status file's mtime into a
    :class:`~sheeprl_tpu_torch.fault.procsup.ProcessSupervisor` lease (a
    SIGSTOPped learner stops rewriting it, misses the lease and is SIGKILLed
    and respawned); :meth:`probe` is the health probe's ``flywheel.learner``
    block. Registers the ``kill-learner``/``hang-learner`` handlers;
    :meth:`stop` clears them and drains the process."""

    NAME = "flywheel-learner"

    def __init__(self, cfg: Any, flywheel_dir: "str | Path", procsup: Any = None) -> None:
        from sheeprl_tpu_torch.fault import inject
        from sheeprl_tpu_torch.fault.procsup import ProcessSupervisor

        self.directory = Path(flywheel_dir)
        fly = dict((cfg.get("serve", {}) or {}).get("flywheel", {}) or {})
        self.procsup = procsup or ProcessSupervisor.from_config(
            dict(fly.get("supervisor") or {}),
            name="serve-flywheel",
            lease_s=float(fly.get("lease_s", 15.0) or 15.0),
            grace_s=float(fly.get("grace_s", 180.0) or 180.0),
            max_restarts=3,
            backoff=0.5,
        )
        cmd = learner_command(cfg, self.directory)
        self.fatal: Optional[BaseException] = None
        # a status file left by an earlier learner is no beat of this one's
        self._status_mtime = self._mtime()
        self.handle = self.procsup.spawn(self.NAME, lambda: subprocess.Popen(cmd))
        inject.set_learner_chaos(kill=self._chaos_kill, hang=self._chaos_hang)

    def _chaos_kill(self) -> None:
        if self.handle.is_alive():
            os.kill(self.handle.pid(), 9)  # SIGKILL

    def _chaos_hang(self) -> None:
        if self.handle.is_alive():
            os.kill(self.handle.pid(), 19)  # SIGSTOP

    def _mtime(self) -> float:
        try:
            return os.path.getmtime(self.directory / STATUS_NAME)
        except OSError:
            return 0.0

    def tick(self) -> None:
        """One pass: the status file's beat, then the supervisor's check. A
        fatal escalation is kept (shown by :meth:`probe`), never raised into
        the serve loop."""
        from sheeprl_tpu_torch.fault.inject import fault_point
        from sheeprl_tpu_torch.fault.supervisor import SupervisionError

        fault_point("serve.flywheel.tick")  # kill-learner / hang-learner
        mtime = self._mtime()
        if mtime > self._status_mtime:
            self._status_mtime = mtime
            self.procsup.beat(self.NAME)
        try:
            self.procsup.check()
        except SupervisionError as e:
            self.fatal = e

    def probe(self) -> Dict[str, Any]:
        """The health probe's ``flywheel.learner`` block."""
        info = self.handle.info()
        status = read_learner_status(self.directory) or {}
        return {
            "alive": bool(info["alive"]),
            "state": info["state"],
            "pid": info["pid"],
            "restarts": int(info["restarts"]),
            "deaths": int(info["deaths"]),
            "hangs": int(info["hangs"]),
            "kills": int(info["kills"]),
            "consumed_rows": int(status.get("consumed_rows", 0)),
            "ingested_rows": int(status.get("ingested_rows", 0)),
            "grad_steps": int(status.get("grad_steps", 0)),
            "published_step": int(status.get("published_step", -1)),
            "staleness_s": round(float(status.get("staleness_s", -1.0)), 3),
            "fatal": str(self.fatal) if self.fatal is not None else None,
        }

    def stop(self, grace_s: Optional[float] = None) -> None:
        from sheeprl_tpu_torch.fault import inject

        inject.set_learner_chaos(None, None)
        self.procsup.terminate_all(grace_s)


def run_flywheel_learner(cfg: Any, state: Dict[str, Any], device: Any) -> Dict[str, Any]:
    """The learner's body (``run --from-serve <dir>``): tail the spool
    directory, feed the rows into the algorithm's registered learner-ingest
    on ``device``, and publish checkpoints into the served checkpoint's
    directory at strictly newer steps (``<served step> + rows trained on``),
    for the servers' watchers to adopt. Runs until ``serve.flywheel.max_rows``
    rows were read (None: for ever) or SIGTERM/SIGINT (it publishes what it
    learned and returns). After every frame it trains on, and every pass, it
    rewrites ``learner_status.json``, publishes once ``publish_rows`` more
    rows were trained on, and heeds a drain. JAX's learner does these once a
    pass, after the whole poll: a backlog longer than the lease to ingest then
    gets it SIGKILLed as hung over and over, publishes wait for the backlog,
    and a drain outlasts its grace. Returns the last status."""
    from sheeprl_tpu_torch.fault.inject import fault_point
    from sheeprl_tpu_torch.fault.manager import CheckpointManager, parse_step
    from sheeprl_tpu_torch.serve.server import install_drain_handlers
    from sheeprl_tpu_torch.utils.registry import registered_flywheel_ingest_names, resolve_flywheel_ingest

    fly = dict((cfg.get("serve", {}) or {}).get("flywheel", {}) or {})
    if not fly.get("dir"):
        raise FlywheelConfigError("serve.flywheel.dir must name the shared spool directory")
    directory = Path(fly["dir"])
    directory.mkdir(parents=True, exist_ok=True)
    builder = resolve_flywheel_ingest(str(cfg.algo.name))
    if builder is None:
        raise FlywheelConfigError(
            f"serve.flywheel is enabled but the algorithm named '{cfg.algo.name}' has no registered learner-ingest "
            f"builder. Algorithms with flywheel support: {', '.join(registered_flywheel_ingest_names())}."
        )
    ingest = builder(cfg, state.get("agent"), device)
    reader = SpoolReader(directory, ingest.row_width)
    manager = CheckpointManager()
    ckpt_path = Path(cfg.checkpoint_path)
    ckpt_dir = ckpt_path.parent
    base_step = parse_step(ckpt_path.name) or 0
    poll_s = float(fly.get("poll_s", 0.5) or 0.5)
    publish_rows = max(1, int(fly.get("publish_rows", 64) or 64))
    max_rows = int(fly["max_rows"]) if fly.get("max_rows") else None

    drain = threading.Event()
    restore_handlers = install_drain_handlers(drain)
    published = {"step": -1, "at": 0}

    def publish() -> None:
        step = base_step + ingest.consumed
        if step <= max(base_step, published["step"]):
            return
        manager.save(ckpt_dir / f"ckpt_{step}_0.ckpt", {"agent": ingest.agent_state(), "flywheel_rows": ingest.consumed},
                     step=step)
        published["step"], published["at"] = step, ingest.consumed
        print(f"flywheel: published step {step} ({ingest.consumed} production rows consumed)", flush=True)

    def maybe_publish() -> None:
        if ingest.consumed - published["at"] >= publish_rows and ingest.grad_steps > 0:
            publish()

    def status() -> Dict[str, Any]:
        out = {
            "pid": os.getpid(),
            "consumed_rows": reader.total_consumed,  # read from the spool
            "ingested_rows": int(ingest.consumed),  # trained into the ring
            "per_replica": dict(reader.consumed_rows),
            "grad_steps": int(ingest.grad_steps),
            "published_step": int(published["step"]),
            "pending_bytes": reader.pending_bytes(),
            "corrupt_files": int(reader.corrupt_files),
            "device": str(device),
        }
        write_learner_status(directory, out)
        return out

    print(f"flywheel learner: ingesting {directory} -> publishing into {ckpt_dir} (base step {base_step}, "
          f"device={device})", flush=True)
    last = status()
    try:
        while not drain.is_set():
            fault_point("serve.flywheel.ingest")
            fresh = 0
            for _replica, rows in reader.poll():
                ingest.ingest(rows)
                fresh += len(rows)
                maybe_publish()
                last = status()  # a beat per frame: a long backlog is progress, not a hang
                if drain.is_set():
                    break
            maybe_publish()
            last = status()
            if max_rows is not None and reader.total_consumed >= max_rows:
                break
            if fresh == 0:
                drain.wait(poll_s)
    except KeyboardInterrupt:
        pass
    finally:
        if ingest.grad_steps > 0:
            publish()
        last = status()
        restore_handlers()
        print(f"flywheel learner: done ({reader.total_consumed} rows from {len(reader.consumed_rows)} replica(s), "
              f"{ingest.grad_steps} grad steps, last published step {published['step']})", flush=True)
    return last
