"""Per-env watchdog: bounded retry and replace-on-death for the vector env's
workers (counterpart of ``sheeprl_tpu/fault/watchdog.py``, over the port's
plain envs).

:class:`SelfHealingEnv` wraps one env together with the factory that built
it. A crash (an exception) or a hang (``step_timeout`` exceeded) is healed
by building the env again from the factory with exponential backoff; the
failed ``step`` comes back as a *truncation* (reward 0, the fresh reset
observation, ``info["env_restarted"] = True``), so the loop records a clean
episode cut instead of dying. Rebuilding is tried ``attempts`` times; past
that the error is raised: resilience is bounded.

The hang watchdog runs the env call on a helper thread and abandons it on
timeout: a wedged call cannot be preempted from Python, so the daemon
thread is leaked on purpose and the env object replaced.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Callable, List, Optional

__all__ = ["EnvTimeoutError", "SelfHealingEnv"]


class EnvTimeoutError(RuntimeError):
    """An env call exceeded the configured watchdog timeout."""


class SelfHealingEnv:
    def __init__(
        self,
        env_fn: Callable[[], Any],
        attempts: int = 3,
        backoff: float = 0.5,
        step_timeout: Optional[float] = None,
        restart_counter: Optional[List[int]] = None,
    ) -> None:
        self._env_fn = env_fn
        self.attempts = max(1, int(attempts))
        self.backoff = float(backoff)
        self.step_timeout = step_timeout if step_timeout and step_timeout > 0 else None
        self._restart_counter = restart_counter if restart_counter is not None else [0]
        self.env = env_fn()

    def __getattr__(self, name: str) -> Any:  # spaces and the rest come from the live env
        if name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def restarts(self) -> int:
        return self._restart_counter[0]

    # -- guarded call ---------------------------------------------------------
    def _call(self, name: str, *args: Any, **kwargs: Any) -> Any:
        # a timeout costs one thread start and join per call: set it only for
        # envs slow enough to hang, not for microsecond-step toys
        fn = getattr(self.env, name)
        if self.step_timeout is None:
            return fn(*args, **kwargs)
        box: dict = {}

        def target() -> None:
            try:
                box["value"] = fn(*args, **kwargs)
            except BaseException as e:  # handed to the calling thread
                box["error"] = e

        t = threading.Thread(target=target, name=f"env-watchdog-{name}", daemon=True)
        t.start()
        t.join(self.step_timeout)
        if t.is_alive():
            raise EnvTimeoutError(f"env.{name} exceeded {self.step_timeout:g}s watchdog timeout")
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _heal(self, exc: BaseException, phase: str) -> None:
        """Replace the env through its factory, with bounded exponential
        backoff. A timed-out env may still be running on the abandoned
        thread, so only a cleanly crashed one is closed."""
        if not isinstance(exc, EnvTimeoutError):
            try:
                self.env.close()
            except Exception:  # the dead env owes us nothing
                pass
        delay = self.backoff
        last: BaseException = exc
        for attempt in range(self.attempts):
            warnings.warn(
                f"{phase}: env crashed with {type(exc).__name__}: {exc} — "
                f"recreating (attempt {attempt + 1}/{self.attempts})"
            )
            if delay > 0 and attempt > 0:
                time.sleep(delay)
                delay *= 2
            try:
                self.env = self._env_fn()
                self._restart_counter[0] += 1
                return
            except Exception as rebuild_exc:
                last = rebuild_exc
        raise RuntimeError(f"{phase}: env could not be recreated after {self.attempts} attempts") from last

    def _reset_healed(self, phase: str, **kwargs: Any):
        """Reset the rebuilt env, still under the watchdog: a replacement
        that fails its first reset is healed again, within the same budget."""
        for _ in range(self.attempts):
            try:
                return self._call("reset", **kwargs)
            except Exception as exc:
                self._heal(exc, phase)
        return self._call("reset", **kwargs)

    # -- env surface ----------------------------------------------------------
    def step(self, action):
        try:
            return self._call("step", action)
        except Exception as exc:
            self._heal(exc, "STEP")
            obs, info = self._reset_healed("STEP-RESET")
            # a truncation: the action's episode is gone, obs starts a new one
            return obs, 0.0, False, True, {**info, "env_restarted": True}

    def reset(self, seed=None, options=None):
        try:
            return self._call("reset", seed=seed, options=options)
        except Exception as exc:
            self._heal(exc, "RESET")
            obs, info = self._reset_healed("RESET", seed=seed, options=options)
            return obs, {**info, "env_restarted": True}

    def close(self) -> None:
        self.env.close()
