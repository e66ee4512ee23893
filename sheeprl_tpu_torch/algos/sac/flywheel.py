"""SAC's flywheel learner-ingest: served rows into the device ring
(counterpart of ``sheeprl_tpu/algos/sac/flywheel.py``).

:class:`SACFlywheelIngest` rebuilds the agent from the SERVED checkpoint,
stages the spooled transitions into a
:class:`~sheeprl_tpu_torch.replay.DeviceReplayBuffer` (one "env": each row is
one transition; ``ingest_rows`` rows per flush) and drives the dispatch that
offline training uses (:func:`~sheeprl_tpu_torch.algos.sac.sac.make_resident_train_step`,
append and train, unguarded): grants metered by ``serve.flywheel.replay_ratio``
after ``learning_starts_rows`` rows, a backlog capped at ``grad_max · 4``, at
most ``grad_max`` steps a dispatch, the EMA on the
``critic.target_network_frequency`` cadence. The optimizers start fresh: the
flywheel fine-tunes the served policy on live traffic, and a checkpoint's
optimizer moments belong to the run that wrote it. The ring's draws come from
its generator (seeded ``seed + 41``), or, for a test, from ``draws``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.utils.registry import register_flywheel_ingest

__all__ = ["SACFlywheelIngest", "flywheel_ingest_sac"]


class SACFlywheelIngest:
    """Feed flat ``(obs, action, reward, done, next_obs)`` float32 rows into
    the SAC resident train step on ``device``. ``draws(count, valid)``, when
    given, returns a dispatch's random numbers (the train step's ``draws``)."""

    def __init__(self, cfg: Any, agent_state: Optional[Dict[str, torch.Tensor]], device: "torch.device | str",
                 draws: Optional[Callable[[int, int], Dict[str, torch.Tensor]]] = None) -> None:
        from sheeprl_tpu_torch.algos.sac.agent import build_agent
        from sheeprl_tpu_torch.algos.sac.sac import make_optimizers, make_resident_train_step
        from sheeprl_tpu_torch.replay import DeviceReplayBuffer
        from sheeprl_tpu_torch.serve.flywheel import flywheel_row_width

        fly = dict((cfg.get("serve", {}) or {}).get("flywheel", {}) or {})
        spaces = cfg.spaces
        self.obs_dim = int(sum(int(np.prod(spaces.obs[k].shape)) for k in cfg.algo.mlp_keys.encoder))
        self.act_dim = int(np.prod(spaces.actions.shape))
        self.row_width = flywheel_row_width(self.obs_dim, self.act_dim)
        self.agent, _ = build_agent(cfg, self.obs_dim, spaces.actions, device, agent_state)
        self.optimizers = make_optimizers(cfg, self.agent)

        self.ingest_rows = max(1, int(fly.get("ingest_rows", 64) or 64))
        self.grad_max = max(1, int(fly.get("grad_max", 8) or 8))
        self.replay_ratio = float(fly.get("replay_ratio", 0.5) or 0.5)
        self.learning_starts = max(0, int(fly.get("learning_starts_rows", 128) or 128))
        buffer_size = max(self.ingest_rows, int(fly.get("buffer_size", 4096) or 4096))
        self.ema_every = max(1, int(cfg.algo.critic.target_network_frequency))
        self.specs = {
            "observations": ((self.obs_dim,), np.float32),
            "next_observations": ((self.obs_dim,), np.float32),
            "actions": ((self.act_dim,), np.float32),
            "rewards": ((1,), np.float32),
            "terminated": ((1,), np.float32),
        }
        self.drb = DeviceReplayBuffer(self.specs, buffer_size, 1, device=device,
                                      seed=int(cfg.get("seed", 0) or 0) + 41, stage_rows=self.ingest_rows)
        self._train = make_resident_train_step(self.agent, self.optimizers, cfg, self.drb, guard=False, append=True)
        self._draws = draws
        self.consumed = 0
        self.grad_steps = 0
        self.dispatches = 0
        self._backlog = 0.0

    def ingest(self, rows: np.ndarray) -> None:
        """Consume ``(m, row_width)`` float32 rows: ``ingest_rows`` at a time
        into the ring, each flush one dispatch of the granted steps (none
        before ``learning_starts_rows``: the dispatch only appends)."""
        from sheeprl_tpu_torch.serve.flywheel import split_rows

        rows = np.ascontiguousarray(np.asarray(rows, np.float32).reshape(-1, self.row_width))
        cols = split_rows(rows, self.obs_dim, self.act_dim)
        m, i = len(rows), 0
        while i < m:
            take = min(self.ingest_rows, m - i)
            for j in range(i, i + take):
                self.drb.add({k: cols[k][j] for k in self.specs})
            i += take
            self.consumed += take
            if self.consumed >= self.learning_starts:
                # a learner that fell behind catches up at grad_max a dispatch, never hoarding grants
                self._backlog = min(self._backlog + take * self.replay_ratio, float(self.grad_max * 4))
            self._dispatch()

    def _dispatch(self) -> None:
        # the first dispatch appends the staged rows; the extra ones drain a big backlog
        while True:
            chunk = min(self.grad_max, int(self._backlog))
            flags = [1.0 if (self.grad_steps + t) % self.ema_every == 0 else 0.0 for t in range(chunk)]
            job = self.drb.make_job()
            draws = self._draws(chunk, job.valid) if self._draws is not None and chunk else None
            self._train(job, flags, 0.0, draws=draws)
            self.dispatches += 1
            self._backlog -= chunk
            self.grad_steps += chunk
            if int(self._backlog) < self.grad_max:
                break

    def agent_state(self) -> Dict[str, torch.Tensor]:
        """The publishable ``state["agent"]``: the agent's state dict, which
        ``serve``'s SAC builder rebuilds from, so a published checkpoint
        swaps in."""
        return self.agent.state_dict()


@register_flywheel_ingest(algorithms=["sac", "sac_decoupled", "sac_sebulba"])
def flywheel_ingest_sac(cfg: Any, agent_state: Optional[Dict[str, torch.Tensor]],
                        device: "torch.device | str") -> SACFlywheelIngest:
    return SACFlywheelIngest(cfg, agent_state, device)
