"""SAC-AE coupled training (counterpart of ``sheeprl_tpu/algos/sac_ae/sac_ae.py``,
one device, the host replay buffer).

Each granted gradient step, in the JAX package's order, gated on the
cumulative count of gradient steps taken before it (``cum``):

1. the critic update: the encoder and the Q ensemble against the TD target
   of the target encoder and Qs;
2. the target EMAs (the Qs at ``algo.tau``, the encoder at
   ``algo.encoder.tau``) when ``cum % critic.per_rank_target_network_update_freq == 0``;
3. the actor and entropy-coefficient updates when ``cum %
   actor.per_rank_update_freq == 0``, the actor on the trunk's features with
   the gradient stopped, through its own head;
4. the reconstruction update of the encoder and the decoder when ``cum %
   decoder.per_rank_update_freq == 0``: pixel targets reduced to 5 bits and
   dithered by uniform noise, plus ``l2_lambda`` times half the squared norm
   of the encoder's features.

The encoder's parameters sit in two Adams, the critic's and the encoder's,
as in the JAX package; the decoder's optimizer is AdamW. Random numbers come
from an explicit ``torch.Generator`` or are passed in (:func:`draw_noise`),
so a test can feed JAX's draws. A skipped actor or decoder update counts 0
in the losses' means, as the JAX step returns 0 for it.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac_ae.agent import SACAEAgent, build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import prepare_obs, preprocess_obs, test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.data import ReplayBuffer
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.fault import CheckpointManager, load_resume_state
from sheeprl_tpu_torch.optim import ClippedOptimizer, build_optimizer
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.timer import log_timers, timer
from sheeprl_tpu_torch.utils.utils import Ratio

__all__ = ["LOSS_NAMES", "draw_noise", "make_optimizers", "make_train_step", "main"]

LOSS_NAMES = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Loss/reconstruction_loss")


def make_optimizers(cfg: Any, agent: SACAEAgent) -> Dict[str, ClippedOptimizer]:
    """The JAX package's five: ``qf`` over the encoder and the Qs, ``actor``
    over the actor and its encoder head, ``alpha``, ``encoder`` over the
    encoder again, ``decoder`` (AdamW with the recipe's weight decay)."""
    algo = cfg.algo
    head = list(agent.actor_enc_head.parameters()) if agent.actor_enc_head is not None else []
    return {
        "qf": build_optimizer(list(agent.encoder.parameters()) + list(agent.qfs.parameters()), algo.critic.optimizer),
        "actor": build_optimizer(list(agent.actor.parameters()) + head, algo.actor.optimizer),
        "alpha": build_optimizer([agent.log_alpha], algo.alpha.optimizer),
        "encoder": build_optimizer(agent.encoder.parameters(), algo.encoder.optimizer),
        "decoder": build_optimizer(agent.decoder.parameters(), algo.decoder.optimizer),
    }


def draw_noise(agent: SACAEAgent, cfg: Any, G: int, B: int, generator: Optional[torch.Generator], device
               ) -> Dict[str, Any]:
    """One train call's draws: ``next`` and ``actor`` ``(G, B, A)`` normals
    (the TD target's and the actor update's actions) and ``pixels``, per
    decoder pixel key ``(G, B, H, W, C)`` uniforms in ``[0, 1)`` that dither
    its reconstruction target."""
    A = agent.action_dim
    pixels = {k: torch.rand((G, B, *(int(d) for d in cfg.spaces.obs[k].shape)), generator=generator, device=device)
              for k in agent.decoder.cnn_keys}
    return {"next": torch.randn((G, B, A), generator=generator, device=device),
            "actor": torch.randn((G, B, A), generator=generator, device=device), "pixels": pixels}


def make_train_step(agent: SACAEAgent, optimizers: Dict[str, ClippedOptimizer], cfg: Any) -> Callable:
    """The train call (JAX ``make_train_step`` on one device): ``train(data,
    cum0, noise=None, generator=None) -> losses``. ``data`` holds ``(G, B,
    ...)`` float32 tensors on the agent's device (pixels in ``[0, 255]``,
    ``next_<key>`` beside each observation key); ``cum0`` counts the
    gradient steps taken before; ``noise`` is a :func:`draw_noise` dict, else
    drawn from ``generator``. Returns the ``(4,)`` mean of :data:`LOSS_NAMES`
    over the G steps, on the device."""
    algo = cfg.algo
    gamma = float(algo.gamma)
    cnn_enc, mlp_enc = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    cnn_dec, mlp_dec = agent.decoder.cnn_keys, agent.decoder.mlp_keys
    target_freq = int(algo.critic.per_rank_target_network_update_freq)
    actor_freq = int(algo.actor.per_rank_update_freq)
    decoder_freq = int(algo.decoder.per_rank_update_freq)
    l2_lambda = float(algo.decoder.l2_lambda)
    encoder_params = list(agent.encoder.parameters())
    critic_params = encoder_params + list(agent.qfs.parameters())
    head = list(agent.actor_enc_head.parameters()) if agent.actor_enc_head is not None else []
    actor_params = list(agent.actor.parameters()) + head
    decoder_params = list(agent.decoder.parameters())

    def normalize(batch: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
        return {k: batch[prefix + k] / 255.0 if k in cnn_enc else batch[prefix + k] for k in cnn_enc + mlp_enc}

    def gradient_step(batch: Dict[str, torch.Tensor], cum: int, noise: Dict[str, Any]) -> List[torch.Tensor]:
        obs, next_obs = normalize(batch), normalize(batch, "next_")
        td_target = agent.next_target_q(next_obs, batch["rewards"], batch["terminated"], gamma, noise["next"])
        qf_loss = critic_loss(agent.q_values(obs, batch["actions"]), td_target)
        optimizers["qf"].step(torch.autograd.grad(qf_loss, critic_params))
        if cum % target_freq == 0:
            agent.ema()

        actor_loss = alpha_loss = torch.zeros((), device=qf_loss.device)
        if cum % actor_freq == 0:
            alpha = torch.exp(agent.log_alpha.detach())
            actions, logp = agent.sample_action(obs, noise["actor"])
            min_q = torch.min(agent.q_values(obs, actions), dim=-1, keepdim=True).values
            actor_loss = policy_loss(alpha, logp, min_q)
            optimizers["actor"].step(torch.autograd.grad(actor_loss, actor_params))
            alpha_loss = entropy_loss(agent.log_alpha, logp.detach(), agent.target_entropy)
            optimizers["alpha"].step(torch.autograd.grad(alpha_loss, [agent.log_alpha]))

        rec_loss = torch.zeros((), device=qf_loss.device)
        if cum % decoder_freq == 0:
            hidden = agent.encoder(obs)
            recon = agent.decoder(hidden)
            l2 = (0.5 * torch.sum(hidden**2, dim=1)).mean()
            for k in list(cnn_dec) + list(mlp_dec):
                target = preprocess_obs(batch[k], bits=5, uniform=noise["pixels"][k]) if k in cnn_dec else batch[k]
                rec_loss = rec_loss + torch.mean((target - recon[k]) ** 2) + l2_lambda * l2
            grads = torch.autograd.grad(rec_loss, encoder_params + decoder_params)
            optimizers["encoder"].step(grads[: len(encoder_params)])
            optimizers["decoder"].step(grads[len(encoder_params):])
        return [qf_loss.detach(), actor_loss.detach(), alpha_loss.detach(), rec_loss.detach()]

    def train(data: Dict[str, torch.Tensor], cum0: int, noise: Optional[Dict[str, Any]] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        G, B = data["actions"].shape[:2]
        device = data["actions"].device
        if noise is None:
            noise = draw_noise(agent, cfg, G, B, generator, device)
        total = torch.zeros(4, dtype=torch.float32, device=device)
        for g in range(G):
            step_noise = {"next": noise["next"][g], "actor": noise["actor"][g],
                          "pixels": {k: v[g] for k, v in noise["pixels"].items()}}
            total += torch.stack(gradient_step({k: v[g] for k, v in data.items()}, int(cum0) + g, step_noise))
        return total / G

    return train


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The coupled loop on the host buffer: act, store, train, log,
    checkpoint; a greedy test episode at the end with ``algo.run_test``.
    Returns a summary of the run (counters, the losses of every train call,
    the finished episodes, the last checkpoint's path)."""
    device = torch.device(device)
    state = load_resume_state(cfg.checkpoint.resume_from) if cfg.checkpoint.get("resume_from") else None
    cfg.env["screen_size"] = 64  # the JAX package fixes it
    algo = cfg.algo
    cnn_keys, mlp_keys = list(algo.cnn_keys.encoder), list(algo.mlp_keys.encoder)
    for kind, enc in (("cnn", cnn_keys), ("mlp", mlp_keys)):
        if set(algo[f"{kind}_keys"].get("decoder", enc)) - set(enc):
            raise RuntimeError(f"The {kind.upper()} keys of the decoder must be contained in the encoder ones")
    obs_keys = cnn_keys + mlp_keys
    sample_next_obs = bool(cfg.buffer.get("sample_next_obs", False))
    num_envs = int(cfg.env.num_envs)
    seed = int(cfg.seed)

    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    envs = make_vector_env(cfg, seed)
    cfg["spaces"] = dotdict(envs.spaces)
    action_space = cfg.spaces.actions
    if not action_space.get("continuous", False):
        raise RuntimeError("Unexpected action space, should be continuous")
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))
    low, high = np.asarray(action_space.low, np.float32), np.asarray(action_space.high, np.float32)

    generator = torch.Generator(device=device).manual_seed(seed)
    if state is not None and state.get("rng") is not None:
        generator.set_state(state["rng"])
    agent, player = build_agent(cfg, device, state["agent"] if state is not None else None, generator)
    optimizers = make_optimizers(cfg, agent)
    if state is not None:
        for name, opt in optimizers.items():
            opt.load_state_dict(state["optimizers"][name])
        algo["per_rank_batch_size"] = int(state["batch_size"])
    batch_size = int(algo.per_rank_batch_size)
    dry_run = bool(cfg.get("dry_run", False))
    train_fn = make_train_step(agent, optimizers, cfg)

    rb = ReplayBuffer(int(cfg.buffer.size) // num_envs if not dry_run else 1, num_envs, tuple(obs_keys),
                      memmap=bool(cfg.buffer.get("memmap", False)),
                      memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
                      memmap_mode=str(cfg.buffer.get("memmap_mode", "r+")))
    rb.seed(seed)
    if state is not None and cfg.buffer.checkpoint and state.get("rb") is not None:
        rb.load_state_dict(state["rb"])

    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * num_envs if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    total_iters = int(algo.total_steps) // num_envs if not dry_run else 1
    learning_starts = int(algo.get("learning_starts", 0)) // num_envs if not dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if state is not None:
        learning_starts += start_iter
        prefill_steps += start_iter
    ratio = Ratio(float(algo.replay_ratio), pretrain_steps=int(algo.per_rank_pretrain_steps))
    if state is not None:
        ratio.load_state_dict(state["ratio"])
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))
    action_repeat = int(cfg.env.get("action_repeat", 1) or 1)
    train_step = int(state.get("train_step", 0)) if state is not None else 0
    last_train = int(state.get("last_train", 0)) if state is not None else 0
    if log_level > 0 and log_every % num_envs != 0:
        warnings.warn(f"The metric.log_every parameter ({log_every}) is not a multiple of the "
                      f"policy_steps_per_iter value ({num_envs}).")
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)

    action_rng = np.random.default_rng(seed)
    obs = envs.reset(seed=seed)[0]
    summary: Dict[str, Any] = {"start_iter": start_iter, "train_calls": 0, "losses": [], "episodes": [],
                               "train_s": [], "checkpoint": None, "device": str(device), "test_reward": None,
                               "test_steps": None}
    pending: List[torch.Tensor] = []
    # this run's gradient steps set the update gates; a resumed run counts from 0, as the JAX loop does
    gradient_steps = 0

    def read_losses() -> None:
        if pending:
            rows = torch.stack(pending).cpu().tolist()
            pending.clear()
            summary["losses"].extend(rows)
            if aggregator is not None:
                for row in rows:
                    for name, value in zip(LOSS_NAMES, row):
                        aggregator.update(name, value)

    t_loop = time.perf_counter()
    for iter_num in range(start_iter, total_iters + 1):
        policy_step += num_envs
        with timer("Time/env_interaction_time", SumMetric):
            if iter_num <= learning_starts:
                actions = action_rng.uniform(low, high, size=(num_envs, len(low))).astype(np.float32)
            else:
                prepared = prepare_obs(obs, cnn_keys, mlp_keys, num_envs)
                actions = player.get_actions({k: torch.from_numpy(v).to(device) for k, v in prepared.items()})
                actions = actions.float().cpu().numpy()
            next_obs, rewards, terminated, truncated, infos = envs.step(actions)
        for i, ep_rew, ep_len in infos.get("episodes", ()):
            summary["episodes"].append((policy_step, i, ep_rew, ep_len))
            if log_level > 0:
                if aggregator is not None:
                    aggregator.update("Rewards/rew_avg", ep_rew)
                    aggregator.update("Game/ep_len_avg", ep_len)
                print(f"Rank-0: policy_step={policy_step}, reward_env_{i}={ep_rew}", flush=True)

        step_data = {k: np.asarray(obs[k])[np.newaxis] for k in obs_keys}
        if not sample_next_obs:
            for k in obs_keys:
                real_next = np.array(next_obs[k])
                for i, final in enumerate(infos.get("final_obs", ())):
                    if final is not None:  # the episode's last observation, not the reset one
                        real_next[i] = final[k]
                step_data[f"next_{k}"] = real_next[np.newaxis]
        step_data["terminated"] = np.asarray(terminated, dtype=np.float32).reshape(1, num_envs, -1)
        step_data["truncated"] = np.asarray(truncated, dtype=np.float32).reshape(1, num_envs, -1)
        step_data["actions"] = actions.astype(np.float32).reshape(1, num_envs, -1)
        step_data["rewards"] = np.asarray(rewards, dtype=np.float32).reshape(1, num_envs, -1)
        rb.add(step_data)
        obs = next_obs

        if iter_num >= learning_starts:
            # the JAX SAC-AE counts its prefill in policy steps here
            granted = ratio(policy_step - prefill_steps * num_envs)
            if granted > 0:
                t0 = time.perf_counter()
                with timer("Time/replay_path_time", SumMetric):
                    sample = rb.sample(batch_size, granted, sample_next_obs=sample_next_obs)
                    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device).float() for k, v in sample.items()}
                with timer("Time/train_time", SumMetric):
                    pending.append(train_fn(data, gradient_steps, generator=generator))
                summary["train_s"].append(time.perf_counter() - t0)
                gradient_steps += granted
                summary["train_calls"] += 1
                train_step += 1

        if policy_step - last_log >= log_every or iter_num == total_iters:
            read_losses()
            if log_level > 0:
                if aggregator is not None:
                    logger.log_dict(aggregator.compute(), policy_step)
                    aggregator.reset()
                logger.log_dict({"Params/replay_ratio": gradient_steps / policy_step}, policy_step)
                log_timers(logger, policy_step, train_step - last_train, (policy_step - last_log) * action_repeat)
                last_train = train_step
            last_log = policy_step

        if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
            iter_num == total_iters and cfg.checkpoint.get("save_last", False)
        ):
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": agent.state_dict(),
                "optimizers": {name: opt.state_dict() for name, opt in optimizers.items()},
                "ratio": ratio.state_dict(),
                "iter_num": iter_num,
                "batch_size": batch_size,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "train_step": train_step,
                "last_train": last_train,
                "rng": generator.get_state(),
            }
            if cfg.buffer.checkpoint:
                ckpt_state["rb"] = rb.checkpoint_state_dict()
            path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
            summary["checkpoint"] = str(manager.save(path, ckpt_state, step=policy_step, config=plain(cfg)))

    manager.close()
    read_losses()
    loop_s = time.perf_counter() - t_loop
    envs.close()
    if algo.get("run_test", True):
        summary["test_reward"], summary["test_steps"] = test(player, cfg, device)
    logger.close()
    steps = policy_step - (start_iter - 1) * num_envs
    summary.update(policy_steps=policy_step, log_dir=log_dir, gradient_steps=gradient_steps,
                   loop_steps_per_s=steps / loop_s if loop_s > 0 else None, checkpoint_timings=manager.timings,
                   **{"Fault/env_restarts": envs.env_restarts})
    return summary
