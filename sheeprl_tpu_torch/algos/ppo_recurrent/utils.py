"""Recurrent PPO host-side helpers (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/utils.py`` and of ``_bucket`` in its
``ppo_recurrent.py``): observation preparation, the rollout's chunking into
padded sequences, the sequence-count bucket, and the greedy test episode."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo_recurrent.agent import initial_state, session_step
from sheeprl_tpu_torch.envs import make_env

__all__ = ["AGGREGATOR_KEYS", "prepare_obs", "chunk_sequences", "bucket", "pad_sequences", "test"]

#: the metrics the recurrent PPO loop aggregates (JAX ``AGGREGATOR_KEYS``)
AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss", "Loss/entropy_loss"}


def prepare_obs(obs: Dict[str, np.ndarray], cnn_keys: Sequence[str] = (), num_envs: int = 1,
                device: "torch.device | str" = "cpu") -> Dict[str, torch.Tensor]:
    """Host observations -> time-major ``(1, num_envs, ...)`` float32
    tensors on ``device``: pixel keys (NHWC) to ``x / 255 - 0.5``, vector
    keys flattened."""
    out = {}
    for k, v in obs.items():
        v = np.asarray(v, dtype=np.float32)
        if k in cnn_keys:
            v = v.reshape(1, num_envs, *v.shape[-3:]) / 255.0 - 0.5
        else:
            v = v.reshape(1, num_envs, -1)
        out[k] = torch.from_numpy(v).to(device)
    return out


def chunk_sequences(local_data: Dict[str, np.ndarray], rollout_steps: int, num_envs: int,
                    seq_len: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Split the ``(T, N, ...)`` rollout into per-env episode slices (an
    episode ends at a step whose ``dones`` is set; the last slice at the
    rollout's end), chunk each into sequences of at most ``seq_len`` steps,
    and right-pad them into float32 ``(seq_len, S, ...)`` arrays with a
    float32 ``(seq_len, S)`` mask of the real steps. Sequences come env by
    env, episode by episode, in time order."""
    sequences: List[Dict[str, np.ndarray]] = []
    lengths: List[int] = []
    for env_id in range(num_envs):
        env_data = {k: v[:, env_id] for k, v in local_data.items()}
        ends = np.nonzero(env_data["dones"].reshape(rollout_steps, -1)[:, 0])[0].tolist()
        ends.append(rollout_steps)
        start = 0
        for stop in ends:
            if start >= rollout_steps:
                break
            # the last pseudo-episode ends at rollout_steps: the +1 is clamped by the array
            episode = {k: v[start : stop + 1] for k, v in env_data.items()}
            length = next(iter(episode.values())).shape[0]
            if length <= 0:
                start = stop + 1
                continue
            for s in range(0, length, seq_len):
                chunk = min(seq_len, length - s)
                sequences.append({k: v[s : s + chunk] for k, v in episode.items()})
                lengths.append(chunk)
            start = stop + 1
    n = len(sequences)
    padded: Dict[str, np.ndarray] = {}
    for k in local_data:
        arr = np.zeros((seq_len, n, *sequences[0][k].shape[1:]), dtype=np.float32)
        for i, seq in enumerate(sequences):
            arr[: lengths[i], i] = seq[k]
        padded[k] = arr
    mask = np.zeros((seq_len, n), dtype=np.float32)
    for i, length in enumerate(lengths):
        mask[:length, i] = 1.0
    return padded, mask


def bucket(n: int, quantum: int) -> int:
    """``n`` rounded up to ``quantum * 2**k`` (JAX ``_bucket``: a few stable
    sequence counts per run)."""
    units = max(1, -(-n // quantum))
    p = 1
    while p < units:
        p *= 2
    return quantum * p


def pad_sequences(padded: Dict[str, np.ndarray], mask: np.ndarray, quantum: int) -> Dict[str, np.ndarray]:
    """The chunked rollout with ``S`` right-padded by all-zero, fully masked
    sequences to ``bucket(S, quantum)``, the mask under ``"mask"``, and the
    stored LSTM pair cut to each sequence's first step (``(1, S_pad,
    H)``), the only one a sequence starts from."""
    seq_len, n = mask.shape
    n_pad = bucket(n, quantum)
    out = {}
    for k, v in padded.items():
        out[k] = np.concatenate([v, np.zeros((seq_len, n_pad - n, *v.shape[2:]), v.dtype)], axis=1) if n_pad > n else v
    out["mask"] = np.concatenate([mask, np.zeros((seq_len, n_pad - n), mask.dtype)], axis=1) if n_pad > n else mask
    out["prev_hx"] = out["prev_hx"][:1]
    out["prev_cx"] = out["prev_cx"][:1]
    return out


def test(agent, cfg: Any, device: "torch.device | str", greedy: bool = True) -> Tuple[float, int]:
    """One episode on a fresh env seeded with ``cfg.seed``, stepping one
    session row of :func:`~sheeprl_tpu_torch.algos.ppo_recurrent.agent.session_step`
    (greedy by default, as JAX's ``test``); prints its return and returns it
    with the episode's step count."""
    seed = int(cfg.seed)
    env = make_env(cfg, seed)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    obs = env.reset(seed=seed)[0]
    state = initial_state(agent, 1, seed, device)
    done, cumulative, steps = False, 0.0, 0
    with torch.no_grad():
        while not done:
            prepared = {k: v[0] for k, v in prepare_obs({k: obs[k] for k in obs_keys}, cnn_keys, 1, device).items()}
            actions, state = session_step(agent, prepared, state, greedy)
            real = (actions.float() if actions.is_floating_point() else actions).cpu().numpy().reshape(-1)
            obs, reward, terminated, truncated, _ = env.step(real[0] if real.size == 1 else real)
            done = terminated or truncated
            cumulative += reward
            steps += 1
    env.close()
    print("Test - Reward:", cumulative, flush=True)
    return float(cumulative), steps
