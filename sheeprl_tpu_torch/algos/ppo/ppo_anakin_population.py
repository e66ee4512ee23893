"""PPO Anakin population: P (seed, hyperparameter, scenario) members trained
at once on the card (counterpart of
``sheeprl_tpu/algos/ppo/ppo_anakin_population.py``, one device).

The members are stacked on a leading axis: their parameters are the rows of
one ``(P, D)`` tensor, Adam's moments and step counts too
(:class:`~sheeprl_tpu_torch.optim.StackedAdam`), their envs one ``(P, N)``
batch of the device env whose dynamics constants are ``(P,)``-stacked (the
scenario axis). One block runs every member's iterations together: the
policy forward is ``torch.func.vmap`` of the agent over the members'
parameters (``functional_call``), GAE is one launch of the ``gae`` kernel's
per-member entry over the ``(T, P * N)`` columns with the ``(P,)`` gamma
and lambda, and each minibatch step is one ``vmap`` of ``grad`` over the
members, each with its own permutations, advantage normalisation, loss
coefficients and learning rate, then one Adam step of every member (its
gradient clipped by its own norm, its update skipped by its own finite
guard). Per iteration each member's fitness is its envs' mean sum of raw
rewards. With ``algo.population.pbt.enabled`` a truncation step follows
every ``every_blocks``-th block: the bottom q members copy the top q's
parameters and Adam state and inherit their hyperparameters, perturbed by
factors drawn from a generator (a test feeds JAX's draws). A population of
one runs the single-run block itself (JAX unrolls its size-1 ``vmap``), so
it equals the single run bit for bit.

Members' hyperparameters (``lr``, ``clip_coef``, ``ent_coef``, ``gamma``,
``gae_lambda``) and env constants resolve from ``algo.population.hparams``
and ``algo.population.env_params`` (a constant, a list of choices or a
``{low, high, log}`` range; ``sweep=grid`` or ``random``), with JAX's numpy
draws, bit for bit. Counters count per-member env steps, as in JAX.
Checkpoints hold the whole population: every member's parameters and Adam
state, the generators, ``hparams``, ``env_params``, ``fitness``,
``population_size``, ``best_member`` and ``block_num``; a resume takes the
checkpoint's hyperparameters and scenarios, never the sweep's. Evaluation
and serving take the fittest member.
"""

from __future__ import annotations

import copy
import itertools
import os
import time
import zlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, PPOPlayer, build_agent, dist_terms
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.ppo import LOSS_NAMES, make_optimizer
from sheeprl_tpu_torch.algos.ppo.ppo_anakin import (
    AnakinCarry,
    _log_episodes,
    anakin_env,
    dispatch_block,
    draw_iteration,
    log_block_rates,
    make_anakin_block,
    resolve_iters_per_block,
    rollout,
)
from sheeprl_tpu_torch.algos.ppo.utils import test
from sheeprl_tpu_torch.config import dotdict, plain
from sheeprl_tpu_torch.envs.device_envs import BatchedDeviceEnv, DeviceEnv
from sheeprl_tpu_torch.fault import CheckpointManager, DivergenceSentinel, load_resume_state
from sheeprl_tpu_torch.models import lecun_normal_
from sheeprl_tpu_torch.ops.kernels import gae_factors
from sheeprl_tpu_torch.optim import build_stacked_optimizer
from sheeprl_tpu_torch.utils.checkpoint import write_run_config
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, SumMetric, build_aggregator
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import polynomial_decay

__all__ = [
    "HPARAM_KEYS",
    "PBTConfig",
    "resolve_matrix",
    "resolve_sweep",
    "resolve_pbt",
    "make_pbt_step",
    "StackedMembers",
    "SingleMember",
    "make_population_block",
    "population_main",
    "main",
]

#: the hyperparameters a member may have of its own (JAX ``HPARAM_KEYS``)
HPARAM_KEYS = ("lr", "clip_coef", "ent_coef", "gamma", "gae_lambda")

#: PBT's clamps after a perturbation: the discounts stay in (0, 1)
_PERTURB_BOUNDS = {"gamma": (1e-3, 0.9999), "gae_lambda": (1e-3, 1.0)}


class PBTConfig(NamedTuple):
    """Resolved PBT: bottom ``num_copy`` members copy the top ones, the
    ``perturb`` hyperparameters (and ``env_perturb`` env fields) multiplied
    by one of ``factors``."""

    num_copy: int
    perturb: Tuple[str, ...]
    factors: Tuple[float, ...]
    env_perturb: Tuple[str, ...] = ()


def _base_hparams(cfg: Any) -> Dict[str, float]:
    return {
        "lr": float(cfg.algo.optimizer.lr),
        "clip_coef": float(cfg.algo.clip_coef),
        "ent_coef": float(cfg.algo.ent_coef),
        "gamma": float(cfg.algo.gamma),
        "gae_lambda": float(cfg.algo.gae_lambda),
    }


def _spec_kind(spec: Any) -> Tuple[str, Any]:
    """One sweep entry: ``const``, ``choices`` or ``range``."""
    if isinstance(spec, (int, float)):
        return "const", float(spec)
    if isinstance(spec, (list, tuple)):
        return "choices", [float(v) for v in spec]
    if isinstance(spec, dict) or hasattr(spec, "keys"):
        if "choices" in spec:
            return "choices", [float(v) for v in spec["choices"]]
        if "low" in spec and "high" in spec:
            low, high = float(spec["low"]), float(spec["high"])
            log = bool(spec.get("log", False))
            if not (high >= low):
                raise ValueError(f"sweep range must have high >= low, got low={low} high={high}")
            if log and low <= 0:
                raise ValueError(f"log-uniform sweep range requires low > 0, got {low}")
            return "range", (low, high, log)
    raise ValueError(
        f"Unsupported sweep spec {spec!r}: expected a scalar, a list of choices, "
        "{choices: [...]}, or {low: .., high: .., log: bool}"
    )


def resolve_matrix(cfg: Any, size: int, seed: int, env: Optional[DeviceEnv] = None
                   ) -> Tuple[Dict[str, np.ndarray], Tuple[str, ...], Dict[str, np.ndarray], Tuple[str, ...]]:
    """``algo.population.hparams`` and ``algo.population.env_params`` ->
    ``(hparams, swept, env_params, env_swept)`` (JAX ``resolve_matrix``, the
    same numpy draws): each hyperparameter a ``(P,)`` float32 array, each
    field of ``env.default_params()`` a ``(P,)`` array of its dtype, and the
    names that vary. ``sweep=grid``: one cartesian product over the
    hyperparameters' and then the env fields' choices, which must have
    ``size`` points. ``sweep=random``: each entry drawn from
    ``np.random.default_rng([seed, crc32(name)])`` (env fields under
    ``env_params.<name>``). Integer fields round to their dtype."""
    pop_cfg = cfg.algo.get("population") or {}
    mode = str(pop_cfg.get("sweep", "grid")).lower()
    if mode not in ("grid", "random"):
        raise ValueError(f"algo.population.sweep must be 'grid' or 'random', got {mode!r}")
    spec_map = dict(pop_cfg.get("hparams") or {})
    unknown = sorted(set(spec_map) - set(HPARAM_KEYS))
    if unknown:
        raise ValueError(f"Unknown population hparam(s) {unknown}; supported: {list(HPARAM_KEYS)}")
    env_spec_map = dict(pop_cfg.get("env_params") or {})
    if env_spec_map and env is None:
        raise ValueError(
            "algo.population.env_params is configured but no device env was provided to resolve "
            "its params against; scenario sweeps need the env"
        )

    base = _base_hparams(cfg)
    out = {k: np.full((size,), base[k], dtype=np.float32) for k in HPARAM_KEYS}
    env_out: Dict[str, np.ndarray] = {}
    env_dtypes: Dict[str, np.dtype] = {}
    env_fields: Tuple[str, ...] = ()
    if env is not None:
        defaults = env.default_params()
        env_fields = tuple(defaults._fields)
        unknown = sorted(set(env_spec_map) - set(env_fields))
        if unknown:
            raise ValueError(f"Unknown env param(s) {unknown} for '{env.id}'; default_params() fields: {list(env_fields)}")
        for f in env_fields:
            leaf = getattr(defaults, f).numpy()
            env_dtypes[f] = leaf.dtype
            env_out[f] = np.full((size,), leaf, dtype=leaf.dtype)

    def _env_cast(name: str, vals) -> np.ndarray:
        dt = env_dtypes[name]
        arr = np.asarray(vals, dtype=np.float64)
        return np.round(arr).astype(dt) if np.issubdtype(dt, np.integer) else arr.astype(dt)

    swept: List[str] = []
    env_swept: List[str] = []
    axes = [("hp", n, spec_map[n]) for n in HPARAM_KEYS if n in spec_map]
    axes += [("env", n, env_spec_map[n]) for n in env_fields if n in env_spec_map]

    if mode == "grid":
        grid_axes: List[Tuple[str, str, List[float]]] = []
        for space, name, spec in axes:
            kind, val = _spec_kind(spec)
            if kind == "const":
                if space == "hp":
                    out[name][:] = val
                else:
                    env_out[name][:] = _env_cast(name, val)
            elif kind == "range":
                raise ValueError(
                    f"sweep=grid cannot expand the range spec for '{name}'; list explicit choices or use sweep=random"
                )
            else:
                grid_axes.append((space, name, val))
        if grid_axes:
            points = list(itertools.product(*(vals for _, _, vals in grid_axes)))
            if len(points) != size:
                raise ValueError(
                    f"sweep=grid: the cartesian product of choices has {len(points)} points "
                    f"({' x '.join(f'{n}[{len(v)}]' for _, n, v in grid_axes)}) but "
                    f"algo.population.size={size}; make them equal (hparam and env_params axes share ONE grid)"
                )
            for i, point in enumerate(points):
                for (space, name, _), v in zip(grid_axes, point):
                    if space == "hp":
                        out[name][i] = v
                    else:
                        env_out[name][i] = _env_cast(name, v)
            swept = [n for s, n, _ in grid_axes if s == "hp"]
            env_swept = [n for s, n, _ in grid_axes if s == "env"]
    else:
        for space, name, spec in axes:
            kind, val = _spec_kind(spec)
            stream = name if space == "hp" else f"env_params.{name}"
            rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, zlib.crc32(stream.encode())])
            if kind == "const":
                draw = None
            elif kind == "choices":
                draw = rng.choice(np.asarray(val, dtype=np.float64), size=size)
            else:
                low, high, log = val
                draw = np.exp(rng.uniform(np.log(low), np.log(high), size=size)) if log else rng.uniform(low, high,
                                                                                                          size=size)
            if space == "hp":
                if draw is None:
                    out[name][:] = val
                else:
                    out[name][:] = draw.astype(np.float32)
                    swept.append(name)
            elif draw is None:
                env_out[name][:] = _env_cast(name, val)
            else:
                env_out[name][:] = _env_cast(name, draw)
                env_swept.append(name)
    return out, tuple(swept), env_out, tuple(env_swept)


def resolve_sweep(cfg: Any, size: int, seed: int) -> Tuple[Dict[str, np.ndarray], Tuple[str, ...]]:
    """The hyperparameters alone of :func:`resolve_matrix`."""
    hparams, swept, _, _ = resolve_matrix(cfg, size, seed, env=None)
    return hparams, swept


def resolve_pbt(cfg: Any, size: int, swept: Tuple[str, ...], env_swept: Tuple[str, ...] = ()
                ) -> Tuple[Optional[PBTConfig], int]:
    """``algo.population.pbt`` -> ``(PBTConfig or None, every_blocks)``
    (JAX ``resolve_pbt``, its checks included)."""
    pbt_cfg = (cfg.algo.get("population") or {}).get("pbt") or {}
    if not bool(pbt_cfg.get("enabled", False)):
        return None, 0
    if size < 2:
        raise ValueError(f"PBT needs algo.population.size >= 2, got {size}")
    frac = float(pbt_cfg.get("truncation_frac", 0.25))
    if not 0.0 < frac <= 0.5:
        raise ValueError(f"algo.population.pbt.truncation_frac must be in (0, 0.5], got {frac}")
    q = max(1, int(size * frac))
    if 2 * q > size:
        raise ValueError(
            f"PBT truncation copies the top {q} over the bottom {q} members, but 2*{q} > size={size}; "
            "lower truncation_frac"
        )
    perturb = pbt_cfg.get("perturb")
    perturb = tuple(perturb) if perturb is not None else tuple(swept)
    unknown = sorted(set(perturb) - set(HPARAM_KEYS))
    if unknown:
        raise ValueError(f"Unknown pbt.perturb hparam(s) {unknown}; supported: {list(HPARAM_KEYS)}")
    factors = tuple(float(f) for f in (pbt_cfg.get("perturb_factors") or (0.8, 1.25)))
    if not factors or any(f <= 0 for f in factors):
        raise ValueError(f"pbt.perturb_factors must be positive multipliers, got {factors}")
    every = int(pbt_cfg.get("every_blocks", 1))
    if every < 1:
        raise ValueError(f"pbt.every_blocks must be >= 1, got {every}")
    env_perturb = tuple(env_swept) if bool(pbt_cfg.get("perturb_env_params", False)) else ()
    return PBTConfig(num_copy=q, perturb=perturb, factors=factors, env_perturb=env_perturb), every


def make_pbt_step(pop_size: int, pbt: PBTConfig, device: "torch.device | str" = "cpu"):
    """The truncation step (JAX ``make_pbt_step``), gathers and selects on
    the member axis with no host read: ``step(hparams, env_params, fitness,
    factor_idx) -> (member_map, hparams, env_params)``. Members rank by
    fitness (a stable descending sort: ties keep member order); the bottom q
    take the top q's slots in ``member_map`` (the caller gathers parameters
    and optimizer state by it) and their hyperparameters, the ``perturb``
    ones times ``factors[factor_idx[i]]`` (row ``i`` of ``HPARAM_KEYS``,
    JAX's ``fold_in(key, i)`` draw), clamped for the discounts; the
    ``env_perturb`` fields of ``env_params`` likewise (row
    ``len(HPARAM_KEYS) + j`` for field ``j``; integers rounded, at least 1).
    ``factor_idx`` is ``(len(HPARAM_KEYS) + fields, P)`` int64. The factors
    are copied to ``device`` here, once, not inside the block."""
    q = int(pbt.num_copy)
    factors = torch.tensor(pbt.factors, dtype=torch.float32).to(device)

    def step(hparams: Dict[str, torch.Tensor], env_params: Any, fitness: torch.Tensor, factor_idx: torch.Tensor):
        device = fitness.device
        order = torch.argsort(-fitness, stable=True)
        src, dst = order[:q], order[pop_size - q:]
        member_map = torch.arange(pop_size, device=device).scatter(0, dst, src)
        replaced = torch.zeros(pop_size, dtype=torch.bool, device=device).scatter(0, dst, True)
        new_hparams = {}
        for i, name in enumerate(HPARAM_KEYS):
            old = hparams[name]
            h = old[member_map]
            if name in pbt.perturb:
                h = h * factors[factor_idx[i]]
                if name in _PERTURB_BOUNDS:
                    h = torch.clamp(h, *_PERTURB_BOUNDS[name])
            new_hparams[name] = torch.where(replaced, h, old)
        if pbt.env_perturb:
            fields = []
            for j, name in enumerate(type(env_params)._fields):
                h = getattr(env_params, name)
                if name not in pbt.env_perturb:
                    fields.append(h)
                    continue
                taken = h[member_map]
                f = factors[factor_idx[len(HPARAM_KEYS) + j]]
                if h.is_floating_point():
                    p = taken * f
                else:
                    p = torch.clamp(torch.round(taken.to(torch.float32) * f), min=1.0).to(h.dtype)
                fields.append(torch.where(replaced, p, h))
            env_params = type(env_params)(*fields)
        return member_map, new_hparams, env_params

    return step


class StackedMembers:
    """P members of one agent architecture: their parameters the rows of
    one ``(P, D)`` tensor (``flat``), in the agent's ``named_parameters``
    order; :meth:`views` gives each parameter as a ``(P, *shape)`` view."""

    def __init__(self, agent: PPOAgent, pop_size: int, device) -> None:
        self.agent = agent
        self.names = [n for n, _ in agent.named_parameters()]
        self.shapes = [tuple(p.shape) for _, p in agent.named_parameters()]
        self.sizes = [int(np.prod(s)) for s in self.shapes]
        self.pop_size = int(pop_size)
        self.flat = torch.zeros(self.pop_size, sum(self.sizes), dtype=torch.float32, device=device)

    def views(self) -> Dict[str, torch.Tensor]:
        parts = torch.split(self.flat, self.sizes, dim=1)
        return {n: p.view(self.pop_size, *s) for n, p, s in zip(self.names, parts, self.shapes)}

    def flatten(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``{name: (P, *shape)}`` -> ``(P, D)`` in this layout."""
        return torch.cat([tensors[n].reshape(self.pop_size, -1) for n in self.names], dim=1)

    def load_member(self, m: int, state: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            self.flat[m].copy_(torch.cat([state[n].reshape(-1).to(self.flat) for n in self.names]))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """``{name: (P, *shape)}``, the agent's keys with the member axis."""
        return {n: v.clone() for n, v in self.views().items()}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            self.flat.copy_(self.flatten({n: torch.as_tensor(state[n]).to(self.flat) for n in self.names}))


def _vmapped_forward(agent: PPOAgent):
    """``(params (P, ...), obs (P, ...)) -> (actor outs, values)`` over the
    member axis."""

    def forward(params: Dict[str, torch.Tensor], obs: Dict[str, torch.Tensor]):
        return torch.func.functional_call(agent, params, (obs,))

    return torch.func.vmap(forward)


def _vmapped_values(agent: PPOAgent):
    def values(params: Dict[str, torch.Tensor], obs: Dict[str, torch.Tensor]):
        feat = torch.func.functional_call(agent.feature_extractor, _sub(params, "feature_extractor."), (obs,))
        return torch.func.functional_call(agent.critic, _sub(params, "critic."), (feat,))

    return torch.func.vmap(values)


def _sub(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def make_population_block(agent: PPOAgent, members: StackedMembers, optimizer, cfg: Any, benv: BatchedDeviceEnv,
                          obs_key: str, guard: bool = False):
    """The P > 1 block: ``block(carry, iters, env_params, hparams,
    rollout_gen=None, train_gen=None, draws=None) -> (carry, metrics)``.
    ``carry`` holds ``(P, N, ...)`` envs; ``hparams`` the ``(P,)`` tensors of
    this block's ``lr``, ``clip_coef``, ``ent_coef`` (annealed), ``gamma``
    and ``gae_lambda``. ``draws`` (one dict per iteration: ``uniforms`` or
    ``noise`` ``(T, P, N, d)``, ``reset`` ``(T, P, N, ...)``, ``perms``
    ``(P, epochs, T * N)``) replaces the generators. ``metrics`` stays on the
    card: ``pg``, ``v``, ``ent``, ``bad``, ``fit`` ``(P, iters)``;
    ``ep_done``, ``ep_ret``, ``ep_len`` ``(P, iters, T, N)``."""
    algo = cfg.algo
    T = int(algo.rollout_steps)
    N = benv.num_envs
    P = members.pop_size
    rows = T * N
    epochs = int(algo.update_epochs)
    mb_size = int(algo.per_rank_batch_size)
    n_mb = max(1, -(-rows // mb_size))
    padded = n_mb * mb_size
    clip_vloss = bool(algo.clip_vloss)
    normalize_adv = bool(algo.normalize_advantages)
    vf_coef = float(algo.vf_coef)
    reduction = str(algo.loss_reduction)
    is_continuous = agent.is_continuous
    forward = _vmapped_forward(agent)
    values_fn = _vmapped_values(agent)

    def member_loss(params, batch, clip_coef, ent_coef):
        actions = torch.split(batch["actions"], list(agent.actions_dim), dim=-1)
        advantages = batch["advantages"]
        if normalize_adv:  # population std, as jnp.std
            advantages = (advantages - advantages.mean()) / (advantages.std(unbiased=False) + 1e-8)
        actor_outs, new_values = torch.func.functional_call(agent, params, ({obs_key: batch[obs_key]},))
        new_logprobs, entropy = dist_terms(actor_outs, is_continuous, actions)
        pg = policy_loss(new_logprobs, batch["logprobs"], advantages, clip_coef, reduction)
        v = value_loss(new_values, batch["values"], batch["returns"], clip_coef, clip_vloss, reduction)
        ent = entropy_loss(entropy, reduction)
        return pg + vf_coef * v + ent_coef * ent, torch.stack([pg, v, ent])

    grad_fn = torch.func.vmap(torch.func.grad_and_value(member_loss, has_aux=True))

    def update(data, perms, hparams):
        device = members.flat.device
        cyclic = torch.arange(padded, device=device) % rows
        idx = perms[:, :, cyclic].reshape(P, epochs, n_mb, mb_size)
        member = torch.arange(P, device=device)[:, None]
        total = torch.zeros(P, 3, dtype=torch.float32, device=device)
        skipped = torch.zeros(P, dtype=torch.float32, device=device)
        for e in range(epochs):
            for m in range(n_mb):
                rows_m = idx[:, e, m]
                batch = {k: v[member, rows_m] for k, v in data.items()}
                grads, (loss, losses) = grad_fn(members.views(), batch, hparams["clip_coef"], hparams["ent_coef"])
                flat_grads = members.flatten(grads)
                ok = None
                if guard:
                    ok = torch.isfinite(flat_grads).all(dim=1) & torch.isfinite(loss)
                    skipped += (~ok).to(torch.float32)
                optimizer.step(flat_grads, hparams["lr"], ok)
                total += losses.detach()
        return total / (epochs * n_mb), skipped

    def block(carry: AnakinCarry, iters: int, env_params, hparams: Dict[str, torch.Tensor],
              rollout_gen: Optional[torch.Generator] = None, train_gen: Optional[torch.Generator] = None,
              draws: Optional[List[Dict[str, Any]]] = None):
        device = carry.obs.device
        per_iter: Dict[str, List[torch.Tensor]] = {k: [] for k in ("losses", "bad", "fit", "ep_done", "ep_ret",
                                                                 "ep_len")}
        for i in range(iters):
            d = draws[i] if draws is not None else draw_iteration(
                benv.env, agent, (P, N), T, (P, epochs), rows, rollout_gen, train_gen, device)
            params = {k: v.detach() for k, v in members.views().items()}
            carry, traj, next_value = rollout(benv, lambda obs: forward(params, {obs_key: obs}),
                                              lambda obs: values_fn(params, {obs_key: obs}), T, carry, env_params,
                                              hparams["gamma"][:, None], d)
            returns, advantages = gae_factors(traj["rewards"][..., None], traj["values"],
                                              traj["dones"].to(torch.float32)[..., None], next_value,
                                              hparams["gamma"], hparams["gae_lambda"])
            data = {obs_key: traj["obs"], "actions": traj["actions"], "logprobs": traj["logprobs"],
                    "values": traj["values"], "returns": returns, "advantages": advantages}
            # (T, P, N, ...) -> (P, T * N, ...): each member's rows in (t, n) order
            data = {k: v.transpose(0, 1).reshape(P, rows, *v.shape[3:]) for k, v in data.items()}
            losses, skipped = update(data, d["perms"], hparams)
            per_iter["losses"].append(losses)
            per_iter["bad"].append(skipped)
            per_iter["fit"].append(traj["raw"].sum(dim=0).mean(dim=-1))
            for k, src in (("ep_done", "dones"), ("ep_ret", "ep_ret"), ("ep_len", "ep_len")):
                per_iter[k].append(traj[src].transpose(0, 1))
        losses = torch.stack(per_iter["losses"], dim=1)  # (P, iters, 3)
        metrics = {"pg": losses[..., 0], "v": losses[..., 1], "ent": losses[..., 2],
                   "bad": torch.stack(per_iter["bad"], dim=1), "fit": torch.stack(per_iter["fit"], dim=1)}
        for k in ("ep_done", "ep_ret", "ep_len"):
            metrics[k] = torch.stack(per_iter[k], dim=1)
        return carry, metrics

    return block


def _init_member(agent: PPOAgent, seed: int) -> Dict[str, torch.Tensor]:
    """flax-style init from ``seed`` (what ``build_agent`` gives for it)."""
    fresh = copy.deepcopy(agent).to("cpu")
    with torch.no_grad():
        lecun_normal_(fresh, torch.Generator().manual_seed(int(seed)))
    return fresh.state_dict()


class SingleMember:
    """A population of one: the single run's agent, Adam and block
    (``make_anakin_block(population=True)``), its state with a member axis
    of one at the checkpoint."""

    def __init__(self, agent: PPOAgent, optimizer, cfg, benv, obs_key: str, guard: bool) -> None:
        self.agent, self.optimizer = agent, optimizer
        self.block = make_anakin_block(agent, optimizer, cfg, benv, obs_key, guard=guard, population=True)

    def run(self, carry, iters, env_params, hparams, rollout_gen=None, train_gen=None, draws=None):
        """``carry`` holds the one member's ``(N, ...)`` envs, unstacked, as
        the single run's; ``env_params`` are ``(1,)``-stacked."""
        # optax's injected learning rate is a float32 array, as is the member's here
        self.optimizer.set_lr(float(hparams["lr_host"][0]))
        env_params = type(env_params)(*[f[0] for f in env_params])
        carry, metrics = self.block(carry, iters, env_params, hparams["clip_coef"][0], hparams["ent_coef"][0],
                                    hparams["gamma"], hparams["gae_lambda"], rollout_gen=rollout_gen,
                                    train_gen=train_gen, draws=draws)
        return carry, {k: v[None] for k, v in metrics.items()}

    def state_dict(self) -> Dict[str, Any]:
        return {"agent": {k: v[None].clone() for k, v in self.agent.state_dict().items()},
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.agent.load_state_dict({k: torch.as_tensor(v)[0] for k, v in state["agent"].items()})
        self.optimizer.load_state_dict(state["optimizer"])

    def member_state(self, m: int) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.agent.state_dict().items()}


class _Stacked:
    """The P > 1 members: :class:`StackedMembers` under
    :class:`~sheeprl_tpu_torch.optim.StackedAdam` and the population block."""

    def __init__(self, agent: PPOAgent, members: StackedMembers, cfg, benv, obs_key: str, guard: bool) -> None:
        self.agent, self.members = agent, members
        self.optimizer = build_stacked_optimizer(members.flat, cfg.algo.optimizer, cfg.algo.max_grad_norm)
        self.block = make_population_block(agent, members, self.optimizer, cfg, benv, obs_key, guard=guard)

    def run(self, carry, iters, env_params, hparams, rollout_gen=None, train_gen=None, draws=None):
        return self.block(carry, iters, env_params, hparams, rollout_gen=rollout_gen, train_gen=train_gen,
                          draws=draws)

    def gather_(self, member_map: torch.Tensor) -> None:
        with torch.no_grad():
            self.members.flat.copy_(self.members.flat.index_select(0, member_map))
        self.optimizer.gather_(member_map)

    def state_dict(self) -> Dict[str, Any]:
        return {"agent": self.members.state_dict(),
                "optimizer": {k: v.clone() for k, v in self.optimizer.state_dict().items()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.members.load_state_dict(state["agent"])
        self.optimizer.load_state_dict(state["optimizer"])

    def member_state(self, m: int) -> Dict[str, torch.Tensor]:
        return {k: v[m].clone() for k, v in self.members.views().items()}


def _host_hparams(hparams: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v, np.float32).copy()).to(device) for k, v in hparams.items()}


def _scenario_line(env_params: Any, env_swept: Tuple[str, ...], m: int) -> str:
    return ", ".join(f"{k}={float(np.asarray(getattr(env_params, k))[m]):.6g}" for k in env_swept)


def population_main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    """The population driver (``algo=ppo_anakin_population``, or
    ``algo=ppo_anakin`` with ``algo.population.size`` > 1). Returns a
    summary: the single run's keys, the best member's episodes under
    ``episodes``, ``fitness`` per block, ``best_member``, ``hparams`` and the
    PBT steps taken."""
    device = torch.device(device)
    algo = cfg.algo
    pop_cfg = algo.get("population") or {}
    pop_size = int(pop_cfg.get("size") or 1)
    if pop_size < 1:
        raise ValueError(f"algo.population.size must be >= 1, got {pop_size}")
    share_init = bool(pop_cfg.get("share_init", False))
    # a population run writes population checkpoints: stamp the name before
    # the run's directory and config are written, so evaluation, serving
    # and resume find the population's entry points
    old_name = str(algo.name)
    algo["name"] = "ppo_anakin_population"
    if old_name != algo.name:
        for key in ("root_dir", "exp_name", "run_name"):
            val = str(cfg.get(key) or "")
            if old_name in val:
                cfg[key] = val.replace(old_name, algo.name)

    state = None
    if cfg.checkpoint.get("resume_from"):
        state = load_resume_state(cfg.checkpoint.resume_from)
        if state is not None and int(state.get("population_size", pop_size)) != pop_size:
            raise ValueError(
                f"Resume checkpoint holds a population of {state.get('population_size')} members but "
                f"algo.population.size={pop_size}; the whole population resumes together"
            )
    env, obs_key = anakin_env(cfg)
    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    cfg["spaces"] = dotdict(env.spaces(obs_key))
    actions_dim = (int(env.action_shape[0]),) if env.is_continuous else (int(env.n_actions),)
    seed = int(cfg.seed)

    hparams_np, swept, env_params_np, env_swept = resolve_matrix(cfg, pop_size, seed, env=env)
    if env_swept:  # a constructor kwarg shadowing a swept field raises
        env, _ = anakin_env(cfg, swept_params=env_swept)
    if state is not None and state.get("hparams") is not None:
        hparams_np = {k: np.asarray(v, dtype=np.float32) for k, v in state["hparams"].items()}
    if state is not None and state.get("env_params") is not None:
        env_params_np = {k: np.asarray(v) for k, v in state["env_params"].items()}
    pbt, pbt_every = resolve_pbt(cfg, pop_size, swept, env_swept)
    defaults = env.default_params()
    env_params = type(defaults)(*[torch.from_numpy(np.asarray(env_params_np[f]).copy()).to(device)
                                  for f in defaults._fields])
    logger.log_hyperparams(cfg)
    write_run_config(log_dir, plain(cfg))
    aggregator = None if MetricAggregator.disabled else build_aggregator(cfg.metric.get("aggregator"))

    train_gen = torch.Generator(device=device).manual_seed(seed)
    rollout_gen = torch.Generator(device=device).manual_seed(seed + 1)
    reset_gen = torch.Generator(device=device).manual_seed(seed + 2)
    pop_gen = torch.Generator(device=device).manual_seed(seed + 3)
    if state is not None:
        for gen, key in ((train_gen, "rng"), (rollout_gen, "rollout_rng"), (pop_gen, "pop_key")):
            if state.get(key) is not None:
                gen.set_state(state[key])
        algo["per_rank_batch_size"] = int(state["batch_size"])

    num_envs = int(cfg.env.num_envs)
    benv = BatchedDeviceEnv(env, num_envs)
    sentinel_cfg = (cfg.get("fault") or {}).get("sentinel") or {}
    guard = bool(sentinel_cfg.get("enabled", True))
    agent, _ = build_agent(cfg, actions_dim, env.is_continuous, cfg.spaces.obs, device)
    if pop_size == 1:
        runner: Any = SingleMember(agent, make_optimizer(cfg, agent), cfg, benv, obs_key, guard)
    else:
        runner = _Stacked(agent, StackedMembers(agent, pop_size, device), cfg, benv, obs_key, guard)
    if state is not None:
        runner.load_state_dict(state)
    elif pop_size > 1:
        for m in range(pop_size):
            runner.members.load_member(m, _init_member(agent, seed if share_init else seed + m))
    print(f"Population: {pop_size} members, sweep over "
          f"{list(swept) + [f'env_params.{n}' for n in env_swept] or 'nothing (seed-only)'}", flush=True)
    for m in range(pop_size):
        line = ", ".join(f"{k}={hparams_np[k][m]:.6g}" for k in HPARAM_KEYS)
        if env_swept:
            line += ", " + ", ".join(f"{k}={np.asarray(env_params_np[k])[m]:.6g}" for k in env_swept)
        print(f"  member {m}: {line}", flush=True)

    T = int(algo.rollout_steps)
    policy_steps_per_iter = num_envs * T
    total_iters = int(algo.total_steps) // policy_steps_per_iter if not bool(cfg.get("dry_run", False)) else 1
    start_iter = int(state["iter_num"]) + 1 if state is not None else 1
    policy_step = int(state["iter_num"]) * policy_steps_per_iter if state is not None else 0
    last_log = int(state["last_log"]) if state is not None else 0
    last_checkpoint = int(state["last_checkpoint"]) if state is not None else 0
    train_step = int(state.get("train_step", 0)) if state is not None else 0
    last_train = int(state.get("last_train", 0)) if state is not None else 0
    log_level = int(cfg.metric.get("log_level", 1))
    log_every = int(cfg.metric.get("log_every", 5000))
    iters_per_block = resolve_iters_per_block(cfg, total_iters, policy_steps_per_iter, True, population_size=pop_size)
    sentinel = DivergenceSentinel(sentinel_cfg)
    ckpt_dir = os.path.join(log_dir, "checkpoint")
    manager = CheckpointManager.from_config(cfg)

    # a population of one steps its envs unstacked, as the single run does
    reset_params = type(env_params)(*[f[0] for f in env_params]) if pop_size == 1 else env_params
    env_state, obs = benv.reset(reset_params, generator=reset_gen)
    batch = benv.batch_shape(reset_params)
    carry = AnakinCarry(env_state, obs, torch.zeros(batch, device=device),
                        torch.zeros(batch, dtype=torch.int32, device=device))
    hparams = _host_hparams(hparams_np, device)
    lr_host = hparams_np["lr"].copy()  # a population of one sets its Adam's rate from the host

    done_iters = start_iter - 1
    fracs = {name: (polynomial_decay(done_iters, initial=1.0, final=0.0, max_decay_steps=total_iters)
                    if algo.get(flag) and done_iters > 0 else 1.0)
             for name, flag in (("lr", "anneal_lr"), ("clip_coef", "anneal_clip_coef"), ("ent_coef", "anneal_ent_coef"))}
    fitness_np = (np.asarray(state["fitness"], np.float32) if state is not None and state.get("fitness") is not None
                  else np.zeros((pop_size,), np.float32))
    block_num = int(state.get("block_num", 0)) if state is not None else 0
    n_fields = len(defaults._fields)
    pbt_step = make_pbt_step(pop_size, pbt, device) if pbt is not None else None
    summary: Dict[str, Any] = {
        "start_iter": start_iter, "iterations": 0, "blocks": 0, "iters_per_block": iters_per_block,
        "population_size": pop_size, "losses": [], "episodes": [], "block_s": [], "fitness": [], "pbt_steps": 0,
        "checkpoint": None, "device": str(device), "test_reward": None, "test_steps": None, "skipped": [],
    }
    iter_num = start_iter - 1
    best = int(fitness_np.argmax())
    while iter_num < total_iters:
        block_iters = min(iters_per_block, total_iters - iter_num)
        block_num += 1
        gate = pbt_step is not None and block_num % pbt_every == 0

        def population_block(carry, block_iters, gate, block_hp):
            """The members' iterations, then (gated) PBT, all on the card."""
            nonlocal hparams, env_params
            carry, metrics = runner.run(carry, block_iters, env_params, block_hp, rollout_gen=rollout_gen,
                                        train_gen=train_gen)
            metrics["fitness"] = metrics["fit"].mean(dim=1)
            if gate:  # before the block's one read, so the host reads the live hyperparameters with it
                factor_idx = torch.randint(0, len(pbt.factors), (len(HPARAM_KEYS) + n_fields, pop_size),
                                           generator=pop_gen, device=device)
                member_map, hparams, env_params = pbt_step(hparams, env_params, metrics["fitness"], factor_idx)
                runner.gather_(member_map)
                for k in HPARAM_KEYS:
                    metrics[f"hparams.{k}"] = hparams[k]
                for k in env_swept:
                    metrics[f"env_params.{k}"] = getattr(env_params, k)
            return carry, metrics

        t0 = time.perf_counter()
        with timer("Time/train_time", SumMetric):
            # the block's annealed coefficients, staged before the block: its inside copies nothing to the card
            frac = torch.tensor([fracs["lr"], fracs["clip_coef"], fracs["ent_coef"]], dtype=torch.float32).to(device)
            block_hp = dict(hparams, lr=hparams["lr"] * frac[0], clip_coef=hparams["clip_coef"] * frac[1],
                            ent_coef=hparams["ent_coef"] * frac[2], lr_host=lr_host * np.float32(fracs["lr"]))
            carry, metrics = dispatch_block(population_block, carry, block_iters, gate, block_hp)
        summary["block_s"].append(time.perf_counter() - t0)
        summary["blocks"] += 1
        fitness_np = metrics["fitness"].astype(np.float32)
        summary["fitness"].append(fitness_np.tolist())
        if gate:
            summary["pbt_steps"] += 1
            hparams_np = {k: metrics[f"hparams.{k}"].astype(np.float32) for k in HPARAM_KEYS}
            lr_host = hparams_np["lr"].copy()
            for k in env_swept:
                env_params_np[k] = metrics[f"env_params.{k}"].astype(np.asarray(env_params_np[k]).dtype)
        best = int(fitness_np.argmax())
        _log_episodes(summary, aggregator if log_level > 0 else None,
                      {k: metrics[k][best] for k in ("ep_done", "ep_ret", "ep_len")}, block_iters, policy_step,
                      policy_steps_per_iter, echo=False)
        tripped = False
        for i in range(block_iters):
            iter_num += 1
            policy_step += policy_steps_per_iter
            train_step += 1
            losses = [float(metrics[k][:, i].mean()) for k in ("pg", "v", "ent")]
            summary["losses"].append(losses)
            if guard:
                bad = float(metrics["bad"][:, i].sum())
                summary["skipped"].append(bad)
                tripped = sentinel.observe(bad) or tripped
            if aggregator is not None and log_level > 0:
                for name, value in zip(LOSS_NAMES, losses):
                    aggregator.update(name, value)
        summary["iterations"] += block_iters
        if tripped:
            def rollback(good: Dict[str, Any]) -> None:
                nonlocal hparams, env_params, fitness_np, hparams_np, lr_host
                runner.load_state_dict(good)
                for gen, key in ((train_gen, "rng"), (rollout_gen, "rollout_rng"), (pop_gen, "pop_key")):
                    if good.get(key) is not None:
                        gen.set_state(good[key])
                if good.get("hparams") is not None:
                    hparams_np = {k: np.asarray(v, np.float32) for k, v in good["hparams"].items()}
                    hparams = _host_hparams(hparams_np, device)
                    lr_host = hparams_np["lr"].copy()
                if good.get("env_params") is not None:
                    env_params = type(env_params)(*[torch.as_tensor(good["env_params"][f]).to(device)
                                                    for f in type(env_params)._fields])
                fitness_np = (np.asarray(good["fitness"], np.float32) if good.get("fitness") is not None
                              else np.zeros((pop_size,), np.float32))

            manager.wait()
            sentinel.recover(ckpt_dir, rollback)
            best = int(fitness_np.argmax())
        if log_level > 0:
            ranks = np.argsort(np.argsort(-fitness_np))
            pop_metrics: Dict[str, Any] = {
                "Population/fitness_best": float(fitness_np.max()),
                "Population/fitness_median": float(np.median(fitness_np)),
                "Population/fitness_worst": float(fitness_np.min()),
                "Population/best_member": best,
            }
            member_ret = np.full((pop_size,), np.nan, np.float32)
            for m in range(pop_size):
                done_m = metrics["ep_done"][m]
                if done_m.any():
                    member_ret[m] = metrics["ep_ret"][m][done_m].mean()
            if np.isfinite(member_ret).any():
                pop_metrics["Population/return_best"] = float(np.nanmax(member_ret))
                pop_metrics["Population/return_median"] = float(np.nanmedian(member_ret))
            for m in range(pop_size):
                pop_metrics[f"Population/member_{m}/fitness"] = float(fitness_np[m])
                pop_metrics[f"Population/member_{m}/rank"] = int(ranks[m])
            if gate:
                for m in range(pop_size):
                    for k in HPARAM_KEYS:
                        pop_metrics[f"Population/member_{m}/{k}"] = float(hparams_np[k][m])
                    for k in env_swept:
                        pop_metrics[f"Population/member_{m}/env_{k}"] = float(np.asarray(env_params_np[k])[m])
            logger.log_dict(pop_metrics, policy_step)
            logger.log_dict({"Info/learning_rate": float(algo.optimizer.lr) * fracs["lr"],
                             "Info/clip_coef": float(algo.clip_coef) * fracs["clip_coef"],
                             "Info/ent_coef": float(algo.ent_coef) * fracs["ent_coef"]}, policy_step)
            if guard and sentinel.total_skipped:
                logger.log_dict({"Fault/skipped_updates": sentinel.total_skipped}, policy_step)
            if policy_step - last_log >= log_every or iter_num == total_iters:
                print(f"policy_step={policy_step} best_member={best} fitness={fitness_np.tolist()}", flush=True)
                if aggregator is not None:
                    logger.log_dict(aggregator.compute(), policy_step)
                    aggregator.reset()
                log_block_rates(logger, policy_step, train_step - last_train, policy_step - last_log, pop_size)
                last_log = policy_step
                last_train = train_step
        for name, flag in (("lr", "anneal_lr"), ("clip_coef", "anneal_clip_coef"), ("ent_coef", "anneal_ent_coef")):
            if algo.get(flag):
                fracs[name] = polynomial_decay(iter_num, initial=1.0, final=0.0, max_decay_steps=total_iters)
        if (int(cfg.checkpoint.every) > 0 and policy_step - last_checkpoint >= int(cfg.checkpoint.every)) or (
            iter_num == total_iters and cfg.checkpoint.get("save_last", False)
        ):
            last_checkpoint = policy_step
            ckpt_state = {
                **runner.state_dict(),
                "scheduler": None,
                "iter_num": iter_num,
                "batch_size": int(algo.per_rank_batch_size),
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "train_step": train_step,
                "last_train": last_train,
                "rng": train_gen.get_state(),
                "rollout_rng": rollout_gen.get_state(),
                "pop_key": pop_gen.get_state(),
                # tensors, not numpy arrays: the checkpoint loads with weights_only
                "hparams": {k: torch.from_numpy(np.asarray(v, np.float32).copy()) for k, v in hparams_np.items()},
                "env_params": {k: torch.from_numpy(np.asarray(v).copy()) for k, v in env_params_np.items()},
                "fitness": torch.from_numpy(fitness_np.copy()),
                "population_size": pop_size,
                "best_member": best,
                "block_num": block_num,
            }
            path = os.path.join(ckpt_dir, f"ckpt_{policy_step}_0.ckpt")
            summary["checkpoint"] = str(manager.save(path, ckpt_state, step=policy_step, config=plain(cfg)))

    manager.close()
    best = int(fitness_np.argmax())
    summary.update(best_member=best, hparams={k: np.asarray(v).tolist() for k, v in hparams_np.items()},
                   env_params={k: np.asarray(v).tolist() for k, v in env_params_np.items()})
    if algo.get("run_test", True):
        best_agent, _ = build_agent(cfg, actions_dim, env.is_continuous, cfg.spaces.obs, device,
                                    runner.member_state(best))
        summary["test_reward"], summary["test_steps"] = test(PPOPlayer(best_agent), cfg, device)
    logger.close()
    block_s = sum(summary["block_s"])
    summary.update(
        policy_steps=policy_step,
        log_dir=log_dir,
        env_steps_per_s=summary["iterations"] * policy_steps_per_iter / block_s if block_s > 0 else None,
        rollbacks=sentinel.rollbacks,
        checkpoint_timings=manager.timings,
        **{"Fault/skipped_updates": sentinel.total_skipped},
    )
    return summary


def main(cfg: Any, device: torch.device) -> Dict[str, Any]:
    return population_main(cfg, device)
