"""Rank processes for the port's data-parallel CPU tests: no JAX here.

:func:`spawn_ranks` starts ``world`` processes (the ``spawn`` start method),
joins them in one gloo group on a loopback port through the port's
``maybe_init``, runs one of this module's jobs on each rank with the same
payload and returns the results in rank order. Each job is a module-level
function ``job(rank, payload) -> result``; payloads are numpy arrays, tensors
and plain containers, results numpy arrays and plain containers.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import traceback
from typing import Any, Callable, Dict, List

import numpy as np
import torch

RANK_TIMEOUT_S = 120.0


def spawn_ranks(job: Callable[[int, Any], Any], payload: Any, world: int = 2,
                timeout: float = RANK_TIMEOUT_S) -> List[Any]:
    """``job(rank, payload)`` on ``world`` gloo ranks; the results by rank.
    Raises with a rank's traceback if a job fails, and stops every process
    whatever happens."""
    from sheeprl_tpu_torch.serve.fleet import free_port

    ctx = mp.get_context("spawn")
    results: "mp.Queue" = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(job, rank, world, port, payload, results), daemon=True)
             for rank in range(world)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{world - len(out)} rank(s) gave no result within {timeout:g}s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(world)]


def _entry(job, rank: int, world: int, port: int, payload: Any, results) -> None:
    from sheeprl_tpu_torch.parallel.distributed import maybe_init, shutdown

    torch.set_num_threads(1)
    try:
        maybe_init(coordinator_address=f"127.0.0.1:{port}", num_processes=world, process_id=rank)
        results.put((rank, True, job(rank, payload)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


# -- jobs ------------------------------------------------------------------------


def comm_job(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """``pmean_grads``, ``pmean_grads_with_verdict``, ``all_gather_wire``,
    ``all_gather_rows`` and ``gather_envs`` on this rank's share of the
    payload, at the payload's wire."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import gather_envs
    from sheeprl_tpu_torch.parallel import comm

    comm.set_grad_reduce_dtype(payload["wire"], fresh_run=True)
    grads = [torch.from_numpy(g[rank]) for g in payload["grads"]]
    ok = torch.tensor(bool(payload["ok"][rank]))
    mean_grads, verdict = comm.pmean_grads_with_verdict(grads, ok)
    return {
        "pmean": [g.numpy() for g in comm.pmean_grads(grads)],
        "pmean_verdict": [g.numpy() for g in mean_grads],
        "verdict": bool(verdict),
        "gather_wire": comm.all_gather_wire(torch.from_numpy(payload["gather"][rank])).numpy(),
        "gather_rows": comm.all_gather_rows(torch.from_numpy(payload["gather"][rank])).numpy(),
        "gather_envs": gather_envs({"x": payload["envs"][:, rank * 2:(rank + 1) * 2]})["x"],
        "calls": dict(comm.REDUCTIONS),
    }


def _numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Results cross back as numpy: a tensor sent through a queue is a file
    descriptor of its sender, which exits."""
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _dotdict(cfg: Dict[str, Any]):
    from sheeprl_tpu_torch.config import dotdict

    return dotdict(cfg)


def ppo_update_job(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """One PPO update on this rank's rows from JAX's weights, with the
    payload's permutations for this rank (indices into the gathered rows
    under ``buffer.share_data``)."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step, param_digest
    from sheeprl_tpu_torch.parallel import comm

    comm.set_grad_reduce_dtype(payload["wire"], fresh_run=True)
    cfg = _dotdict(payload["cfg"])
    agent, _ = build_agent(cfg, (2,), False, {"state": {"shape": [4]}}, "cpu", payload["state"])
    optimizer = make_optimizer(cfg, agent)
    local = payload["local_rows"]
    data = {k: torch.from_numpy(np.ascontiguousarray(v[rank * local:(rank + 1) * local]))
            for k, v in payload["data"].items()}
    train = make_train_step(agent, optimizer, cfg, local, guard=payload["guard"])
    losses, skipped = train(data, 0.2, 0.01, perms=torch.from_numpy(payload["perms"][rank]))
    names = {p: n for n, p in agent.named_parameters()}
    state = optimizer.optimizer.state
    return {
        "losses": losses.numpy(), "skipped": float(skipped),
        "params": _numpy(agent.state_dict()), "mu": {names[p]: s["exp_avg"].numpy().copy() for p, s in state.items()},
        "digest": param_digest(agent), "calls": comm.REDUCTIONS["calls"],
    }


def a2c_update_job(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """One A2C update on this rank's rows from JAX's weights with this
    rank's permutation."""
    from sheeprl_tpu_torch.algos.a2c.a2c import make_optimizer, make_train_step
    from sheeprl_tpu_torch.algos.a2c.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import param_digest
    from sheeprl_tpu_torch.parallel import comm

    comm.set_grad_reduce_dtype(payload["wire"], fresh_run=True)
    cfg = _dotdict(payload["cfg"])
    agent, _ = build_agent(cfg, payload["dims"], False, {"state": {"shape": [4]}}, "cpu", payload["state"])
    optimizer = make_optimizer(cfg, agent)
    local = payload["local_rows"]
    data = {k: torch.from_numpy(np.ascontiguousarray(v[rank * local:(rank + 1) * local]))
            for k, v in payload["data"].items()}
    losses = make_train_step(agent, optimizer, cfg, local)(data, perm=torch.from_numpy(payload["perms"][rank]))
    return {"losses": losses.numpy(), "params": _numpy(agent.state_dict()), "digest": param_digest(agent)}


def recurrent_update_job(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """One recurrent PPO update: this rank's envs of the rollout gathered
    back into the group's (``gather_envs``), chunked and sharded by
    ``prepare_update``, then the update with this rank's permutations."""
    from sheeprl_tpu_torch.algos.ppo.ppo import param_digest
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import (
        gather_envs,
        make_optimizer,
        make_train_step,
        prepare_update,
    )
    from sheeprl_tpu_torch.parallel import comm

    comm.set_grad_reduce_dtype(payload["wire"], fresh_run=True)
    cfg = _dotdict(payload["cfg"])
    world, n = 2, payload["envs_per_rank"]
    local = {k: np.ascontiguousarray(v[:, rank * n:(rank + 1) * n]) for k, v in payload["rollout"].items()}
    gathered = gather_envs(local)
    returns, advantages = gathered.pop("returns"), gathered.pop("advantages")
    data = prepare_update(gathered, returns, advantages, payload["T"], world * n, payload["seq"],
                          world * payload["nb"], "cpu", rank, world)
    agent, _ = build_agent(cfg, (2,), False, {"state": {"shape": [4]}}, "cpu", payload["state"])
    optimizer = make_optimizer(cfg, agent)
    s_local = int(data["mask"].shape[1])
    losses = make_train_step(agent, optimizer, cfg, s_local)(
        data, 0.2, 0.001, perms=torch.from_numpy(payload["perms"][rank]))
    return {"losses": losses.numpy(), "s_local": s_local,
            "params": _numpy(dict(agent.named_parameters())), "digest": param_digest(agent)}


# -- the off-policy families (one job runs every case of a test file) -------------


class PlainSgd:
    """``optax.sgd(lr)``'s step in place of a port optimizer: a parameter's
    change is its (reduced) gradient times ``lr``."""

    def __init__(self, params, lr: float):
        self.params, self.lr = list(params), float(lr)

    def step(self, grads):
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                p.sub_(self.lr * g)


def _rows_of(data: Dict[str, np.ndarray], rank: int, width: int, axis: int) -> Dict[str, torch.Tensor]:
    """This rank's slice ``[rank * width, (rank + 1) * width)`` of each
    array along ``axis``."""
    sl = [slice(None)] * 8
    sl[axis] = slice(rank * width, (rank + 1) * width)
    return {k: torch.from_numpy(np.ascontiguousarray(v[tuple(sl[:v.ndim])])) for k, v in data.items()}


def _noise_of(noise: Dict[str, Any], rank: int) -> Dict[str, Any]:
    out = {}
    for k, v in noise.items():
        if isinstance(v, dict):
            out[k] = _noise_of(v, rank)
        else:
            out[k] = None if v is None else torch.from_numpy(np.ascontiguousarray(v[rank]))
    return out


def _sac_case(rank: int, c: Dict[str, Any]) -> Dict[str, Any]:
    from sheeprl_tpu_torch.algos.ppo.ppo import param_digest
    from sheeprl_tpu_torch.algos.sac import sac
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.parallel.distributed import world_size
    from sheeprl_tpu_torch.replay import DeviceReplayBuffer, DeviceReplayState

    cfg = _dotdict(c["cfg"])
    agent, _ = build_agent(cfg, c["obs_dim"], c["action_space"], "cpu", c["state"])
    optimizers = sac.make_optimizers(cfg, agent)
    out: Dict[str, Any] = {}
    if c["kind"] == "sac_host":
        data = _rows_of(c["data"], rank, c["local_batch"], 1)
        losses, skipped = sac.make_train_step(agent, optimizers, cfg, guard=c["guard"])(
            data, c["ema"], noise=_noise_of(c["noise"], rank))
    else:
        ring = c["ring"]
        n_local = c["envs_per_rank"]
        prioritized = c["prioritized"]
        n_ring = n_local * world_size() if prioritized else n_local
        drb = DeviceReplayBuffer(c["specs"], ring["capacity"], n_ring, prioritized=prioritized, per_alpha=0.6,
                                 per_eps=1e-6, seed=29)
        arrays = {f"storage/{k}": torch.from_numpy(np.ascontiguousarray(
            v if prioritized else v[:, rank * n_local:(rank + 1) * n_local])) for k, v in ring["storage"].items()}
        arrays["key"] = drb.generator.get_state()
        if prioritized:
            arrays["tree"], arrays["max_p"] = torch.from_numpy(ring["tree"]), torch.tensor(ring["max_p"])
        meta = {"capacity": ring["capacity"], "n_envs": n_ring, "prioritized": prioritized,
                "host_pos": ring["pos"], "host_full": False}
        drb.load_state_dict(DeviceReplayState("uniform", arrays, meta))
        row = {k: np.ascontiguousarray(v[:, rank * n_local:(rank + 1) * n_local]) for k, v in c["row"].items()}
        # the loop's append: the replicated ring takes every rank's row in rank order
        drb.add({k: sac._gather_envs(v, world_size()) for k, v in row.items()} if prioritized else row)
        draws = _noise_of(c["draws"], rank)
        train = sac.make_resident_train_step(agent, optimizers, cfg, drb, guard=c["guard"])
        losses, skipped = train(drb.make_job(), c["flags"], c["beta"], draws=draws)
        out["storage"] = _numpy(drb.storage)
        out["ring_digest"] = drb.digest()
        if prioritized:
            out["tree"], out["max_p"] = drb.tree.numpy().copy(), float(drb.max_p)
    out.update(losses=losses.numpy(), skipped=float(skipped), params=_numpy(agent.state_dict()),
               digest=param_digest(agent))
    return out


def _ensemble_case(rank: int, c: Dict[str, Any]) -> Dict[str, Any]:
    from sheeprl_tpu_torch.algos.droq import droq
    from sheeprl_tpu_torch.algos.droq.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import param_digest
    from sheeprl_tpu_torch.algos.sac.sac import RING_KEYS, make_optimizers

    cfg = _dotdict(c["cfg"])
    agent, _ = build_agent(cfg, c["obs_dim"], c["action_space"], "cpu", c["state"])
    train = droq.make_train_step(agent, make_optimizers(cfg, agent), cfg)
    critic = _rows_of({k: c["critic_data"][k] for k in RING_KEYS}, rank, c["local_batch"], 1)
    actor = _rows_of({k: c["actor_data"][k] for k in RING_KEYS}, rank, c["local_batch"], 0)
    losses = train(critic, actor, noise=_noise_of(c["noise"], rank))
    return {"losses": losses.numpy(), "params": _numpy(agent.state_dict()), "digest": param_digest(agent)}


def _pixel_case(rank: int, c: Dict[str, Any]) -> Dict[str, Any]:
    from sheeprl_tpu_torch.algos.ppo.ppo import param_digest
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_optimizers, make_train_step

    cfg = _dotdict(c["cfg"])
    agent, _ = build_agent(cfg, "cpu", c["state"])
    optimizers = {k: PlainSgd([p for group in opt.optimizer.param_groups for p in group["params"]], c["lr"])
                  for k, opt in make_optimizers(cfg, agent).items()}
    data = _rows_of(c["data"], rank, c["local_batch"], 1)
    losses = make_train_step(agent, optimizers, cfg)(data, c["cum0"], noise=_noise_of(c["noise"], rank))
    return {"losses": losses.numpy(), "params": _numpy(agent.state_dict()), "digest": param_digest(agent)}


def _exact_case(rank: int, c: Dict[str, Any]) -> Dict[str, Any]:
    """``all_reduce_max``, ``all_true`` and ``all_gather_exact`` on this
    rank's inputs, at the case's (bfloat16) wire: none of them rounds."""
    from sheeprl_tpu_torch.parallel import comm

    leaves = torch.from_numpy(c["leaves"][rank])
    prios = torch.from_numpy(c["prios"][rank])
    got_leaves, got_prios = comm.all_gather_exact(leaves, prios)
    return {"max": comm.all_reduce_max(torch.from_numpy(c["values"][rank])).numpy(),
            "all_true": [comm.all_true(bool(f[rank])) for f in c["flags"]],
            "leaves": got_leaves.numpy(), "prios": got_prios.numpy(),
            "dtypes": [str(got_leaves.dtype), str(got_prios.dtype)]}


_OFFPOLICY = {"sac_host": _sac_case, "sac_resident": _sac_case, "ensemble": _ensemble_case, "pixel": _pixel_case,
              "exact": _exact_case}


def offpolicy_job(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """Every case of ``payload["cases"]`` in turn on this rank, each at its
    own wire, with the reductions each made: ``{case id: result}``."""
    from sheeprl_tpu_torch.parallel import comm

    torch.manual_seed(0)
    results = {}
    for name, case in payload["cases"].items():
        comm.set_grad_reduce_dtype(case["wire"], fresh_run=True)
        before = dict(comm.REDUCTIONS)
        results[name] = _OFFPOLICY[case["kind"]](rank, case)
        results[name]["reductions"] = comm.REDUCTIONS["calls"] - before["calls"]
    return results


def rssm_job(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """Every case of ``payload["cases"]``: the DreamerV3 train call from the
    payload's weights and fresh optimizers, once per ``calls`` entry (its
    ``cum0`` and each rank's noise), on this rank's share of the batch;
    ``{case id: {"calls": [per call: metrics, moments, skipped], "params",
    "digest", "reductions"}}``. Also checks that the ``Moments`` gather
    carries no gradient."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_training_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments, moments_update
    from sheeprl_tpu_torch.algos.ppo.ppo import param_digest
    from sheeprl_tpu_torch.parallel import comm

    results: Dict[str, Any] = {}
    for name, c in payload["cases"].items():
        comm.set_grad_reduce_dtype(c["wire"], fresh_run=True)
        before = comm.REDUCTIONS["calls"]
        cfg = _dotdict(c["cfg"])
        wm, actor, critic, target = build_training_agent(cfg, "cpu", c["state"])
        optimizers = make_optimizers(cfg, wm, actor, critic)
        train = make_train_step(wm, actor, critic, target, optimizers, cfg, guard=c["guard"])
        local = c["local_batch"]
        data = _rows_of(c["data"], rank, local, 2)
        moments = init_moments()
        calls = []
        for call in c["calls"]:
            noise = [{"posterior": torch.from_numpy(call["posterior"][rank]),
                      "imagined_prior": torch.from_numpy(call["imagined_prior"][rank]),
                      "actions": [torch.from_numpy(a[rank]) for a in call["actions"]]}]
            moments, metrics, skipped = train(data, moments, call["cum0"], noise=noise)
            calls.append({"metrics": metrics[0].numpy().copy(), "skipped": float(skipped),
                          "moments": {k: float(v) for k, v in moments.items()}})
        x = torch.linspace(-1.0, 1.0, 16, requires_grad=True) * (rank + 1)
        _, offset, invscale = moments_update(init_moments(), x)
        results[name] = {
            "calls": calls, "digest": param_digest(torch.nn.ModuleList([wm, actor, critic, target])),
            "params": {m: _numpy(mod.state_dict()) for m, mod in
                       (("world_model", wm), ("actor", actor), ("critic", critic), ("target_critic", target))},
            "reductions": comm.REDUCTIONS["calls"] - before,
            "gather_detached": offset.grad_fn is None and invscale.grad_fn is None,
        }
    return results
