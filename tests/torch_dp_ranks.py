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
