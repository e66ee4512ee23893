"""DroQ (the dropout-Q SAC variant) in the port against the JAX package, on
the CPU, at a small size of the ``exp=droq`` recipe (hidden 32, batch 8, 2
critics, Pendulum's 3 observations and 1 torque in [-2, 2]).

Dropout masks: flax draws them inside its ``nn.vmap`` from rngs it splits
per critic. The test rebuilds JAX's ensemble module with the intermediates
collection mapped over the ensemble axis (the same names, the same
``split_rngs``), captures each ``nn.Dropout``'s output with
``capture_intermediates`` and reads the mask as its non-zero pattern; the
rebuilt module's Q-values equal the JAX package's own for the same rng, so
the masks are the ones the JAX step draws. The port takes them as
arguments.

- the critic ensemble on JAX's masks, and without dropout;
- one train call (``make_train_step``: G = 3 critic steps with a target EMA
  after each, then one actor and one entropy step on a separate batch) from
  the same converted weights, on JAX's draws rebuilt from the call's key
  (``fold_in`` of the device index; ``k_scan, k_actor, k_q``; per step
  ``k_target, k_online`` and ``k_act, k_drop``);
- ``run preset=droq`` (``exp=droq`` on Pendulum-v1, key for key), its
  checkpoint, a resume and ``evaluation``, equal to the run's test episode.

Tolerances (float32 on both sides): Q-values within 1e-5; the three losses
within rtol 1e-5 (atol 1e-6); every parameter after the call within 1e-5.
"""

import flax.linen as nn
import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.droq.agent import DROQCritic
from sheeprl_tpu.algos.droq.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.droq.droq import make_train_step as jax_make_train_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu.utils.utils import Ratio as JaxRatio
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.droq.droq import make_train_step
from sheeprl_tpu_torch.algos.sac.sac import RING_KEYS, make_optimizers
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.convert import sac_state_from_jax
from tests.test_torch_sac_loop import _leaves

HIDDEN, BATCH, N_CRITICS, G, OBS, ACT = 32, 8, 2, 3, 3, 1
DROPOUT = 0.2  # above the recipe's 0.01, so each layer drops several units at this width
OVERRIDES = [f"algo.hidden_size={HIDDEN}", f"algo.actor.hidden_size={HIDDEN}", f"algo.critic.hidden_size={HIDDEN}",
             f"algo.per_rank_batch_size={BATCH}", f"algo.critic.dropout={DROPOUT}"]
ACTION_SPACE = {"shape": [ACT], "low": [-2.0], "high": [2.0], "continuous": True}
TINY = [
    "fabric.accelerator=cpu", "metric.log_level=0", "env.num_envs=2", "buffer.size=256", "algo.hidden_size=32",
    "algo.actor.hidden_size=32", "algo.critic.hidden_size=32", "algo.per_rank_batch_size=8",
    "algo.learning_starts=16", "algo.replay_ratio=2", "checkpoint.every=0", "checkpoint.save_last=true",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # module scope: the module's own fixtures (JAX builds, runs) run on one thread too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CapturingEnsemble(nn.Module):
    """``DROQCriticEnsemble`` with its intermediates mapped over the
    ensemble axis, so ``capture_intermediates`` sees every critic's dropout."""

    n: int
    hidden_size: int
    dropout: float

    @nn.compact
    def __call__(self, obs, action, deterministic=True):
        ensemble = nn.vmap(DROQCritic, variable_axes={"params": 0, "intermediates": 0},
                           split_rngs={"params": True, "dropout": True}, in_axes=None, out_axes=-1,
                           axis_size=self.n)(num_critics=1, hidden_size=self.hidden_size, dropout=self.dropout,
                                             name="qfs")
        return ensemble(obs, action, deterministic)[..., 0, :]


def _masks(critic_params, key, batch: int, rng) -> tuple:
    """``(2, n, batch, hidden)`` keep masks the JAX critic draws with
    ``key`` (they depend on the key and the shapes only), and the Q-values
    of the rebuilt module on random inputs."""
    module = _CapturingEnsemble(N_CRITICS, HIDDEN, DROPOUT)
    obs = jnp.asarray(rng.normal(size=(batch, OBS)), jnp.float32)
    act = jnp.asarray(rng.uniform(-2, 2, (batch, ACT)), jnp.float32)
    q, state = module.apply(critic_params, obs, act, False, rngs={"dropout": key},
                            capture_intermediates=lambda mdl, _: isinstance(mdl, nn.Dropout))
    drops = state["intermediates"]["qfs"]["model"]
    masks = np.stack([np.asarray(drops[f"Dropout_{i}"]["__call__"][0]) != 0 for i in range(2)]).astype(np.float32)
    return masks, (obs, act, q)


@pytest.fixture(scope="module")
def jax_side():
    cfg = compose(["exp=droq"] + OVERRIDES)
    fabric = Fabric(devices=1, accelerator="cpu")
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (OBS,), np.float32)})
    act_space = gym.spaces.Box(-2.0, 2.0, (ACT,), np.float32)
    agent, params, _ = jax_build_agent(fabric, cfg, obs_space, act_space)
    return cfg, fabric, agent, params


def _port(params):
    cfg = apply_overrides(preset("droq"), OVERRIDES)
    agent, _ = build_agent(cfg, OBS, ACTION_SPACE, "cpu", sac_state_from_jax(jax.tree.map(np.asarray, params)))
    return cfg, agent


def test_torch_dropout_q_critic_on_jax_masks_matches_jax(jax_side):
    _, _, agent, params = jax_side
    _, port = _port(params)
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(5)
    masks, (obs, act, q_rebuilt) = _masks(params["critic"], key, BATCH, rng)
    q_jax = agent.q_values_droq(params["critic"], obs, act, key)
    np.testing.assert_array_equal(np.asarray(q_rebuilt), np.asarray(q_jax))  # the rebuilt module draws JAX's masks
    assert 0 < masks.mean() < 1 and masks.shape == (2, N_CRITICS, BATCH, HIDDEN)
    with torch.no_grad():
        o, a = torch.from_numpy(np.array(obs)), torch.from_numpy(np.array(act))
        got = port.critic(o, a, torch.from_numpy(masks))
        np.testing.assert_allclose(got.numpy(), np.asarray(q_jax), atol=1e-5)
        plain = port.critic(o, a)
    want_plain = agent.critic.apply(params["critic"], obs, act, True)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want_plain), atol=1e-5)


def test_torch_dropout_q_port_masks_keep_the_rate():
    agent, _ = build_agent(apply_overrides(preset("droq"), OVERRIDES), OBS, ACTION_SPACE, "cpu")
    gen = torch.Generator().manual_seed(0)
    masks = agent.critic.draw_masks(4096, gen, "cpu")
    assert masks.shape == (2, N_CRITICS, 4096, HIDDEN)
    assert abs(float(masks.mean()) - (1 - DROPOUT)) < 0.01
    assert set(masks.unique().tolist()) == {0.0, 1.0}


def _batch(rng, lead):
    return {
        "observations": rng.normal(size=(*lead, OBS)).astype(np.float32),
        "next_observations": rng.normal(size=(*lead, OBS)).astype(np.float32),
        "actions": rng.uniform(-2, 2, size=(*lead, ACT)).astype(np.float32),
        "rewards": rng.normal(size=(*lead, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(*lead, 1)) < 0.2).astype(np.float32),
    }


@pytest.fixture(scope="module")
def train_call(jax_side):
    cfg, fabric, agent, params = jax_side
    before = jax.tree.map(np.array, params)
    txs = [jax_build_optimizer(cfg.algo[k].optimizer) for k in ("actor", "critic", "alpha")]
    opts = [txs[0].init(params["actor"]), txs[1].init(params["critic"]), txs[2].init(params["log_alpha"])]
    train_fn = jax_make_train_step(agent, txs[0], txs[1], txs[2], cfg, fabric.mesh)
    rng = np.random.default_rng(1)
    critic_data, actor_data = _batch(rng, (G, BATCH)), _batch(rng, (BATCH,))
    key = jax.random.PRNGKey(17)
    out = train_fn(jax.tree.map(jnp.asarray, params), *opts, {k: jnp.asarray(v) for k, v in critic_data.items()},
                   {k: jnp.asarray(v) for k, v in actor_data.items()}, key)
    jax_params, losses = out[0], [float(x) for x in out[4:]]

    # the call's draws: fold_in, split(3), split(G), split(k) and split(k_target)
    k_scan, k_actor, k_q = jax.random.split(jax.random.fold_in(key, 0), 3)
    nxt, target_masks, online_masks = [], [], []
    mask_rng = np.random.default_rng(2)
    for k in jax.random.split(k_scan, G):
        k_target, k_online = jax.random.split(k)
        k_act, k_drop = jax.random.split(k_target)
        nxt.append(np.asarray(jax.random.normal(k_act, (BATCH, ACT))))
        target_masks.append(_masks(before["critic"], k_drop, BATCH, mask_rng)[0])
        online_masks.append(_masks(before["critic"], k_online, BATCH, mask_rng)[0])
    noise = {
        "next": torch.from_numpy(np.stack(nxt)),
        "target_masks": torch.from_numpy(np.stack(target_masks)),
        "online_masks": torch.from_numpy(np.stack(online_masks)),
        "actor": torch.from_numpy(np.asarray(jax.random.normal(k_actor, (BATCH, ACT)))),
        "actor_masks": torch.from_numpy(_masks(before["critic"], k_q, BATCH, mask_rng)[0]),
    }
    port_cfg, port = _port(before)
    train = make_train_step(port, make_optimizers(port_cfg, port), port_cfg)
    got = train({k: torch.from_numpy(critic_data[k]) for k in RING_KEYS},
                {k: torch.from_numpy(actor_data[k]) for k in RING_KEYS}, noise=noise)
    return {"jax": (sac_state_from_jax(jax.tree.map(np.asarray, jax_params)), losses),
            "port": ({k: v.clone() for k, v in port.state_dict().items()}, got.tolist()),
            "before": sac_state_from_jax(before)}


@pytest.mark.parametrize("index", range(3), ids=["value_loss", "policy_loss", "alpha_loss"])
def test_torch_dropout_q_train_call_losses_match_jax(train_call, index):
    got, want = train_call["port"][1][index], train_call["jax"][1][index]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("module", ["actor", "critic", "target_critic", "log_alpha"])
def test_torch_dropout_q_train_call_parameters_match_jax(train_call, module):
    got, want, before = train_call["port"][0], train_call["jax"][0], train_call["before"]
    names = [k for k in want if k.split(".")[0] == module]
    assert names and set(names) == {k for k in got if k.split(".")[0] == module}
    moved = 0
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
        moved += int(not np.array_equal(want[name].numpy(), before[name].numpy()))
    assert moved > 0  # every module moved: G critic steps, G EMAs, one actor and one entropy step


def test_torch_dropout_q_preset_is_the_jax_exp_droq():
    """Every key of the preset holds the value of ``exp=droq`` with the
    preset's overrides (optimizer targets by their last component), but
    ``buffer.memmap``, which the SAC presets keep off."""
    port = preset("droq")
    assert port.preset.composition == "exp=droq"
    jax_cfg = compose(["exp=droq"] + list(port.preset.overrides))
    checked = 0
    for path, value in _leaves(port):
        if path.startswith("preset."):
            continue
        node = jax_cfg
        for part in path.split("."):
            node = node[part]
        if path == "buffer.memmap":
            assert node is True and value is False
        elif path.endswith("_target_"):
            assert str(node).rsplit(".", 1)[-1] == value, path
        elif isinstance(value, float):
            assert float(node) == pytest.approx(value), path
        else:
            assert node == value, path
        checked += 1
    assert checked >= 40 and port.algo.replay_ratio == 20.0 and port.algo.critic.dropout == 0.01


def test_torch_dropout_q_loop_trains_resumes_and_evaluates(tmp_path):
    from sheeprl_tpu_torch.ops import kernels

    kernels.reset_launches()
    s = cli.run(["preset=droq", f"log_root={tmp_path}", "algo.total_steps=48"] + TINY)
    assert s["device"] == "cpu" and s["gradient_steps"] > s["train_calls"] > 0
    # the JAX DroQ's grants: its prefill counted in policy steps (droq.py:350)
    ratio, learning_starts = JaxRatio(2.0), 16 // 2
    prefill = learning_starts - 1
    want = sum(ratio(it * 2 - prefill * 2) for it in range(1, 25) if it >= learning_starts)
    assert s["gradient_steps"] == want
    assert np.isfinite(np.asarray(s["losses"])).all() and s["test_steps"] == 200
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # a host-buffer path: no kernel
    saved = load_checkpoint(s["checkpoint"])
    assert {"agent", "qf_optimizer", "actor_optimizer", "alpha_optimizer", "rb", "ratio"} <= set(saved)
    assert any(k.startswith("critic.qfs.model.ln_0") for k in saved["agent"])
    evaluated = cli.evaluation([f"checkpoint_path={s['checkpoint']}", "fabric.accelerator=cpu"])
    assert evaluated["reward"] == s["test_reward"] and evaluated["steps"] == 200
    resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "algo.total_steps=64", "algo.learning_starts=4",
                       f"log_root={tmp_path}", "fabric.accelerator=cpu", "metric.log_level=0", "algo.run_test=false"])
    assert resumed["start_iter"] == 25 and resumed["gradient_steps"] > 0
