"""Continuous DreamerV3 through the port's entry points on the CPU, at tiny
widths of ``preset=dreamer_v3_continuous_dummy``:

- the preset is the JAX package's ``exp=dreamer_v3_dmc_walker_walk`` key for
  key (DreamerV3-S widths, 4 envs, action repeat 2, replay ratio 0.5,
  ``learning_starts`` 1300, a 500,000-row memmapped, checkpointed buffer,
  saves every 10,000 steps, seed 5), but for the substitutions its
  ``preset`` block names: the ``continuous_dummy`` env for dm_control, no
  episode limit, and no precision key;
- a run on the host buffer (random actions uniform in the Box until
  ``learning_starts``, continuous actions stored and stepped as they are)
  checkpoints, and a resume goes on from the checkpoint's buffer; a run with
  ``decoupled_rssm`` on the device ring (plain ``ragged_ring_scatter`` on
  CPU tensors, the 2-wide float action column carried unchanged) resumes on
  the ring;
- ``evaluation`` of the checkpoint equals the greedy test episode of the
  same weights; a served session (``serve``'s stateful policy, action width
  2) fed the run's sampled test episode's frames gives its actions exactly;
  a batched row of 8 sessions equals the row stepped alone (within 1e-6:
  matmuls of other batch sizes round differently).
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3 import utils as dv3_utils
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import initial_state, serve_policy_dreamer_v3, session_step
from sheeprl_tpu_torch.config import load_config, preset
from sheeprl_tpu_torch.serve.server import PolicyServer
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, load_checkpoint
from tests.test_torch_action_repeat import jax_episode_length
from tests.test_torch_sac_loop import _leaves
from tests.test_torch_train_loop import TINY_RUN

TINY = ["preset=dreamer_v3_continuous_dummy", "env.num_envs=2", "algo.replay_ratio=1", "buffer.memmap=false"] + [
    o for o in TINY_RUN[1:] if not o.startswith("buffer.")] + ["buffer.size=256"]
#: what the preset sets that the JAX recipe does not have, or has otherwise on purpose
SUBSTITUTED = {"env.id", "env.max_episode_steps"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # module scope: the module's own fixtures (JAX builds, runs) run on one thread too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_torch_rssm_continuous_loop_preset_is_the_jax_walker_recipe():
    port = preset("dreamer_v3_continuous_dummy")
    assert port.preset.composition == "exp=dreamer_v3_dmc_walker_walk"
    jax_cfg = compose(["exp=dreamer_v3_dmc_walker_walk"])
    checked = 0
    for path, value in _leaves(port):
        if path.startswith("preset.") or path in SUBSTITUTED:
            continue
        node = jax_cfg
        for part in path.split("."):
            node = node[part]
        if path.endswith("_target_"):
            assert str(node).rsplit(".", 1)[-1] == value, path
        elif isinstance(value, float):
            assert float(node) == pytest.approx(value), path
        else:
            assert node == value, path
        checked += 1
    assert checked >= 80
    assert jax_cfg.env.max_episode_steps == -1 and port.env.max_episode_steps is None  # -1 is "no limit"
    # the recipe's precision is the preset's own leaf, held above with the others
    assert jax_cfg.fabric.precision == "bf16-mixed" == port.fabric.precision
    assert len(port.preset.substitutions) == 2


def test_torch_rssm_continuous_loop_env_and_prefill_actions(tmp_path, monkeypatch):
    """The prefill's actions are uniform in the Box, stored as they are and
    stepped as they are; after ``learning_starts`` the player's continuous
    actions (clipped to 1) go to the env unchanged."""
    from sheeprl_tpu_torch.envs import vector

    stepped = []
    real_step = vector.SyncVectorEnv.step

    def spy(self, actions):
        stepped.append(np.array(actions, dtype=np.float64))
        return real_step(self, actions)

    monkeypatch.setattr(vector.SyncVectorEnv, "step", spy)
    s = cli.run(TINY + [f"log_root={tmp_path}", "algo.total_steps=24", "algo.run_test=false",
                        "checkpoint.save_last=true"])
    acts = np.stack(stepped)
    assert acts.shape == (12, 2, 2) and np.all(np.abs(acts) <= 1.0)
    assert len(np.unique(acts[:4].round(6))) > 8  # random floats, not one-hot codes
    stored = load_checkpoint(s["checkpoint"])["rb"]["envs"][0]["buffer"]["actions"].numpy()
    np.testing.assert_array_equal(stored[:4, 0], acts[:4, 0].astype(np.float32))
    assert s["gradient_steps"] > 0 and s["player_steps"] > 0


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("host")
    first = cli.run(TINY + [f"log_root={root}", "algo.total_steps=24", "checkpoint.save_last=true"])
    return root, first


def test_torch_rssm_continuous_loop_run_checkpoints_and_resumes(host_run):
    root, first = host_run
    assert first["device"] == "cpu" and first["policy_steps"] == 24 and not first["resident"]
    assert first["gradient_steps"] > 0 and np.isfinite(np.asarray(first["metrics"])).all()
    # the counter env ends on the step after 128, reached at 2 per agent step (action repeat 2)
    assert first["test_steps"] == jax_episode_length()
    state = load_checkpoint(first["checkpoint"])
    assert state["actor"]["head_0.weight"].shape[0] == 4  # mean and std of 2 actions
    resumed = cli.run([f"checkpoint.resume_from={first['checkpoint']}", "fabric.accelerator=cpu",
                       "metric.log_level=0", "algo.learning_starts=2", f"log_root={root}", "algo.total_steps=32",
                       "algo.run_test=false"])
    assert resumed["start_iter"] == 13 and resumed["gradient_steps"] > 0
    assert np.isfinite(np.asarray(resumed["metrics"])).all()


def test_torch_rssm_continuous_loop_decoupled_ring_run_and_resume(tmp_path):
    from sheeprl_tpu_torch.ops import kernels

    kernels.reset_launches()
    ring = ["algo.world_model.decoupled_rssm=true", "buffer.device_resident=true", "algo.run_test=false"]
    first = cli.run(TINY + ring + [f"log_root={tmp_path}", "algo.total_steps=24", "checkpoint.save_last=true"])
    assert first["resident"] and first["gradient_steps"] > 0 and np.isfinite(np.asarray(first["metrics"])).all()
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # CPU tensors take the plain versions
    saved = load_checkpoint(first["checkpoint"])
    actions = saved["rb"]["arrays"]["storage/actions"]
    assert actions.dtype == torch.float32 and actions.shape[-1] == 2 and float(actions.abs().max()) > 0
    resumed = cli.run([f"checkpoint.resume_from={first['checkpoint']}", "fabric.accelerator=cpu",
                       "metric.log_level=0", "algo.learning_starts=2", f"log_root={tmp_path}",
                       "algo.total_steps=32"])
    assert resumed["resident"] and resumed["start_iter"] == 13 and resumed["gradient_steps"] > 0


def _recorded_test(cfg, agent, greedy, monkeypatch):
    frames, actions = [], []
    make_env = dv3_utils.make_env

    def recording_env(*args, **kwargs):
        env = make_env(*args, **kwargs)
        reset, step = env.reset, env.step

        def rec_reset(*a, **k):
            out = reset(*a, **k)
            frames.append(out[0]["rgb"].copy())
            return out

        def rec_step(action):
            actions.append(np.array(action, dtype=np.float32).reshape(-1))
            out = step(action)
            frames.append(out[0]["rgb"].copy())
            return out

        env.reset, env.step = rec_reset, rec_step
        return env

    monkeypatch.setattr(dv3_utils, "make_env", recording_env)
    reward, steps = dv3_utils.test(agent, cfg, "cpu", greedy=greedy)
    monkeypatch.setattr(dv3_utils, "make_env", make_env)
    return reward, frames[:-1], np.stack(actions)


def test_torch_rssm_continuous_loop_evaluation_equals_the_greedy_test(host_run, monkeypatch):
    _, first = host_run
    cfg = load_config(find_run_config(first["checkpoint"]))
    cfg["env"]["num_envs"] = 1
    evaluated = cli.evaluation([f"checkpoint_path={first['checkpoint']}", "fabric.accelerator=cpu"])
    policy = serve_policy_dreamer_v3(cfg, load_checkpoint(first["checkpoint"]), "cpu")
    reward, frames, actions = _recorded_test(cfg, policy.params, True, monkeypatch)
    length = jax_episode_length()
    assert evaluated["reward"] == reward and evaluated["steps"] == len(actions) == length
    assert actions.shape == (length, 2) and np.all(np.abs(actions) <= 1.0)


def test_torch_rssm_continuous_loop_served_session_replays_the_test_episode(host_run, monkeypatch):
    _, first = host_run
    cfg = load_config(find_run_config(first["checkpoint"]))
    policy = serve_policy_dreamer_v3(cfg, load_checkpoint(first["checkpoint"]), "cpu")
    assert policy.action_dim == 2
    reward, frames, actions = _recorded_test(cfg, policy.params, False, monkeypatch)
    assert reward == first["test_reward"] and len(actions) == first["test_steps"]  # the run's own test episode
    with PolicyServer(policy, {"mode": "sample", "max_wait_ms": 0.0, "session": {"buckets": [1, 4]}}) as server:
        served = []
        for t, frame in enumerate(frames):
            out, _ = server.client.act({"rgb": frame[None]}, session_id="episode", reset=t == 0, timeout=60)
            served.append(np.asarray(out[0], dtype=np.float32))
            if t % 40 == 0:  # another session in the same dispatches changes nothing
                server.client.act({"rgb": frames[-1 - t][None]}, session_id="other", timeout=60)
    np.testing.assert_array_equal(np.stack(served), actions)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_torch_rssm_continuous_loop_batched_rows_equal_rows_alone(host_run, greedy):
    _, first = host_run
    cfg = load_config(find_run_config(first["checkpoint"]))
    policy = serve_policy_dreamer_v3(cfg, load_checkpoint(first["checkpoint"]), "cpu")
    agent = policy.params
    rng = np.random.default_rng(3)
    n, steps = 8, 6
    frames = rng.integers(0, 256, (steps, n, 64, 64, 3)).astype(np.float32) / 255.0 - 0.5
    with torch.no_grad():
        batch = initial_state(agent, n, 5)
        batch["seed"] = torch.arange(n, dtype=torch.int64) * 7 + 5
        alone = [{k: v[i:i + 1].clone() for k, v in batch.items()} for i in range(n)]
        for t in range(steps):
            got, batch = session_step(agent, {"rgb": torch.from_numpy(frames[t])}, batch, greedy)
            assert got.shape == (n, 2)
            for i in range(n):
                want, alone[i] = session_step(agent, {"rgb": torch.from_numpy(frames[t, i:i + 1])}, alone[i], greedy)
                np.testing.assert_allclose(got[i:i + 1].float().numpy(), want.float().numpy(), atol=1e-6, rtol=0)
