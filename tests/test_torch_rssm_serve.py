"""The port's DreamerV3 session step against the JAX package's
``serve_policy_dreamer_v3``, under weights carried across by
``dreamer_v3_state_from_jax``.

3 sessions x 6 steps, teacher-forced: each port step starts from the JAX
state row (action carry, recurrent state, JAX-sampled posterior), since the
two frameworks never draw the same posterior sample. Per step:

- the recurrent state within atol 1e-5 and the representation logits
  (unimixed log-probabilities) within atol 1e-4: float32 throughout, with
  flax's one-pass LayerNorm variance against torch's two-pass one;
- the greedy actions, argmax of the unimixed actor logits on the JAX
  posterior, exactly equal.

One case has vector observations only; one adds 64x64x3 pixels, so a wrong
flatten order of the CNN features would show as wrong logits.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v3.evaluate import serve_policy_dreamer_v3 as jax_serve_policy
from sheeprl_tpu.config import compose
from sheeprl_tpu.config import plain as jax_plain
from sheeprl_tpu.parallel import Fabric
from sheeprl_tpu_torch.algos.dreamer_v3.agent import CNNEncoder
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import act, posterior_step
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import serve_policy_dreamer_v3 as torch_serve_policy
from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax, flax_to_state_dict

N_ACTIONS = 9


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several pytest workers side by side: torch's default of
    # one thread per core each would oversubscribe the machine and slow the
    # timing-sensitive tests of the other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = [
    "exp=dreamer_v3",
    "env=dummy",
    "env.num_envs=1",
    "env.capture_video=False",
    "fabric.devices=1",
    "metric.log_level=0",
    "algo=dreamer_v3_XS",
    "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=1",
    "algo.dense_units=16",
    "algo.mlp_layers=2",
    "algo.world_model.recurrent_model.recurrent_state_size=32",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.reward_model.bins=17",
    "algo.critic.bins=17",
]


def _configs(pixels: bool):
    cnn = ["rgb"] if pixels else []
    cfg = compose(
        SMALL
        + [
            f"algo.cnn_keys.encoder=[{','.join(cnn)}]",
            f"algo.cnn_keys.decoder=[{','.join(cnn)}]",
            "algo.mlp_keys.encoder=[state]",
            "algo.mlp_keys.decoder=[state]",
        ]
    )
    spaces = {"state": gym.spaces.Box(-np.inf, np.inf, (10,), np.float32)}
    obs_spec = {"state": {"shape": [10], "dtype": "float32"}}
    if pixels:
        spaces["rgb"] = gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)
        obs_spec["rgb"] = {"shape": [64, 64, 3], "dtype": "uint8"}
    port_cfg = dotdict(
        {**jax_plain(cfg), "spaces": {"obs": obs_spec, "actions": {"n": [N_ACTIONS], "continuous": False}}}
    )
    return cfg, port_cfg, gym.spaces.Dict(spaces)


def _raw_obs(rng, pixels: bool, k: int):
    obs = {"state": rng.normal(size=(k, 10)).astype(np.float32) * 3}
    if pixels:
        obs["rgb"] = rng.integers(0, 256, size=(k, 64, 64, 3), dtype=np.uint8)
    return obs


def _torch(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("pixels", [False, True], ids=["vector", "pixels+vector"])
def test_torch_rssm_serve_step_matches_jax(pixels):
    cfg, port_cfg, obs_space = _configs(pixels)
    fabric = Fabric(devices=1, accelerator="cpu")
    jax_policy = jax_serve_policy(fabric, cfg, obs_space, gym.spaces.Discrete(N_ACTIONS), None)
    world_model, _, _, _, _ = jax_build_agent(fabric, (N_ACTIONS,), False, cfg, obs_space)
    params = jax_policy.params
    wmp = params["world_model"]
    numpy_params = jax.tree.map(np.asarray, {"world_model": wmp, "actor": params["actor"]})
    port = torch_serve_policy(port_cfg, dreamer_v3_state_from_jax(numpy_params), "cpu")
    agent = port.params

    K, T = 3, 6
    jax_step = jax.jit(jax_policy.step_fn, static_argnums=(4,))
    jax_state = jax_policy.init_fn(params, K)
    port_init = port.init_fn(agent, K)
    np.testing.assert_allclose(port_init["recurrent"].numpy(), np.asarray(jax_state["recurrent"]), atol=1e-6)
    np.testing.assert_array_equal(port_init["stochastic"].numpy(), np.asarray(jax_state["stochastic"]))

    rng = np.random.default_rng(7)
    for t in range(T):
        raw = _raw_obs(rng, pixels, K)
        jax_obs = jax_policy.prepare(raw, K)
        port_obs = port.prepare(raw, K)
        for k in jax_obs:
            np.testing.assert_array_equal(port_obs[k], jax_obs[k])
        jax_actions, new_state = jax_step(params, jax_obs, jax_state, None, True)

        # JAX representation logits on the advanced recurrent state
        emb = world_model.encoder.apply(wmp["encoder"], jax_obs)
        jax_logits, _ = world_model.rssm._representation(wmp, new_state["recurrent"], emb, jax.random.PRNGKey(0))

        with torch.no_grad():
            rec, logits = posterior_step(
                agent,
                {k: torch.from_numpy(v) for k, v in port_obs.items()},
                _torch(jax_state["actions"]),
                _torch(jax_state["recurrent"]),
                _torch(jax_state["stochastic"]),
            )
            greedy = act(agent, _torch(new_state["stochastic"]), rec, greedy=True)
        np.testing.assert_allclose(rec.numpy(), np.asarray(new_state["recurrent"]), atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits), atol=1e-4, err_msg=f"step {t}")
        port_actions = torch.stack([a.argmax(-1) for a in greedy], dim=-1).numpy()
        np.testing.assert_array_equal(port_actions, np.asarray(jax_actions), err_msg=f"step {t}")
        np.testing.assert_array_equal(torch.cat(greedy, -1).numpy(), np.asarray(new_state["actions"]))
        jax_state = new_state


def test_torch_rssm_cnn_encoder_flattens_like_flax():
    """The 64x64x3 NHWC encoder output, feature by feature (atol 1e-5), at a
    non-square channel count so a transposed flatten cannot pass."""
    from sheeprl_tpu.algos.dreamer_v3.agent import CNNEncoder as JaxCNNEncoder

    rng = np.random.default_rng(8)
    x = (rng.integers(0, 256, size=(2, 64, 64, 3)) / 255.0 - 0.5).astype(np.float32)
    je = JaxCNNEncoder(keys=("rgb",), channels_multiplier=3, stages=4)
    params = je.init(jax.random.PRNGKey(0), {"rgb": jnp.asarray(x)})
    want = np.asarray(je.apply(params, {"rgb": jnp.asarray(x)}))
    te = CNNEncoder(("rgb",), 3, 3, stages=4)
    te.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = te({"rgb": torch.from_numpy(x)}).numpy()
    assert got.shape == want.shape == (2, 4 * 4 * 24)
    np.testing.assert_allclose(got, want, atol=1e-5)
