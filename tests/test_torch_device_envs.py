"""The port's device envs (``sheeprl_tpu_torch/envs/device_envs``) against the
JAX package's pure-JAX twins (``sheeprl_tpu/envs/jax_envs``), on the CPU.

Both compute in float32. JAX's reset draws are fed to the port as the unit
uniforms of the same keys (``jax.random.uniform(key, shape)``), so a reset's
state is bit-equal (its observation too, but for Pendulum's and Acrobot's
sines and cosines: within 1e-7, one float32 ulp). Steps differ by rounding only: XLA fuses multiply-adds and has its
own sine and cosine, so one step from JAX's state is held within 1e-6 (plus
1e-6 relative: Acrobot's velocities reach 28 rad/s, where float32's spacing
is 2e-6), and a 200-step trace from one reset, each side on its own state,
with each observation component within 1e-5 of its range (the observation
space's bound, 1 where it has none: 1 for the sines and cosines, 8 for
Pendulum's speed, 4 pi and 9 pi for Acrobot's). The two sides' roundings
grow along a trajectory, most on the double pendulum, which is chaotic:
over 200 steps Pendulum's and Acrobot's reach 2e-5 and 4.5e-5 rad/s (seeds
0-3), past a plain 1e-5, and Acrobot's angles drift past 1e-5 of their
range after ~150 steps. So Acrobot's trace is held within 1e-5 for the 60
steps the JAX package's own Acrobot trace test takes (it stops there for the
same reason) and within 1e-4 over the 200.
Batched autoreset is held against ``BatchedJaxEnv`` with JAX's per-env key
stream rebuilt and injected, and the ``(P,)``-stacked params (the
population's scenario axis) against JAX's ``vmap`` over members."""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs.jax_envs import BatchedJaxEnv, make_jax_env
from sheeprl_tpu_torch.envs.device_envs import (
    DEVICE_ENV_REGISTRY,
    BatchedDeviceEnv,
    is_device_env,
    make_device_env,
    params_batch_shape,
    stack_params,
)

ENV_IDS = ["CartPole-v1", "Pendulum-v1", "Acrobot-v1", "MountainCar-v0"]
TRACE_STEPS = 200


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _unit(key, shape) -> torch.Tensor:
    """The unit uniforms ``jax.random.uniform(key, shape, minval, maxval)``
    scales: the same key's draw in [0, 1)."""
    return _t(jax.random.uniform(key, tuple(shape), dtype=jnp.float32))


def _action(jenv, rng, n=None):
    shape = () if n is None else (n,)
    if isinstance(jenv.action_space, gym.spaces.Box):
        a = rng.uniform(-2, 2, size=shape + (1,)).astype(np.float32)
        return jnp.asarray(a), _t(a)
    a = rng.randint(jenv.action_space.n, size=shape).astype(np.int32)
    return jnp.asarray(a), _t(a).long()


def _state_from_jax(pstate_type, jstate):
    return pstate_type(*[_t(x) for x in jstate])


def test_torch_device_envs_registry():
    assert sorted(DEVICE_ENV_REGISTRY) == sorted(ENV_IDS)
    for env_id in ENV_IDS:
        assert is_device_env(env_id) and make_device_env(env_id).id == env_id
    assert not is_device_env("MsPacmanNoFrameskip-v4")
    with pytest.raises(ValueError, match="No device environment"):
        make_device_env("Walker2d-v4")
    with pytest.raises(ValueError, match=r"algo\.population\.env_params\.max_episode_steps"):
        make_device_env("CartPole-v1", swept_params=("max_episode_steps",), max_episode_steps=100)
    make_device_env("CartPole-v1", swept_params=("length",), max_episode_steps=100)


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_torch_device_envs_params_and_spaces_match_jax(env_id):
    """The params' fields, values and dtypes are JAX's; the spaces block is
    the host env's (what evaluation and serving read)."""
    from sheeprl_tpu_torch.envs.classic import CLASSIC_ENVS

    jp, pp = make_jax_env(env_id).default_params(), make_device_env(env_id).default_params()
    assert type(pp)._fields == type(jp)._fields
    for f in jp._fields:
        want = np.asarray(getattr(jp, f))
        got = getattr(pp, f)
        assert got.shape == () and str(got.dtype).split(".")[-1] == str(want.dtype), f
        assert got.numpy() == want, f
    assert make_device_env(env_id).spaces("state") == CLASSIC_ENVS[env_id](obs_key="state", seed=0).spaces


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_torch_device_envs_reset_is_bit_equal(env_id):
    jenv, penv = make_jax_env(env_id), make_device_env(env_id)
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        jstate, jobs = jenv.reset(key)
        pstate, pobs = penv.reset(_unit(key, penv.reset_shape), penv.default_params())
        np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), atol=1.2e-7, rtol=0)
        if env_id in ("CartPole-v1", "MountainCar-v0"):  # the observation is the state
            np.testing.assert_array_equal(pobs.numpy(), np.asarray(jobs))
        for a, b in zip(pstate, jstate):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_torch_device_envs_one_step_matches_jax(env_id):
    """50 steps, each from JAX's state: observation, reward, flags."""
    jenv, penv = make_jax_env(env_id), make_device_env(env_id)
    jstep = jax.jit(jenv.step)
    params = penv.default_params()
    rng = np.random.RandomState(3)
    jstate, _ = jenv.reset(jax.random.PRNGKey(7))
    state_type = type(penv.reset(_unit(jax.random.PRNGKey(7), penv.reset_shape), params)[0])
    for t in range(50):
        ja, pa = _action(jenv, rng)
        jstate2, jobs, jrew, jdone, jinfo = jstep(jstate, ja, jenv.default_params())
        pstate, pobs, prew, pdone, pinfo = penv.step(_state_from_jax(state_type, jstate), pa, params)
        np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(prew.numpy(), np.asarray(jrew), atol=1e-6, rtol=1e-6)
        assert bool(pdone) == bool(jdone)
        assert bool(pinfo["terminated"]) == bool(jinfo["terminated"])
        assert bool(pinfo["truncated"]) == bool(jinfo["truncated"])
        assert int(pstate.t) == int(jstate2.t)
        jstate = jenv.reset(jax.random.PRNGKey(100 + t))[0] if bool(jdone) else jstate2


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_torch_device_envs_trace_matches_jax(env_id):
    """200 steps from one reset, each side on its own state; on an episode's
    end both reset from the same key."""
    jenv, penv = make_jax_env(env_id), make_device_env(env_id)
    jstep = jax.jit(jenv.step)
    params = penv.default_params()
    rng = np.random.RandomState(5)
    key = jax.random.PRNGKey(11)
    jstate, jobs = jenv.reset(key)
    pstate, pobs = penv.reset(_unit(key, penv.reset_shape), params)
    high = np.asarray(jenv.observation_space.high, np.float64)
    scale = np.where(high < 1e6, np.maximum(high, 1.0), 1.0)
    episodes = 0
    for t in range(TRACE_STEPS):
        ja, pa = _action(jenv, rng)
        jstate, jobs, jrew, jdone, _ = jstep(jstate, ja, jenv.default_params())
        pstate, pobs, prew, pdone, _ = penv.step(pstate, pa, params)
        err = np.abs(pobs.numpy().astype(np.float64) - np.asarray(jobs, np.float64))
        tol = 1e-4 if env_id == "Acrobot-v1" and t >= 60 else 1e-5
        assert (err <= tol * scale).all(), (t, err, scale)
        np.testing.assert_allclose(prew.numpy(), np.asarray(jrew), atol=1e-5, rtol=1e-5)
        assert bool(pdone) == bool(jdone), t
        if bool(jdone):
            episodes += 1
            key = jax.random.fold_in(key, t)
            jstate, jobs = jenv.reset(key)
            pstate, pobs = penv.reset(_unit(key, penv.reset_shape), params)
    if env_id == "CartPole-v1":
        assert episodes >= 5  # a random policy's episodes are short: the trace crosses resets


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_torch_device_envs_truncate_at_the_time_limit(env_id):
    jenv, penv = make_jax_env(env_id, max_episode_steps=3), make_device_env(env_id, max_episode_steps=3)
    params = penv.default_params()
    key = jax.random.PRNGKey(2)
    jstate, _ = jenv.reset(key)
    pstate, _ = penv.reset(_unit(key, penv.reset_shape), params)
    rng = np.random.RandomState(0)
    for t in range(3):
        ja, pa = _action(jenv, rng)
        jstate, _, _, jdone, jinfo = jenv.step(jstate, ja)
        pstate, _, _, pdone, pinfo = penv.step(pstate, pa, params)
        assert bool(pinfo["truncated"]) == bool(jinfo["truncated"]) == (t == 2)
        assert bool(pdone) == bool(jdone)


def _jax_batched_trace(env_id, n, steps, max_steps, seed):
    """BatchedJaxEnv's trajectory, and the reset noise its per-env keys give
    at every step (JAX draws a fresh reset for every env on every step from
    ``split(key)[1]`` and moves the key on only where the episode ended)."""
    raw = make_jax_env(env_id, max_episode_steps=max_steps)
    benv = BatchedJaxEnv(raw, n)
    shape = make_device_env(env_id).reset_shape
    bstate, bobs = benv.reset(jax.random.PRNGKey(seed))
    keys = np.asarray(bstate.keys)
    first_noise = [_unit(jax.random.split(k)[1], shape) for k in jax.random.split(jax.random.PRNGKey(seed), n)]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ja, pa = _action(raw, rng, n)
        noise = torch.stack([_unit(jax.random.split(jnp.asarray(k))[1], shape) for k in keys])
        bstate, obs, rew, done, info = benv.step(bstate, ja)
        keys = np.asarray(bstate.keys)
        out.append(dict(action=pa, noise=noise, obs=np.asarray(obs), rew=np.asarray(rew), done=np.asarray(done),
                        final=np.asarray(info["final_obs"]), truncated=np.asarray(info["truncated"])))
    return np.asarray(bobs), torch.stack(first_noise), out


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Acrobot-v1"])
def test_torch_device_envs_batched_autoreset_matches_jax_key_stream(env_id):
    """Same-step autoreset over 4 envs and 60 steps, with a 20-step time limit
    so every env resets more than once: on the done step the observation is
    the new episode's first (bit-equal, from the injected noise of JAX's key)
    and ``final_obs`` the terminal one."""
    n = 4
    first_obs, first_noise, steps = _jax_batched_trace(env_id, n, 60, 20, seed=11)
    benv = BatchedDeviceEnv(make_device_env(env_id, max_episode_steps=20), n)
    params = benv.env.default_params()
    state, obs = benv.reset(params, noise=first_noise)
    np.testing.assert_allclose(obs.numpy(), first_obs, atol=1.2e-7, rtol=0)
    resets = 0
    for t, s in enumerate(steps):
        state, obs, rew, done, info = benv.step(state, s["action"], params, noise=s["noise"])
        np.testing.assert_array_equal(done.numpy(), s["done"])
        np.testing.assert_array_equal(info["truncated"].numpy(), s["truncated"])
        np.testing.assert_array_equal(rew.numpy(), s["rew"])
        np.testing.assert_allclose(info["final_obs"].numpy(), s["final"], atol=1e-5, rtol=1e-5)
        d = s["done"]
        np.testing.assert_allclose(obs.numpy()[d], s["obs"][d], atol=1.2e-7, rtol=0)  # fresh resets
        np.testing.assert_allclose(obs.numpy(), s["obs"], atol=1e-5, rtol=1e-5)
        resets += int(d.sum())
    assert resets >= 2 * n


def test_torch_device_envs_generator_draws_reset_noise():
    """Without injected noise the batched env draws its resets from the
    generator: one seed, one trajectory; another seed, another."""
    benv = BatchedDeviceEnv(make_device_env("CartPole-v1", max_episode_steps=5), 3)
    params = benv.env.default_params()

    def roll(seed):
        g = torch.Generator().manual_seed(seed)
        state, obs = benv.reset(params, generator=g)
        seen = [obs]
        for _ in range(12):
            state, obs, *_ = benv.step(state, torch.ones(3, dtype=torch.long), params, generator=g)
            seen.append(obs)
        return torch.stack(seen)

    assert torch.equal(roll(1), roll(1)) and not torch.equal(roll(1), roll(2))


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_torch_device_envs_stacked_params_match_jax_vmap(env_id):
    """``(P,)``-stacked params over a ``(P, N)`` batch: reset and 10 steps
    equal JAX's ``vmap`` of the batched env over members, each member under
    its own gravity."""
    P, n = 3, 2
    jenv, penv = make_jax_env(env_id), make_device_env(env_id)
    jbenv, pbenv = BatchedJaxEnv(jenv, n), BatchedDeviceEnv(penv, n)
    vary = "g" if env_id == "Pendulum-v1" else "gravity"
    scale = np.asarray([1.0, 1.35, 0.75], np.float32)
    jdef = jenv.default_params()
    jstacked = jax.tree.map(lambda x: jnp.broadcast_to(x, (P,) + x.shape), jdef)
    jstacked = jstacked._replace(**{vary: getattr(jdef, vary) * jnp.asarray(scale)})
    pstacked = stack_params([penv.default_params()] * P)
    pstacked = pstacked._replace(**{vary: _t(np.asarray(jstacked[jstacked._fields.index(vary)]))})
    assert params_batch_shape(pstacked) == (P,) and pbenv.batch_shape(pstacked) == (P, n)

    keys = jax.random.split(jax.random.PRNGKey(4), P)
    jstate, jobs = jax.vmap(jbenv.reset)(keys, jstacked)
    noise = torch.stack([torch.stack([_unit(jax.random.split(k)[1], penv.reset_shape)
                                      for k in jax.random.split(mk, n)]) for mk in keys])
    pstate, pobs = pbenv.reset(pstacked, noise=noise)
    np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), atol=1.2e-7, rtol=0)
    vstep = jax.jit(jax.vmap(jbenv.step))
    rng = np.random.RandomState(1)
    for _ in range(10):
        if isinstance(jenv.action_space, gym.spaces.Box):
            a = rng.uniform(-2, 2, size=(P, n, 1)).astype(np.float32)
            pa = _t(a)
        else:
            a = rng.randint(jenv.action_space.n, size=(P, n)).astype(np.int32)
            pa = _t(a).long()
        step_noise = torch.stack([torch.stack([_unit(jax.random.split(k)[1], penv.reset_shape) for k in member])
                                  for member in np.asarray(jstate.keys)])
        jstate, jobs, jrew, jdone, _ = vstep(jstate, jnp.asarray(a), jstacked)
        pstate, pobs, prew, pdone, _ = pbenv.step(pstate, pa, pstacked, noise=step_noise)
        np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(prew.numpy(), np.asarray(jrew), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(pdone.numpy(), np.asarray(jdone))
    obs = pobs.numpy()
    assert not np.array_equal(obs[0], obs[1])  # the members' dynamics differ
