"""The port's stateless bucket engine on the CPU (the cases of the JAX
package's ``tests/test_serve/test_engine.py``): ladder selection, padding
parity, chunking past the largest bucket, sample-mode determinism,
slab reuse, hot swaps, observation validation, the naive engine and the
fill counters. A toy linear policy, and the PPO and SAC builders at their
presets' widths from a seed; no JAX.

Padding parity: the engine's rows are bit-equal to the policy run on the
same bucket-padded batch (staging, padding and slicing add nothing). Against
the policy run on the unpadded rows, PPO's actions (argmax indices) are
equal and SAC's within atol 1e-6: PyTorch's CPU matrix products pick their
kernel by batch size, so float rows may move by a few ulps (up to 3e-7 at
these widths) when only the batch size changes.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.algos.ppo.evaluate import serve_policy_ppo
from sheeprl_tpu_torch.algos.sac.evaluate import serve_policy_sac
from sheeprl_tpu_torch.config import apply_overrides, dotdict, preset
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.ops import counter_uniform
from sheeprl_tpu_torch.serve.engine import BucketEngine, NaiveEngine, check_chunk_order, chunk_plan, row_keys
from sheeprl_tpu_torch.serve.policy import ServePolicy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_policy() -> ServePolicy:
    """Linear map: tiny, deterministic, and a swap shows in the actions."""

    def greedy_fn(p, obs):
        return obs["x"] @ p["w"]

    def sample_fn(p, obs, noise):
        return obs["x"] @ p["w"] + 1e-3 * noise

    return ServePolicy(
        name="toy",
        params={"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
        obs_spec={"x": ((2,), np.float32)},
        action_dim=3,
        greedy_fn=greedy_fn,
        sample_fn=sample_fn,
        draw_fn=lambda seed, counter: torch.special.ndtri(counter_uniform(seed, counter, 0, 3)),
        prepare=lambda obs, n: {"x": np.asarray(obs["x"], np.float32).reshape(n, 2)},
        params_from_state=lambda state: {"w": torch.as_tensor(state["w"], dtype=torch.float32)},
        device=torch.device("cpu"),
    )


def port_cfg(name: str, extra=()):
    cfg = apply_overrides(preset(name), ["env.num_envs=1"] + list(extra))
    cfg["spaces"] = dotdict(make_vector_env(cfg, 0).spaces)
    return cfg


@pytest.fixture(scope="module")
def ppo_policy():
    return serve_policy_ppo(port_cfg("ppo"), None, "cpu")


@pytest.fixture(scope="module")
def sac_policy():
    return serve_policy_sac(port_cfg("sac"), None, "cpu")


def _obs(policy, n, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n, *shape)).astype(dtype) for k, (shape, dtype) in policy.obs_spec.items()}


def _direct(policy, obs, params=None):
    with torch.no_grad():
        return policy.greedy_fn(policy.params if params is None else params,
                                {k: torch.from_numpy(v) for k, v in obs.items()}).numpy()


def test_torch_serve_engine_bucket_selection():
    eng = BucketEngine(toy_policy(), buckets=(1, 8, 32), warmup=False)
    assert [eng.bucket_for(n) for n in (1, 2, 8, 9, 32, 33)] == [1, 8, 8, 32, 32, 32]  # 33: the caller chunks
    with pytest.raises(ValueError):
        eng.bucket_for(0)
    assert BucketEngine(toy_policy(), buckets=None, warmup=False).buckets == (1, 8, 32, 128)
    assert BucketEngine(toy_policy(), buckets=(8, 1, 8), warmup=False).buckets == (1, 8)


def test_torch_serve_engine_bad_ladder_and_mode():
    policy = toy_policy()
    with pytest.raises(ValueError):
        BucketEngine(policy, buckets=(0, 4))
    with pytest.raises(ValueError):
        BucketEngine(policy, buckets=(1, 4), mode="nope")
    with pytest.raises(ValueError):
        NaiveEngine(policy, mode="both")
    eng = BucketEngine(policy, buckets=(1, 4), mode="greedy")
    with pytest.raises(ValueError, match="cannot serve sample"):
        eng.infer(policy.params, _obs(policy, 2), greedy=False, key=(0, 0))
    sampler = BucketEngine(policy, buckets=(1, 4), mode="sample")
    with pytest.raises(ValueError, match="needs a key"):
        sampler.infer(policy.params, _obs(policy, 2))


@pytest.mark.parametrize("which", ["toy", "ppo", "sac"])
def test_torch_serve_engine_bucket_padding_parity(which, request):
    policy = toy_policy() if which == "toy" else request.getfixturevalue(f"{which}_policy")
    buckets = (1, 4, 16)
    cap = max(buckets)
    eng = BucketEngine(policy, buckets=buckets)
    for n in (1, 2, 3, 4, 5, 15, 16, 17, 33, 40):
        obs = _obs(policy, n, seed=n)
        got = eng.infer(policy.params, obs)
        assert got.shape == (n, policy.action_dim), n
        # against the policy on the same padded slabs, chunk by chunk: bit for bit
        padded = []
        for a, b in chunk_plan(n, cap):
            bucket = eng.bucket_for(b - a)
            slab = {k: np.zeros((bucket, *v.shape[1:]), v.dtype) for k, v in obs.items()}
            for k, v in obs.items():
                slab[k][: b - a] = v[a:b]
            padded.append(_direct(policy, slab)[: b - a])
        np.testing.assert_array_equal(got, np.concatenate(padded), err_msg=f"batch {n}")
        whole = _direct(policy, obs)
        assert got.dtype == whole.dtype
        if which == "ppo":
            np.testing.assert_array_equal(got, whole, err_msg=f"batch {n}")
        else:
            np.testing.assert_allclose(got, whole, rtol=0, atol=1e-6, err_msg=f"batch {n}")


def test_torch_serve_engine_slab_reuse_after_large_batch(ppo_policy):
    """A full batch leaves its rows in the slab; a smaller one after it reads
    zeros in its padding (the tail is zeroed) and gets its own actions."""
    eng = BucketEngine(ppo_policy, buckets=(4,))
    eng.infer(ppo_policy.params, _obs(ppo_policy, 4, seed=1))
    small = _obs(ppo_policy, 2, seed=2)
    np.testing.assert_array_equal(eng.infer(ppo_policy.params, small), _direct(ppo_policy, small))
    assert not eng._host[4]["state"][2:].any()


def test_torch_serve_engine_chunking_matches_unchunked():
    """11 rows through a ladder topped at 4 (chunks 4, 4, 3 in order) equal
    the whole-batch call row for row, in greedy mode and in sample mode
    (a chunk's rows keep their row index in the batch as their counter)."""
    policy = toy_policy()
    obs = _obs(policy, 11, seed=3)
    assert chunk_plan(11, 4) == [(0, 4), (4, 8), (8, 11)]
    np.testing.assert_array_equal(BucketEngine(policy, buckets=(1, 4)).infer(policy.params, obs), _direct(policy, obs))
    got = BucketEngine(policy, buckets=(1, 4), mode="sample").infer(policy.params, obs, key=(5, 2))
    want = BucketEngine(policy, buckets=(16,), mode="sample").infer(policy.params, obs, key=(5, 2))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="out of order"):
        check_chunk_order([(0, 4), (8, 11), (4, 8)], 11)
    with pytest.raises(RuntimeError, match="covers"):
        check_chunk_order([(0, 4), (4, 8)], 11)


def test_torch_serve_engine_sample_mode_deterministic_per_key():
    policy = toy_policy()
    eng = BucketEngine(policy, buckets=(1, 4), mode="sample")
    obs = _obs(policy, 3, seed=4)
    a = eng.infer(policy.params, obs, key=(7, 0))
    np.testing.assert_array_equal(a, eng.infer(policy.params, obs, key=(7, 0)))
    for other in ((8, 0), (7, 1)):  # another seed, another batch index
        assert not np.array_equal(a, eng.infer(policy.params, obs, key=other))
    # rows are decorrelated: one observation repeated gets three draws
    same = {"x": np.repeat(obs["x"][:1], 3, axis=0)}
    rows = eng.infer(policy.params, same, key=(7, 0))
    assert len({r.tobytes() for r in rows}) == 3
    seeds, counters = row_keys((7, 1), 2, 3, torch.device("cpu"))
    assert counters.tolist() == [2, 3, 4] and len(set(seeds.tolist())) == 1
    assert seeds[0].item() != row_keys((7, 0), 2, 3, torch.device("cpu"))[0][0].item()


def test_torch_serve_engine_hot_swapped_params():
    """``infer`` takes the weights per call: a rebuilt params object serves
    the very next batch, and the actions follow the new weights."""
    policy = toy_policy()
    eng = BucketEngine(policy, buckets=(1, 4))
    obs = _obs(policy, 2, seed=5)
    before = eng.infer(policy.params, obs)
    swapped = policy.params_from_state({"w": policy.params["w"].numpy() * 2.0})
    np.testing.assert_allclose(eng.infer(swapped, obs), before * 2.0, rtol=1e-6)
    np.testing.assert_array_equal(eng.infer(policy.params, obs), before)


def test_torch_serve_engine_obs_validation():
    policy = toy_policy()
    eng = BucketEngine(policy, buckets=(1,), warmup=False)
    with pytest.raises(ValueError, match="keys"):
        eng.infer(policy.params, {"y": np.zeros((1, 2), np.float32)})
    with pytest.raises(ValueError, match="per-row shape"):
        eng.infer(policy.params, {"x": np.zeros((1, 3), np.float32)})


def test_torch_serve_engine_naive_engine_matches():
    policy = toy_policy()
    naive = NaiveEngine(policy)
    aot = BucketEngine(policy, buckets=(1, 4))
    for n in (1, 3, 4, 6):
        obs = _obs(policy, n, seed=10 + n)
        np.testing.assert_array_equal(naive.infer(policy.params, obs), aot.infer(policy.params, obs))
    assert naive.buckets == () and naive.stats() == {"dispatches": 4, "rows": 14, "padded_rows": 0, "batch_fill_ratio": 1.0}
    sample = NaiveEngine(policy, mode="sample")
    obs = _obs(policy, 3, seed=9)
    np.testing.assert_array_equal(sample.infer(policy.params, obs, key=(1, 1)),
                                  BucketEngine(policy, buckets=(4,), mode="sample").infer(policy.params, obs, key=(1, 1)))


def test_torch_serve_engine_fill_stats():
    """The warm-up dispatches are not counted; a 3-row call in bucket 4 is
    one dispatch with one padded row, and a 9-row call two dispatches of
    4 and one of 1 padded to 4."""
    policy = toy_policy()
    eng = BucketEngine(policy, buckets=(4,))
    assert eng.stats() == {"dispatches": 0, "rows": 0, "padded_rows": 0, "batch_fill_ratio": 0.0}
    eng.infer(policy.params, _obs(policy, 3))
    assert eng.stats() == {"dispatches": 1, "rows": 3, "padded_rows": 1, "batch_fill_ratio": 0.75}
    eng.infer(policy.params, _obs(policy, 9))
    assert eng.stats() == {"dispatches": 4, "rows": 12, "padded_rows": 4, "batch_fill_ratio": 0.75}
