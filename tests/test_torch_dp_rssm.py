"""Data-parallel DreamerV3 gradient steps of the port (2 gloo rank
processes) against the JAX package's ``make_train_step`` on a 2-device CPU
mesh, on the CPU, at the tiny pixel+vector size of
``tests/test_torch_train_step.py`` (sequence 8, horizon 5), a global batch
of 4: rank ``r``, as JAX's device ``r``, trains on batch columns ``2 r`` and
``2 r + 1``.

Two calls of one gradient step each (``cum0`` 0 copies the critic into the
target critic, ``cum0`` 1 mixes it in at ``tau`` and takes Adam's second
step), at the float32 wire unguarded and at the bfloat16 wire guarded. The
world-model, actor and critic gradients are mean-reduced before their
clipped steps, the ``Moments`` percentiles are taken over both ranks'
lambda-returns (gathered detached, on the gradient wire, as JAX's
``all_gather_wire`` gathers them), and the metrics are the group's means.
Each device's noise is rebuilt from its key (``fold_in`` of the device
index, then that file's splits). The two ranks spawn once for the file.

Tolerances: at the float32 wire the ten metrics within rtol 1e-4 (atol
1e-5), every parameter within 1e-6 and the ``Moments`` state within rtol
1e-5 (the one-device file's). At the bfloat16 wire the gradients and the
gathered lambda-returns cross in bfloat16 on both sides; a value one float32
rounding from a bfloat16 boundary may round one ulp (2^-8 relative) apart,
which moves an Adam step (at most lr, 1e-4) by at most lr x 2^-8, so the
parameters are held within 1e-6 + 2 steps x 1e-4 x 2^-8 and the ``Moments``
state and the second call's metrics within rtol 1e-3. The two ranks'
parameters are bit-equal in every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jax_init_moments
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel import comm as jax_comm
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES
from sheeprl_tpu_torch.config import plain
from sheeprl_tpu_torch.utils.convert import dreamer_v3_state_from_jax
from tests.test_torch_rssm_train import N_ACTIONS, tiny_configs
from tests.torch_dp_ranks import rssm_job, spawn_ranks

T, B, H, WORLD = 8, 4, 5, 2
LOCAL = B // WORLD
EXTRA = [f"algo.per_rank_batch_size={B}", f"algo.per_rank_sequence_length={T}", f"algo.horizon={H}"]
CASES = {"f32": dict(wire="float32", guard=False), "bf16-guarded": dict(wire="bfloat16", guard=True)}
LR = 1e-4  # the recipe's largest rate (the world model's)


def _batch():
    rng = np.random.default_rng(0)
    data = {
        "rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3)).astype(np.float32),
        "state": rng.normal(size=(1, T, B, 10)).astype(np.float32),
        "actions": np.eye(N_ACTIONS, dtype=np.float32)[rng.integers(0, N_ACTIONS, (1, T, B))],
        "rewards": (rng.normal(size=(1, T, B, 1)) * 3).astype(np.float32),
        "terminated": np.zeros((1, T, B, 1), np.float32),
        "truncated": np.zeros((1, T, B, 1), np.float32),
        "is_first": np.zeros((1, T, B, 1), np.float32),
    }
    for col, t in ((0, 3), (1, 6), (2, 2), (3, 5)):
        data["is_first"][:, t, col] = 1.0
        data["terminated"][:, t - 1, col] = 1.0
    return data


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))


def _device_noise(key, d, stoch, discrete):
    """Device ``d``'s draws for its one gradient step, as the port's
    ``noise`` takes them."""
    step_key = jax.random.split(jax.random.fold_in(key, d), 1)[0]
    k_dyn, k_img = jax.random.split(step_key)
    rows = T * LOCAL
    posterior = np.stack([_uniform(k, (LOCAL, stoch, discrete)).reshape(LOCAL, stoch * discrete)
                          for k in jax.random.split(k_dyn, T)])
    k0, k_scan = jax.random.split(k_img)
    actions = [_uniform(jax.random.split(k0, 1)[0], (rows, N_ACTIONS))]
    prior = []
    for k in jax.random.split(k_scan, H):
        k_prior, k_act = jax.random.split(k)
        prior.append(_uniform(k_prior, (rows, stoch, discrete)).reshape(rows, stoch * discrete))
        actions.append(_uniform(jax.random.split(k_act, 1)[0], (rows, N_ACTIONS)))
    return posterior, np.stack(prior), np.stack(actions)


@pytest.fixture(scope="module")
def calls():
    cfg, port_cfg, obs_space = tiny_configs(EXTRA)
    fabric = Fabric(devices=WORLD, accelerator="cpu")
    world_model, actor, critic, params0, _ = jax_build_agent(fabric, (N_ACTIONS,), False, cfg, obs_space)
    before = jax.tree.map(np.array, params0)
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    data = _batch()
    cases, want = {}, {}
    for name, c in CASES.items():
        txs = {k: jax_build_optimizer(cfg.algo[m].optimizer, max_grad_norm=cfg.algo[m].clip_gradients)
               for k, m in (("world", "world_model"), ("actor", "actor"), ("critic", "critic"))}
        params = jax.tree.map(jnp.asarray, before)
        opts = {"world": txs["world"].init(params["world_model"]), "actor": txs["actor"].init(params["actor"]),
                "critic": txs["critic"].init(params["critic"])}
        jax_comm.set_grad_reduce_dtype(c["wire"], fresh_run=True)
        try:
            train = jax_make_train_step(world_model, actor, critic, cfg, fabric.mesh, (N_ACTIONS,), False, txs,
                                        guard=c["guard"])
            moments, port_calls, jax_calls = jax_init_moments(), [], []
            for cum in range(2):
                key = jax.random.PRNGKey(11 + cum)
                params, opts, moments, metrics = train(params, opts, moments, data, key, jnp.int32(cum))
                noise = [_device_noise(key, d, S, D) for d in range(WORLD)]
                port_calls.append({"cum0": cum, "posterior": np.stack([n[0] for n in noise]),
                                   "imagined_prior": np.stack([n[1] for n in noise]),
                                   "actions": [np.stack([n[2] for n in noise])]})
                jax_calls.append({"metrics": [float(m) for m in metrics],
                                  "moments": {k: float(v) for k, v in moments.items()}})
        finally:
            jax_comm.set_grad_reduce_dtype("float32", fresh_run=True)
        want[name] = {"calls": jax_calls, "params": dreamer_v3_state_from_jax(jax.tree.map(np.asarray, params))}
        cases[name] = dict(c, cfg=plain(port_cfg), state=dreamer_v3_state_from_jax(before), data=data,
                           local_batch=LOCAL, calls=port_calls)
    ranks = spawn_ranks(rssm_job, {"cases": cases}, world=WORLD, timeout=240.0)
    return {"ranks": ranks, "jax": want, "before": dreamer_v3_state_from_jax(before)}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_dp_rssm_ranks_end_bit_equal(calls, case):
    a, b = (r[case] for r in calls["ranks"])
    assert a["digest"] == b["digest"]
    for module, tensors in a["params"].items():
        for name, value in tensors.items():
            assert np.array_equal(value, b["params"][module][name]), f"{module}.{name}"
    for ca, cb in zip(a["calls"], b["calls"]):
        np.testing.assert_array_equal(ca["metrics"], cb["metrics"])
        assert ca["moments"] == cb["moments"] and ca["skipped"] == cb["skipped"] == 0.0
    # world model, actor and critic: three reductions a step, the verdict riding the last
    assert a["reductions"] == b["reductions"] == 3 * 2
    assert a["gather_detached"] and b["gather_detached"]


@pytest.mark.parametrize("call", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_dp_rssm_metrics_and_moments_match_jax(calls, case, call):
    bf16 = CASES[case]["wire"] == "bfloat16"
    got = calls["ranks"][0][case]["calls"][call]
    want = calls["jax"][case]["calls"][call]
    rtol = 1e-3 if bf16 and call else 1e-4
    np.testing.assert_allclose(got["metrics"], want["metrics"][:len(METRIC_NAMES)], rtol=rtol, atol=1e-5)
    if CASES[case]["guard"]:
        assert want["metrics"][len(METRIC_NAMES)] == 0.0  # JAX's skipped share
    for k in ("low", "high"):
        np.testing.assert_allclose(got["moments"][k], want["moments"][k], rtol=1e-3 if bf16 else 1e-5, atol=1e-8)
    assert want["moments"]["high"] != 0.0


@pytest.mark.parametrize("module", ["world_model", "actor", "critic", "target_critic"])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_dp_rssm_parameters_match_jax(calls, case, module):
    bf16 = CASES[case]["wire"] == "bfloat16"
    got = calls["ranks"][0][case]["params"][module]
    want = calls["jax"][case]["params"][module]
    assert set(got) == set(want)
    atol = 1e-6 + (2 * LR * 2.0 ** -8 if bf16 else 0.0)
    moved = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value.numpy(), atol=atol, rtol=0, err_msg=f"{module}.{name}")
        moved += int(not np.array_equal(value.numpy(), calls["before"][module][name].numpy()))
    assert moved > 0
