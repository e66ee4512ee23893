"""One data-parallel train call of the port's dropout-Q ensemble SAC and of
its pixel SAC with an autoencoder (2 gloo rank processes) against the JAX
package's on a 2-device CPU mesh, on the CPU.

- The dropout-Q ensemble at the size of ``tests/test_torch_dropout_q.py``
  (hidden 32, dropout 0.2, 2 critics, Pendulum), a global batch of 8: each
  rank, as each JAX device, takes 4 rows of each of the G = 3 critic
  batches and of the actor's batch. The masks and noise of each device are
  rebuilt from its key (``fold_in`` of the device index, then that file's
  splits) with the capturing ensemble of that file. The recipe's Adams.
- The pixel SAC at the size of ``tests/test_torch_pixel_autoencoder.py``
  (conv trunk multiplier 1, features 16, hidden 32, rgb 64x64x3, 2
  actions), a global batch of 4: 2 rows a rank, G = 2 steps from ``cum0``
  1, so the first step skips the target EMAs and the actor and the second
  takes both, each takes the decoder's update. Every optimizer is a plain
  SGD at 1e-3 on both sides (``optax.sgd`` and the port's twin), so a
  parameter's change is the reduced gradient itself.

Each at the float32 and the bfloat16 wire. The two ranks spawn once for the
file and run every case.

Tolerances: the dropout-Q ensemble at the float32 wire as its one-device
file (losses rtol 1e-5, atol 1e-6; parameters within 1e-5); at the bfloat16
wire the parameters within 1e-5 + 4 steps x lr x 2^-8 (each reduced
gradient is the bfloat16 rounding of the mean on both sides, one bfloat16
ulp apart at worst, and an Adam step moves a parameter by at most lr) and
the losses within rtol 1e-4. The pixel SAC's losses within rtol 1e-5
(atol 1e-6) and each tensor's change within 1e-5 of JAX's relative to its
norm plus twice the float32 rounding of the stored values (its one-device
file's SGD bound); at the bfloat16 wire within 2^-7 of the norm (a change is
the bfloat16-rounded gradient times the rate, each element within one
bfloat16 ulp of JAX's). The two ranks' parameters are bit-equal in every
case.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sheeprl_tpu.algos.droq.agent import build_agent as jax_ensemble_agent
from sheeprl_tpu.algos.droq.droq import make_train_step as jax_ensemble_step
from sheeprl_tpu.algos.sac_ae.agent import build_agent as jax_pixel_agent
from sheeprl_tpu.algos.sac_ae.sac_ae import make_train_step as jax_pixel_step
from sheeprl_tpu.config import compose
from sheeprl_tpu.optim.builders import build_optimizer as jax_build_optimizer
from sheeprl_tpu.parallel import comm as jax_comm
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu_torch.config import apply_overrides, plain, preset
from sheeprl_tpu_torch.utils.convert import sac_ae_state_from_jax, sac_state_from_jax
from tests.test_torch_dropout_q import _batch, _masks
from tests.test_torch_dropout_q import OVERRIDES as ENSEMBLE_OVERRIDES
from tests.test_torch_pixel_autoencoder import SMALL as PIXEL_SMALL
from tests.test_torch_pixel_autoencoder import SPACES as PIXEL_SPACES
from tests.torch_dp_ranks import offpolicy_job, spawn_ranks

WORLD, OBS = 2, 3
E_BATCH, E_G, E_ACT = 8, 3, 1
P_BATCH, P_G, P_ACT, SGD_LR = 4, 2, 2, 1e-3
CASES = {
    "ensemble-f32": dict(kind="ensemble", wire="float32"),
    "ensemble-bf16": dict(kind="ensemble", wire="bfloat16"),
    "pixel-f32": dict(kind="pixel", wire="float32"),
    "pixel-bf16": dict(kind="pixel", wire="bfloat16"),
}


def _ensemble_case(fabric):
    overrides = [o for o in ENSEMBLE_OVERRIDES if not o.startswith("algo.per_rank_batch_size")]
    overrides += [f"algo.per_rank_batch_size={E_BATCH}"]
    cfg = compose(["exp=droq"] + overrides)
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (OBS,), np.float32)})
    act_space = gym.spaces.Box(-2.0, 2.0, (E_ACT,), np.float32)
    agent, params, _ = jax_ensemble_agent(fabric, cfg, obs_space, act_space)
    before = jax.tree.map(np.array, params)
    txs = [jax_build_optimizer(cfg.algo[k].optimizer) for k in ("actor", "critic", "alpha")]
    opts = [txs[0].init(params["actor"]), txs[1].init(params["critic"]), txs[2].init(params["log_alpha"])]
    rng = np.random.default_rng(1)
    critic_data, actor_data = _batch(rng, (E_G, E_BATCH)), _batch(rng, (E_BATCH,))
    key = jax.random.PRNGKey(17)
    train = jax_ensemble_step(agent, *txs, cfg, fabric.mesh)
    out = train(jax.tree.map(jnp.asarray, params), *opts, {k: jnp.asarray(v) for k, v in critic_data.items()},
                {k: jnp.asarray(v) for k, v in actor_data.items()}, key)
    local = E_BATCH // WORLD
    mask_rng = np.random.default_rng(2)
    noise = {k: [] for k in ("next", "target_masks", "online_masks", "actor", "actor_masks")}
    for d in range(WORLD):
        k_scan, k_actor, k_q = jax.random.split(jax.random.fold_in(key, d), 3)
        per = {k: [] for k in ("next", "target_masks", "online_masks")}
        for k in jax.random.split(k_scan, E_G):
            k_target, k_online = jax.random.split(k)
            k_act, k_drop = jax.random.split(k_target)
            per["next"].append(np.asarray(jax.random.normal(k_act, (local, E_ACT))))
            per["target_masks"].append(_masks(before["critic"], k_drop, local, mask_rng)[0])
            per["online_masks"].append(_masks(before["critic"], k_online, local, mask_rng)[0])
        for name, values in per.items():
            noise[name].append(np.stack(values))
        noise["actor"].append(np.asarray(jax.random.normal(k_actor, (local, E_ACT))))
        noise["actor_masks"].append(_masks(before["critic"], k_q, local, mask_rng)[0])
    port_cfg = plain(apply_overrides(preset("droq"), overrides))
    lr = max(float(cfg.algo[k].optimizer.lr) for k in ("actor", "critic", "alpha"))
    port = {"cfg": port_cfg, "state": sac_state_from_jax(before), "obs_dim": OBS, "local_batch": local,
            "action_space": {"shape": [E_ACT], "low": [-2.0], "high": [2.0], "continuous": True},
            "critic_data": critic_data, "actor_data": actor_data, "noise": {k: np.stack(v) for k, v in noise.items()}}
    want = {"params": sac_state_from_jax(jax.tree.map(np.asarray, out[0])), "losses": [float(x) for x in out[4:]],
            "before": sac_state_from_jax(before), "steps": E_G + 1, "lr": lr}
    return port, want


def _pixel_case(fabric):
    small = [o for o in PIXEL_SMALL if not o.startswith("algo.per_rank_batch_size")]
    small += [f"algo.per_rank_batch_size={P_BATCH}"]
    cfg = compose(["exp=sac_ae", "env=dummy", "env.id=continuous_dummy"] + small)
    obs_space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    act_space = gym.spaces.Box(-1.0, 1.0, (P_ACT,), np.float32)
    agent, params, _ = jax_pixel_agent(fabric, cfg, obs_space, act_space)
    params = jax.tree.map(np.asarray, params)
    txs = {k: optax.sgd(SGD_LR) for k in ("qf", "actor", "alpha", "encoder", "decoder")}
    jp = jax.tree.map(jnp.asarray, params)
    opts = {
        "qf": txs["qf"].init({"encoder": jp["encoder"], "qfs": jp["qfs"]}),
        "actor": txs["actor"].init({"actor": jp["actor"], "actor_enc_head": jp["actor_enc_head"]}),
        "alpha": txs["alpha"].init(jp["log_alpha"]),
        "encoder": txs["encoder"].init({"e": jp["encoder"]}),
        "decoder": txs["decoder"].init({"d": jp["decoder"]}),
    }
    rng = np.random.default_rng(4)
    data = {
        "rgb": rng.integers(0, 256, (P_G, P_BATCH, 64, 64, 3)).astype(np.float32),
        "next_rgb": rng.integers(0, 256, (P_G, P_BATCH, 64, 64, 3)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (P_G, P_BATCH, P_ACT)).astype(np.float32),
        "rewards": rng.normal(size=(P_G, P_BATCH, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(P_G, P_BATCH, 1)) < 0.25).astype(np.float32),
    }
    key = jax.random.PRNGKey(21)
    train = jax_pixel_step(agent, txs, cfg, fabric.mesh)
    new, _, *losses = train(jp, opts, {k: jnp.asarray(v) for k, v in data.items()}, key, jnp.int32(1))
    local = P_BATCH // WORLD
    noise = {"next": [], "actor": [], "pixels": {"rgb": []}}
    for d in range(WORLD):
        nxt, act, pix = [], [], []
        for k in jax.random.split(jax.random.fold_in(key, d), P_G):
            k_next, k_actor, k_noise = jax.random.split(k, 3)
            nxt.append(np.asarray(jax.random.normal(k_next, (local, P_ACT))))
            act.append(np.asarray(jax.random.normal(k_actor, (local, P_ACT))))
            pix.append(np.asarray(jax.random.uniform(k_noise, (local, 64, 64, 3), dtype=jnp.float32)))
        noise["next"].append(np.stack(nxt))
        noise["actor"].append(np.stack(act))
        noise["pixels"]["rgb"].append(np.stack(pix))
    noise = {"next": np.stack(noise["next"]), "actor": np.stack(noise["actor"]),
             "pixels": {"rgb": np.stack(noise["pixels"]["rgb"])}}
    port_cfg = {**plain(apply_overrides(preset("sac_ae"), small)), "spaces": PIXEL_SPACES}
    port = {"cfg": port_cfg, "state": sac_ae_state_from_jax(params), "data": data, "noise": noise, "cum0": 1,
            "local_batch": local, "lr": SGD_LR}
    want = {"params": sac_ae_state_from_jax(jax.tree.map(np.asarray, new)), "losses": [float(x) for x in losses],
            "before": sac_ae_state_from_jax(params)}
    return port, want


@pytest.fixture(scope="module")
def calls():
    fabric = Fabric(devices=WORLD, accelerator="cpu")
    cases, want = {}, {}
    for name, c in CASES.items():
        jax_comm.set_grad_reduce_dtype(c["wire"], fresh_run=True)
        try:
            port, want[name] = (_ensemble_case if c["kind"] == "ensemble" else _pixel_case)(fabric)
        finally:
            jax_comm.set_grad_reduce_dtype("float32", fresh_run=True)
        cases[name] = dict(c, **port)
    return {"ranks": spawn_ranks(offpolicy_job, {"cases": cases}, world=WORLD, timeout=240.0), "jax": want}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_dp_offpolicy_ensemble_ranks_end_bit_equal(calls, case):
    a, b = (r[case] for r in calls["ranks"])
    assert a["digest"] == b["digest"]
    for name, value in a["params"].items():
        assert np.array_equal(value, b["params"][name]), name
    np.testing.assert_array_equal(a["losses"], b["losses"])
    # the ensemble: G critic reductions, the actor's and alpha's; the pixel
    # SAC: each step's critic and decoder, the second step's actor and alpha
    want = E_G + 2 if CASES[case]["kind"] == "ensemble" else 2 * P_G + 2
    assert a["reductions"] == b["reductions"] == want


@pytest.mark.parametrize("case", list(CASES))
def test_torch_dp_offpolicy_ensemble_matches_jax(calls, case):
    c = CASES[case]
    got, want = calls["ranks"][0][case], calls["jax"][case]
    bf16 = c["wire"] == "bfloat16"
    assert np.all(np.isfinite(got["losses"]))
    if c["kind"] == "ensemble":
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4 if bf16 else 1e-5, atol=1e-6)
        atol = 1e-5 + (want["steps"] * want["lr"] * 2.0 ** -8 if bf16 else 0.0)
        for name, value in want["params"].items():
            np.testing.assert_allclose(got["params"][name], value.numpy(), atol=atol, rtol=0, err_msg=name)
    else:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-6)
        rel = 2.0 ** -7 if bf16 else 1e-5
        for name, value in want["params"].items():
            g = got["params"][name].astype(np.float64)
            w, b = value.numpy().astype(np.float64), want["before"][name].numpy()
            err, norm = np.linalg.norm(g - w), np.linalg.norm(w - b)
            rounding = float(np.linalg.norm(np.spacing(np.abs(b).astype(np.float32)).astype(np.float64)))
            assert err <= rel * norm + 2 * rounding, f"{name}: change differs by {err} against {norm}"
    moved = sum(int(not np.array_equal(v.numpy(), want["before"][k].numpy())) for k, v in want["params"].items())
    assert moved > 0
