"""The population's sweep, scenario and PBT resolution
(``resolve_matrix``, ``resolve_sweep``, ``resolve_pbt``) against the JAX
package's, on the CPU: the same numpy draws (``default_rng([seed,
crc32(name)])``), so every array is equal bit for bit, in its dtype, and
every rejection is the same ``ValueError``. The configs are the two
packages' compositions of the same overrides (``exp=ppo_anakin`` and the
port's ``ppo_anakin`` preset); the envs their own CartPole and Pendulum."""

import numpy as np
import pytest

from sheeprl_tpu.algos.ppo import ppo_anakin_population as J
from sheeprl_tpu.config import compose
from sheeprl_tpu.envs.jax_envs import make_jax_env
from sheeprl_tpu_torch.algos.ppo import ppo_anakin_population as Q
from sheeprl_tpu_torch.config import apply_overrides, preset
from sheeprl_tpu_torch.envs.device_envs import make_device_env

FAST = ["env.num_envs=2", "algo.rollout_steps=8", "algo.per_rank_batch_size=4", "algo.update_epochs=1"]

CASES = {
    "grid-two-axes": (["algo.population.sweep=grid", "algo.population.hparams={lr: [1e-3, 5e-4], ent_coef: [0.0, 0.01]}"],
                      4, 0, None),
    "grid-seed-independent": (["algo.population.sweep=grid", "algo.population.hparams={lr: [1e-3, 5e-4], ent_coef: [0.0, 0.01]}"],
                              4, 99, None),
    "random-ranges": (["algo.population.sweep=random",
                       "algo.population.hparams={lr: {low: 1e-4, high: 1e-2, log: true}, ent_coef: {choices: [0.0, 0.01, 0.1]}}"],
                      16, 3, None),
    "random-other-seed": (["algo.population.sweep=random",
                           "algo.population.hparams={lr: {low: 1e-4, high: 1e-2, log: true}, gamma: {low: 0.9, high: 0.999}}"],
                          8, 5, None),
    "recipe-lr-grid": ([], 8, 42, None),
    "const-broadcast": (["algo.population.hparams={clip_coef: 0.3}"], 3, 0, None),
    "matrix-grid": (["algo.population.sweep=grid", "algo.population.hparams={lr: [1e-3, 5e-4]}",
                     "algo.population.env_params={length: [0.25, 0.5]}"], 4, 0, "CartPole-v1"),
    "matrix-random": (["algo.population.sweep=random", "algo.population.hparams={lr: {low: 1e-4, high: 1e-2, log: true}}",
                       "algo.population.env_params={g: {low: 2.0, high: 20.0}, max_episode_steps: {low: 100, high: 400}}"],
                      8, 5, "Pendulum-v1"),
    "matrix-env-only": (["algo.population.sweep=random", "algo.population.env_params={g: {low: 2.0, high: 20.0}}"],
                        8, 5, "Pendulum-v1"),
    "matrix-env-choices": (["algo.population.sweep=random", "algo.population.env_params={length: [0.5, 1.0, 2.0]}"],
                           6, 11, "CartPole-v1"),
}

REJECTIONS = {
    "grid-size": (["algo.population.hparams={lr: [1e-3, 5e-4]}"], 3, None, "cartesian product"),
    "grid-range": (["algo.population.hparams={lr: {low: 1e-4, high: 1e-2}}"], 4, None, "cannot expand the range"),
    "unknown-hparam": (["algo.population.hparams={vf_coef: [0.5, 1.0]}"], 2, None, "Unknown population hparam"),
    "log-low": (["algo.population.sweep=random", "algo.population.hparams={lr: {low: 0.0, high: 1e-2, log: true}}"],
                2, None, "low > 0"),
    "high-low": (["algo.population.sweep=random", "algo.population.hparams={lr: {low: 1e-2, high: 1e-3}}"],
                 2, None, "high >= low"),
    "mode": (["algo.population.sweep=bayes"], 2, None, "grid' or 'random"),
    "unknown-env": (["algo.population.env_params={mass_of_moon: [1, 2]}"], 2, "CartPole-v1", "Unknown env param"),
    "no-env": (["algo.population.env_params={length: [0.25, 0.5]}"], 2, "none", "no "),
    "env-range": (["algo.population.env_params={length: {low: 0.25, high: 1.0}}"], 2, "CartPole-v1",
                  "cannot expand the range"),
    "joint-grid": (["algo.population.hparams={lr: [1e-3, 5e-4]}", "algo.population.env_params={length: [0.25, 0.5]}"],
                   3, "CartPole-v1", "share ONE grid"),
}


def _cfgs(extra):
    jax_cfg = compose(["exp=ppo_anakin", "algo.mlp_keys.encoder=[state]", *FAST, *extra])
    port_cfg = apply_overrides(preset("ppo_anakin"), FAST + list(extra))
    return jax_cfg, port_cfg


def _lr_grid_cfgs():
    return compose(["exp=ppo_anakin_population", "algo.mlp_keys.encoder=[state]", *FAST]), apply_overrides(
        preset("ppo_anakin_population"), FAST)


@pytest.mark.parametrize("case", list(CASES))
def test_torch_population_resolve_matrix_matches_jax(case):
    extra, size, seed, env_id = CASES[case]
    jax_cfg, port_cfg = _lr_grid_cfgs() if case == "recipe-lr-grid" else _cfgs(extra)
    jenv = make_jax_env(env_id) if env_id else None
    penv = make_device_env(env_id) if env_id else None
    want = J.resolve_matrix(jax_cfg, size, seed, env=jenv)
    got = Q.resolve_matrix(port_cfg, size, seed, env=penv)
    assert got[1] == want[1] and got[3] == want[3]
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if case == "recipe-lr-grid":
        assert got[1] == ("lr",) and len(set(got[0]["lr"].tolist())) == 8


@pytest.mark.parametrize("case", ["grid-two-axes", "random-ranges", "const-broadcast"])
def test_torch_population_resolve_sweep_matches_jax(case):
    extra, size, seed, _ = CASES[case]
    jax_cfg, port_cfg = _cfgs(extra)
    want, w_swept = J.resolve_sweep(jax_cfg, size, seed=seed)
    got, g_swept = Q.resolve_sweep(port_cfg, size, seed=seed)
    assert g_swept == w_swept
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_torch_population_resolve_rejections_match_jax(case):
    extra, size, env_id, match = REJECTIONS[case]
    jax_cfg, port_cfg = _cfgs(extra)
    jenv = make_jax_env(env_id) if env_id not in (None, "none") else None
    penv = make_device_env(env_id) if env_id not in (None, "none") else None
    with pytest.raises(ValueError, match=match) as want:
        J.resolve_matrix(jax_cfg, size, 0, env=jenv)
    with pytest.raises(ValueError, match=match) as got:
        Q.resolve_matrix(port_cfg, size, 0, env=penv)
    if case not in ("no-env", "unknown-env"):  # those name the packages' own env kinds
        assert str(got.value) == str(want.value)


PBT_CASES = {
    "default": (["algo.population.pbt.enabled=true"], 8, ("lr",), ()),
    "off": ([], 8, (), ()),
    "frac": (["algo.population.pbt.enabled=true", "algo.population.pbt.truncation_frac=0.5",
              "algo.population.pbt.every_blocks=3", "algo.population.pbt.perturb_factors=[0.5, 2.0]"], 4, ("gamma",), ()),
    "env": (["algo.population.pbt.enabled=true", "algo.population.pbt.perturb_env_params=true",
             "algo.population.pbt.perturb=[lr, ent_coef]"], 4, ("lr",), ("length",)),
}


@pytest.mark.parametrize("case", list(PBT_CASES))
def test_torch_population_resolve_pbt_matches_jax(case):
    extra, size, swept, env_swept = PBT_CASES[case]
    jax_cfg, port_cfg = _cfgs(extra)
    want = J.resolve_pbt(jax_cfg, size, swept, env_swept)
    got = Q.resolve_pbt(port_cfg, size, swept, env_swept)
    assert got[1] == want[1]
    assert (got[0] is None) == (want[0] is None)
    if want[0] is not None:
        assert tuple(got[0]) == tuple(want[0])


@pytest.mark.parametrize("extra, size, match", [
    (["algo.population.pbt.enabled=true"], 1, "size >= 2"),
    (["algo.population.pbt.enabled=true", "algo.population.pbt.truncation_frac=0.7"], 8, "truncation_frac"),
    (["algo.population.pbt.enabled=true", "algo.population.pbt.perturb=[vf_coef]"], 8, "Unknown pbt.perturb"),
    (["algo.population.pbt.enabled=true", "algo.population.pbt.perturb_factors=[0.0, 2.0]"], 8, "positive"),
    (["algo.population.pbt.enabled=true", "algo.population.pbt.every_blocks=0"], 8, "every_blocks"),
], ids=["size", "frac", "perturb", "factors", "every"])
def test_torch_population_resolve_pbt_rejections_match_jax(extra, size, match):
    jax_cfg, port_cfg = _cfgs(extra)
    with pytest.raises(ValueError, match=match) as want:
        J.resolve_pbt(jax_cfg, size, ())
    with pytest.raises(ValueError, match=match) as got:
        Q.resolve_pbt(port_cfg, size, ())
    assert str(got.value) == str(want.value)
