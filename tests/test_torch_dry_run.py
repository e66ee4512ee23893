"""``dry_run=true`` in every ported loop whose JAX twin reads ``cfg.dry_run``:
one iteration (``total_iters`` 1), no warm-up (``learning_starts`` 0) and
the JAX loops' smallest buffers (DreamerV3 and P2E exploration 2 rows per
env, P2E finetuning 4, SAC, DroQ and SAC-AE 1), on the CPU at small widths:
the run takes exactly one iteration's policy steps, trains in it (an
update, or the gradient steps the ratio grants), and writes its
checkpoint. ``dry_run`` defaults to false in ``RUN_DEFAULTS``, as in JAX's
``config.yaml``."""

import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import RUN_DEFAULTS
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_train_loop import TINY_RUN

COMMON = ["fabric.accelerator=cpu", "metric.log_level=0", "dry_run=true", "checkpoint.save_last=true",
          "checkpoint.every=0"]
SAC_WIDTHS = ["algo.hidden_size=32", "algo.actor.hidden_size=32", "algo.critic.hidden_size=32",
              "algo.per_rank_batch_size=8", "env.num_envs=2"]
RSSM_WIDTHS = [o for o in TINY_RUN[2:] if not o.startswith(("buffer.", "checkpoint.", "algo.learning_starts"))] + [
    "algo.per_rank_sequence_length=1", "algo.run_test=false"]
EXPLORE_WIDTHS = RSSM_WIDTHS + ["algo.ensembles.n=2", "algo.ensembles.mlp_layers=1", "algo.ensembles.dense_units=8",
                                "env.num_envs=2"]

#: id -> (preset, overrides, policy steps of the one iteration, whether it must take gradient steps)
FAMILIES = {
    "ppo": ("ppo", ["algo.rollout_steps=16", "buffer.size=16"], 16 * 4, False),
    "a2c": ("a2c", [], 5 * 4, False),
    "ppo_recurrent": ("ppo_recurrent", ["env.num_envs=2", "algo.rollout_steps=16", "algo.per_rank_sequence_length=8",
                                        "algo.per_rank_num_batches=2", "algo.update_epochs=1"], 16 * 2, False),
    "rssm": ("dreamer_v3_100k_atari_dummy", RSSM_WIDTHS, 1, True),
    "sac": ("sac", SAC_WIDTHS, 2, True),
    "q_dropout": ("droq", SAC_WIDTHS, 2, True),
    "pixel_autoencoder": ("sac_ae", SAC_WIDTHS + [
        "algo.cnn_channels_multiplier=1", "algo.encoder.cnn_channels_multiplier=1",
        "algo.decoder.cnn_channels_multiplier=1", "algo.encoder.features_dim=16", "buffer.memmap=false"], 2, True),
    "explore": ("p2e_dv3_exploration_atari_dummy", EXPLORE_WIDTHS, 2, True),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_torch_dry_run_defaults_to_false_as_in_jax():
    assert RUN_DEFAULTS["dry_run"] is False
    assert compose(["exp=ppo"]).dry_run is False


@pytest.mark.parametrize("family", list(FAMILIES))
def test_torch_dry_run_takes_one_iteration(tmp_path, family):
    name, overrides, policy_steps, trains = FAMILIES[family]
    s = cli.run([f"preset={name}", f"log_root={tmp_path}", "algo.total_steps=100000", "algo.learning_starts=64000"]
                + COMMON + overrides)
    assert s["device"] == "cpu" and s["policy_steps"] == policy_steps
    if trains:
        assert s["gradient_steps"] >= 1
    state = load_checkpoint(s["checkpoint"])
    assert int(state.get("iter_num", state.get("update", 1))) == 1
    losses = s.get("metrics") or s.get("losses") or []
    assert np.isfinite(np.asarray(losses, dtype=np.float64)).all()


def test_torch_dry_run_finetuning_after_an_exploration_dry_run(tmp_path):
    name, overrides, _, _ = FAMILIES["explore"]
    explored = cli.run([f"preset={name}", f"log_root={tmp_path}"] + COMMON + overrides)
    s = cli.run(["preset=p2e_dv3_finetuning_atari_dummy", f"log_root={tmp_path}",
                 f"checkpoint.exploration_ckpt_path={explored['checkpoint']}"] + COMMON + overrides)
    assert s["policy_steps"] == 2 and s["gradient_steps"] >= 1 and s["switched_at"] == 2
    assert int(load_checkpoint(s["checkpoint"])["iter_num"]) == 1
