"""The port's DreamerV3 loop on the device-resident sequence ring
(``run preset=dreamer_v3_100k_atari_dummy_resident``) on the CPU, at the tiny
widths of ``tests/test_torch_train_loop.py``.

- The preset is the host preset with the JAX ``buffer/default.yaml`` keys
  ``device_resident: true`` and ``hbm_budget_gb: 4.0`` and the exp's
  ``buffer.checkpoint: true``.
- A run past the dummy env's first episode end (seed 5) dispatches once per
  env step, flushes the reset row as a 2-row blob, takes the granted
  gradient steps (finite losses, one row per trained dispatch) and writes a
  checkpoint holding the ring.
- A resume restores the ring, its heads and its generator exactly and goes
  on training; the same checkpoint resumed with ``buffer.device_resident=
  false`` fills the host per-env buffers (``restore_host_env_buffer``) and
  trains from them at once.
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.config import preset
from sheeprl_tpu_torch.envs import make_vector_env
from sheeprl_tpu_torch.replay import DeviceReplayState
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_train_loop import TINY_RUN

RESIDENT = "preset=dreamer_v3_100k_atari_dummy_resident"
TINY = [RESIDENT] + TINY_RUN[1:] + ["buffer.size=512", "metric.log_every=64"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _first_episode_end(cfg) -> int:
    """The env step at which the preset's env (seed ``cfg.seed``) first
    finishes an episode: the dummy env's lives run out on a schedule that
    does not depend on the actions."""
    envs = make_vector_env(cfg, int(cfg.seed))
    envs.reset(seed=int(cfg.seed))
    for step in range(1, 2000):
        _, _, terminated, truncated, _ = envs.step(np.zeros((1, 1), np.int64))
        if terminated[0] or truncated[0]:
            return step
    raise AssertionError("no episode ended in 2000 steps")


def test_torch_rssm_resident_preset_is_the_host_preset_with_the_ring():
    host, resident = preset("dreamer_v3_100k_atari_dummy"), preset("dreamer_v3_100k_atari_dummy_resident")
    assert resident.buffer == {"size": 100000, "device_resident": True, "hbm_budget_gb": 4.0, "checkpoint": True}
    assert host.buffer.device_resident is False
    # the resident preset keeps the hybrid player off, as JAX's device-resident exps do
    assert resident.algo.pop("hybrid_player") == {"enabled": False, "train_every": 16, "snapshot_every": 4}
    assert host.algo.pop("hybrid_player") == {"enabled": "auto", "train_every": 16, "snapshot_every": 4}
    assert {k: v for k, v in resident.items() if k != "buffer"} == {k: v for k, v in host.items() if k != "buffer"}


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    end = _first_episode_end(preset("dreamer_v3_100k_atari_dummy_resident"))
    assert 300 < end < 450  # 3 lives of about 500 frames at frame-skip 4
    starts = end + 4
    log_root = tmp_path_factory.mktemp("resident")
    summary = cli.run(TINY + [f"log_root={log_root}", f"algo.learning_starts={starts}",
                              f"algo.total_steps={starts + 5}"])
    return {"summary": summary, "end": end, "starts": starts}


def test_torch_rssm_resident_loop_dispatches_and_trains(first_run):
    s, starts = first_run["summary"], first_run["starts"]
    assert s["resident"] and s["device"] == "cpu" and s["policy_steps"] == starts + 5
    assert s["gradient_steps"] == 6 and s["train_calls"] == 6 and len(s["metrics"]) == 6  # iterations starts..starts+5
    assert np.isfinite(np.asarray(s["metrics"])).all()
    replay = s["replay"]
    assert replay["Replay/flushes"] == s["policy_steps"] == len(s["dispatch_host_s"])
    assert replay["Replay/size"] - replay["Replay/flushes"] == 1  # one 2-row flush: the episode's reset row
    assert sum(n for _, n in s["dispatch_host_s"]) == 6
    state = load_checkpoint(s["checkpoint"])
    snap = DeviceReplayState.from_dict(state["rb"])
    assert snap.kind == "sequence" and snap.meta["capacity"] == 512
    assert int(snap.arrays["pos"][0]) == s["policy_steps"] + 1
    # the ring holds the episode's last frame and then the reset frame
    rgb = snap.arrays["storage/rgb"][:, 0]
    assert rgb[: s["policy_steps"] + 1].reshape(s["policy_steps"] + 1, -1).any(dim=1).all()
    assert float(snap.arrays["storage/is_first"][first_run["end"] + 1, 0]) == 1.0


def test_torch_rssm_resident_loop_resume_restores_the_ring(first_run, monkeypatch, tmp_path):
    """The resume's driver holds the checkpoint's ring, heads and generator,
    and the run goes on training on it."""
    s = first_run["summary"]
    saved = DeviceReplayState.from_dict(load_checkpoint(s["checkpoint"])["rb"])
    restored = {}

    class Recording(dv3.SequenceRingDriver):
        def load_state_dict(self, snap):
            super().load_state_dict(snap)
            restored.update(self.state_dict().arrays)
            return self

    monkeypatch.setattr(dv3, "SequenceRingDriver", Recording)
    resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "fabric.accelerator=cpu", "metric.log_level=0",
                       "algo.learning_starts=2", f"algo.total_steps={s['policy_steps'] + 6}", f"log_root={tmp_path}"])
    assert set(restored) == set(saved.arrays)
    for k, v in saved.arrays.items():
        assert torch.equal(restored[k], v), k
    assert resumed["resident"] and resumed["start_iter"] == s["policy_steps"] + 1
    assert resumed["gradient_steps"] > 0 and np.isfinite(np.asarray(resumed["metrics"])).all()


def test_torch_rssm_resident_checkpoint_resumes_on_the_host_tier(first_run, monkeypatch, tmp_path):
    """``buffer.device_resident=false`` on a ring checkpoint: the host per-env
    buffers take the ring's storage and heads, and the host path samples
    them from its first grant."""
    s = first_run["summary"]
    calls = []

    def spy(snap, rb, fill_missing=None):
        dv3_restore(snap, rb, fill_missing)
        calls.append((rb.buffer[0].pos, rb.buffer[0].full, sorted(rb.buffer[0].buffer)))

    dv3_restore = dv3.restore_host_env_buffer
    monkeypatch.setattr(dv3, "restore_host_env_buffer", spy)
    resumed = cli.run([f"checkpoint.resume_from={s['checkpoint']}", "fabric.accelerator=cpu", "metric.log_level=0",
                       "buffer.device_resident=false", "algo.learning_starts=1", f"algo.total_steps={s['policy_steps'] + 3}",
                       f"log_root={tmp_path}"])
    assert calls == [(s["policy_steps"] + 1, False, ["actions", "is_first", "rewards", "rgb", "terminated", "truncated"])]
    assert not resumed["resident"] and resumed["gradient_steps"] == len(resumed["metrics"]) > 0
    assert np.isfinite(np.asarray(resumed["metrics"])).all()
