"""``metric.profiler`` (``sheeprl_tpu_torch/utils/profiler.py``) against the
JAX package's ``TraceProfiler``, on the CPU.

- The tick state machine: for the same configuration and tick sequence
  (every iteration, blocks of iterations, a window still open at the end)
  the port's trace is open at exactly the ticks JAX's is (both profilers'
  start and stop recorded instead of run), and ``close`` stops an open one.
- The loops: a PPO run with ``metric.profiler.enabled=true`` writes one
  Chrome trace under ``<log_dir>/profiler`` holding the window's CPU events;
  the same run without it writes nothing there; the Anakin loop and
  DreamerV3's host loop write theirs too.
"""

import json
import os

import pytest

from sheeprl_tpu.utils.profiler import TraceProfiler as JaxTraceProfiler
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import RUN_DEFAULTS
from sheeprl_tpu_torch.utils.profiler import TraceProfiler

TICKS = {
    "every_iteration": list(range(1, 21)),
    "blocks_of_nine": [1, 10, 19, 28, 37],
    "open_at_the_end": list(range(1, 10)),
    "resumed_late": list(range(30, 36)),
}


@pytest.mark.parametrize("ticks", list(TICKS), ids=list(TICKS))
@pytest.mark.parametrize("window", [(8, 4), (1, 2), (9, 1)], ids=["default", "first", "one"])
def test_torch_profiler_window_matches_jax(tmp_path, monkeypatch, ticks, window):
    import jax
    import torch.profiler

    class Recorded:
        """``torch.profiler.profile``'s start, stop and export, recorded."""

        def __init__(self, activities):
            self.activities = activities

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": []}, f)

    monkeypatch.setattr(jax.profiler, "start_trace", lambda *a, **k: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda *a, **k: None)
    monkeypatch.setattr(torch.profiler, "profile", Recorded)
    cfg = {"enabled": True, "start_iter": window[0], "num_iters": window[1]}
    jax_prof = JaxTraceProfiler(cfg, str(tmp_path / "jax"))
    port = TraceProfiler(cfg, str(tmp_path / "port"))
    jax_open, port_open = [], []
    for t in TICKS[ticks]:
        jax_prof.tick(t)
        port.tick(t)
        jax_open.append(jax_prof._active)
        port_open.append(port._prof is not None)
    assert port_open == jax_open and any(port_open)
    jax_prof.close()
    port.close()
    assert not jax_prof._active and port._prof is None and port.window is not None
    assert port.window[0] == TICKS[ticks][port_open.index(True)]
    assert os.path.isfile(port.trace_path)


def test_torch_profiler_disabled_does_nothing(tmp_path):
    port = TraceProfiler({"enabled": False, "start_iter": 1, "num_iters": 1}, str(tmp_path))
    for t in range(1, 5):
        port.tick(t)
    port.close()
    assert port.window is None and port.trace_path is None and not os.path.exists(tmp_path / "profiler")


def test_torch_profiler_is_a_run_default():
    assert RUN_DEFAULTS["metric"]["profiler"] == {"enabled": False, "start_iter": 8, "num_iters": 4}


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


# the recipe cut to 3 short iterations: a profiled iteration of the full one is ~40 MB of CPU events
PPO = ["preset=ppo", "fabric.accelerator=cpu", "algo.rollout_steps=16", "algo.update_epochs=1", "buffer.size=16",
       "algo.per_rank_batch_size=16", "algo.total_steps=192", "metric.log_level=0", "algo.run_test=false"]


def test_torch_profiler_ppo_run_writes_its_window(tmp_path):
    s = cli.run(PPO + ["metric.profiler.enabled=true", "metric.profiler.start_iter=2", "metric.profiler.num_iters=1",
                       f"log_root={tmp_path}"])
    assert s["profiler"] == os.path.join(s["log_dir"], "profiler", "trace_2_3.json")
    names = {e.get("name") for e in _events(s["profiler"])}
    assert any(n and n.startswith("aten::") for n in names)  # the window's CPU operator events
    plain = cli.run(PPO + [f"log_root={tmp_path / 'plain'}"])
    assert plain["profiler"] is None and not os.path.exists(os.path.join(plain["log_dir"], "profiler"))


def test_torch_profiler_anakin_and_rssm_runs_write_their_windows(tmp_path):
    from tests.test_torch_train_loop import TINY_RUN

    s = cli.run(["preset=ppo_anakin", "fabric.accelerator=cpu", "algo.rollout_steps=16", "algo.update_epochs=1",
                 "algo.per_rank_batch_size=16", "algo.total_steps=256", "algo.iters_per_block=1", "metric.log_level=0",
                 "algo.run_test=false", "metric.profiler.enabled=true", "metric.profiler.start_iter=2",
                 "metric.profiler.num_iters=1", f"log_root={tmp_path}"])
    assert s["profiler"] is not None and s["profiler"].endswith("trace_2_3.json") and os.path.isfile(s["profiler"])
    r = cli.run(TINY_RUN + ["algo.total_steps=12", "algo.learning_starts=8", "algo.run_test=false",
                            "metric.profiler.enabled=true", "metric.profiler.start_iter=9",
                            "metric.profiler.num_iters=2", f"log_root={tmp_path / 'rssm'}"])
    assert r["profiler"].endswith("trace_9_11.json") and os.path.isfile(r["profiler"])
