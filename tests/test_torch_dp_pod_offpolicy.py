"""``run --pod 2`` for the off-policy families and DreamerV3 on the CPU, and
the loops' data-parallel checks.

- A ``dry_run=True`` pod of 2 workers (``fabric.accelerator=cpu``) of each
  new family: SAC on the host buffer and on the prioritized device ring, the
  dropout-Q ensemble SAC, the pixel SAC (multiplier 1) and DreamerV3 on the
  host buffer and on the device sequence ring (tiny widths). Each exits 0,
  both workers take the same gradient steps and reductions, and their
  parameters, and the prioritized rings, end bit-equal (``POD_WORKER``
  digests). The pods run three at a time.
- A global batch that the group's size does not divide raises JAX's
  ``ValueError`` text in every new family before any step.
"""

import importlib
import json
import os
import subprocess
import sys

import pytest

from sheeprl_tpu_torch import cli

RSSM_TINY = [
    "algo.per_rank_sequence_length=1", "algo.world_model.recurrent_model.recurrent_state_size=32",
    "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4", "algo.dense_units=16", "algo.mlp_layers=1",
]
PODS = {
    "sac_host": ["preset=sac"],
    "sac_per_ring": ["preset=sac_per"],
    "offpolicy_ensemble": ["preset=droq"],
    "pixel_sac": ["preset=sac_ae", "algo.encoder.cnn_channels_multiplier=1", "algo.decoder.cnn_channels_multiplier=1",
                  "algo.per_rank_batch_size=8"],
    "rssm_host": ["preset=dreamer_v3_100k_atari_dummy"] + RSSM_TINY,
    "rssm_ring": ["preset=dreamer_v3_100k_atari_dummy_resident"] + RSSM_TINY,
}
COMMON = ["fabric.accelerator=cpu", "dry_run=True", "metric.log_level=0", "algo.run_test=False",
          "buffer.memmap=False", "fabric.pod.tick_s=0.05"]


def _start(tmp, name):
    cmd = [sys.executable, "-m", "sheeprl_tpu_torch", "run", "--pod", "2", *PODS[name], *COMMON,
           f"log_root={tmp}/{name}"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("offpolicy_pods")
    names, out = list(PODS), {}
    for i in range(0, len(names), 3):
        batch = {name: _start(tmp, name) for name in names[i:i + 3]}
        for name, proc in batch.items():
            try:
                text, _ = proc.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
            out[name] = (proc.returncode, text)
    return out


def _workers(text):
    return sorted((json.loads(line[len("POD_WORKER "):]) for line in text.splitlines()
                   if line.startswith("POD_WORKER ")), key=lambda w: w["rank"])


@pytest.mark.parametrize("name", list(PODS))
def test_torch_dp_pod_offpolicy_dry_run_pod_ends_bit_equal(pods, name):
    rc, text = pods[name]
    assert rc == 0, text[-4000:]
    workers = _workers(text)
    assert [w["rank"] for w in workers] == [0, 1] and all(w["world_size"] == 2 for w in workers), text[-4000:]
    a, b = workers
    assert a["param_digest"] is not None and a["param_digest"] == b["param_digest"]
    assert a["gradient_steps"] == b["gradient_steps"] and a["gradient_steps"] and a["gradient_steps"] > 0
    assert a["reductions"] == b["reductions"] and a["reductions"]["calls"] > 0
    if name == "sac_per_ring":
        assert a["replay_digest"] is not None and a["replay_digest"] == b["replay_digest"]
    summary = json.loads(next(line for line in text.splitlines() if line.startswith("POD_SUMMARY "))[12:])
    assert summary["finished"] and summary["deaths"] == 0


BATCH_LINES = {
    "sac": (["preset=sac"], "sheeprl_tpu_torch.algos.sac.sac"),
    "offpolicy_ensemble": (["preset=droq"], "sheeprl_tpu_torch.algos.droq.droq"),
    "pixel_sac": (["preset=sac_ae"], "sheeprl_tpu_torch.algos.sac_ae.sac_ae"),
    "rssm": (["preset=dreamer_v3_100k_atari_dummy"], "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3"),
}


@pytest.mark.parametrize("family", list(BATCH_LINES))
def test_torch_dp_pod_offpolicy_batch_not_divisible_raises_jax_s_error(monkeypatch, tmp_path, family):
    line, module_name = BATCH_LINES[family]
    module = importlib.import_module(module_name)
    monkeypatch.setattr(module, "world_size", lambda: 2)
    with pytest.raises(ValueError, match=r"^per_rank_batch_size \(5\) must be divisible by the number of devices \(2\)$"):
        cli.run(line + ["fabric.accelerator=cpu", "dry_run=True", "metric.log_level=0", "algo.per_rank_batch_size=5",
                        "buffer.memmap=False", f"log_root={tmp_path}"])
