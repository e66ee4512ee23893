"""``BurstRunner.flush`` on a ring built without ``is_first`` (Dreamer V1's
and Plan2Explore-on-V1's rows have none: four keys and the pixels) against
the JAX package's runner, on the CPU.

The same staged steps, ragged reset rows and grants go through JAX's runner
(its burst function stubbed to record the jobs) and the port's: each
flush's blob holds the same bytes, segment by segment (JAX's ``__key__``
excepted: the port's draws come from the ring's generator), the same
granted chunk and heads; then each side's burst program (a stub gradient
step) appends its blobs to a ring of the four keys and the pixels, and the
rings are equal bit for bit (tolerance 0) after every flush.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sheeprl_tpu.data.ring import build_burst_train_step as jax_build_burst
from sheeprl_tpu.data.ring import make_blob_layouts as jax_make_blob_layouts
from sheeprl_tpu.parallel.fabric import Fabric
from sheeprl_tpu.utils.burst import BurstRunner as JaxBurstRunner
from sheeprl_tpu.utils.burst import dreamer_ring_keys as jax_dreamer_ring_keys
from sheeprl_tpu_torch.data.ring import build_burst_train_step
from sheeprl_tpu_torch.utils.burst import BurstRunner, dreamer_ring_keys, dreamer_stage_sizes

CAP, E, T, B, TRAIN_EVERY = 24, 2, 4, 2, 3
GRAD_CHUNK = E * TRAIN_EVERY
OBS = {"rgb": {"shape": [3, 2, 2]}, "state": {"shape": [3]}}


def _step(rng):
    return {"rgb": rng.integers(0, 256, (1, E, 3, 2, 2)).astype(np.uint8),
            "state": rng.normal(size=(1, E, 3)).astype(np.float32),
            "actions": rng.normal(size=(1, E, 2)).astype(np.float32),
            "rewards": rng.normal(size=(1, E, 1)).astype(np.float32),
            "terminated": (rng.random((1, E, 1)) < 0.1).astype(np.float32),
            "truncated": np.zeros((1, E, 1), np.float32)}


def test_torch_hybrid_flush_v1_four_key_ring_matches_jax():
    keys = dreamer_ring_keys(OBS, ["rgb"], ["state"], (2,), with_is_first=False)
    jax_keys = jax_dreamer_ring_keys({"rgb": type("S", (), {"shape": (3, 2, 2)})(),
                                      "state": type("S", (), {"shape": (3,)})()}, ["rgb"], ["state"], (2,),
                                     with_is_first=False)
    assert list(keys) == list(jax_keys) == ["rgb", "state", "actions", "rewards", "terminated"]
    stage_max, buckets = dreamer_stage_sizes(TRAIN_EVERY, E, CAP)
    layouts = jax_make_blob_layouts(keys, E, GRAD_CHUNK, (*buckets, stage_max))
    jax_blobs, port_blobs = [], []
    jax_runner = JaxBurstRunner(lambda c, rb, blob: (jax_blobs.append(np.asarray(blob).copy()), (c, rb, None))[1], 0,
                                {}, keys, n_envs=E, capacity=CAP, grad_chunk=GRAD_CHUNK, stage_max=stage_max,
                                seq_len=T, stage_buckets=buckets, blob_layouts=layouts, supervisor_cfg={"backoff": 0})
    port_runner = BurstRunner(lambda c, rb, blob, gen=None: (port_blobs.append(blob.clone()), (c, rb, None))[1], 0,
                              {}, keys, n_envs=E, capacity=CAP, grad_chunk=GRAD_CHUNK, stage_max=stage_max,
                              seq_len=T, stage_buckets=buckets, supervisor_cfg={"backoff": 0})
    rng, key, backlog, chunks = np.random.default_rng(5), jax.random.PRNGKey(1), 0, []
    try:
        for it in range(40):
            step = _step(rng)
            jax_runner.stage_step(step)
            port_runner.stage_step(step)
            if rng.random() < 0.3:  # V1's reset rows: zero action and reward, no is_first
                done = sorted(rng.choice(E, size=int(rng.integers(1, E + 1)), replace=False).tolist())
                reset = {k: v[:, done] for k, v in _step(rng).items()}
                jax_runner.stage_reset(reset, done)
                port_runner.stage_reset(reset, done)
            backlog += 2 * GRAD_CHUNK if it == 1 else int(rng.integers(0, 2 * E)) if it > 1 else 0
            while backlog >= GRAD_CHUNK or port_runner.staging_full():
                key, sub = jax.random.split(key)
                got, want = port_runner.flush(backlog), jax_runner.flush(sub, backlog)
                assert got == want
                np.testing.assert_array_equal(port_runner.dev_pos, jax_runner.dev_pos)
                np.testing.assert_array_equal(port_runner.dev_valid, jax_runner.dev_valid)
                chunks.append(got)
                backlog -= got
                if got == 0 or backlog < GRAD_CHUNK:
                    break
    finally:
        jax_runner.close()
        port_runner.close()
    assert len(chunks) >= 5 and chunks[0] == 0 and GRAD_CHUNK in chunks and (port_runner.dev_valid == CAP).all()

    for jblob, pblob in zip(jax_blobs, port_blobs):  # the bytes, segment by segment
        jl = next(lay for lay in layouts.values() if lay.nbytes == jblob.size)
        pl = next(lay for lay in port_runner._layouts.values() if lay.nbytes == pblob.numel())
        jseg = {n: (off, int(np.prod(shape)) * np.dtype(dt).itemsize) for n, off, shape, dt in jl.segments}
        pseg = {n: (off, int(np.prod(shape)) * np.dtype(dt).itemsize) for n, off, shape, dt in pl.segments}
        assert set(jseg) - set(pseg) == {"__key__"} and "is_first" not in pseg
        for name, (off, n) in pseg.items():
            np.testing.assert_array_equal(pblob.numpy()[off:off + n], jblob[jseg[name][0]:jseg[name][0] + n],
                                          err_msg=name)

    spec = {"capacity": CAP, "n_envs": E, "grad_chunk": GRAD_CHUNK, "seq_len": T, "batch_size": B,
            "ring_keys": keys, "stage_buckets": tuple(sorted(set(buckets) | {stage_max})), "stage_max": stage_max}
    jax_burst = jax_build_burst(lambda c, xs: (c, (jnp.float32(0),)), Fabric(devices=1, accelerator="cpu").mesh, spec)
    port_burst = build_burst_train_step(lambda c, xs: (c, torch.zeros(1)), spec, lambda g: None)
    jax_rb = {k: jnp.zeros((CAP, E) + shape, dtype) for k, (shape, dtype) in keys.items()}
    port_rb = {k: torch.from_numpy(np.zeros((CAP, E) + shape, dtype)) for k, (shape, dtype) in keys.items()}
    gen = torch.Generator().manual_seed(0)
    for jblob, pblob in zip(jax_blobs, port_blobs):
        _, jax_rb, _ = jax_burst(jnp.int32(0), jax_rb, jnp.asarray(jblob))
        _, port_rb, _ = port_burst(0, port_rb, pblob, gen)
        for k in keys:
            np.testing.assert_array_equal(port_rb[k].numpy(), np.asarray(jax_rb[k]), err_msg=k)
