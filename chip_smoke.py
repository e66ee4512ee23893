#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``sheeprl_tpu_torch``) on one
NVIDIA Hopper GPU. Run from the root of a checkout::

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints no
result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel under ``sheeprl_tpu_torch/csrc`` with ``nvcc``, one
   process per source, all at once, and beside them the script's own L2
   pointer chase and empty kernel; the empty kernel's graph-replayed time is
   the floor of one launch (``floor_ms`` in every kernel's row);
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the shapes the serving and training paths give it, timed with
   CUDA events around CUDA-graph replays; ``gru_gates`` both alone and as
   ``gru_gates_ln``, the GRU projection's LayerNorm fused in (every RSSM
   step's entry), beside the pair of calls it replaces
   (``F.layer_norm``, then the gates kernel); ``gae`` bit-equal at every
   shape and dtype; the two-hot loss over raw logits with the
   log-normalisation fused in (``two_hot_symlog_loss_lse``) and its backward
   kernel at every case of TWO_HOT_LSE_CASES (f32 and bf16, 1 to 15,360
   rows, misaligned bases, every special target); ``gru_gates_ln``'s bf16
   entry (a bf16 projection, the float32 affine, the normalised projection
   rounded to bf16 before the gates; over a bf16 or a float32 carry) at
   GRU_BF16_SHAPES, bit-equal shares and worst ulps reported; beside the pair of calls
   the forward replaces and the unfused path's backward; the two-hot
   kernels', ``gru_gates_ln``'s and ``gae``'s
   gradients against the plain chain's;
4. model: the DreamerV3-S session step on the card against the same weights
   on the CPU, TF32 off, on one small batch;
5. step: one engine dispatch per bucket timed on the host clock, the device
   time inside it from ``torch.profiler``, and the host cost of one frame's
   JSON round trip;
6. train step: one DreamerV3-S gradient step (full width, batch 4 x
   sequence 16, horizon 15) on the card against the same step on the CPU:
   same seeded weights, batch and injected noise, TF32 off;
7. run: ``python -m sheeprl_tpu_torch run preset=dreamer_v3_100k_atari_dummy``'s
   entry point on the card at the full recipe (batch 16 x sequence 64,
   horizon 15, 255 bins) with ``learning_starts`` 128, for 9 gradient
   steps, ending in a checkpoint and the end-of-run test episode
   (``algo.run_test``, one GRU step per episode step); the launch counters
   are zeroed just before and checked against the path's exact counts just
   after; the
   checkpoint holds the host replay buffer, and a resume of 4 steps must
   start with it (rows, heads, generators) and train with the path's
   counts; then one gradient step from that checkpoint under
   ``torch.profiler``, whose forward must hold no LayerNorm of the GRU
   projection (the cell fuses it into ``gru_gates_ln``) and which must hold
   no op of the unfused two-hot chain (255-wide logsumexps, the plain
   loss's bracket comparisons);
8. serve: the run's checkpoint (Atari-protocol shape: 64x64x3 pixels, 18
   actions, full width) through the port's ``serve`` entry point on an
   ephemeral socket: 8 concurrent sessions x 16 steps, one client reset, a
   health probe, one session replayed alone; the launch counters are
   zeroed just before and read just after;
9. PPO update: one full-recipe PPO update (512 rows, 10 epochs x 8
   minibatches of 64) on the card against the same update on the CPU, TF32
   off, with the CartPole MLP agent and with the NatureCNN agent on 64x64x3
   pixels and 18 actions; then each of its 80 steps from the card's state
   just before it: losses, gradients (with the ReLU and clip kinks crossed
   on one machine counted) and the Adam step on the card's gradients;
10. PPO run: ``python -m sheeprl_tpu_torch run preset=ppo``'s entry point on
   the card at the full recipe's widths (CartPole-v1, 4 envs x 128 steps),
   its depth cut to PPO_ITERATIONS iterations, the launch counters zeroed just before and checked just after
   (``gae`` once per iteration, no DreamerV3 kernel), a learning check on
   the last episodes' returns, a resume for one more iteration from its
   checkpoint, and one update under ``torch.profiler``;
11. sumtree: ``sumtree_sample`` against its plain version on the card at
   trees of 2^6 to 2^22 leaves and 1 to 4096 draws (zero leaves, padding,
   uniforms of 0 and just under 1), timed as the other kernels are, beside
   its bound: the bytes, or the fewest dependent L2 hits a descent needs
   (``sumtree_bound``), whose latency a pointer chase measures on the card;
   and a sweep of the kernel's levels per dependent read, k in
   SUMTREE_HOP_SWEEP, at the SAC shape, each checked as above;
12. SAC update: one device-resident dispatch at the full ``sac_per`` width
   (append + 4 PER gradient steps, hidden 256, batch 256, a ring of
   250,000 x 4) on the card against the CPU, each step from the card's
   state just before it;
13. SAC run: ``python -m sheeprl_tpu_torch run preset=sac_per``'s entry point
   on the card at full width (Pendulum-v1, 4 envs, a 1,000,000-transition
   ring with PER), ``total_steps`` cut to 16,384; the launch counters zeroed
   just before and checked just after (``sumtree_sample`` once per gradient
   step, no other kernel), a learning check, a resume from its checkpoint
   that must restore the ring, the sum-tree and ``max_p``, and one dispatch
   under ``torch.profiler``;
14. ring scatter: ``ragged_ring_scatter`` against its plain version on the
   card, bit for bit, at uint8 and f32, slots of 1 to 12,288 elements, 1-2
   staged rows, 1 and 4 envs, column offsets, dropped slots, heads that
   wrap and misaligned staged rows, each case also through
   ``ragged_ring_scatter_keys`` with 1, 2 and 5 keys in one launch; then the
   main path's 5 ring keys (the 100,000-row 64x64x3 frame ring and its
   action and scalar rings) from a packed upload, one launch timed as the
   other kernels are beside the 5 per-key launches it replaces and its
   bytes bound; the async ring's append (``dreamer_sebulba``: 16 staged
   rows x 4 envs into a 12,500-row x 8-column ring at col_offset 4) timed
   the same way; the gradients against the plain scatter's;
15. resident dispatch: one device-resident DreamerV3-S dispatch (full width,
   B 4 x T 16, a 2-env ring with a dropped slot) on the card against the
   CPU: the ring and the windows bit-equal, losses and parameters as in 6;
   one scatter launch for the 5 ring keys;
16. resident run: ``python -m sheeprl_tpu_torch run
   preset=dreamer_v3_100k_atari_dummy_resident``'s entry point on the card
   at the full recipe with the full 100,000-row ring in card memory,
   ``learning_starts`` past the env's first episode end (a 2-row flush),
   then 9 gradient steps and the test episode; the launch counters zeroed
   just before and checked just after (one scatter per flush, the two-hot
   and GRU counts of 7); a resume that must restore the ring, its heads and
   its generator; append-only and training dispatches under
   ``torch.profiler``;
17. DreamerV3 evaluation: ``evaluation`` of the run's checkpoint (7), one
   greedy episode on the card, ``gru_gates`` launched exactly once per step
   at the (1, 1536) projection; then one session served over the socket,
   fed the episode's frames, must give its actions step by step;
18. PPO stateless serving: ``serve`` of the PPO run's checkpoint (10)
   through the bucket engine (buckets 1, 8, 32, 128): 8 concurrent clients
   x 16 requests of 1-4 raw rows, then one of 200 rows chunked through
   bucket 128; each served row equal to the card's greedy program on that
   row alone, the 200 rows to their unchunked call, the engine's counts to
   a log of every dispatch, no repo kernel launched; client p50/p99,
   requests/s, dispatches/s, and one bucket-8 dispatch's host and device
   time (``torch.profiler``); then PPO ``evaluation`` on the card: one
   greedy CartPole episode at or above PPO_RETURN_BAR;
19. SAC stateless serving and evaluation: the same on the SAC run's
   checkpoint (13), rows within SAC_ROW_ATOL, the greedy Pendulum return
   at or above SAC_RETURN_BAR;
20. fault: the fault runtime on the card. PPO through ``run`` with
   ``fault.inject.nan_grads_at``: the poisoned iteration's 80 minibatches
   skipped and its checkpoint bit-equal to the previous one; a rollback
   (``max_consecutive=1``) restoring the latest complete checkpoint
   exactly; ``checkpoint.resume_from=latest`` publishing into a run directory of its own;
   ``action=abort`` raising ``DivergenceError``. One SAC-PER resident
   dispatch whose drawn rows carry NaN rewards, and one DreamerV3 host-tier
   gradient step on NaN rewards: every parameter, Adam state (step counts
   on the card), the sum-tree, ``max_p`` and ``Moments`` bit-equal to
   before, the kernels at their exact counts. Beside it, phases 7 and 10
   profile the guarded step and update next to the unguarded ones, phase 13
   the guarded dispatch (the loop's default), and phase 16 saves the ring's checkpoint through the manager, synchronously
   and asynchronously (host ms, write and sha256 seconds, bytes);
21. non-finite inputs (run beside the kernels of 3): each kernel of the
   guarded paths (``gru_gates_ln``, the fused two-hot loss and its backward,
   the decode, ``gae``, ``sumtree_sample``, ``ragged_ring_scatter_keys``) on
   inputs seeded with NaN, +inf and -inf at the main path's shapes gives
   non-finite outputs exactly where its plain version does; the fused loss
   is held to the JAX Pallas kernel's form, which picks the bracket's two
   bins, so a -inf logit outside the bracket leaves its row finite;
22. run directories: three ``run preset=ppo`` runs of one seed and one
   ``run_name`` into one ``log_root`` (6 iterations, a save every 2,
   ``keep_last`` 2): each in its own ``version_N``, keeping its own newest 2
   saves and leaving the others' ``config.json`` as written; the second
   run's planted NaN rolls back to its own checkpoint; the third resumes from
   the first run's older step, and ``resume_from=latest`` then names its
   save; the first run's ``metrics.jsonl`` holds the JAX loop's keys at the
   JAX loop's steps; ``Time/sps_*`` and host ms per iteration at
   ``metric.log_level`` 1 and 0 (``gae`` once per iteration);
23. memmap: DreamerV3-S host runs (full width, 3 gradient steps) with
   ``buffer.memmap`` on and off: the first gradient step's losses bit-equal,
   the buffer's files under ``<log_dir>/memmap_buffer/rank_0/env_0``, a
   resume that restores the buffer equal to the saved one into files of its
   own run, host ms per env step and per batch draw both ways (the path's
   GRU and two-hot counts, as in 7);
24. hot swap: ``serve`` of a PPO checkpoint with ``serve.watch=true`` while
   the run that wrote it trains on, publishing a save per iteration, and 8
   clients send requests: versions only go up per client, every answer equals
   the greedy program of the save its version came from, a rotted save is
   quarantined while serving goes on; the publish-to-first-served latency;
25. A2C update: 8 full-width A2C updates (20 rows, 4 minibatches of 5, the
   gradients summed, clip 0.5, RMSprop) on the card, each against the CPU
   from the card's state just before it: losses, the summed gradient, and
   the RMSprop step on the card's own gradient;
26. A2C run: ``run preset=a2c``, the whole JAX recipe (25,000 steps, 4 envs
   x 5 steps, 1,250 iterations): ``gae`` exactly once per iteration and no
   other kernel, a learning floor, a two-iteration resume, ``evaluation``
   of the checkpoint equal to the run's test episode, one update profiled;
27. recurrent PPO run: ``run preset=ppo_recurrent`` at full width (16 envs x
   512 steps, LSTM 64), cut to RECURRENT_ITERATIONS iterations: exact
   ``gae`` launches, a learning floor, a one-iteration resume, one update
   profiled (the cuDNN LSTM's share of the device time);
28. recurrent PPO update: the run's first recorded rollout chunked and
   bucketed, 8 epochs x 8 minibatches, every minibatch step on the card
   against the CPU from the card's state just before it;
29. recurrent PPO serving: ``evaluation`` of the run's checkpoint, then 8
   concurrent sessions over the socket (a batched row equal to the row
   alone), then one session fed the evaluation episode's observations gives
   its actions step by step; client p50/p99 and requests/s;
30. continuous PPO: ``run preset=ppo env.id=Pendulum-v1`` for
   CONTINUOUS_ITERATIONS full-width iterations (exact ``gae`` launches),
   one update on the card against the CPU, stateless serving (8 clients x
   16 requests of 1-4 rows) and ``evaluation``;
31. continuous DreamerV3 step: one continuous DreamerV3-S gradient step
   (full width, B 4 x T 16, H 15; the actor's gradient through the imagined
   RSSM steps and the reward and critic decodes) on the card against the
   CPU at the recipe's ``bf16-mixed``, coupled and with ``decoupled_rssm``
   (losses and each gradient's cosine, held beside the CPU's own bfloat16
   distance from its float32 step), and coupled at
   ``32-true`` (losses, the three modules' gradients and parameters); then
   ``gru_gates_ln``'s and the decode's backward (the plain chains) at the
   recipe's own shapes;
32. continuous DreamerV3 run: ``run preset=dreamer_v3_continuous_dummy``
   (the walker-walk recipe on the continuous dummy env, at its
   ``bf16-mixed``: every RSSM step through ``gru_gates_ln``'s bf16 entry) on
   the host buffer cut to CONTINUOUS_HOST_BUFFER rows, a few gradient steps
   with exact launch counts, finite losses, the test episode, a resume, and
   one gradient step profiled at ``bf16-mixed`` and at ``32-true`` with the
   two plain backward chains' device ms and operations;
33. sessions: the run's checkpoint served to 8 continuous sessions x 16
   steps (a row alone equals its batched row within SOLO_ATOL_F32; in
   bfloat16 its first step within SOLO_ATOL_BF16, the rest reported), then
   a session in sample mode replaying the run's test episode exactly;
34. decoupled ring run: the preset with ``decoupled_rssm`` on the device
   ring (cut to CONTINUOUS_RING_BUFFER rows; the recipe's ring bytes
   reported), exact launch counts with one scatter per flush, a resume;
35. DroQ: one train call card vs CPU on the same dropout masks and draws,
   then ``run preset=droq``, a resume and ``evaluation``, no kernel;
36. SAC-AE: one 2-step train call card vs CPU at full width (batch 2),
   then ``run preset=sac_ae`` at batch 128, a resume and ``evaluation``, no
   kernel;
37. SAC with ``buffer.sample_next_obs``: a short host-buffer run, no next
   observation stored, no kernel.
38. P2E exploration step: one Plan2Explore-DV3 exploration gradient step
   (full width, B 4 x T 16, H 15, 8 ensemble members) on the card against
   the CPU: the fifteen metrics (the intrinsic reward among them), the eight
   optimizers' gradients, every module's parameters;
39. P2E exploration run: ``run preset=p2e_dv3_exploration_atari_dummy`` on
   1 env, ``learning_starts`` 128 and 6 gradient steps, each T + 2H
   ``gru_gates_ln``, 7 fused two-hot losses and backwards and 8 decodes,
   exactly; a resume from its buffer; ``evaluation`` equal to the run's test
   episode; one full-recipe step profiled (host, device, operations, each
   kernel's share and the ensembles');
40. P2E finetuning: ``run preset=p2e_dv3_finetuning_atari_dummy`` from the
   exploration's checkpoint and buffer, the player switched to the task
   actor at the first granted step, DreamerV3's exact counts, and
   ``evaluation``; the continuous DreamerV3 run (32) asserts its repaired
   65-step episode (action repeat 2);
41. classic control and dry runs: PPO for 4 iterations on Acrobot-v1 and on
   MountainCar-v0 (``gae`` once per iteration) and their evaluations; one
   ``dry_run=true`` per ported family at recipe width with its exact counts.
42. Dreamer V2 step: one gradient step at the V2 recipe's widths (recurrent
   600, dense 400 x 4, CNN multiplier 48; B 4 x T 16, H 15) on the card
   against the CPU, for the discrete actor and for a ``trunc_normal`` actor
   at ``objective_mix`` 0 (the gradient through the imagined RSSM steps):
   the ten metrics, each AdamW's gradient and the parameters after it; the
   card's AdamW fused and capturable (phase 3 also holds ``gru_gates_ln`` at
   H 600 and 400, B 1, 16 and 800, and bf16 (800, 600), forward and gradient);
43. Dreamer V2 run: ``run preset=dreamer_v2_atari_dummy`` (the sequential
   buffer) on 1 env, ``learning_starts`` 128 and 6 gradient steps, T + H
   ``gru_gates_ln`` a step and one per player and test step, exactly; a
   resume from exactly the saved buffer and gradient-step count;
   ``evaluation`` equal to the run's greedy test episode; one full-recipe
   step profiled (host, device, operations, the GRU's and the convolutions'
   shares);
44. the episode buffer: ``run preset=dreamer_v2_ms_pacman_dummy``
   (``prioritize_ends``, the continue head, B 32) past the first episode's
   end, 3 gradient steps, and a resume whose ``EpisodeBuffer`` is the saved
   one;
45. Plan2Explore on Dreamer V2: ``run preset=p2e_dv2_exploration_atari_dummy``
   (recurrent 400, 10 members) for 4 steps at T + 2H ``gru_gates_ln`` each,
   one step profiled with the ensembles' share; the finetuning hand-off from
   its checkpoint and buffer (the task actor from the first granted step, T
   + H a step); ``evaluation`` of both checkpoints.
46. Dreamer V1 step: one gradient step at the full V1 recipe (B 50 x T 50,
   H 15; stochastic 30, recurrent 200, dense 400 x 4, CNN multiplier 32) on
   the card against the CPU: the ten metrics, each Adam's gradient (the
   actor's by dynamics backpropagation through the imagined RSSM steps) and
   the parameters after it, no kernel launched; then the step profiled
   (host, device, operations, the convolutions' and the flax-form GRU's
   recurrent model's shares);
47. Dreamer V1 run: ``run preset=dreamer_v1_atari_dummy`` on 1 env,
   ``learning_starts`` 128 and 3 gradient steps, the player's epsilon
   exploration, no kernel launched; a resume from exactly the saved buffer;
   ``evaluation`` equal to the run's test episode; a ``dry_run``;
48. Plan2Explore on Dreamer V1: ``run preset=p2e_dv1_exploration_atari_dummy``
   (recurrent 400, 10 members regressing the next embedded observation) for
   3 steps, one step profiled with the ensembles' share; the finetuning
   hand-off from its checkpoint and buffer; ``evaluation`` of both
   checkpoints; no kernel launched on any of these paths.
49. Anakin iteration: one full-recipe ``ppo_anakin`` iteration (4 envs x 128
   steps of the device CartPole, GAE, 10 x 8 guarded minibatches) on the card
   against the CPU from the same weights, env reset and injected draws:
   episodes exact, observations, losses and parameters within tolerance
   (phase 3 also holds ``gae``'s per-member entry bit-equal to its plain
   version at the population's (128, 8 x 4, 1) and four other shapes, and
   times it);
50. Anakin run: ``run preset=ppo_anakin``, the whole recipe's
   ANAKIN_ITERATIONS iterations: ``gae`` exactly once per iteration and no
   other kernel, one host read of the card per block (counted with
   ``torch.cuda.set_sync_debug_mode``), the learning floor of the PPO run at
   its end, env steps/s and host ms per block, one iteration profiled, a
   resume;
51. Anakin population: ``run preset=ppo_anakin_population`` with
   POPULATION_SIZE members and PBT for POPULATION_ITERATIONS iterations:
   ``gae`` (the per-member entry) once per iteration, one host read per
   block, a PBT step per block; a resume; ``evaluation`` of the best member;
   a population of one bit-equal to the single run.
52. bf16 families: one short ``bf16-mixed`` train call of PPO, A2C,
   recurrent PPO, SAC, DroQ, SAC-AE, Dreamer V2, Dreamer V1 and
   Plan2Explore on each Dreamer, and one guarded append-free dispatch of
   ``dreamer_sebulba``'s async ring, on the card against the CPU
   (BF16_FAMILIES): losses, each optimizer's gradient, the card's modules
   in bfloat16. The discrete DreamerV3, PPO and SAC runs above stay at
   their recipes' ``32-true``.
53. the pipeline on the card: a published parameter snapshot stays
   bit-equal while Adam updates the live weights in place and an actor
   stream reads it; the stager's refill waits for its slab's upload event
   and the learner reads the item bit for bit; two threads reaching an
   unbuilt ``gae`` at once build it once, both results bit-equal; an actor
   stream's work ends while a long kernel runs on the learner's stream;
54. Sebulba PPO: ``run preset=ppo_sebulba`` (2 actor threads, each on its
   own stream) for SEBULBA_PPO_ITERATIONS items: ``gae`` exactly once per
   item trained on or in flight at the stop, no other kernel, the staleness
   within its bound, finite losses, the learning bar; a resume for one
   item, ``evaluation``, one update and one actor step profiled, and a short
   profiled run for the card's busy share and kernels by stream;
55. decoupled PPO: ``run preset=ppo_decoupled``, the player's ``gae`` once
   per iteration on its own stream; a resume;
56. Sebulba SAC with PER: ``run preset=sac_sebulba_per`` at full width for
   SEBULBA_SAC_STEPS steps: ``sumtree_sample`` exactly once per granted
   gradient step, the replay-ratio governor's bound, finite losses; a
   resume restoring the ring, the sum-tree, ``max_p`` and the generator bit
   for bit; the append-free dispatch card against CPU step by step;
57. decoupled SAC: ``run preset=sac_decoupled``, no kernel launched; a resume.
58. dreamer_sebulba on the card: two actor threads, each on its own stream,
   write blocks with ragged reset rows into their writers at env columns 0
   and 4, and the learner's appends through ``ragged_ring_scatter_keys``
   leave the ring (every column wrapped) and its heads bit-equal to the
   plain version's after every blob; a writer's slab is refilled only after
   its upload's event; one guarded append-free dispatch (B 4 x T 16) and one
   act step on the card against the CPU; ``prefer_ready``: while a train
   dispatch still waits on the learner's stream, an actor's act step ends
   on the previous snapshot;
59. dreamer_sebulba run: ``run preset=dreamer_sebulba_atari_dummy`` (2 actors
   x 4 envs, the 100,000-row ring) through the 1,024-step prefill and
   SEBULBA_RSSM_FULL_DISPATCHES full 32-step dispatches: the scatter once per
   committed blob, ``gru_gates`` once per act and test step and T + H a
   gradient step, the two-hot kernels 3 a gradient step, exactly; the
   governor, the staleness guard, finite losses, the actors' streams; a
   resume from the latest save restoring the ring, heads, generator and
   ``Ratio`` bit for bit; ``evaluation``, one served session, one dispatch
   alone and an act step profiled;
60. hybrid burst on the card: one DreamerV3-S burst at the hybrid player's
   spec (16 grants, the 19-row bucket) against the CPU's from the same state
   and draws; the blob appended bit-equal to the plain scatter; the host
   snapshot's bf16 pull bit-equal and untouched by a later burst;
61. hybrid DreamerV3 run: ``run preset=dreamer_v3_100k_atari_dummy`` at its
   default ``algo.hybrid_player.enabled=auto`` (the host player on the CPU,
   bursts on the trainer thread), exact launch counts, a resume onto the
   ring; act-step, burst and snapshot timings;
62. hybrid SAC: one burst against the CPU's, ``run preset=sac`` at ``auto``
   (bursts of 256 grants), the exact grant accounting, a resume, beside a
   coupled run of the same length;
63. ``metric.profiler``: a profiled PPO run's trace holds ``gae``'s kernel
   events; its launch counts equal the plain run's.

Phases 1-3, 11, 14 and 21 run first, in this process alone, so that the
kernels are timed on an idle card. Phases 4-10, 12, 13 and 15-63 then run
in five worker processes at once on the same card (``LANES``; each worker
is this script with ``--lane NAME --out FILE``), each a chain of phases in
the order above; path timings taken there share the card and the CPU's
cores with the other lanes. The script fails, and stops the other workers,
as soon as one fails.

The last three lines: the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_training_agent, sample_stochastic
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, draw_noise, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import act, posterior_step, serve_policy_dreamer_v3
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu_torch.algos.ppo.agent import build_agent as build_ppo_agent
from sheeprl_tpu_torch.algos.ppo.ppo import LOSS_NAMES as PPO_LOSS_NAMES
from sheeprl_tpu_torch.algos.ppo.ppo import draw_permutations
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer as make_ppo_optimizer
from sheeprl_tpu_torch.algos.ppo.ppo import make_train_step as make_ppo_train_step
from sheeprl_tpu_torch.algos.ppo import ppo_anakin, ppo_anakin_population
from sheeprl_tpu_torch.envs.device_envs import BatchedDeviceEnv
from sheeprl_tpu_torch.config import apply_overrides, load_config, preset
from sheeprl_tpu_torch.models import NatureCNN
from sheeprl_tpu_torch.ops import kernels
from sheeprl_tpu_torch.ops.kernels import _build
from sheeprl_tpu_torch.ops.kernels import twohot
from sheeprl_tpu_torch.parallel import Precision
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, load_checkpoint

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
GRU_OPS_PER_ELEMENT = 10  # 2 sigmoid + tanh + 7 multiply/add, counted as one op each
# per projection element: an add to the mean's sum, a subtraction and a
# multiply-add for the squared deviation, a subtraction and two products to
# normalise and scale, the bias's add
GRU_LN_OPS_PER_ELEMENT = 8
GRU_LN_EPS = 1e-3  # the RSSM cell's LayerNorm epsilon
# the Dreamer V2 (H 600) and P2E-DV2 (H 400) cells: a player or test step, a
# gradient step's dynamic rollout (B 16) and its imagination (T x B = 800);
# 150 and 100 quads a row, not a multiple of 32, so the block's last warp
# has idle lanes in both row sums
GRU_V2_SHAPES = [(B, H, "float32") for H in (600, 400) for B in (1, 16, 800)] + [(800, 600, "bfloat16")]
# gru_gates_ln's bf16 entry: (B, H, the carry's dtype) on the bf16 paths
GRU_BF16_SHAPES = [(16, 512, "bfloat16"), (1, 512, "bfloat16"), (16, 512, "float32"), (1, 512, "float32"),
                   (4, 512, "float32"), (16, 600, "bfloat16"), (800, 600, "bfloat16")]
# the loss, per row: symlog (~10), the bracket's guess and two checks (~8),
# the weights (~8) and the two-term dot (3); the decode, per logit: a max, a
# subtraction, an exp, an add and a multiply-add
TWO_HOT_LOSS_OPS_PER_ROW = 30
TWO_HOT_DECODE_OPS_PER_LOGIT = 6
# the fused loss per logit: a max, a subtraction, an exp and an add for the
# log-sum-exp (plus the loss's per row); its backward per logit: a
# subtraction, an exp, two products, the target's two compares and adds and
# a subtraction
TWO_HOT_LSE_OPS_PER_LOGIT = 4
TWO_HOT_LSE_BWD_OPS_PER_LOGIT = 8
# the fused loss's and its backward's shapes (rows, dtype, base one element
# past an aligned address); the main path's is (15360, 255) f32, the
# critic's T x B x H rows (15 x 16 x 64)
TWO_HOT_LSE_MAIN = 15360
TWO_HOT_LSE_CASES = [(n, dt, mis) for n in (1, 5, 1024, 15360) for dt in ("float32", "bfloat16") for mis in (False, True)]
# H100 SXM boost clock (NVIDIA's data sheet) and an f32 multiply-add's
# latency in cycles: GAE's serial chain is one dependent multiply-add per step
SM_CLOCK_HZ = 1.98e9
FMA_LATENCY_CYCLES = 4
# per element: 1 - done, two products and a sum for delta, a product and a
# multiply-add for the carry, the return's add
GAE_OPS_PER_ELEMENT = 8
# the per-member entry's (T, P, N, trailing) cases: the population path's
# (128, 8 members x 4 envs, 1) and P 4, a short ragged case, three tiles with
# a row per span, one step
GAE_FACTOR_SHAPES = [(128, 8, 4, (1,)), (128, 4, 4, (1,)), (16, 2, 3, ()), (300, 5, 33, ()), (1, 3, 4, (1,))]
N_SESSIONS, N_STEPS, RESET_AT = 8, 16, 8
RUN_PRESET = "dreamer_v3_100k_atari_dummy"
RUN_LEARNING_STARTS, RUN_GRADIENT_STEPS = 128, 9
RUN_RESUME_STEPS = 4  # env steps of the host run's resume, learning from the restored buffer after 2
PPO_PRESET = "ppo"
# the mean return of the last PPO_LAST_EPISODES finished CartPole episodes
# must reach PPO_RETURN_BAR: a random policy gets ~22; the first card run of
# the full recipe read 500.0, CartPole's maximum, and 500.0 at half its 128
# iterations, the depth the run is cut to (PERF.md)
PPO_LAST_EPISODES, PPO_RETURN_BAR = 10, 450.0
PPO_ITERATIONS = 64
ANAKIN_PRESET = "ppo_anakin"
# the Anakin run takes the whole recipe, 128 iterations (65,536 steps, the
# JAX exp's budget), and holds PPO's floor at its end: at half the recipe the
# last-10 mean is luck of the draws for the host loop and this one alike (on
# the CPU, seed 3's host PPO read 34.5 and seed 1's Anakin 273.5 at 64
# iterations, every seed 500 at 128; on an H100 the seed-42 Anakin read 409.7
# at 64), so the 64-iteration mark is reported, not held. The population runs
# 10 iterations of 4 members: two blocks at the preset's 9 iterations a block
ANAKIN_ITERATIONS, ANAKIN_HALF = 128, 64
POPULATION_SIZE, POPULATION_ITERATIONS = 4, 10
SAC_PRESET = "sac_per"
# the JAX package's own Pendulum learning budget and floor
# (tests/test_algos/test_sac_sebulba.py): the best mean return over 10
# consecutive episodes reaches -500 within 16,384 steps; random play scores
# about -1200
SAC_TOTAL_STEPS, SAC_WINDOW, SAC_RETURN_BAR = 16384, 10, -500.0
SAC_RESUME_ITERATIONS = 4  # a resumed Ratio grants nothing on its first, then 4 steps an iteration
RESIDENT_PRESET = "dreamer_v3_100k_atari_dummy_resident"
# learning starts a few steps past the env's first episode end, so the ring
# takes the reset row as a 2-row flush before the first gradient step
RESIDENT_GRADIENT_STEPS, RESIDENT_RESUME_STEPS = 9, 4
PROFILED = 3  # resident dispatches per profiling window
# the sumtree kernel's shapes: (leaves, draws); the SAC path's is (2^20, 256)
SUMTREE_SHAPES = [(p, b) for p in (1 << 6, 1 << 10, 1 << 16, 1 << 20, 1 << 22) for b in (1, 256, 4096)]
SUMTREE_MAIN = (1 << 20, 256)
SUMTREE_HOP_SWEEP = (5, 6, 7, 8, 10)  # the kernel's levels per dependent read, swept at SUMTREE_MAIN
SECTOR_BYTES = 32  # one L2 sector: the least one dependent read moves
# one thread walks a random cycle of dependent loads through an 8 MiB buffer
# (inside the 50 MB L2, far beyond L1), loading with __ldcg (cached in L2
# only): the time per hop is one L2 hit's latency. Beside it, an empty
# kernel: its graph-replayed time is the floor of one launch, which every
# kernel's ``ms`` includes
_L2_CHASE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void chase(const uint32_t* __restrict__ next, uint32_t start, long long hops, uint32_t* out) {
  uint32_t i = start;
  for (long long h = 0; h < hops; ++h) i = __ldcg(next + i);
  *out = i;
}
extern "C" int chase_launch(const void* next, unsigned int start, long long hops, void* out, void* stream) {
  chase<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const uint32_t*>(next), start, hops,
                                                       static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
__global__ void empty() {}
extern "C" int empty_launch(void* stream) {
  empty<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def log(msg: str) -> None:
    print(f"[chip_smoke] {_LANE_TAG}{msg}", flush=True)


# -- 1. device --------------------------------------------------------------


def device_phase() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"nvidia-smi: {out}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return out.splitlines()[0]


# -- 2. build -----------------------------------------------------------------


def _start_l2_chase_build():
    """``nvcc`` of the pointer chase, started beside the kernels' builds."""
    out_dir = _build.BUILD_DIR.parent / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    source, target = out_dir / "l2_chase.cu", out_dir / "l2_chase.so"
    source.write_text(_L2_CHASE_SOURCE)
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(target), str(source)]
    return target, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_phase():
    t0 = time.perf_counter()
    chase_target, chase_build = _start_l2_chase_build()
    libs = _build.build_all()
    output, _ = chase_build.communicate()
    if chase_build.returncode != 0:
        raise RuntimeError(f"nvcc failed for the L2 pointer chase:\n{output}")
    log(f"built {sorted(libs)} and the L2 pointer chase in {time.perf_counter() - t0:.2f} s")
    for name, text in sorted(_build.BUILD_LOGS.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {name}: {line.strip()}")
    return chase_target


# -- 3. kernels ---------------------------------------------------------------


def _time_ms(fn, iters: int) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _graph_ms(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph,
    replayed ``replays`` times between two CUDA events, so the host's launch
    cost drops out. Inputs stay where the calls leave them: a shape below the
    50 MB L2 is timed with its operands in L2, as a caller that has just
    produced them would find them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * per_graph)


def _gru_ln_inputs(gen, B: int, H: int, dt, carry_dt=None):
    """A projection in ``dt``, a carry in ``carry_dt`` (default ``dt``) and
    the float32 affine (the parameter dtype under every precision)."""
    proj = (torch.randn((B, 3 * H), generator=gen, device="cuda") * 2 + 0.5).to(dt)
    h = torch.randn((B, H), generator=gen, device="cuda").to(carry_dt or dt)
    weight = 1 + 0.3 * torch.randn((3 * H,), generator=gen, device="cuda")
    bias = 0.2 * torch.randn((3 * H,), generator=gen, device="cuda")
    return proj, h, weight, bias


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance, in bf16 steps, between two bf16 tensors."""
    def line(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((line(a) - line(b)).abs().max())


def gru_bf16_rows(gen) -> list:
    """``gru_gates_ln``'s bf16 entry against its plain version on the same
    inputs (a bf16 projection, the float32 affine, the normalised projection
    rounded to bf16 before the gates) at the shapes the bf16 paths give it:
    the continuous DreamerV3 run's (16, 1536) training and (1, 1536) session
    steps with a bf16 carry and the float32 carry a player's or a session's
    state keeps (the Pallas kernel writes the carry's dtype), and Dreamer
    V2's (16, 1800) and (800, 1800). Held: every element within atol and
    rtol 1e-2 (a normalised projection within float32 rounding of a bf16
    rounding boundary rounds the other way); over a bf16 carry at least
    99.9 % of the elements bit-equal, over a float32 carry at least 99 %
    within 1e-5 (a kernel that left the projection unrounded is ~4e-3 off);
    reported with the worst bf16 ulps (bf16 carry)."""
    rows = []
    for B, H, carry in GRU_BF16_SHAPES:
        carry_dt = getattr(torch, carry)
        proj, h, w, b = _gru_ln_inputs(gen, B, H, torch.bfloat16, carry_dt)
        out = kernels.gru_gates_ln(proj, h, w, b, GRU_LN_EPS)
        torch.cuda.synchronize()
        want = kernels.gru_gates_ln_reference(proj, h, w, b, GRU_LN_EPS)
        if out.dtype != carry_dt or want.dtype != carry_dt:
            raise AssertionError(f"gru_gates_ln bf16 ({B},{3 * H}) over a {carry} carry: out {out.dtype}")
        torch.testing.assert_close(out, want, atol=1e-2, rtol=1e-2)
        bit_equal = float((out == want).float().mean())
        if carry == "bfloat16" and bit_equal < 0.999:
            raise AssertionError(f"gru_gates_ln bf16 ({B},{3 * H}): {bit_equal} of the elements bit-equal")

        def fused_call():
            return kernels.gru_gates_ln(proj, h, w, b, GRU_LN_EPS)

        def plain_call():
            return kernels.gru_gates_ln_reference(proj, h, w, b, GRU_LN_EPS)

        # read the projection and the carry in their dtypes and the float32 affine once, write the output once
        nbytes = 3 * B * H * proj.element_size() + 2 * B * H * h.element_size() + 6 * H * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (GRU_OPS_PER_ELEMENT * B * H + GRU_LN_OPS_PER_ELEMENT * 3 * B * H) / F32_FLOPS * 1e3
        row = {"shape": [B, 3 * H], "dtype": "bfloat16", "carry": carry, "bit_equal": bit_equal,
               "max_abs_err": float((out.float() - want.float()).abs().max()),
               "ms": _graph_ms(fused_call), "plain_ms": _graph_ms(plain_call),
               "call_ms": _time_ms(fused_call, 200), "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        if carry == "bfloat16":
            row["worst_ulps"] = _bf16_ulps(out, want)
        else:
            row["share_within_1e-5"] = float(((out - want).abs() <= 1e-5).float().mean())
            if row["share_within_1e-5"] < 0.99:
                raise AssertionError(f"gru_gates_ln bf16 ({B},{3 * H}) over a float32 carry: "
                                     f"{row['share_within_1e-5']} of the elements within 1e-5")
        rows.append(row)
        log(f"gru_gates_ln bf16 proj ({B},{3 * H}) over a {carry} carry: bit-equal {bit_equal:.6f} "
            f"err {row['max_abs_err']:.3g} kernel {row['ms'] * 1e3:.2f} us (call {row['call_ms'] * 1e3:.2f} us) "
            f"plain {row['plain_ms'] * 1e3:.2f} us bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")
    return rows


def gru_gates_phase(main_batch: int) -> dict:
    """Two entries of ``csrc/gru_gates.cu``, each against its plain version
    (computed in f32, cast to the IO dtype) at each shape:

    - the gate chain alone (``gru_gates``, the cell without LayerNorm): f32
      within atol 1e-6 rtol 1e-5, bf16 within atol 1e-2 rtol 1e-2 (one bf16
      rounding);
    - the GRU projection's LayerNorm and the gate chain in one kernel
      (``gru_gates_ln``, every RSSM step of the main paths): f32 within atol
      and rtol 1e-5 (the row statistics are summed in another order), bf16
      as above; beside it the pair of calls it replaces, ``F.layer_norm``
      then the ``gru_gates`` kernel (``library_ms``), timed the same way;
      its gradient through the ``autograd.Function`` against the plain
      chain's within 1e-5.

    ``ms``/``plain_ms`` are device time per call (:func:`_graph_ms`);
    ``call_ms``/``plain_call_ms`` are eager calls back to back, which the
    host's launch cost bounds at small shapes. The row's main numbers are
    the fused kernel's at (main_batch, 1536) f32, the training paths'
    shape."""
    shapes = [(1, 512, "float32"), (8, 512, "float32"), (16, 512, "float32"), (32, 512, "float32"),
              (1024, 512, "float32"), (1, 512, "bfloat16"), (32, 512, "bfloat16"), (1024, 512, "bfloat16"),
              (1024, 4096, "float32")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, H, dtype in shapes:
        dt = getattr(torch, dtype)
        fused = (torch.randn((B, 3 * H), generator=gen, device="cuda") * 2).to(dt)
        h = torch.randn((B, H), generator=gen, device="cuda").to(dt)
        out = kernels.gru_gates(fused, h)
        torch.cuda.synchronize()
        want = kernels.gru_gates_reference(fused.float(), h.float()).to(dt)
        f32 = dtype == "float32"
        torch.testing.assert_close(out, want, atol=1e-6 if f32 else 1e-2, rtol=1e-5 if f32 else 1e-2)
        err = float((out.float() - want.float()).abs().max())
        iters = 200 if B * H < 1 << 20 else 100
        call_ms = _time_ms(lambda: kernels.gru_gates(fused, h), iters)
        plain_call_ms = _time_ms(lambda: kernels.gru_gates_reference(fused, h), iters)
        ms = _graph_ms(lambda: kernels.gru_gates(fused, h))
        plain_ms = _graph_ms(lambda: kernels.gru_gates_reference(fused, h))
        nbytes = 5 * B * H * h.element_size()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = GRU_OPS_PER_ELEMENT * B * H / F32_FLOPS * 1e3
        rows.append({
            "shape": [B, 3 * H], "dtype": dtype, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        log(f"gru_gates {dtype} fused ({B},{3 * H}): err {err:.3g} kernel {ms * 1e3:.2f} us "
            f"(call {call_ms * 1e3:.2f} us) plain {plain_ms * 1e3:.2f} us (call {plain_call_ms * 1e3:.2f} us) "
            f"bound {max(bytes_ms, ops_ms) * 1e3:.3f} us")
    ln_shapes = [(1, 512, "float32"), (8, 512, "float32"), (16, 512, "float32"), (32, 512, "float32"),
                 (1024, 512, "float32"), (32, 512, "bfloat16"), (1024, 512, "bfloat16"), (1024, 4096, "float32")]
    ln_shapes += GRU_V2_SHAPES
    ln_rows = []
    for B, H, dtype in ln_shapes:
        dt = getattr(torch, dtype)
        proj, h, w, b = _gru_ln_inputs(gen, B, H, dt)
        out = kernels.gru_gates_ln(proj, h, w, b, GRU_LN_EPS)
        torch.cuda.synchronize()
        want = kernels.gru_gates_ln_reference(proj, h, w, b, GRU_LN_EPS)
        f32 = dtype == "float32"
        torch.testing.assert_close(out, want, atol=1e-5 if f32 else 1e-2, rtol=1e-5 if f32 else 1e-2)
        err = float((out.float() - want.float()).abs().max())

        def fused_call():
            return kernels.gru_gates_ln(proj, h, w, b, GRU_LN_EPS)

        def pair_call():  # the two launches the fused kernel replaces (its affine cast to bf16 rows' dtype)
            return kernels.gru_gates(F.layer_norm(proj, (3 * H,), w.to(dt), b.to(dt), GRU_LN_EPS), h)

        def plain_call():
            return kernels.gru_gates_ln_reference(proj, h, w, b, GRU_LN_EPS)

        iters = 200 if B * H < 1 << 20 else 100
        row = {"shape": [B, 3 * H], "dtype": dtype, "max_abs_err": err,
               "call_ms": _time_ms(fused_call, iters), "pair_call_ms": _time_ms(pair_call, iters),
               "ms": _graph_ms(fused_call), "pair_ms": _graph_ms(pair_call), "plain_ms": _graph_ms(plain_call)}
        # read the projection, the carry and the float32 affine once, write the output once
        nbytes = 5 * B * H * h.element_size() + 6 * H * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (GRU_OPS_PER_ELEMENT * B * H + GRU_LN_OPS_PER_ELEMENT * 3 * B * H) / F32_FLOPS * 1e3
        row.update(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        ln_rows.append(row)
        log(f"gru_gates_ln {dtype} proj ({B},{3 * H}): err {err:.3g} kernel {row['ms'] * 1e3:.2f} us "
            f"(call {row['call_ms'] * 1e3:.2f} us) layer_norm + gru_gates pair {row['pair_ms'] * 1e3:.2f} us "
            f"(call {row['pair_call_ms'] * 1e3:.2f} us) plain {row['plain_ms'] * 1e3:.2f} us "
            f"bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")
    # the gradient through the autograd.Function against the plain chain's, both on the card
    arrays = _gru_ln_inputs(gen, main_batch, 512, torch.float32)
    cot = torch.randn((main_batch, 512), generator=gen, device="cuda")
    grads = []
    for fn in (kernels.gru_gates_ln, kernels.gru_gates_ln_reference):
        leaves = [t.clone().requires_grad_(True) for t in arrays]
        fn(*leaves, GRU_LN_EPS).backward(cot)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(*grads))
    log(f"gru_gates_ln backward: max err {grad_err:.3g} against the plain chain")
    # the Dreamer V2 family's widths: each f32 case's gradient against the plain chain's too
    v2_rows = []
    for B, H, dtype in GRU_V2_SHAPES:
        row = next(r for r in ln_rows if r["shape"] == [B, 3 * H] and r["dtype"] == dtype)
        if dtype == "float32":
            arrays = _gru_ln_inputs(gen, B, H, torch.float32)
            cot = torch.randn((B, H), generator=gen, device="cuda")
            grads = []
            for fn in (kernels.gru_gates_ln, kernels.gru_gates_ln_reference):
                leaves = [t.clone().requires_grad_(True) for t in arrays]
                fn(*leaves, GRU_LN_EPS).backward(cot)
                grads.append([t.grad for t in leaves])
            for a, b in zip(*grads):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
            row["grad_max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(*grads))
        v2_rows.append(row)
    log("gru_gates_ln at the Dreamer V2 (H 600) and P2E-DV2 (H 400) widths: " + json.dumps(
        [{k: r.get(k) for k in ("shape", "dtype", "max_abs_err", "grad_max_abs_err", "ms", "pair_ms", "bound_ms")}
         for r in v2_rows]))
    bf16_rows = gru_bf16_rows(gen)
    main = next(r for r in ln_rows if r["shape"] == [main_batch, 3 * 512] and r["dtype"] == "float32")
    # every evaluation and test-episode step: one row
    eval_shape = next(r for r in ln_rows if r["shape"] == [1, 3 * 512] and r["dtype"] == "float32")
    gates = next(r for r in rows if r["shape"] == [main_batch, 3 * 512] and r["dtype"] == "float32")
    return {
        "name": "gru_gates",
        "route": "cuda",
        "source": "sheeprl_tpu_torch/csrc/gru_gates.cu",
        "replaces": "sheeprl_tpu/ops/kernels/gru.py:59",
        "launches": None,  # filled from the run phase
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        # no single PyTorch call computes the chain: the yardstick is the pair
        # of calls the fused kernel replaces
        "library_ms": main["pair_ms"],
        "library_call": "F.layer_norm, then the gru_gates kernel (a pair of calls)",
        "entry": "gru_gates_ln",
        "grad_max_abs_err": grad_err,
        "eval_shape": {k: eval_shape[k] for k in ("shape", "ms", "call_ms", "plain_ms", "pair_ms", "bound_ms",
                                                  "bound_by", "max_abs_err")},
        "gates_alone": {k: gates[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
        "v2_shapes": v2_rows,
        "ln_shapes": ln_rows,
        "bf16_shapes": bf16_rows,
        "shapes": rows,
    }


def _bf16_family_step(name: str, family: str, preset_name: str, cfg_fn, card: str = "cuda",
                      yardstick: bool = False) -> dict:
    """One ``bf16-mixed`` train call of ``family`` on the card and on the
    CPU (``cfg_fn(precision) -> cfg``, :func:`_bf16_call` runs it), held by
    :func:`_bf16_step_check`; with ``yardstick``, the CPU's ``32-true`` call
    of the same step gives it bfloat16's own noise."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cpu = _bf16_call(family, cfg_fn("bf16-mixed"), "cpu")
    on_card = _bf16_call(family, cfg_fn("bf16-mixed"), card)
    f32 = _bf16_call(family, cfg_fn("32-true"), "cpu") if yardstick else ()
    out = {"preset": preset_name, **_bf16_step_check(f"{name} bf16 step", on_card[0], cpu[0], on_card[1], cpu[1],
                                                     *f32[:2]),
           "card_dtype": on_card[2], "seconds": time.perf_counter() - t0}
    if on_card[2] != "torch.bfloat16":
        raise AssertionError(f"{name}: the card's step computed in {on_card[2]}, not bfloat16")
    return out


def _bf16_call(family: str, cfg, dev: str):
    """``(losses, {optimizer: gradients}, the dtype of one module output)``
    of one train call of ``family`` on ``dev`` from the seeded weights, with
    draws made on the CPU from fixed seeds."""
    out_dtype = {}

    def keep(mod, inputs, output):
        out_dtype.setdefault("dtype", str(output.dtype))

    def watch(module):
        for m in module.modules():
            if hasattr(m, "weight") and isinstance(getattr(type(m), "dtype", None), torch.dtype):
                m.register_forward_hook(keep)
                return module
        return module

    if family in ("ppo", "a2c"):
        from sheeprl_tpu_torch.algos.a2c import a2c as a2c_loop
        rows = 64 if family == "ppo" else int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
        agent, _ = build_ppo_agent(cfg, (2,), False, {"state": {"shape": [4]}}, dev)
        watch(agent)
        rng = np.random.default_rng(40)
        batch = _ppo_batch(rng, rows, False, 2) if family == "ppo" else _cartpole_batch(rng, rows)
        data = {k: v.to(dev) for k, v in batch.items()}
        if family == "ppo":
            opt = make_ppo_optimizer(cfg, agent)
            seen = _capture_grads(opt)
            perms = draw_permutations(1, rows, torch.Generator().manual_seed(41), "cpu").to(dev)
            losses = make_ppo_train_step(agent, opt, cfg, rows)(data, float(cfg.algo.clip_coef),
                                                                float(cfg.algo.ent_coef), perms=perms)[0]
        else:
            opt = a2c_loop.make_optimizer(cfg, agent)
            seen = _capture_grads(opt)
            perm = torch.randperm(rows, generator=torch.Generator().manual_seed(41)).to(dev)
            losses = a2c_loop.make_train_step(agent, opt, cfg, rows)(data, perm=perm)
        return losses.cpu(), {"agent": seen["grads"]}, out_dtype.get("dtype")
    if family == "ppo_recurrent":
        from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as rec_loop
        from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent as build_rec
        T, N, seq = 16, 4, 8
        hidden = int(cfg.algo.rnn.lstm.hidden_size)
        rng = np.random.default_rng(42)
        local = {"state": rng.normal(size=(T, N, 4)).astype(np.float32),
                 "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, N))],
                 "prev_actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, N))],
                 "logprobs": (np.log(0.5) + 0.2 * rng.normal(size=(T, N, 1))).astype(np.float32),
                 "values": rng.normal(size=(T, N, 1)).astype(np.float32),
                 "rewards": np.ones((T, N, 1), np.float32),
                 "dones": (rng.uniform(size=(T, N, 1)) < 0.1).astype(np.float32),
                 "prev_hx": (rng.normal(size=(T, N, hidden)) * 0.3).astype(np.float32),
                 "prev_cx": (rng.normal(size=(T, N, hidden)) * 0.3).astype(np.float32)}
        returns = (rng.normal(size=(T, N, 1)) * 2).astype(np.float32)
        advantages = rng.normal(size=(T, N, 1)).astype(np.float32)
        data = rec_loop.prepare_update(local, returns, advantages, T, N, seq, 1, dev)
        s_pad = int(data["mask"].shape[1])
        one = apply_overrides(cfg, ["algo.update_epochs=1", "algo.per_rank_num_batches=1"])
        agent, _ = build_rec(one, (2,), False, {"state": {"shape": [4]}}, dev)
        watch(agent)
        opt = rec_loop.make_optimizer(one, agent)
        seen = _capture_grads(opt)
        losses = rec_loop.make_train_step(agent, opt, one, s_pad)(
            data, float(cfg.algo.clip_coef), float(cfg.algo.ent_coef), perms=torch.arange(s_pad).reshape(1, s_pad))
        return losses.cpu(), {"agent": seen["grads"]}, out_dtype.get("dtype")
    if family in ("sac", "droq"):
        from sheeprl_tpu_torch.algos.droq.agent import build_agent as build_droq
        from sheeprl_tpu_torch.algos.droq.droq import draw_noise as droq_noise
        from sheeprl_tpu_torch.algos.droq.droq import make_train_step as droq_train_step
        from sheeprl_tpu_torch.algos.sac.agent import build_agent as build_sac
        from sheeprl_tpu_torch.algos.sac.sac import make_optimizers as sac_optimizers
        from sheeprl_tpu_torch.algos.sac.sac import make_train_step as sac_train_step
        space = {"shape": [1], "low": [-2.0], "high": [2.0], "continuous": True}
        rng = np.random.default_rng(43)
        B, G = 64, 2

        def batch(lead):
            return {"observations": torch.from_numpy(rng.normal(size=(*lead, 3)).astype(np.float32)).to(dev),
                    "next_observations": torch.from_numpy(rng.normal(size=(*lead, 3)).astype(np.float32)).to(dev),
                    "actions": torch.from_numpy(rng.uniform(-2, 2, size=(*lead, 1)).astype(np.float32)).to(dev),
                    "rewards": torch.from_numpy(rng.normal(size=(*lead, 1)).astype(np.float32)).to(dev),
                    "terminated": torch.from_numpy((rng.uniform(size=(*lead, 1)) < 0.1).astype(np.float32)).to(dev)}

        agent, _ = (build_sac if family == "sac" else build_droq)(cfg, 3, space, dev)
        watch(agent)
        opts = sac_optimizers(cfg, agent)
        seen = {k: _capture_grads(o) for k, o in zip(("actor", "critic", "alpha"), opts)}
        if family == "sac":
            noise = {k: torch.randn((1, B, 1), generator=torch.Generator().manual_seed(44 + i)).to(dev)
                     for i, k in enumerate(("next", "actor"))}
            losses = sac_train_step(agent, opts, cfg)(batch((1, B)), True, noise=noise)[0]
        else:
            ref, _ = build_droq(cfg, 3, space, "cpu")
            noise = {k: v.to(dev) for k, v in droq_noise(ref, G, B, torch.Generator().manual_seed(44), "cpu").items()}
            losses = droq_train_step(agent, opts, cfg)(batch((G, B)), batch((B,)), noise=noise)
        return losses.cpu(), {k: v["grads"] for k, v in seen.items()}, out_dtype.get("dtype")
    if family == "sac_ae":
        from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent as build_sac_ae
        from sheeprl_tpu_torch.algos.sac_ae.sac_ae import draw_noise as sac_ae_noise
        from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_optimizers as sac_ae_optimizers
        from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_train_step as sac_ae_train_step
        B, G = 2, 1
        rng = np.random.default_rng(45)
        data = {"rgb": rng.integers(0, 256, (G, B, 64, 64, 3)).astype(np.float32),
                "next_rgb": rng.integers(0, 256, (G, B, 64, 64, 3)).astype(np.float32),
                "actions": rng.uniform(-1, 1, (G, B, 2)).astype(np.float32),
                "rewards": rng.normal(size=(G, B, 1)).astype(np.float32),
                "terminated": (rng.uniform(size=(G, B, 1)) < 0.25).astype(np.float32)}
        ref, _ = build_sac_ae(cfg, "cpu")
        noise = sac_ae_noise(ref, cfg, G, B, torch.Generator().manual_seed(46), "cpu")
        agent, _ = build_sac_ae(cfg, dev)
        watch(agent)
        opts = sac_ae_optimizers(cfg, agent)
        seen = {k: _capture_grads(o) for k, o in opts.items()}
        losses = sac_ae_train_step(agent, opts, cfg)({k: torch.from_numpy(v).to(dev) for k, v in data.items()}, 1,
                                                     noise=_to_device(noise, dev))
        # an optimizer the call's gates skip hands over no gradient
        return (losses.cpu().reshape(-1), {k: v["grads"] for k, v in seen.items() if v["grads"]},
                out_dtype.get("dtype"))
    # the Dreamer families and Plan2Explore on each: one gradient step, B 2 x T 8, every
    # categorical draw decided (_decisive_tree), so both devices draw the same classes
    T, B = 8, 2
    discrete = int(cfg.algo.world_model.get("discrete_size", 0)) or None
    data = _batch(np.random.default_rng(47), T, B, 18)
    gen = torch.Generator().manual_seed(48)
    if family == "dreamer_sebulba":
        # one guarded append-free dispatch of the async ring: an actor's blob appended at env
        # columns 4-7, then one granted step on draws made on the CPU
        from sheeprl_tpu_torch.data.ring import pack_burst_blob
        from sheeprl_tpu_torch.replay import AsyncSequenceRing

        keys, C, E, local = _sebulba_keys(), 256, 8, 4
        modules = build_training_agent(cfg, dev)
        watch(modules[0])
        opts = make_optimizers(cfg, *modules[:3])
        seen = {k: _capture_grads(o) for k, o in opts.items()}
        rng = np.random.default_rng(49)
        ring = AsyncSequenceRing(keys, C, E, local, T, 16, device=dev).load_state_dict(
            _sebulba_ring_state(rng, keys, C, E))
        rows = _sebulba_blob_rows(rng, keys, local)
        counts = np.zeros(E, np.int64)
        counts[local:] = sum(m for _, m in rows)
        ring.append(ring.pack_rows(rows, local).to(dev), local)
        ring.note_append(counts, 0)
        train, ctl = make_train_step(*modules, opts, cfg, guard=True, ring={
            "capacity": C, "n_envs": E, "grad_chunk": 1, "seq_len": T, "batch_size": B, "decoupled": True})
        draws = {"env": torch.randint(0, E, (1, B), generator=gen), "u": torch.rand((1, B), generator=gen),
                 "noise": [_decisive_tree(draw_noise(cfg, T, B, [18], gen, "cpu"), discrete)]}
        _, metrics = train((init_moments(dev), 0), ring.state, pack_burst_blob(ctl, {"__validmask__": np.ones(1, np.float32)}),
                           ring.host_valid, None, _to_device(draws, dev))
        return metrics.cpu()[:len(METRIC_NAMES)], {k: v["grads"] for k, v in seen.items()}, out_dtype.get("dtype")
    if family == "dreamer_v2":
        from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
        from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent as build_v2
        modules = build_v2(cfg, dev)
        watch(modules[0])
        opts = dv2.make_optimizers(cfg, *modules[:3])
        noise = _decisive_tree(dv2.draw_noise(cfg, T, B, modules[1], gen, "cpu"), discrete)
        seen = {k: _capture_grads(o) for k, o in opts.items()}
        metrics = dv2.make_train_step(*modules, opts, cfg)({k: v.to(dev) for k, v in data.items()}, 0,
                                                          noise=[_to_device(noise, dev)])
    elif family == "dreamer_v1":
        from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as dv1
        from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as build_v1
        from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_optimizers as make_v1_optimizers
        data = {k: v for k, v in data.items() if k != "is_first"}
        modules = build_v1(cfg, dev)
        watch(modules[0])
        opts = make_v1_optimizers(cfg, *modules)
        noise = _decisive_tree(dv1.draw_noise(cfg, T, B, modules[1], gen, "cpu"), None)
        seen = {k: _capture_grads(o) for k, o in opts.items()}
        metrics = dv1.make_train_step(*modules, opts, cfg)({k: v.to(dev) for k, v in data.items()},
                                                          noise=[_to_device(noise, dev)])
    elif family == "p2e_dv3":
        from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as p2e
        from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent as build_p2e
        agent = build_p2e(cfg, dev)
        watch(agent.world_model)
        opts = p2e.make_optimizers(cfg, agent)
        noise = _decisive_tree(p2e.draw_noise(cfg, T, B, [18], gen, "cpu"), discrete)
        seen = {k: _capture_grads(o) for k, o in opts.items()}
        metrics = p2e.make_train_step(agent, opts, cfg)({k: v.to(dev) for k, v in data.items()},
                                                       p2e.initial_moments(agent, dev), 0,
                                                       noise=[_to_device(noise, dev)])[1]
    else:
        from importlib import import_module
        version = family[-1]
        loop = import_module(f"sheeprl_tpu_torch.algos.p2e_dv{version}.p2e_dv{version}_exploration")
        build = import_module(f"sheeprl_tpu_torch.algos.p2e_dv{version}.agent").build_agent
        if version == "1":
            data = {k: v for k, v in data.items() if k != "is_first"}
        agent = build(cfg, dev)
        watch(agent.world_model)
        opts = loop.make_optimizers(cfg, agent)
        noise = _decisive_tree(loop.draw_noise(cfg, T, B, agent, gen, "cpu"), None if version == "1" else discrete)
        seen = {k: _capture_grads(o) for k, o in opts.items()}
        train = loop.make_train_step(agent, opts, cfg)
        dev_data = {k: v.to(dev) for k, v in data.items()}
        metrics = (train(dev_data, noise=[_to_device(noise, dev)]) if version == "1"
                   else train(dev_data, 0, noise=[_to_device(noise, dev)]))
    return metrics.cpu()[0], {k: v["grads"] for k, v in seen.items()}, out_dtype.get("dtype")


def _gru_bf16_kernel_row(gru: dict, floor: float, run: dict, serve: dict, ring: dict) -> dict:
    """``gru_gates_ln``'s bf16 entry as a row of the kernels line: its
    numbers at the continuous run's training shape (16, 1536) with a bf16
    carry, its launches on the ``bf16-mixed`` continuous paths (every RSSM
    step of the run's training, its player over the float32 carry and its
    test episode; the resume; the sessions; the ring run)."""
    main = next(r for r in gru["bf16_shapes"] if r["shape"] == [16, 1536] and r["carry"] == "bfloat16")
    return {
        "name": "gru_gates_ln_bf16", "route": "cuda", "source": "sheeprl_tpu_torch/csrc/gru_gates.cu",
        "replaces": "sheeprl_tpu/ops/kernels/gru.py:59", "launches": run["launches"]["gru_gates"],
        "max_abs_err": main["max_abs_err"], "bit_equal": main["bit_equal"], "worst_ulps": main["worst_ulps"],
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        # no single PyTorch call computes flax's bf16 LayerNorm and the gates
        "library_ms": None, "floor_ms": floor,
        "launches_by_path": {"dreamer_continuous_run": run["launches"]["gru_gates"],
                             "dreamer_continuous_resume": run["resume"]["launches"]["gru_gates"],
                             "dreamer_continuous_serve": serve["launches"]["gru_gates"],
                             "dreamer_decoupled_ring": ring["launches"]["gru_gates"]},
        "shapes": gru["bf16_shapes"],
    }


#: the families whose bf16-mixed step the card is held to, besides the
#: continuous DreamerV3 of phases 31-34: (name, family, preset, overrides).
#: Only SAC-AE's step needs the float32 yardstick: its encoder's gradient
#: reaches the critic's loss through bf16 convolutions, 0.93 cosine from
#: float32 on the CPU; every other gradient lies within 2.3e-4 of the CPU's.
BF16_YARDSTICK = {"sac_ae"}
BF16_FAMILIES = [
    ("PPO", "ppo", "ppo", ["algo.update_epochs=1", "algo.per_rank_batch_size=64"]),
    ("A2C", "a2c", "a2c", []),
    ("recurrent PPO", "ppo_recurrent", "ppo_recurrent", []),
    ("SAC", "sac", "sac", ["algo.per_rank_batch_size=64"]),
    ("DroQ", "droq", "droq", ["algo.per_rank_batch_size=64"]),
    # SAC-AE's convolutions cut to 64 channels: bf16 convolutions on the host's CPU are slow at 512
    ("SAC-AE", "sac_ae", "sac_ae", ["algo.per_rank_batch_size=2", "algo.cnn_channels_multiplier=2",
                                    "algo.encoder.cnn_channels_multiplier=2", "algo.decoder.cnn_channels_multiplier=2"]),
    ("Dreamer V2", "dreamer_v2", "dreamer_v2_atari_dummy", []),
    ("Dreamer V1", "dreamer_v1", "dreamer_v1_atari_dummy", []),
    ("P2E-DV3", "p2e_dv3", "p2e_dv3_exploration_atari_dummy", []),
    ("P2E-DV2", "p2e_dv2", "p2e_dv2_exploration_atari_dummy", []),
    ("P2E-DV1", "p2e_dv1", "p2e_dv1_exploration_atari_dummy", []),
    ("dreamer_sebulba", "dreamer_sebulba", "dreamer_sebulba_atari_dummy",
     ["algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8"]),
]


def bf16_families_phase(card: str = "cuda") -> dict:
    """One short ``bf16-mixed`` train call of every other family the port
    reaches at that precision, at its preset's widths with a small batch, on
    the card against the CPU (:func:`_bf16_family_step`): the losses and
    each optimizer's gradient, and the card's modules computing in
    bfloat16. The Anakin paths build the PPO agent, whose step is held here."""
    out = {}
    for name, family, preset_name, extra in BF16_FAMILIES:
        def cfg_fn(precision, preset_name=preset_name, extra=extra):
            over = list(extra) + [f"fabric.precision={precision}"]
            if preset_name in ("sac_ae",):
                cfg = apply_overrides(preset(preset_name), over)
                cfg["spaces"] = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}},
                                 "actions": {"shape": [2], "low": [-1.0, -1.0], "high": [1.0, 1.0],
                                             "continuous": True}}
                return apply_overrides(cfg, [])
            if preset_name.startswith(("dreamer", "p2e")):
                return _v2_cfg(preset_name, over)
            return apply_overrides(preset(preset_name), over)

        out[family] = _bf16_family_step(name, family, preset_name, cfg_fn, card, family in BF16_YARDSTICK)
        log(f"{name} bf16 step (card vs CPU): " + json.dumps(out[family]))
    return out


def _two_hot_inputs(gen, n: int, k: int, scale: float):
    logits = torch.log_softmax(torch.randn((n, k), generator=gen, device="cuda") * scale, dim=-1)
    value = torch.randn((n, 1), generator=gen, device="cuda") * 30
    # zero, negatives, beyond +-20 in symlog space, exactly on the top bin,
    # then one target on each bin
    value[:5, 0] = torch.tensor([0.0, -1.0, 1e10, -1e10, float(np.expm1(20.0))], device="cuda")
    bins = torch.linspace(-20.0, 20.0, k, device="cuda")
    value[5:5 + k, 0] = torch.sign(bins) * torch.expm1(bins.abs())
    return logits, value


def two_hot_phase() -> list:
    """Both two-hot kernels against their plain versions computed in f32 on
    the same (rounded) inputs, at the training path's shapes: f32 within
    atol 1e-4 rtol 1e-5 (the in-kernel bins ``low + i * step`` and
    ``torch.linspace`` differ by an ulp of 20, which moves a two-hot weight
    by ~1e-5 against logits down to ~-25), bf16 within atol 2e-2 rtol 1e-2
    (one bf16 rounding of the output). Each ``autograd.Function``'s gradient
    on the card against the plain chain's, within atol and rtol 1e-4."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    # loss logits spread wide (down to ~-25); decode logits spread as a head's
    # do, so decoded values stay in the range a critic or reward head gives
    for name, main_n, scale in (("two_hot_symlog_loss", 15360, 3.0), ("two_hot_symexp_decode", 16384, 1.0)):
        kernel, plain_fn = getattr(kernels, name), getattr(kernels, f"{name}_reference")
        rows = []
        for n in (1024, 15360, 16384):
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                logits, value = _two_hot_inputs(gen, n, 255, scale)
                logits = logits.to(dt)
                args = (logits, value) if name == "two_hot_symlog_loss" else (logits,)
                plain_args = (logits.float(), value) if name == "two_hot_symlog_loss" else (logits.float(),)
                got = kernel(*args)
                torch.cuda.synchronize()
                want = plain_fn(*plain_args)
                f32 = dtype == "float32"
                tol = dict(atol=1e-4, rtol=1e-5) if f32 else dict(atol=2e-2, rtol=1e-2)
                torch.testing.assert_close(got.float(), want, **tol)
                if got.dtype != dt:
                    raise AssertionError(f"{name} returned {got.dtype} for {dt} logits")
                err = float((got.float() - want).abs().max())
                call_ms = _time_ms(lambda: kernel(*args), 200)
                plain_call_ms = _time_ms(lambda: plain_fn(*args), 200)
                ms = _graph_ms(lambda: kernel(*args))
                plain_ms = _graph_ms(lambda: plain_fn(*args))
                size = logits.element_size()
                if name == "two_hot_symlog_loss":  # per row: the target, two logits, the output
                    nbytes, ops = n * (4 + 3 * size), TWO_HOT_LOSS_OPS_PER_ROW * n
                else:  # per row: every logit, the output
                    nbytes, ops = n * 255 * size + n * size, TWO_HOT_DECODE_OPS_PER_LOGIT * n * 255
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = ops / F32_FLOPS * 1e3
                rows.append({
                    "shape": [n, 255], "dtype": dtype, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                    "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                })
                log(f"{name} {dtype} ({n},255): err {err:.3g} kernel {ms * 1e3:.2f} us (call {call_ms * 1e3:.2f} us) "
                    f"plain {plain_ms * 1e3:.2f} us (call {plain_call_ms * 1e3:.2f} us) "
                    f"bound {max(bytes_ms, ops_ms) * 1e3:.4f} us")
        # the gradient through the autograd.Function against the plain chain's
        logits, value = _two_hot_inputs(gen, 512, 255, scale)
        value[8:] = value[8:] / 8  # most targets inside the support, where d/dvalue != 0
        weight = torch.rand((512,), generator=gen, device="cuda")
        grads = []
        for fn in (kernel, plain_fn):
            lg = logits.clone().requires_grad_(True)
            v = value.clone().requires_grad_(True)
            out_ = fn(lg, v) if name == "two_hot_symlog_loss" else fn(lg)[..., 0]
            (out_ * weight).sum().backward()
            grads.append([t.grad for t in ((lg, v) if name == "two_hot_symlog_loss" else (lg,))])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        grad_err = max(float((a - b).abs().max()) for a, b in zip(*grads))
        log(f"{name} backward: max err {grad_err:.3g} against the plain chain")
        main = next(r for r in rows if r["shape"] == [main_n, 255] and r["dtype"] == "float32")
        out.append({
            "name": name,
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/two_hot.cu",
            "replaces": "sheeprl_tpu/ops/kernels/twohot.py:133" if name == "two_hot_symlog_loss"
            else "sheeprl_tpu/ops/kernels/twohot.py:158",
            "launches": None,  # filled from the run phase
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the two-hot loss or decode
            "grad_max_abs_err": grad_err,
            "shapes": rows,
        })
    return out


def _two_hot_lse_inputs(gen, n: int, k: int, dt, misaligned: bool):
    """Raw head logits (spread, off centre), targets with every special one
    (zero, negatives, beyond +-20 in symlog space, exactly on the top bin,
    then one on each bin, as far as n allows), and an upstream gradient."""
    logits = torch.randn((n, k), generator=gen, device="cuda") * 3 + 1.5
    value = torch.randn((n, 1), generator=gen, device="cuda") * 30
    special = [0.0, -1.0, -250.0, 3.5, 1e10, -1e10, float(np.expm1(20.0))]
    bins = torch.linspace(-20.0, 20.0, k, device="cuda")
    special = torch.cat([torch.tensor(special, device="cuda"), torch.sign(bins) * torch.expm1(bins.abs())])[:n]
    value[: len(special), 0] = special
    grad = torch.rand((n,), generator=gen, device="cuda") * 1.5 + 0.5
    logits, grad = logits.to(dt), grad.to(dt)
    if misaligned:  # a view one element past an aligned address, as a slice of a larger buffer is
        logits = torch.empty(n * k + 1, dtype=dt, device="cuda")[1:].view(n, k).copy_(logits)
    return logits, value, grad


def two_hot_lse_phase() -> list:
    """The fused loss over raw logits (``two_hot_symlog_loss_lse``) and its
    backward kernel against their plain versions computed in f32 on the same
    (rounded) inputs, at every case of TWO_HOT_LSE_CASES:

    - the log-prob within atol 1e-4 rtol 1e-5 in f32 (the kernels' bins are
      ``torch.linspace``'s floats, so targets bracket alike and what differs
      is the order of the sums and the exps' rounding), atol 2e-2 rtol 1e-2
      in bf16 (one bf16 rounding of the output); the rows' lse within atol
      and rtol 1e-5;
    - the gradient, given the same lse and upstream gradient (0.5 to 2),
      within atol 1e-6 rtol 1e-5 in f32 (a row's softmax terms are ~1e-4
      each, so a coarser atol would pass a kernel that got them wrong), as
      the log-prob in bf16;

    then both at the main shape and (1024, 255) in f32 and bf16, timed beside
    their bounds: the forward beside the pair of calls it replaces
    (``logits - torch.logsumexp``, then the ``two_hot_symlog_loss`` kernel:
    ``library_ms``), the
    backward beside the unfused path's backward (``_plain_grads`` and the
    normalisation's, as the forward and backward of both paths minus the
    forwards); and ``two_hot_mean``
    (the decode kernel on raw logits) against the plain decode of the
    normalised logits."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    k = 255
    f32_tol, f32_grad_tol, bf16_tol = dict(atol=1e-4, rtol=1e-5), dict(atol=1e-6, rtol=1e-5), dict(atol=2e-2, rtol=1e-2)
    checked = []
    for n, dtype, misaligned in TWO_HOT_LSE_CASES:
        dt = getattr(torch, dtype)
        logits, value, grad = _two_hot_lse_inputs(gen, n, k, dt, misaligned)
        tol, grad_tol = (f32_tol, f32_grad_tol) if dtype == "float32" else (bf16_tol, bf16_tol)
        before = dict(kernels.LAUNCHES)
        out, lse = twohot._launch_loss_lse(logits, value, -20.0, 20.0)
        dx = twohot._launch_loss_lse_bwd(logits, value, lse, grad, -20.0, 20.0)
        torch.cuda.synchronize()
        if (kernels.LAUNCHES["two_hot_symlog_loss_lse"] - before["two_hot_symlog_loss_lse"],
                kernels.LAUNCHES["two_hot_symlog_loss_lse_bwd"] - before["two_hot_symlog_loss_lse_bwd"]) != (1, 1):
            raise AssertionError("the fused loss or its backward did not count one launch")
        if out.dtype != dt or dx.dtype != dt or lse.dtype != torch.float32 or dx.shape != logits.shape:
            raise AssertionError(f"fused loss returned {out.dtype}, {lse.dtype}, {dx.dtype} {tuple(dx.shape)}")
        want = kernels.two_hot_symlog_loss_lse_reference(logits.float(), value)
        want_lse = torch.logsumexp(logits.float(), dim=-1)
        want_dx = kernels.two_hot_symlog_loss_lse_grad_reference(logits.float(), value, lse, grad.float())
        torch.testing.assert_close(out.float(), want, **tol)
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dx.float(), want_dx, **grad_tol)
        checked.append({"n": n, "dtype": dtype, "misaligned": misaligned,
                        "max_abs_err": float((out.float() - want).abs().max()),
                        "lse_max_abs_err": float((lse - want_lse).abs().max()),
                        "grad_max_abs_err": float((dx.float() - want_dx).abs().max())})
    log(f"two_hot_symlog_loss_lse: {len(checked)} cases against the plain versions, max err forward "
        f"{max(c['max_abs_err'] for c in checked if c['dtype'] == 'float32'):.3g} (f32), backward "
        f"{max(c['grad_max_abs_err'] for c in checked if c['dtype'] == 'float32'):.3g} (f32)")
    # the mean from raw logits: the decode kernel, unchanged, against the plain decode of the normalised logits
    raw, _, _ = _two_hot_lse_inputs(gen, 16384, k, torch.float32, False)
    raw = raw / 3  # spread as a head's are, so decoded values stay in a head's range
    torch.testing.assert_close(kernels.two_hot_mean(raw), kernels.two_hot_symexp_decode_reference(
        raw - torch.logsumexp(raw, dim=-1, keepdim=True)), **f32_tol)

    fwd_rows, bwd_rows = [], []
    for n in (1024, TWO_HOT_LSE_MAIN):
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            logits, value, grad = _two_hot_lse_inputs(gen, n, k, dt, False)
            out, lse = twohot._launch_loss_lse(logits, value, -20.0, 20.0)
            dx = twohot._launch_loss_lse_bwd(logits, value, lse, grad, -20.0, 20.0)
            torch.cuda.synchronize()
            err = float((out.float() - kernels.two_hot_symlog_loss_lse_reference(logits.float(), value)).abs().max())
            grad_err = float((dx.float() - kernels.two_hot_symlog_loss_lse_grad_reference(
                logits.float(), value, lse, grad.float())).abs().max())
            leaf = logits.detach().requires_grad_(True)

            def fused():
                return kernels.two_hot_symlog_loss_lse(logits, value)

            def pair():  # the two calls the fused kernel replaces
                return kernels.two_hot_symlog_loss(logits - torch.logsumexp(logits, dim=-1, keepdim=True), value)

            def fused_fwd_bwd():
                return torch.autograd.grad(kernels.two_hot_symlog_loss_lse(leaf, value), leaf, grad)

            def pair_fwd_bwd():
                y = kernels.two_hot_symlog_loss(leaf - torch.logsumexp(leaf, dim=-1, keepdim=True), value)
                return torch.autograd.grad(y, leaf, grad)

            size = logits.element_size()
            row = {"shape": [n, k], "dtype": dtype, "max_abs_err": err, "ms": _graph_ms(fused),
                   "pair_ms": _graph_ms(pair),
                   "plain_ms": _graph_ms(lambda: kernels.two_hot_symlog_loss_lse_reference(logits, value)),
                   "call_ms": _time_ms(fused, 200), "pair_call_ms": _time_ms(pair, 200)}
            # every logit read once; the target, the log-prob and the lse per row
            nbytes, ops = n * k * size + n * (8 + size), TWO_HOT_LSE_OPS_PER_LOGIT * n * k + TWO_HOT_LOSS_OPS_PER_ROW * n
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
            row.update(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            fwd_rows.append(row)
            fwd_bwd_ms, pair_fwd_bwd_ms = _graph_ms(fused_fwd_bwd), _graph_ms(pair_fwd_bwd)
            brow = {"shape": [n, k], "dtype": dtype, "max_abs_err": grad_err,
                    "ms": _graph_ms(lambda: twohot._launch_loss_lse_bwd(logits, value, lse, grad, -20.0, 20.0)),
                    "plain_ms": _graph_ms(lambda: kernels.two_hot_symlog_loss_lse_grad_reference(
                        logits, value, lse, grad)),
                    "fwd_bwd_ms": fwd_bwd_ms, "pair_fwd_bwd_ms": pair_fwd_bwd_ms,
                    # the unfused path's backward: _plain_grads, then the normalisation's
                    "pair_bwd_ms": pair_fwd_bwd_ms - row["pair_ms"]}
            # the logits read and their gradient written once; the target, lse and upstream gradient per row
            nbytes, ops = 2 * n * k * size + n * (8 + size), TWO_HOT_LSE_BWD_OPS_PER_LOGIT * n * k
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
            brow.update(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            bwd_rows.append(brow)
            log(f"two_hot_symlog_loss_lse {dtype} ({n},{k}): err {err:.3g} kernel {row['ms'] * 1e3:.2f} us "
                f"(call {row['call_ms'] * 1e3:.2f} us) logsumexp + two_hot_symlog_loss pair {row['pair_ms'] * 1e3:.2f} us "
                f"(call {row['pair_call_ms'] * 1e3:.2f} us) plain {row['plain_ms'] * 1e3:.2f} us "
                f"bound {row['bound_ms'] * 1e3:.3f} us; backward err {grad_err:.3g} kernel {brow['ms'] * 1e3:.2f} us "
                f"plain {brow['plain_ms'] * 1e3:.2f} us bound {brow['bound_ms'] * 1e3:.3f} us; forward + backward "
                f"{fwd_bwd_ms * 1e3:.2f} us, the unfused path's {pair_fwd_bwd_ms * 1e3:.2f} us")
    main = next(r for r in fwd_rows if r["shape"][0] == TWO_HOT_LSE_MAIN and r["dtype"] == "float32")
    bmain = next(r for r in bwd_rows if r["shape"][0] == TWO_HOT_LSE_MAIN and r["dtype"] == "float32")
    common = {"route": "cuda", "source": "sheeprl_tpu_torch/csrc/two_hot.cu", "launches": None}  # from the run phase
    return [
        {"name": "two_hot_symlog_loss_lse", **common, "replaces": "sheeprl_tpu/ops/kernels/twohot.py:133",
         **{key: main[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         # no single PyTorch call computes the loss: the yardstick is the pair of calls it replaces
         "library_ms": main["pair_ms"],
         "library_call": "logits - torch.logsumexp, then the two_hot_symlog_loss kernel (a pair of calls)",
         "cases": checked, "shapes": fwd_rows},
        {"name": "two_hot_symlog_loss_lse_bwd", **common, "replaces": "sheeprl_tpu/ops/kernels/twohot.py:192",
         **{key: bmain[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,  # no single PyTorch call computes the gradient
         "unfused_bwd_ms": bmain["pair_bwd_ms"], "shapes": bwd_rows},
    ]


def _gae_inputs(gen, T: int, N: int, trailing: tuple, value_dtype, done_dtype):
    shape = (T, N) + trailing
    rewards = torch.randn(shape, generator=gen, device="cuda")
    values = torch.randn(shape, generator=gen, device="cuda") * 3
    dones = torch.rand(shape, generator=gen, device="cuda") < 0.05
    if T > 2:
        dones[T // 2, ::2] = True  # terminal flags in the middle of columns
    next_value = torch.randn(shape[1:], generator=gen, device="cuda")
    dones = dones.to(done_dtype)
    return rewards.to(value_dtype), values.to(value_dtype), dones, next_value.to(value_dtype)


def gae_phase(gamma: float = 0.99, lam: float = 0.95) -> dict:
    """The kernel against its plain version (float32 math on the same
    inputs) at every shape and dones dtype, float32 and bf16 inputs, within
    atol and rtol 1e-6 and with max error 0 (bit-equal); the gradient through the ``autograd.Function``
    against the plain chain's within 1e-5 (float16 inputs are held the same
    way). ``ms``/``plain_ms`` are device
    time per call (:func:`_graph_ms`); ``call_ms`` is an eager call. Bound:
    the larger of the bytes over the card's rate and the dependent chain, T
    multiply-adds of FMA_LATENCY_CYCLES at the SM clock."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    # PPO's main path, then the other shapes; (512, 16, 1) and (5, 4, 1) are
    # the recurrent PPO and A2C paths' (continuous PPO's is PPO's)
    shapes = [((128, 4), (1,)), ((128, 4), ()), ((1, 7), ()), ((128, 1000), ()), ((1024, 4096), ()),
              ((512, 16), (1,)), ((5, 4), (1,))]
    rows = []
    for (T, N), trailing in shapes:
        for value_dtype in (torch.float32, torch.bfloat16, torch.float16):
            for done_dtype in (torch.uint8, torch.bool, torch.float32):
                args = _gae_inputs(gen, T, N, trailing, value_dtype, done_dtype)
                got = kernels.gae(*args, gamma, lam)
                torch.cuda.synchronize()
                want = kernels.gae_reference(*args, gamma, lam)
                for g, w in zip(got, want):
                    if g.dtype != torch.float32 or g.shape != args[0].shape:
                        raise AssertionError(f"gae returned {g.dtype} {tuple(g.shape)} for {tuple(args[0].shape)}")
                    torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                if err != 0:  # the same f32 ops in the same order: bit-equal at every shape and dtype
                    raise AssertionError(f"gae is not bit-equal to its plain version at {(T, N, *trailing)} "
                                         f"{value_dtype} {done_dtype}: max err {err}")
                row = {"shape": [T, N, *trailing], "dtype": str(value_dtype).split(".")[-1],
                       "dones": str(done_dtype).split(".")[-1], "max_abs_err": err}
                # timed once per shape and value dtype, and with the recurrent path's float32 dones
                if done_dtype == torch.uint8 or ((T, N) == (512, 16) and done_dtype == torch.float32):
                    big = T * N > 1 << 20 or T >= 512  # the plain chain's long loop: fewer calls per graph
                    row["call_ms"] = _time_ms(lambda: kernels.gae(*args, gamma, lam), 50 if big else 200)
                    row["ms"] = _graph_ms(lambda: kernels.gae(*args, gamma, lam))
                    if value_dtype == torch.float32:  # the plain chain's time, a yardstick, once per shape
                        row["plain_ms"] = _graph_ms(lambda: kernels.gae_reference(*args, gamma, lam),
                                                    per_graph=2 if big else 20, replays=5 if big else 20)
                    size = args[0].element_size()
                    nbytes = T * N * (2 * size + args[2].element_size()) + N * size + 8 * T * N
                    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    ops_ms = max(T * FMA_LATENCY_CYCLES / SM_CLOCK_HZ, GAE_OPS_PER_ELEMENT * T * N / F32_FLOPS) * 1e3
                    row.update(bytes_ms=bytes_ms, chain_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
                    plain = f" plain {row['plain_ms'] * 1e3:.2f} us" if "plain_ms" in row else ""
                    log(f"gae {row['dtype']} {tuple(row['shape'])}: err {err:.3g} kernel {row['ms'] * 1e3:.2f} us "
                        f"(call {row['call_ms'] * 1e3:.2f} us){plain} "
                        f"bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: bytes {bytes_ms * 1e3:.4f} us, "
                        f"chain {ops_ms * 1e3:.3f} us)")
                rows.append(row)
    # the gradient through the autograd.Function against the plain chain's
    r, v, d, nv = _gae_inputs(gen, 128, 4, (1,), torch.float32, torch.uint8)
    w_ret, w_adv = torch.rand_like(r), torch.rand_like(r)
    grads = []
    for fn in (kernels.gae, kernels.gae_reference):
        leaves = [t.clone().requires_grad_(True) for t in (r, v, nv)]
        ret, adv = fn(leaves[0], leaves[1], d, leaves[2], gamma, lam)
        ((ret * w_ret).sum() + (adv * w_adv).sum()).backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(*grads))
    log(f"gae backward: max err {grad_err:.3g} against the plain chain")
    def timed_row(shape, dones="uint8"):
        return next(r for r in rows if r["shape"] == shape and r["dtype"] == "float32" and r["dones"] == dones)

    main = timed_row([128, 4, 1])
    per_member = gae_factors_check(gen)
    wide = next(r for r in rows if r["shape"] == [1024, 4096] and r["dtype"] == "float32" and r["dones"] == "uint8")
    log(f"gae at (1024, 4096) f32: {wide['ms'] * 1e3:.2f} us, {wide['ms'] / wide['bytes_ms']:.2f}x its bytes bound "
        f"{wide['bytes_ms'] * 1e3:.2f} us")
    return {
        "name": "gae",
        "route": "cuda",
        "source": "sheeprl_tpu_torch/csrc/gae.cu",
        "replaces": "sheeprl_tpu/ops/kernels/gae.py:56",
        "launches": None,  # filled from the PPO run phase
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the GAE recurrence
        "call_ms": main["call_ms"],
        "bytes_ms": main["bytes_ms"],
        "chain_ms": main["chain_ms"],
        "grad_max_abs_err": grad_err,
        "wide": {"shape": [1024, 4096], "ms": wide["ms"], "bytes_ms": wide["bytes_ms"],
                 "over_bytes_bound": wide["ms"] / wide["bytes_ms"]},
        # each PPO-family path's own shape, f32 values; the recurrent path stores float32 dones
        "paths": {
            name: {k: r[k] for k in ("shape", "dones", "ms", "plain_ms", "call_ms", "bound_ms", "bound_by")}
            for name, r in (("ppo", main), ("ppo_continuous", main), ("a2c", timed_row([5, 4, 1])),
                            ("ppo_recurrent", timed_row([512, 16, 1], "float32")))
        },
        "shapes": rows,
        "per_member": per_member,
    }


def gae_factors_check(gen) -> dict:
    """The per-member entry (``gae_factors``, the population's ``(T, P, N,
    1)`` rollout with ``(P,)`` gamma and lambda, each member its own) against
    its plain version, bit for bit (max error 0), at GAE_FACTOR_SHAPES and
    every dones dtype; the main path's (128, 8 members x 4 envs, 1) timed as
    the scalar entry is (CUDA events around graph replays), beside the scalar
    entry on the same columns, and its bound worked out as the scalar
    entry's: the bytes (and the two (P,) factor arrays) or the 128-step
    chain. With every member's factors equal it must equal the scalar entry
    bit for bit."""
    cases = []
    for T, P, N, trailing in GAE_FACTOR_SHAPES:
        for done_dtype in (torch.uint8, torch.bool, torch.float32):
            shape = (T, P, N) + trailing
            r, v, d, nv = _gae_inputs(gen, T, P * N, (), torch.float32, done_dtype)
            args = (r.reshape(shape), v.reshape(shape), d.reshape(shape), nv.reshape(shape[1:]))
            gamma = 0.9 + 0.099 * torch.rand(P, generator=gen, device="cuda")
            lam = 0.5 + 0.49 * torch.rand(P, generator=gen, device="cuda")
            got = kernels.gae_factors(*args, gamma, lam)
            want = kernels.gae_factors_reference(*args, gamma, lam)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            if err != 0 or any(g.shape != args[0].shape for g in got):
                raise AssertionError(f"gae_factors is not bit-equal to its plain version at {shape} {done_dtype}: {err}")
            cases.append({"shape": list(shape), "dones": str(done_dtype).split(".")[-1], "max_abs_err": err,
                          "args": (args, gamma, lam)})
    main = next(c for c in cases if c["shape"] == [128, 8, 4, 1] and c["dones"] == "float32")
    args, gamma, lam = main.pop("args")
    for c in cases:
        c.pop("args", None)
    same = kernels.gae_factors(*args, torch.full_like(gamma, 0.99), torch.full_like(lam, 0.95))
    flat = [a.reshape(128, 32, 1) for a in args[:3]] + [args[3].reshape(32, 1)]
    scalar = kernels.gae(*flat, 0.99, 0.95)
    if not all(torch.equal(a.reshape(b.shape), b) for a, b in zip(same, scalar)):
        raise AssertionError("gae_factors with every member at 0.99, 0.95 differs from the scalar entry")
    T, cols = 128, 32
    nbytes = T * cols * (4 + 4 + 4) + cols * 4 + 8 * T * cols + 2 * 8 * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = max(T * FMA_LATENCY_CYCLES / SM_CLOCK_HZ, GAE_OPS_PER_ELEMENT * T * cols / F32_FLOPS) * 1e3
    row = {
        "shape": [128, 8, 4, 1], "dones": "float32", "members": 8,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": _graph_ms(lambda: kernels.gae_factors(*args, gamma, lam)),
        "scalar_entry_ms": _graph_ms(lambda: kernels.gae(*flat, 0.99, 0.95)),
        "plain_ms": _graph_ms(lambda: kernels.gae_factors_reference(*args, gamma, lam), per_graph=2, replays=5),
        "call_ms": _time_ms(lambda: kernels.gae_factors(*args, gamma, lam), 200),
        "bytes_ms": bytes_ms, "chain_ms": chain_ms, "bound_ms": max(bytes_ms, chain_ms),
        "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
        "library_ms": None,  # no PyTorch call computes the recurrence
        "cases": cases,
    }
    log(f"gae_factors (128, 8x4, 1) f32: {row['ms'] * 1e3:.2f} us (the scalar entry on the same columns "
        f"{row['scalar_entry_ms'] * 1e3:.2f} us) plain {row['plain_ms'] * 1e3:.1f} us bound {row['bound_ms'] * 1e3:.3f} us "
        f"({row['bound_by']}); {len(cases)} cases bit-equal")
    return row


# -- 4. model on the card against the CPU --------------------------------------


def model_phase(cfg) -> dict:
    """The session step's pieces on the card against the same seeded weights
    on the CPU, full float32 (TF32 off for cuDNN and cuBLAS): recurrent state
    and representation logits within atol 1e-3 (float32 sums over 4096-wide
    inputs in another order), greedy actions on the same posterior equal."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = serve_policy_dreamer_v3(cfg, None, "cuda")
    cpu = serve_policy_dreamer_v3(cfg, None, "cpu")
    rng = np.random.default_rng(1)
    B = 8
    raw = {"rgb": rng.integers(0, 256, size=(B, 64, 64, 3), dtype=np.uint8)}
    obs = gpu.prepare(raw, B)
    init = cpu.init_fn(cpu.params, B)
    stoch_logits = torch.from_numpy(rng.normal(size=tuple(init["stochastic"].shape)).astype(np.float32))
    stoch = sample_stochastic(stoch_logits, cpu.params.world_model.discrete, sample=False)
    actions = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, 9, size=B)), 9).float()
    rec0 = torch.from_numpy(rng.normal(size=tuple(init["recurrent"].shape)).astype(np.float32)).tanh()
    out = {}
    with torch.no_grad():
        for name, pol, dev in (("gpu", gpu, "cuda"), ("cpu", cpu, "cpu")):
            o = {k: torch.from_numpy(v).to(dev) for k, v in obs.items()}
            rec, logits = posterior_step(pol.params, o, actions.to(dev), rec0.to(dev), stoch.to(dev))
            greedy = act(pol.params, stoch.to(dev), rec, greedy=True)
            out[name] = (rec.cpu(), logits.cpu(), torch.cat(greedy, -1).cpu())
    torch.cuda.synchronize()
    rec_err = float((out["gpu"][0] - out["cpu"][0]).abs().max())
    logit_err = float((out["gpu"][1] - out["cpu"][1]).abs().max())
    log(f"model: recurrent max err {rec_err:.3g}, logits max err {logit_err:.3g} (card vs CPU)")
    if not (rec_err <= 1e-3 and logit_err <= 1e-3 and torch.isfinite(out["gpu"][1]).all()):
        raise AssertionError(f"DreamerV3-S step on the card disagrees with the CPU: {rec_err}, {logit_err}")
    if not torch.equal(out["gpu"][2], out["cpu"][2]):
        raise AssertionError("greedy actions on the card differ from the CPU on the same posterior")
    return {"recurrent_max_abs_err": rec_err, "logits_max_abs_err": logit_err}


def _device_kernels(prof) -> list:
    """The profile's device-side events, without user annotations (the
    optimizer's ``Optimizer.step#Adam.step`` range spans kernels that are
    counted on their own)."""
    return [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]


def step_phase(cfg) -> dict:
    """Where a request's time goes, below the socket: one engine dispatch per
    bucket (host clock, ending in the actions' copy to the host), the device
    time inside it (``torch.profiler``, summed over kernels), and the host
    cost of one frame's JSON round trip."""
    from sheeprl_tpu_torch.serve.sessions import SessionEngine

    policy = serve_policy_dreamer_v3(cfg, None, "cuda")
    engine = SessionEngine(policy, buckets=(1, 8, 32), max_sessions=64)
    rng = np.random.default_rng(3)
    out = {}
    for b in engine.buckets:
        obs = policy.prepare({"rgb": rng.integers(0, 256, size=(b, 64, 64, 3), dtype=np.uint8)}, b)
        ids = [f"p{i}" for i in range(b)]
        for _ in range(5):
            engine.step_sessions(policy.params, obs, ids)
        t0 = time.perf_counter()
        n = 30
        for _ in range(n):
            engine.step_sessions(policy.params, obs, ids)
        host_ms = (time.perf_counter() - t0) / n * 1e3
        acts = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            for _ in range(10):
                engine.step_sessions(policy.params, obs, ids)
        events = _device_kernels(prof)
        device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 10
        kernels_per_step = sum(e.count for e in events) / 10
        out[f"bucket_{b}"] = {
            "dispatch_ms": host_ms,
            "device_ms": device_us / 1e3 if device_us > 0 else None,
            "device_busy_share": device_us / 1e3 / host_ms if device_us > 0 else None,
            "device_ops_per_step": kernels_per_step,
        }
        log(f"step bucket {b}: {json.dumps(out[f'bucket_{b}'])}")
    frame = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    for _ in range(20):
        msg = json.dumps({"obs": {"rgb": frame.tolist()}, "session_id": "x"})
        np.asarray(json.loads(msg)["obs"]["rgb"])
    out["json_frame_round_trip_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    log(f"host JSON encode + decode of one 64x64x3 frame: {out['json_frame_round_trip_ms']:.3f} ms")
    return out


# -- 6. one gradient step on the card against the CPU -----------------------------


def _batch(rng, T: int, B: int, n_actions: int) -> dict:
    data = {
        "rgb": rng.integers(0, 256, (1, T, B, 64, 64, 3)).astype(np.float32),
        "actions": np.eye(n_actions, dtype=np.float32)[rng.integers(0, n_actions, (1, T, B))],
        "rewards": (rng.random((1, T, B, 1)) < 0.1).astype(np.float32) * 10,
        "terminated": np.zeros((1, T, B, 1), np.float32),
        "is_first": np.zeros((1, T, B, 1), np.float32),
    }
    data["terminated"][0, T // 2, 0] = 1.0
    data["is_first"][0, T // 2 + 1, 0] = 1.0
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _run_cfg(extra=()):
    cfg = apply_overrides(preset(RUN_PRESET), list(extra))
    cfg["spaces"] = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}}, "actions": {"n": [18], "continuous": False}}
    return apply_overrides(cfg, [])


def train_step_phase() -> dict:
    """One DreamerV3-S gradient step (full width, B 4 x T 16, H 15) on the
    card against the same step on the CPU, TF32 off: the same seeded
    weights, batch and injected noise. Tolerances:

    - the ten losses within rtol 1e-4: float32 sums of the same terms in
      another order (cuDNN's convolutions, cuBLAS's matmuls);
    - the updated parameters: Adam's first step moves each element by about
      its learning rate times the sign of its gradient, so an element whose
      gradient is within float32 noise of zero can move either way on the
      two machines, by up to twice the learning rate (2e-4). So every
      element within 2 * lr + 1e-6 of the CPU's, and at least 99.9% of each
      module's elements within 1e-6."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B = 16, 4
    cfg = _run_cfg([f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}"])
    data = _batch(np.random.default_rng(4), T, B, 18)
    noise = draw_noise(cfg, T, B, [18], torch.Generator().manual_seed(5), "cpu")
    results = {}
    for dev in ("cpu", "cuda"):
        modules = build_training_agent(cfg, dev)
        optimizers = make_optimizers(cfg, *modules[:3])
        train = make_train_step(*modules, optimizers, cfg)
        dev_noise = {
            "posterior": noise["posterior"].to(dev), "imagined_prior": noise["imagined_prior"].to(dev),
            "actions": [u.to(dev) for u in noise["actions"]],
        }
        t0 = time.perf_counter()
        moments, metrics, _ = train({k: v.to(dev) for k, v in data.items()}, init_moments(dev), 0, noise=[dev_noise])
        metrics = metrics.cpu()
        seconds = time.perf_counter() - t0
        params = {name: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                  for name, m in zip(("world_model", "actor", "critic"), modules)}
        results[dev] = (metrics[0], params, seconds)
    out = {"cpu_s": results["cpu"][2], "cuda_s": results["cuda"][2]}
    if not torch.isfinite(results["cuda"][0]).all():
        raise AssertionError(f"non-finite losses on the card: {results['cuda'][0].tolist()}")
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=1e-4, atol=1e-5)
    out["loss_abs_err"] = dict(zip(METRIC_NAMES, (results["cuda"][0] - results["cpu"][0]).abs().tolist()))
    out["losses_cpu"] = dict(zip(METRIC_NAMES, results["cpu"][0].tolist()))
    lrs = {"world_model": 1e-4, "actor": 8e-5, "critic": 8e-5}
    for name, lr in lrs.items():
        diffs = torch.cat([(results["cuda"][1][name][k] - results["cpu"][1][name][k]).abs().reshape(-1)
                           for k in results["cpu"][1][name]])
        close = float((diffs <= 1e-6).float().mean())
        out[name] = {"max_abs_err": float(diffs.max()), "share_within_1e-6": close}
        if float(diffs.max()) > 2 * lr + 1e-6 or close < 0.999:
            raise AssertionError(f"{name} after one step on the card differs from the CPU: {out[name]}")
    log("train step (card vs CPU): " + json.dumps(out))
    return out


# -- 7. run -------------------------------------------------------------------------


def _gru_layer_norms(prof, width: int) -> tuple:
    """The profile's LayerNorms over ``width`` features (the GRU projection's
    3H, a width no other LayerNorm of the model has), counted as
    ``(forward, backward)``: an ``aten::native_layer_norm`` call is in a
    backward when the autograd engine's ``evaluate_function`` range holds
    it (``gru_gates_ln``'s backward recomputes the norm there)."""
    forward = backward = 0
    for e in prof.events():
        shapes = getattr(e, "input_shapes", None)
        if e.name != "aten::native_layer_norm" or not shapes or not shapes[0] or shapes[0][-1] != width:
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("autograd::engine::evaluate_function"):
            parent = parent.cpu_parent
        if parent is None:
            forward += 1
        else:
            backward += 1
    return forward, backward


def _two_hot_plain_ops(prof, bins: int) -> dict:
    """The unfused two-hot chain's ops left in the profile: ``aten::logsumexp``
    over ``bins`` (the two-hot heads' normalisation; the one-hot
    categoricals' are 32 and 18 wide) and the plain loss's bracket
    comparisons, ``aten::le`` / ``aten::gt`` with the ``(bins,)`` support as
    an input."""
    counts = {"logsumexp": 0, "bracket_compares": 0}
    for e in prof.events():
        shapes = getattr(e, "input_shapes", None) or []
        if e.cpu_parent is not None and e.cpu_parent.name == e.name:
            continue  # an op's call of its own overload
        if e.name == "aten::logsumexp" and shapes and shapes[0] and shapes[0][-1] == bins:
            counts["logsumexp"] += 1
        elif e.name in ("aten::le", "aten::gt") and [bins] in shapes:
            counts["bracket_compares"] += 1
    return counts


def _profile_gradient_step(checkpoint: str, guard: bool = False) -> dict:
    """One full-recipe gradient step (B 16 x T 64, H 15) from the run's
    checkpoint, after two warm-up steps: host time around the step (ending
    in a synchronize), and device time and device operations from
    ``torch.profiler``, with the two-hot kernels' and ``gru_gates``' share;
    with ``guard`` the step the host tier runs by default (the finite guard
    and its select over the four modules, the Adams and ``Moments``).
    No LayerNorm of the GRU projection may remain in the forward: the cell
    fuses it into ``gru_gates_ln``. No op of the unfused two-hot chain may
    remain (:func:`_two_hot_plain_ops`): the heads' log-prob is the fused
    loss and its backward kernel, their mean the decode of raw logits."""
    cfg = load_config(find_run_config(checkpoint))
    state = load_checkpoint(checkpoint)
    modules = build_training_agent(cfg, "cuda", state)
    optimizers = make_optimizers(cfg, *modules[:3])
    train = make_train_step(*modules, optimizers, cfg, guard=guard)
    T, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    data = {k: v.cuda() for k, v in _batch(np.random.default_rng(6), T, B, 18).items()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    moments = init_moments("cuda")
    for _ in range(2):
        moments = train(data, moments, 1, gen)[0]
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        moments = train(data, moments, 1, gen)[0]
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA], record_shapes=True) as prof:
        moments = train(data, moments, 1, gen)[0]
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    ops = sum(e.count for e in events)
    forward_ln, backward_ln = _gru_layer_norms(prof, 3 * int(cfg.algo.world_model.recurrent_model.recurrent_state_size))
    if forward_ln:
        raise AssertionError(f"{forward_ln} LayerNorms of the GRU projection remain in a gradient step's forward: "
                             "the cell must fuse them into gru_gates_ln")
    plain_two_hot = _two_hot_plain_ops(prof, int(cfg.algo.critic.bins))
    if any(plain_two_hot.values()):
        raise AssertionError(f"the unfused two-hot chain remains in a gradient step: {plain_two_hot}; the "
                             "distribution must call two_hot_symlog_loss_lse and decode the raw logits")
    share = {}
    for kernel, needle in (("two_hot", "two_hot_"), ("gru_gates", "gru_gates_")):
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in events if needle in e.key)
        share[kernel] = {"device_ms": us / 1e3, "share": us / device_us if device_us > 0 else None,
                         "ops": sum(e.count for e in events if needle in e.key)}
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    return {
        "guard": guard,
        "host_ms": float(np.median(host) * 1e3),
        "host_ms_all": [h * 1e3 for h in host],
        "device_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": device_us / 1e3 / (np.median(host) * 1e3) if device_us > 0 else None,
        "device_ops": ops,
        "gru_layer_norms": {"forward": forward_ln, "backward": backward_ln},
        "two_hot_plain_ops": plain_two_hot,
        "kernels": share,
        "top": [{"name": e.key[:80], "device_ms": getattr(e, "self_device_time_total", 0.0) / 1e3, "count": e.count}
                for e in top],
    }


def _run_resume(summary: dict, T: int, H: int) -> dict:
    """The host run's checkpoint holds its replay buffer (``buffer.checkpoint``
    is on under the preset, as in the JAX package): a resume of
    RUN_RESUME_STEPS steps must start with that buffer, rows, heads and
    generator states equal to the saved ones, and train from it with the
    path's launch counts."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3

    saved = load_checkpoint(summary["checkpoint"])["rb"]
    rows = [env["pos"] for env in saved["envs"]]
    log(f"run checkpoint: {os.path.getsize(summary['checkpoint'])} bytes, with the host buffer's {rows} rows")
    restored = []

    class _Recording(dv3.EnvIndependentReplayBuffer):
        def load_state_dict(self, state):
            super().load_state_dict(state)
            restored.append(self.state_dict())

    kernels.reset_launches()
    dv3.EnvIndependentReplayBuffer = _Recording
    try:
        resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                           "algo.learning_starts=2", f"algo.total_steps={summary['policy_steps'] + RUN_RESUME_STEPS}",
                           "checkpoint.save_last=false", f"log_root={_log_root(summary)}"])
    finally:
        dv3.EnvIndependentReplayBuffer = _Recording.__bases__[0]
    launches = dict(kernels.LAUNCHES)
    if len(restored) != 1 or restored[0]["rng"] != saved["rng"] or len(restored[0]["envs"]) != len(saved["envs"]):
        raise AssertionError("the resume did not restore the checkpoint's host buffer")
    for got, want in zip(restored[0]["envs"], saved["envs"]):
        same = [got[k] == want[k] for k in ("pos", "full", "rng")]
        same += [sorted(got["buffer"]) == sorted(want["buffer"])]
        same += [torch.equal(got["buffer"][k], v) for k, v in want["buffer"].items()]
        if not all(same):
            raise AssertionError(f"the resume restored a different host buffer: {same}")
    G = resumed["gradient_steps"]
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update({"two_hot_symlog_loss_lse": 3 * G, "two_hot_symlog_loss_lse_bwd": 3 * G,
                 "two_hot_symexp_decode": 3 * G,
                 "gru_gates": G * (T + H) + resumed["player_steps"] + resumed["test_steps"]})
    if (resumed["start_iter"] != summary["policy_steps"] + 1 or G == 0 or launches != want
            or not resumed["test_steps"]):
        raise AssertionError(f"host resume: start {resumed['start_iter']}, {G} gradient steps, launches {launches} "
                             f"!= {want}")
    if not np.isfinite(np.asarray(resumed["metrics"])).all():
        raise AssertionError(f"non-finite losses after the resume: {resumed['metrics']}")
    out = {"start_iter": resumed["start_iter"], "policy_steps": resumed["policy_steps"], "gradient_steps": G,
           "player_steps": resumed["player_steps"], "test_steps": resumed["test_steps"],
           "test_reward": resumed["test_reward"], "launches": launches, "restored_rows": rows,
           "restored_equal": True}
    log("run resume: " + json.dumps(out))
    return out


def _log_root(summary: dict) -> str:
    """The ``log_root`` a run wrote under: its directory is
    ``<log_root>/<algo>/<env>/<run_name>/version_N``."""
    return str(Path(summary["log_dir"]).parents[3])


def run_phase(workdir: str) -> dict:
    """DreamerV3-S coupled training through ``run``'s entry point at the
    full recipe, ``learning_starts`` 128 and 9 gradient steps. Every loss
    finite; the launch counts exactly those of the path: per gradient step
    3 fused two-hot losses and their 3 backward launches (reward, critic
    against the lambda-returns and against the target critic), 3 decodes
    (critic values, imagined rewards, target values) and T + H GRU steps
    (dynamic rollout, imagination), plus one GRU step per player step after
    ``learning_starts`` and one per step of the end-of-run test episode
    (``algo.run_test``, on in the preset); the unfused
    ``two_hot_symlog_loss`` kernel none."""
    total = RUN_LEARNING_STARTS + RUN_GRADIENT_STEPS - 1
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run([
        f"preset={RUN_PRESET}",
        "algo.hybrid_player.enabled=false",  # the coupled topology, as JAX's coupled benchmark exps set it
        f"algo.learning_starts={RUN_LEARNING_STARTS}",
        f"algo.total_steps={total}",
        "checkpoint.save_last=true",
        "checkpoint.every=0",
        "metric.log_level=0",  # the losses are logged below
        f"log_root={workdir}",
    ])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    G = summary["gradient_steps"]
    cfg = load_config(find_run_config(summary["checkpoint"]))
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    if G < 8 or summary["device"].split(":")[0] != "cuda" or not summary["test_steps"]:
        raise AssertionError(f"run took {G} gradient steps on {summary['device']}, test episode "
                             f"{summary['test_steps']} steps")
    if not np.isfinite(summary["test_reward"]):
        raise AssertionError(f"test episode's return {summary['test_reward']}")
    if not np.isfinite(np.asarray(summary["metrics"])).all() or len(summary["metrics"]) != G:
        raise AssertionError(f"non-finite or missing losses: {summary['metrics']}")
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update({
        "two_hot_symlog_loss_lse": 3 * G,
        "two_hot_symlog_loss_lse_bwd": 3 * G,
        "two_hot_symexp_decode": 3 * G,
        "gru_gates": G * (T + H) + summary["player_steps"] + summary["test_steps"],
    })
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} for {G} gradient steps")
    per_step = [s / g * 1e3 for s, g in summary["train_host_s"]]
    out = {
        "gradient_steps": G,
        "policy_steps": summary["policy_steps"],
        "player_steps": summary["player_steps"],
        "test_steps": summary["test_steps"],
        "test_reward": summary["test_reward"],
        "launches": launches,
        "wall_s": wall,
        "host_ms_per_gradient_step": per_step,
        "env_steps_per_s": summary["env_steps_per_s"],
        "losses": [dict(zip(METRIC_NAMES, row)) for row in summary["metrics"]],
        "checkpoint": summary["checkpoint"],
    }
    for i, row in enumerate(summary["metrics"]):
        log(f"run gradient step {i}: " + " ".join(f"{n.split('/')[-1]}={v:.5g}" for n, v in zip(METRIC_NAMES, row)))
    log(f"run: {G} gradient steps, host ms per gradient step {[round(x, 1) for x in per_step]}, "
        f"env steps/s {summary['env_steps_per_s']:.1f}, launches {launches}")
    out["checkpoint_bytes"] = os.path.getsize(summary["checkpoint"])
    out["resume"] = _run_resume(summary, T, H)
    out["profile"] = _profile_gradient_step(summary["checkpoint"])
    log("gradient step profile: " + json.dumps(out["profile"]))
    out["profile_guarded"] = _profile_gradient_step(summary["checkpoint"], guard=True)
    log("guarded gradient step profile: " + json.dumps(out["profile_guarded"]))
    return out


# -- 8. serve -----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Conn:
    """One persistent JSON-lines connection."""

    def __init__(self, port: int, deadline: float) -> None:
        while True:
            try:
                self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self.rfile = self.sock.makefile("rb")

    def ask(self, payload: dict) -> dict:
        self.sock.sendall((json.dumps(payload) + "\n").encode())
        line = self.rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def close(self) -> None:
        self.rfile.close()
        self.sock.close()


def _serve_with(args, client, reset: bool = True) -> dict:
    """``cli.serve(args)`` on this thread (it installs the drain handlers)
    on a free port while ``client(port, result)`` talks to it from another
    thread, then asks the server to drain with SIGTERM. The launch counters
    are zeroed just before (unless ``reset`` is False) and read into
    ``result["launches"]`` just after; what the client raised is raised
    here."""
    port = _free_port()
    result: dict = {}

    def run() -> None:
        try:
            client(port, result)
        except BaseException as e:  # reported by the main thread
            result["error"] = e
        finally:
            os.kill(os.getpid(), signal.SIGTERM)  # graceful drain of the server

    if reset:
        kernels.reset_launches()
    client_thread = threading.Thread(target=run, daemon=True)
    client_thread.start()
    cli.serve(list(args) + [f"serve.port={port}", "serve.log_every_s=600"])
    result["launches"] = dict(kernels.LAUNCHES)
    client_thread.join(timeout=60)
    if "error" in result:
        raise result["error"]
    if client_thread.is_alive():
        raise TimeoutError("the serve client did not finish")
    return result


def _sessions_client(frames):
    """8 concurrent sessions x 16 steps, one client reset, then session s0's
    frames again alone."""

    def client(port: int, result: dict) -> None:
        deadline = time.monotonic() + 300
        probe = _Conn(port, deadline)
        result["health_start"] = probe.ask({"health": True})
        actions = [[None] * N_STEPS for _ in range(N_SESSIONS)]
        latencies = []
        errors = []

        def session(i: int) -> None:
            try:
                conn = _Conn(port, deadline)
                for t in range(N_STEPS):
                    msg = {"obs": {"rgb": frames[i][t].tolist()}, "session_id": f"s{i}"}
                    if i == 1 and t == RESET_AT:
                        msg["reset"] = True
                    t0 = time.perf_counter()
                    resp = conn.ask(msg)
                    latencies.append(time.perf_counter() - t0)
                    if "actions" not in resp:
                        raise AssertionError(f"session s{i} step {t}: {resp}")
                    actions[i][t] = resp["actions"]
                conn.close()
            except BaseException as e:  # reported by the main thread
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=session, args=(i,), daemon=True) for i in range(N_SESSIONS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        if any(th.is_alive() for th in threads):
            raise TimeoutError("a session client did not finish")
        result["health_batched"] = probe.ask({"health": True})
        result["actions"], result["latencies"], result["wall_s"] = actions, latencies, wall
        # session s0's frames again, alone: the same actions
        solo = [probe.ask({"obs": {"rgb": frames[0][t].tolist()}, "session_id": "solo"})["actions"] for t in range(N_STEPS)]
        result["solo"] = solo
        result["health_end"] = probe.ask({"health": True})
        probe.close()

    return client


def serve_phase(ckpt: str, accelerator: str = "cuda") -> dict:
    n_actions = int(load_config(find_run_config(ckpt)).spaces.actions.n[0])
    rng = np.random.default_rng(2)
    frames = [[rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8) for _ in range(N_STEPS)] for _ in range(N_SESSIONS)]
    result = _serve_with([
        f"checkpoint_path={ckpt}",
        f"fabric.accelerator={accelerator}",
        "serve.session.buckets=[1,8,32]",
        "serve.max_wait_ms=2.0",
    ], _sessions_client(frames))
    launches = result["launches"]

    for i in range(N_SESSIONS):
        for t, a in enumerate(result["actions"][i]):
            if not (len(a) == 1 and len(a[0]) == 1 and 0 <= a[0][0] < n_actions):
                raise AssertionError(f"session s{i} step {t}: bad action {a}")
    hb = result["health_batched"]
    if hb["sessions"]["live"] != N_SESSIONS or hb["sessions"]["client_resets"] != 1:
        raise AssertionError(f"sessions after the batched phase: {hb['sessions']}")
    if result["solo"] != result["actions"][0]:
        raise AssertionError(f"session alone {result['solo']} != batched {result['actions'][0]}")
    end = result["health_end"]["engine"]
    dispatches = end["dispatches"] + end["warmup_dispatches"]
    if launches["gru_gates"] < 1 or launches["gru_gates"] != dispatches:
        raise AssertionError(f"gru_gates launched {launches['gru_gates']} times for {dispatches} dispatches")
    lat = np.asarray(result["latencies"]) * 1e3
    phase_dispatches = hb["engine"]["dispatches"] - result["health_start"]["engine"]["dispatches"]
    stats = {
        "sessions": N_SESSIONS,
        "steps": N_STEPS,
        "requests": int(lat.size),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "dispatches": int(phase_dispatches),
        "dispatches_per_s": phase_dispatches / result["wall_s"],
        "rows_per_dispatch": lat.size / max(phase_dispatches, 1),
        "requests_per_s": lat.size / result["wall_s"],
        "launches": launches,
        "engine_end": end,
    }
    log("serve: " + json.dumps(stats))
    return stats


# -- 9. one PPO update on the card against the CPU -------------------------------


def _ppo_cfg(pixels: bool):
    extra = ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]"] if pixels else []
    return apply_overrides(preset(PPO_PRESET), extra)


def _ppo_batch(rng, rows: int, pixels: bool, n_actions: int) -> dict:
    data = {
        "actions": np.eye(n_actions, dtype=np.float32)[rng.integers(0, n_actions, rows)],
        "logprobs": (np.log(1.0 / n_actions) + 0.2 * rng.normal(size=(rows, 1))).astype(np.float32),
        "values": rng.normal(size=(rows, 1)).astype(np.float32),
        "returns": (rng.normal(size=(rows, 1)) * 3).astype(np.float32),
        "advantages": rng.normal(size=(rows, 1)).astype(np.float32),
        "rewards": np.ones((rows, 1), np.float32),
        "dones": (rng.uniform(size=(rows, 1)) < 0.05).astype(np.uint8),
    }
    if pixels:
        data["rgb"] = rng.integers(0, 256, (rows, 64, 64, 3), dtype=np.uint8)
    else:
        data["state"] = (rng.normal(size=(rows, 4)) * 0.1).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in data.items()}


PPO_GRAD_RTOL = 2e-4  # the gradient's distance from the CPU's over its norm, on a step without a kink
PPO_KINK_GRAD_RTOL = 5e-2  # the same on a step where a kink took the other branch on one machine
PPO_KINK_SHARE = 1e-4  # the most kinks a step may cross, over the kink inputs it has
PPO_ADAM_ATOL = 1e-6  # the card's Adam step against the CPU's on the card's own gradients


def _record_step(agent, optimizer) -> dict:
    """Hooks that keep what each train step of ``agent`` saw: the gradients
    handed to ``optimizer.step``, every ReLU input of a NatureCNN (its
    convolutions' and ``fc``'s outputs) and the actor heads' logits."""
    seen = {"grads": [], "relu": [], "logits": []}
    step = optimizer.step

    def capturing(grads):
        seen["grads"] = [g.detach().clone() for g in grads]
        step(grads)

    def keep(key):
        return lambda module, inputs, out: seen[key].append(out.detach().cpu())

    optimizer.step = capturing
    for module in agent.modules():
        if isinstance(module, NatureCNN):
            for layer in module.modules():
                if isinstance(layer, (torch.nn.Conv2d, torch.nn.Linear)):
                    layer.register_forward_hook(keep("relu"))
    for i in range(len(agent.actions_dim)):
        getattr(agent, f"actor_head_{i}").register_forward_hook(keep("logits"))
    return seen


def _ppo_kinks(card: dict, cpu: dict, batch: dict, clip: float) -> tuple:
    """The kinks one step crossed on one machine and not on the other, and
    the kink inputs it had: ReLU inputs of another sign, and rows whose
    policy ratio lies on another side of 1 -+ clip (or within 1e-5 of it on
    either machine: the ratio here is recomputed from the logits)."""
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(card["relu"], cpu["relu"]))
    inputs = sum(a.numel() for a in cpu["relu"])
    actions = torch.split(batch["actions"], [x.shape[-1] for x in cpu["logits"]], dim=-1)
    sides = []
    for seen in (card, cpu):
        logprob = sum((torch.log_softmax(lg, -1) * a).sum(-1) for lg, a in zip(seen["logits"], actions))
        ratio = torch.exp(logprob - batch["logprobs"].reshape(-1))
        sides.append((torch.sign(ratio - (1 - clip)), torch.sign(ratio - (1 + clip)),
                      torch.minimum((ratio - (1 - clip)).abs(), (ratio - (1 + clip)).abs()) <= 1e-5))
    rows = (sides[0][0] != sides[1][0]) | (sides[0][1] != sides[1][1]) | sides[0][2] | sides[1][2]
    return flips + int(rows.sum()), inputs + int(rows.numel())


def _ppo_stepwise(cfg, spaces: dict, n_actions: int, data: dict, perms: torch.Tensor) -> dict:
    """Every minibatch step of one update on the card, each held against the
    same step on the CPU taken from the card's weights and Adam state just
    before it, in three parts:

    - the step's three losses within rtol 1e-5 (atol 1e-6 for a loss near 0);
    - the gradient, every parameter's in one vector, within PPO_GRAD_RTOL of
      its norm: float32 sums in another order (cuDNN's and cuBLAS's against
      the CPU's). One vector, because a small tensor whose gradient nearly
      cancels (a bias's, summed over 64 rows) keeps the rounding of its
      terms, which can be far more than its own norm allows. The step's
      kinks are counted: a ReLU input, or a policy ratio at 1 -+ clip,
      that lies within rounding of its kink takes the other branch on one
      machine, and that row's share of the gradient changes whole. A step
      with a kink is held to PPO_KINK_GRAD_RTOL, and crosses at most
      PPO_KINK_SHARE of its kink inputs, or one (a wrong layer would flip half);
    - the card's Adam step within PPO_ADAM_ATOL of the CPU's Adam step on
      the card's own gradients.

    The parameters after the CPU's own step are reported, not held: Adam's
    slope in a gradient near 0 is lr / eps = 10, so it turns a gradient
    rounding of 1e-6, or any kink, into a step 1e-5 or more apart."""
    rows, mb = perms.shape[1], int(cfg.algo.per_rank_batch_size)
    one = apply_overrides(cfg, ["algo.update_epochs=1"])
    agents = {}
    for dev in ("cpu", "cuda"):
        agent, _ = build_ppo_agent(cfg, (n_actions,), False, spaces, dev)
        optimizer = make_ppo_optimizer(cfg, agent)
        agents[dev] = (agent, optimizer, make_ppo_train_step(agent, optimizer, one, mb), _record_step(agent, optimizer))
    (cpu_agent, cpu_opt, cpu_train, cpu_seen), (card_agent, card_opt, card_train, card_seen) = agents["cpu"], agents["cuda"]
    own_order = torch.arange(mb).reshape(1, mb)
    clip, ent = float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)
    worst = {"loss_max_rel_err": 0.0, "param_max_abs_err": 0.0, "adam_max_abs_err": 0.0,
             "grad_max_rel_err": 0.0, "kink_grad_max_rel_err": 0.0}
    kinks, kink_steps = 0, 0
    for epoch_perm in perms:
        for rows_mb in epoch_perm[: rows - rows % mb].reshape(-1, mb):
            before = {k: v.detach().cpu().clone() for k, v in card_agent.state_dict().items()}
            # a copy: load_state_dict would share the CPU tensors of a state it loads on the CPU
            adam_before = copy.deepcopy(card_opt.state_dict())
            cpu_agent.load_state_dict(before)
            cpu_opt.load_state_dict(copy.deepcopy(adam_before))
            for seen in (cpu_seen, card_seen):
                seen["relu"].clear()
                seen["logits"].clear()
            batch = {k: v[rows_mb] for k, v in data.items()}
            on_card = card_train({k: v.cuda() for k, v in batch.items()}, clip, ent, perms=own_order.cuda())[0].cpu()
            on_cpu = cpu_train(batch, clip, ent, perms=own_order)[0]
            torch.testing.assert_close(on_card, on_cpu, rtol=1e-5, atol=1e-6)
            worst["loss_max_rel_err"] = max(worst["loss_max_rel_err"],
                                            float(((on_card - on_cpu).abs() / on_cpu.abs().clamp(min=1e-12)).max()))
            card_state, cpu_state = card_agent.state_dict(), cpu_agent.state_dict()
            worst["param_max_abs_err"] = max(worst["param_max_abs_err"],
                                             max(float((card_state[k].cpu() - cpu_state[k]).abs().max()) for k in cpu_state))

            crossed, inputs = _ppo_kinks(card_seen, cpu_seen, batch, clip)
            if crossed > max(1.0, PPO_KINK_SHARE * inputs):
                raise AssertionError(f"one PPO minibatch step crossed {crossed} of its {inputs} kinks on one machine only")
            kinks, kink_steps = kinks + crossed, kink_steps + int(crossed > 0)
            key, bound = ("kink_grad_max_rel_err", PPO_KINK_GRAD_RTOL) if crossed else ("grad_max_rel_err", PPO_GRAD_RTOL)
            g_card = torch.cat([g.cpu().reshape(-1) for g in card_seen["grads"]])
            g_cpu = torch.cat([g.reshape(-1) for g in cpu_seen["grads"]])
            err = float((g_card - g_cpu).norm() / g_cpu.norm().clamp(min=1e-30))
            if err > bound:
                raise AssertionError(f"one PPO minibatch step ({crossed} kinks crossed) on the card: the gradient "
                                     f"is {err} of its norm away from the CPU's")
            worst[key] = max(worst[key], err)

            cpu_agent.load_state_dict(before)
            cpu_opt.load_state_dict(copy.deepcopy(adam_before))
            cpu_opt.step([g.cpu() for g in card_seen["grads"]])
            cpu_state = cpu_agent.state_dict()
            adam = max(float((card_state[k].cpu() - cpu_state[k]).abs().max()) for k in cpu_state)
            if adam > PPO_ADAM_ATOL:
                raise AssertionError(f"one Adam step on the card moved a parameter {adam} away from the CPU's "
                                     "on the same gradients")
            worst["adam_max_abs_err"] = max(worst["adam_max_abs_err"], adam)
    return {"steps": int(perms.shape[0] * (rows // mb)), "kinks_crossed": kinks, "steps_with_kinks": kink_steps, **worst}


def ppo_update_phase() -> dict:
    """One full-recipe PPO update (512 rows = 4 envs x 128 steps, 10 epochs
    x 8 minibatches of 64, Adam lr 1e-3 eps 1e-4) on the card against the
    same update on the CPU, TF32 off: the same seeded weights, batch and
    permutations. Twice: the CartPole MLP agent, and the NatureCNN agent on
    64x64x3 uint8 pixels with 18 actions.

    - The MLP update as one call on each machine: the three mean losses
      within rtol 1e-5 (atol 1e-6 for a loss near 0); the parameters after
      80 Adam steps every element within 2e-4 (a fifth of the learning rate:
      an element whose gradient sits in float32 noise can take a step of
      another size on the two machines) and at least 99.9 % within 1e-5.
    - The NatureCNN update as one call on each machine is reported, not
      held to a tolerance: the float32 rounding of cuDNN's and the CPU's
      convolutions compounds over 80 Adam steps on a value head fitting
      random returns, and the two trajectories part (PERF.md).
    - Both agents, every one of the 80 steps held against the CPU from the
      card's state before it (:func:`_ppo_stepwise`)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, pixels, n_actions in (("mlp", False, 2), ("nature_cnn", True, 18)):
        cfg = _ppo_cfg(pixels)
        rows = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
        spaces = {"rgb": {"shape": [64, 64, 3]}} if pixels else {"state": {"shape": [4]}}
        data = _ppo_batch(np.random.default_rng(8), rows, pixels, n_actions)
        perms = draw_permutations(int(cfg.algo.update_epochs), rows, torch.Generator().manual_seed(9), "cpu")
        results = {}
        for dev in ("cpu", "cuda"):
            agent, _ = build_ppo_agent(cfg, (n_actions,), False, spaces, dev)
            train = make_ppo_train_step(agent, make_ppo_optimizer(cfg, agent), cfg, rows)
            t0 = time.perf_counter()
            losses = train({k: v.to(dev) for k, v in data.items()}, float(cfg.algo.clip_coef),
                           float(cfg.algo.ent_coef), perms=perms.to(dev))[0].cpu()
            seconds = time.perf_counter() - t0
            results[dev] = (losses, {k: v.detach().cpu() for k, v in agent.state_dict().items()}, seconds)
        if not torch.isfinite(results["cuda"][0]).all():
            raise AssertionError(f"non-finite PPO losses on the card: {results['cuda'][0].tolist()}")
        diffs = torch.cat([(results["cuda"][1][k] - results["cpu"][1][k]).abs().reshape(-1) for k in results["cpu"][1]])
        close = float((diffs <= 1e-5).float().mean())
        loss_err = (results["cuda"][0] - results["cpu"][0]).abs()
        row = {
            "losses_cpu": dict(zip(PPO_LOSS_NAMES, results["cpu"][0].tolist())),
            "loss_abs_err": dict(zip(PPO_LOSS_NAMES, loss_err.tolist())),
            "loss_rel_err": dict(zip(PPO_LOSS_NAMES, (loss_err / results["cpu"][0].abs()).tolist())),
            "param_max_abs_err": float(diffs.max()),
            "param_share_within_1e-5": close,
            "cpu_s": results["cpu"][2],
            "cuda_s": results["cuda"][2],
        }
        if not pixels:
            torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=1e-5, atol=1e-6)
            if float(diffs.max()) > 2e-4 or close < 0.999:
                raise AssertionError(f"PPO {name} parameters after one update on the card differ from the CPU: {row}")
        row["stepwise"] = _ppo_stepwise(cfg, spaces, n_actions, data, perms)
        log(f"PPO update {name} (card vs CPU): " + json.dumps(row))
        out[name] = row
    return out


# -- 10. PPO run -----------------------------------------------------------------


def _profile_ppo_update(checkpoint: str, guard: bool = False) -> dict:
    """One full-recipe update (512 rows, 10 x 8 minibatches) from the run's
    checkpoint on a synthetic rollout, after one warm-up update: host time
    (ending in the losses' read) and device time and operations from
    ``torch.profiler``; with ``guard`` the update the loop runs by default
    (each minibatch guarded, the skipped count read with the losses)."""
    cfg = load_config(find_run_config(checkpoint))
    state = load_checkpoint(checkpoint)
    agent, _ = build_ppo_agent(cfg, (2,), False, cfg.spaces.obs, "cuda", state["agent"])
    optimizer = make_ppo_optimizer(cfg, agent)
    optimizer.load_state_dict(state["optimizer"])
    rows = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
    update = make_ppo_train_step(agent, optimizer, cfg, rows, guard=guard)
    data = {k: v.cuda() for k, v in _ppo_batch(np.random.default_rng(10), rows, False, 2).items()}
    gen = torch.Generator(device="cuda").manual_seed(11)

    def train():  # ends in the loop's one read
        losses, skipped = update(data, 0.2, 0.0, generator=gen)
        return torch.cat([losses, skipped.reshape(1)]).cpu()

    train()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        train()
        host.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        train()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
    return {
        "guard": guard,
        "host_ms": float(np.median(host) * 1e3),
        "host_ms_all": [h * 1e3 for h in host],
        "device_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": device_us / 1e3 / (np.median(host) * 1e3) if device_us > 0 else None,
        "device_ops": sum(e.count for e in events),
        "top": [{"name": e.key[:80], "device_ms": getattr(e, "self_device_time_total", 0.0) / 1e3, "count": e.count}
                for e in top],
    }


def _ppo_launch_check(summary: dict, launches: dict) -> None:
    want = {name: 0 for name in kernels.LAUNCHES}
    want["gae"] = summary["iterations"]
    if launches != want:
        raise AssertionError(f"PPO launches {launches} != {want} for {summary['iterations']} iterations")


def ppo_run_phase(workdir: str) -> dict:
    """PPO on CartPole-v1 through ``run`` at the full recipe's widths, cut to
    PPO_ITERATIONS iterations of 4 envs x 128 steps. ``gae`` launched exactly once per iteration and no
    other kernel; every loss finite; the mean return of the last
    PPO_LAST_EPISODES episodes at least PPO_RETURN_BAR; then a resume from
    the last checkpoint for one more iteration, its counters going on."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    steps = PPO_ITERATIONS * 4 * 128
    summary = cli.run([f"preset={PPO_PRESET}", f"algo.total_steps={steps}", "metric.log_level=0", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    iters = summary["iterations"]
    if iters != PPO_ITERATIONS or summary["device"].split(":")[0] != "cuda" or summary["policy_steps"] != steps:
        raise AssertionError(f"PPO run took {iters} iterations, {summary['policy_steps']} steps on {summary['device']}")
    _ppo_launch_check(summary, launches)
    if not np.isfinite(np.asarray(summary["losses"])).all():
        raise AssertionError(f"non-finite PPO losses: {summary['losses']}")
    returns = [ret for _, _, ret, _ in summary["episodes"]]
    last = float(np.mean(returns[-PPO_LAST_EPISODES:]))
    if len(returns) < PPO_LAST_EPISODES or last < PPO_RETURN_BAR:
        raise AssertionError(f"PPO did not learn CartPole: mean return of the last {PPO_LAST_EPISODES} episodes {last}")
    rollout_ms = [s * 1e3 for s in summary["rollout_s"]]
    gae_ms = [s * 1e3 for s in summary["gae_s"]]
    update_ms = [s * 1e3 for s in summary["update_s"]]
    out = {
        "iterations": iters,
        "policy_steps": summary["policy_steps"],
        "launches": launches,
        "wall_s": wall,
        "env_steps_per_s": summary["env_steps_per_s"],
        "host_ms_per_iteration": {
            "rollout_median": float(np.median(rollout_ms)), "gae_median": float(np.median(gae_ms)),
            "update_median": float(np.median(update_ms)), "rollout_range": [min(rollout_ms), max(rollout_ms)],
            "gae_range": [min(gae_ms), max(gae_ms)], "update_range": [min(update_ms), max(update_ms)],
        },
        "episodes": len(returns),
        "first_10_mean_return": float(np.mean(returns[:10])),
        "last_10_mean_return": last,
        # where the run would stand cut to half its depth
        "last_10_mean_return_at_half": float(np.mean(
            [ret for step, _, ret, _ in summary["episodes"] if step <= summary["policy_steps"] // 2][-PPO_LAST_EPISODES:])),
        "test_reward": summary["test_reward"],
        "losses_first": dict(zip(PPO_LOSS_NAMES, summary["losses"][0])),
        "losses_last": dict(zip(PPO_LOSS_NAMES, summary["losses"][-1])),
        "checkpoint": summary["checkpoint"],
    }
    log("PPO run: " + json.dumps({k: v for k, v in out.items() if k != "checkpoint"}))

    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                       f"algo.total_steps={summary['policy_steps'] + 512}", "algo.run_test=false",
                       f"log_root={workdir}"])
    resume_launches = dict(kernels.LAUNCHES)
    if resumed["start_iter"] != iters + 1 or resumed["iterations"] != 1 or resumed["policy_steps"] != steps + 512:
        raise AssertionError(f"PPO resume: start {resumed['start_iter']}, {resumed['iterations']} iterations, "
                             f"{resumed['policy_steps']} steps")
    _ppo_launch_check(resumed, resume_launches)
    if not np.isfinite(np.asarray(resumed["losses"])).all():
        raise AssertionError(f"non-finite PPO losses after the resume: {resumed['losses']}")
    out["resume"] = {"start_iter": resumed["start_iter"], "policy_steps": resumed["policy_steps"],
                     "launches": resume_launches, "losses": resumed["losses"]}
    log("PPO resume: " + json.dumps(out["resume"]))
    out["profile"] = _profile_ppo_update(summary["checkpoint"])
    log("PPO update profile: " + json.dumps(out["profile"]))
    out["profile_guarded"] = _profile_ppo_update(summary["checkpoint"], guard=True)
    log("guarded PPO update profile: " + json.dumps(out["profile_guarded"]))
    return out


# -- 11. sumtree --------------------------------------------------------------------


def l2_latency_ns(chase_lib: str, hops: int = 1 << 20) -> float:
    """One L2 hit's latency: the pointer chase's time per dependent hop."""
    import ctypes

    lib = ctypes.CDLL(chase_lib)
    lib.chase_launch.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.chase_launch.restype = ctypes.c_int
    stride = SECTOR_BYTES // 4  # one node per sector
    nodes = (8 << 20) // SECTOR_BYTES
    order = np.random.default_rng(12).permutation(nodes).astype(np.int64) * stride
    table = np.zeros(nodes * stride, np.uint32)
    table[order] = np.roll(order, -1)  # one random cycle through every node
    table_d = torch.from_numpy(table).cuda()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(n: int) -> None:
        if lib.chase_launch(table_d.data_ptr(), int(order[0]), n, out.data_ptr(), stream) != 0:
            raise RuntimeError("the L2 pointer chase did not launch")

    run(nodes)  # the buffer into L2
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(hops)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e6 / hops


def launch_floor_ms(chase_lib: str) -> float:
    """The floor of one launch: an empty kernel's device time per call,
    timed as every kernel is (:func:`_graph_ms`)."""
    import ctypes

    lib = ctypes.CDLL(chase_lib)
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int

    def run() -> None:
        if lib.empty_launch(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty kernel did not launch")

    floor = _graph_ms(run)
    log(f"launch floor (an empty kernel, graph-replayed): {floor * 1e3:.3f} us")
    return floor


def _sumtree_inputs(gen, leaves: int, batch: int):
    """A tree of ``leaves`` leaves, a tenth of them padding past the filled
    ones (always zero), every seventh filled leaf zero; ``batch`` uniforms
    with 0 and values just under 1 among them."""
    from sheeprl_tpu_torch.replay import sumtree as st

    filled = leaves - leaves // 10
    prios = torch.rand(filled, generator=gen, device="cuda") * 2.0 + 0.01
    prios[::7] = 0.0
    tree = st.update(st.init(filled, "cuda"), torch.arange(filled, device="cuda"), prios)
    u = torch.rand(batch, generator=gen, device="cuda")
    edges = torch.tensor([0.0, float(np.nextafter(np.float32(1), np.float32(0))), 1 - 1e-7], device="cuda")
    u[: min(batch, 3)] = edges[: min(batch, 3)]
    return tree, u, prios, filled


def sumtree_bound(leaves: int, batch: int, l2_ns: float) -> dict:
    """The least time of ``batch`` proportional draws from a tree of
    ``leaves`` leaves: a descent is a chain of dependent reads, each costing
    one L2 hit (``l2_ns``), and every byte moves at the card's memory rate.

    A read of 2^k aligned nodes settles k levels: node i's descendants k
    levels down are nodes [i 2^k, (i + 1) 2^k), and every internal node is
    the exact f32 sum of its children, so the nodes between follow from
    them. The first read, nodes [0, 2^k), is the same for every draw (read
    once) and holds the root and k - 1 levels; each later one is per draw
    (at least one 32-byte sector), its last holding the leaf the weight
    needs. Wider reads mean fewer hops and more bytes: the bound is the
    best k's max(bytes, hops x l2_ns), from one sector per hop (k = 3, 3
    levels a hop) to the whole tree in one read (k = levels + 1)."""
    levels = leaves.bit_length() - 1
    best = None
    for k in range(3, levels + 2):
        settled, hops, moved = min(k - 1, levels), 1, 4 << k
        while settled < levels:
            step = min(k, levels - settled)
            hops, settled = hops + 1, settled + step
            moved += batch * max(SECTOR_BYTES, 4 << step)
        moved += 12 * batch  # its uniform in, its leaf and weight out
        bytes_ms, chain_ms = moved / HBM_BYTES_PER_S * 1e3, hops * l2_ns * 1e-6
        cand = {"bound_ms": max(bytes_ms, chain_ms), "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
                "bytes_ms": bytes_ms, "chain_ms": chain_ms, "hops": hops, "hop_nodes": 1 << k}
        if best is None or cand["bound_ms"] < best["bound_ms"]:
            best = cand
    return best


def sumtree_phase(chase_lib: str, beta: float = 0.55) -> dict:
    """The kernel against its plain version on the same tree and uniforms at
    every shape: the leaves equal, no zero-priority or padding leaf drawn,
    the weights within rtol 1e-6 (``powf`` against ``torch.pow``, one ulp);
    the gradient through the ``autograd.Function`` against the plain
    chain's within 1e-5. ``ms``/``plain_ms`` are device time per call
    (:func:`_graph_ms`); the bound is :func:`sumtree_bound` at the pointer
    chase's L2 hit."""
    l2_ns = l2_latency_ns(chase_lib)
    log(f"L2 hit latency (pointer chase): {l2_ns:.1f} ns")
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for leaves, batch in SUMTREE_SHAPES:
        tree, u, prios, filled = _sumtree_inputs(gen, leaves, batch)
        leaf, w = kernels.sumtree_sample(tree, u, filled, beta)
        torch.cuda.synchronize()
        want_leaf, want_w = kernels.sumtree_sample_reference(tree, u, filled, beta)
        if not torch.equal(leaf, want_leaf):
            raise AssertionError(f"sumtree_sample leaves differ from the plain version at ({leaves}, {batch})")
        if bool((leaf.long() >= filled).any()) or bool((prios[leaf.long().clamp(max=filled - 1)] <= 0).any()):
            raise AssertionError(f"sumtree_sample drew a zero-priority leaf at ({leaves}, {batch})")
        torch.testing.assert_close(w, want_w, rtol=1e-6, atol=0)
        err = float(((w - want_w).abs() / want_w.abs()).max())
        abs_err = float((w - want_w).abs().max())
        big = leaves * batch > 1 << 28
        row = {"leaves": leaves, "batch": batch, "max_rel_err": err, "max_abs_err": abs_err,
               "ms": _graph_ms(lambda: kernels.sumtree_sample(tree, u, filled, beta)),
               "plain_ms": _graph_ms(lambda: kernels.sumtree_sample_reference(tree, u, filled, beta),
                                     per_graph=5 if big else 20, replays=5 if big else 20),
               "call_ms": _time_ms(lambda: kernels.sumtree_sample(tree, u, filled, beta), 200)}
        row.update(sumtree_bound(leaves, batch, l2_ns))
        rows.append(row)
        log(f"sumtree_sample P={leaves} B={batch}: rel err {err:.3g} kernel {row['ms'] * 1e3:.2f} us "
            f"(call {row['call_ms'] * 1e3:.2f} us) plain {row['plain_ms'] * 1e3:.2f} us bound {row['bound_ms'] * 1e3:.3f} us "
            f"({row['bound_by']}: {row['hops']} hops of {row['hop_nodes']} nodes, bytes {row['bytes_ms'] * 1e3:.4f} us, "
            f"chain {row['chain_ms'] * 1e3:.3f} us)")
    # the sweep of k, the tree levels settled per dependent read, at the SAC shape
    from sheeprl_tpu_torch.ops.kernels import sumtree as sumtree_module

    tree, u, _, filled = _sumtree_inputs(gen, *SUMTREE_MAIN)
    want_leaf, want_w = kernels.sumtree_sample_reference(tree, u, filled, beta)
    sweep = []
    for k in SUMTREE_HOP_SWEEP:
        leaf, w = sumtree_module._launch(tree, u, filled, beta, hop_levels=k)
        torch.cuda.synchronize()
        if not torch.equal(leaf, want_leaf):
            raise AssertionError(f"sumtree_sample at k = {k} draws other leaves than the plain version")
        torch.testing.assert_close(w, want_w, rtol=1e-6, atol=0)
        sweep.append({"k": k, "ms": _graph_ms(lambda: sumtree_module._launch(tree, u, filled, beta, hop_levels=k))})
    log("sumtree_sample k sweep at (2^20, 256): " + ", ".join(f"k={r['k']} {r['ms'] * 1e3:.3f} us" for r in sweep)
        + f"; the wrapper uses k={sumtree_module.HOP_LEVELS}")
    # the gradient through the autograd.Function against the plain chain's
    tree, u, _, filled = _sumtree_inputs(gen, 1 << 10, 256)
    scale = torch.rand(256, generator=gen, device="cuda")
    grads = []
    for fn in (kernels.sumtree_sample, kernels.sumtree_sample_reference):
        t = tree.clone().requires_grad_(True)
        (fn(t, u, filled, beta)[1] * scale).sum().backward()
        grads.append(t.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-5)
    grad_err = float((grads[0] - grads[1]).abs().max())
    log(f"sumtree_sample backward: max err {grad_err:.3g} against the plain chain")
    main = next(r for r in rows if (r["leaves"], r["batch"]) == SUMTREE_MAIN)
    return {
        "name": "sumtree_sample",
        "route": "cuda",
        "source": "sheeprl_tpu_torch/csrc/sumtree.cu",
        "replaces": "sheeprl_tpu/ops/kernels/sumtree.py:68",
        "launches": None,  # filled from the SAC run phase
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the descent and the weights
        "call_ms": main["call_ms"],
        "bytes_ms": main["bytes_ms"],
        "chain_ms": main["chain_ms"],
        "hops": main["hops"],
        "hop_nodes": main["hop_nodes"],
        "hop_levels": sumtree_module.HOP_LEVELS,
        "hop_sweep": sweep,
        "l2_hit_ns": l2_ns,
        "leaves_exact": True,
        "max_rel_err": max(r["max_rel_err"] for r in rows),
        "grad_max_abs_err": grad_err,
        "shapes": rows,
    }


# -- 12. one SAC dispatch on the card against the CPU -----------------------------


def _sac_parts(cfg, device: str, agent_state=None):
    from sheeprl_tpu_torch.algos.sac.agent import build_agent as build_sac_agent
    from sheeprl_tpu_torch.algos.sac.sac import make_optimizers as make_sac_optimizers

    space = {"shape": [1], "low": [-2.0], "high": [2.0]}  # Pendulum-v1's torque
    agent, _ = build_sac_agent(cfg, 3, space, device, agent_state)
    return agent, make_sac_optimizers(cfg, agent)


def _sac_ring(cfg, device: str):
    from sheeprl_tpu_torch.algos.sac.sac import _ring_specs
    from sheeprl_tpu_torch.replay import DeviceReplayBuffer

    per = cfg.buffer.priority
    n_envs = int(cfg.env.num_envs)
    return DeviceReplayBuffer(_ring_specs(3, 1), int(cfg.buffer.size) // n_envs, n_envs, device=device,
                              prioritized=True, per_alpha=float(per.alpha), per_eps=float(per.eps), seed=int(cfg.seed) + 29)


def sac_update_phase(filled_rows: int = 4096, beta: float = 0.5) -> dict:
    """One device-resident dispatch at the full ``sac_per`` width on the
    card against the CPU, TF32 off: a ring of 250,000 x 4 holding
    ``filled_rows`` random rows at random priorities (``max_p`` 2.5), one
    staged row appended (its fresh leaves at ``max_p``), then the 4 granted
    PER steps, each run on both machines from the card's state just before
    it (weights, Adam, sum-tree, ``max_p``) with the same uniforms and noise:

    - the drawn batch is the same on both (the kernel's leaves equal the
      plain version's), so the step's three losses agree within rtol 1e-5
      (atol 1e-6 for the entropy loss near 0): float32 sums in another order;
    - every parameter within 2e-5: Adam moves an element by up to lr / eps =
      3 times a gradient rounding where the gradient is near 0;
    - the sum-tree and ``max_p`` within rtol 1e-5 (atol 1e-5): the written
      priorities are |TD|s of those float32 forwards, summed in the same pairs."""
    from sheeprl_tpu_torch.algos.sac.sac import make_resident_train_step
    from sheeprl_tpu_torch.replay import DeviceReplayState
    from sheeprl_tpu_torch.replay import sumtree as st

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset(SAC_PRESET)
    rng = np.random.default_rng(14)
    agents = {dev: _sac_parts(cfg, dev) for dev in ("cpu", "cuda")}
    rings = {dev: _sac_ring(cfg, dev) for dev in ("cpu", "cuda")}
    capacity, n_envs, B = rings["cpu"].capacity, rings["cpu"].n_envs, int(cfg.algo.per_rank_batch_size)
    arrays = {}
    for k, (shape, _) in rings["cpu"].specs.items():
        full = np.zeros((capacity, n_envs) + shape, np.float32)
        full[:filled_rows] = rng.normal(size=(filled_rows, n_envs) + shape)
        arrays[f"storage/{k}"] = torch.from_numpy(full)
    arrays["storage/terminated"].zero_()
    leaves = filled_rows * n_envs
    arrays["tree"] = st.update(st.init(capacity * n_envs), torch.arange(leaves),
                               torch.from_numpy(rng.uniform(0.05, 2.0, size=leaves).astype(np.float32)))
    arrays["max_p"] = torch.tensor(2.5)
    meta = {"capacity": capacity, "n_envs": n_envs, "prioritized": True, "host_pos": filled_rows, "host_full": False}
    staged = {k: rng.normal(size=(1, n_envs) + shape).astype(np.float32) for k, (shape, _) in rings["cpu"].specs.items()}
    for drb in rings.values():  # each keeps its own generator: the steps take their draws as arguments
        drb.load_state_dict(DeviceReplayState("uniform", {**arrays, "key": drb.generator.get_state()}, meta))
        drb.add(staged)
    trains = {dev: make_resident_train_step(agents[dev][0], agents[dev][1], cfg, rings[dev]) for dev in rings}
    for dev in rings:  # the append alone
        trains[dev](rings[dev].make_job(), [], beta)
    if not torch.equal(rings["cuda"].tree.cpu(), rings["cpu"].tree) or float(rings["cuda"].max_p) != 2.5:
        raise AssertionError("the appended fresh leaves differ between the card and the CPU")
    gen = torch.Generator().manual_seed(15)
    worst = {"loss_rel": 0.0, "param": 0.0, "tree": 0.0, "max_p": 0.0}
    losses_cpu = []
    for g in range(4):
        card_agent, card_opts = agents["cuda"]
        cpu_agent, cpu_opts = agents["cpu"]
        cpu_agent.load_state_dict(card_agent.state_dict())
        for a, b in zip(cpu_opts, card_opts):  # a copy: load_state_dict shares same-device tensors
            a.load_state_dict(copy.deepcopy(b.state_dict()))
        rings["cpu"].tree.copy_(rings["cuda"].tree.cpu())
        rings["cpu"].max_p.copy_(rings["cuda"].max_p.cpu())
        draws = {"u": torch.rand((1, B), generator=gen), "next": torch.randn((1, B, 1), generator=gen),
                 "actor": torch.randn((1, B, 1), generator=gen)}
        out = {}
        for dev in ("cuda", "cpu"):
            job = rings[dev].make_job()  # nothing staged: the step samples the ring as it is
            out[dev] = trains[dev](job, [1.0], beta, draws={k: v.to(dev) for k, v in draws.items()})[0].cpu()
        torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-6)
        losses_cpu.append(out["cpu"].tolist())
        worst["loss_rel"] = max(worst["loss_rel"], float(((out["cuda"] - out["cpu"]).abs() / out["cpu"].abs().clamp(min=1e-12)).max()))
        card_state, cpu_state = card_agent.state_dict(), cpu_agent.state_dict()
        diff = max(float((card_state[k].cpu() - cpu_state[k]).abs().max()) for k in cpu_state)
        if diff > 2e-5:
            raise AssertionError(f"SAC step {g} on the card moved a parameter {diff} away from the CPU's")
        torch.testing.assert_close(rings["cuda"].tree.cpu(), rings["cpu"].tree, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(rings["cuda"].max_p.cpu(), rings["cpu"].max_p, rtol=1e-5, atol=1e-5)
        worst["param"] = max(worst["param"], diff)
        worst["tree"] = max(worst["tree"], float((rings["cuda"].tree.cpu() - rings["cpu"].tree).abs().max()))
        worst["max_p"] = max(worst["max_p"], abs(float(rings["cuda"].max_p) - float(rings["cpu"].max_p)))
    out = {"steps": 4, "losses_cpu": losses_cpu, "loss_max_rel_err": worst["loss_rel"], "param_max_abs_err": worst["param"],
           "tree_max_abs_err": worst["tree"], "max_p_abs_err": worst["max_p"], "max_p": float(rings["cuda"].max_p)}
    log("SAC update (card vs CPU, per step): " + json.dumps(out))
    return out


# -- 13. SAC run ----------------------------------------------------------------


def _profile_sac_dispatch(checkpoint: str) -> dict:
    """One full-width dispatch (append + 4 PER steps) from the run's
    checkpoint as the loop runs it by default (each step guarded, the
    skipped count read after it), after warm-up dispatches: host time (ending
    in a synchronize), and device time and operations from
    ``torch.profiler``, with ``sumtree_sample``'s share."""
    from sheeprl_tpu_torch.algos.sac.sac import make_resident_train_step
    from sheeprl_tpu_torch.replay import DeviceReplayState

    cfg = load_config(find_run_config(checkpoint))
    state = load_checkpoint(checkpoint)
    agent, optimizers = _sac_parts(cfg, "cuda", state["agent"])
    for opt, name in zip(optimizers, ("actor_optimizer", "qf_optimizer", "alpha_optimizer")):
        opt.load_state_dict(state[name])
    drb = _sac_ring(cfg, "cuda").load_state_dict(DeviceReplayState.from_dict(state["rb"]))
    train = make_resident_train_step(agent, optimizers, cfg, drb, guard=True)
    rng = np.random.default_rng(16)

    def dispatch():
        drb.add({k: rng.normal(size=(1, 4) + shape).astype(np.float32) for k, (shape, _) in drb.specs.items()})
        return float(train(drb.make_job(), [1.0] * 4, 1.0)[1])

    for _ in range(3):
        dispatch()
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        dispatch()
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    kern_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events if "sumtree_sample" in e.key)
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    return {
        "guard": True,
        "host_ms": float(np.median(host) * 1e3),
        "host_ms_all": [h * 1e3 for h in host],
        "device_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": device_us / 1e3 / (np.median(host) * 1e3) if device_us > 0 else None,
        "device_ops": sum(e.count for e in events),
        "sumtree_sample": {"device_ms": kern_us / 1e3, "share": kern_us / device_us if device_us > 0 else None,
                           "ops": sum(e.count for e in events if "sumtree_sample" in e.key)},
        "top": [{"name": e.key[:80], "device_ms": getattr(e, "self_device_time_total", 0.0) / 1e3, "count": e.count}
                for e in top],
    }


def _sac_launch_check(summary: dict, launches: dict) -> None:
    want = {name: 0 for name in kernels.LAUNCHES}
    want["sumtree_sample"] = summary["gradient_steps"]
    if launches != want:
        raise AssertionError(f"SAC launches {launches} != {want} for {summary['gradient_steps']} gradient steps")


def sac_run_phase(workdir: str) -> dict:
    """SAC with PER on Pendulum-v1 through ``run`` at full width,
    ``total_steps`` 16,384 (4,096 iterations of 4 envs): ``sumtree_sample``
    launched exactly once per gradient step and no other kernel; every loss
    finite; the best mean return over SAC_WINDOW consecutive episodes at
    least SAC_RETURN_BAR. Then a resume from the last checkpoint for
    SAC_RESUME_ITERATIONS iterations: the ring, the sum-tree, ``max_p`` and
    the draw generator it restores equal the checkpoint's, and its counters
    go on; then the guarded dispatch (the loop's default) under
    ``torch.profiler``."""
    from sheeprl_tpu_torch.algos.sac import sac as sac_module
    from sheeprl_tpu_torch.replay import DeviceReplayState

    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run([f"preset={SAC_PRESET}", f"algo.total_steps={SAC_TOTAL_STEPS}", "metric.log_level=0",
                       f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    iters = SAC_TOTAL_STEPS // 4
    if (summary["iterations"] != iters or summary["device"].split(":")[0] != "cuda" or not summary["prioritized"]
            or summary["policy_steps"] != SAC_TOTAL_STEPS):
        raise AssertionError(f"SAC run: {summary['iterations']} iterations on {summary['device']}, "
                             f"prioritized {summary['prioritized']}")
    _sac_launch_check(summary, launches)
    if not np.isfinite(np.asarray(summary["losses"])).all() or len(summary["losses"]) != summary["train_calls"]:
        raise AssertionError("non-finite or missing SAC losses")
    returns = [ret for _, _, ret, _ in summary["episodes"]]
    windows = [float(np.mean(returns[i:i + SAC_WINDOW])) for i in range(len(returns) - SAC_WINDOW + 1)]
    best = max(windows) if windows else float("-inf")
    if best < SAC_RETURN_BAR:
        raise AssertionError(f"SAC did not learn Pendulum: best mean of {SAC_WINDOW} episodes {best}")
    env_ms, train_ms = (np.asarray(summary[k]) * 1e3 for k in ("env_s", "train_s"))
    learning = int(preset(SAC_PRESET).algo.learning_starts) // 4  # the warm-up iterations train nothing
    out = {
        "iterations": summary["iterations"],
        "policy_steps": summary["policy_steps"],
        "gradient_steps": summary["gradient_steps"],
        "dispatches": summary["replay"]["Replay/flushes"],
        "launches": launches,
        "wall_s": wall,
        "env_steps_per_s": summary["env_steps_per_s"],
        "host_ms_per_iteration": {
            "env_median": float(np.median(env_ms)), "env_range": [float(env_ms.min()), float(env_ms.max())],
            "train_median": float(np.median(train_ms[learning:])),
            "train_range": [float(train_ms[learning:].min()), float(train_ms[learning:].max())],
        },
        "episodes": len(returns),
        "first_10_mean_return": float(np.mean(returns[:SAC_WINDOW])),
        "best_10_mean_return": best,
        "last_10_mean_return": float(np.mean(returns[-SAC_WINDOW:])),
        "test_reward": summary["test_reward"],
        "losses_first": dict(zip(sac_module.LOSS_NAMES, summary["losses"][0])),
        "losses_last": dict(zip(sac_module.LOSS_NAMES, summary["losses"][-1])),
        "replay": summary["replay"],
        "checkpoint": summary["checkpoint"],
    }
    log("SAC run: " + json.dumps({k: v for k, v in out.items() if k != "checkpoint"}))

    saved = DeviceReplayState.from_dict(load_checkpoint(summary["checkpoint"])["rb"])
    restored = {}

    class _Recording(sac_module.DeviceReplayBuffer):
        def load_state_dict(self, snap):
            super().load_state_dict(snap)
            restored.update(self.state_dict().arrays)
            return self

    kernels.reset_launches()
    sac_module.DeviceReplayBuffer = _Recording
    try:
        resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0", "algo.run_test=false",
                           f"algo.total_steps={SAC_TOTAL_STEPS + 4 * SAC_RESUME_ITERATIONS}", "checkpoint.save_last=false",
                           f"log_root={_log_root(summary)}"])
    finally:
        sac_module.DeviceReplayBuffer = _Recording.__bases__[0]
    resume_launches = dict(kernels.LAUNCHES)
    same = {k: torch.equal(restored[k], v) for k, v in saved.arrays.items()}
    if not all(same.values()):
        raise AssertionError(f"the resume restored a different ring: {same}")
    if (resumed["start_iter"] != iters + 1 or resumed["iterations"] != SAC_RESUME_ITERATIONS
            or resumed["gradient_steps"] == 0):
        raise AssertionError(f"SAC resume: start {resumed['start_iter']}, {resumed['iterations']} iterations, "
                             f"{resumed['gradient_steps']} gradient steps")
    _sac_launch_check(resumed, resume_launches)
    out["resume"] = {"start_iter": resumed["start_iter"], "policy_steps": resumed["policy_steps"],
                     "gradient_steps": resumed["gradient_steps"], "launches": resume_launches,
                     "restored_equal": sorted(same), "losses": resumed["losses"]}
    log("SAC resume: " + json.dumps({k: v for k, v in out["resume"].items() if k != "losses"}))
    out["profile_guarded"] = _profile_sac_dispatch(summary["checkpoint"])
    log("guarded SAC dispatch profile: " + json.dumps(out["profile_guarded"]))
    return out


# -- 14. ragged_ring_scatter --------------------------------------------------------


def _parking_scatter(storage, staged, row, pos, col_offset: int = 0):
    """The plain version in the JAX docstring's parking form, which reads
    nothing back and so can be graph-timed: a dropped slot rewrites the old
    bytes of the row before its env's head, ``(pos - 1) % C``. Equal to
    ``ragged_ring_scatter_reference`` (the literal masked scatter, whose
    boolean indexing waits for the host). Returns the one ``index_put_``'s
    operands for the library column."""
    C = storage.shape[0]
    S, e = row.shape
    m = row < C
    cols = col_offset + torch.arange(e, device=row.device).expand(S, e)
    safe_row = torch.where(m, row, ((pos.to(row.dtype) - 1) % C)[None, :]).long()
    keep = m.reshape(S, e, *([1] * (staged.ndim - 2)))
    vals = torch.where(keep, staged, storage[safe_row, cols])
    storage.index_put_((safe_row, cols), vals)
    return safe_row, cols, vals


def _scatter_rows(gen, C: int, S: int, e: int, *, wrap: bool = False, drop: str = "ragged"):
    """Heads and the ``ring_append_rows`` row table of a staged ``(S, e)``
    mask: ``drop`` "none" writes every slot, "ragged" drops some, "column"
    drops every slot of env 0. ``wrap`` puts the heads just before ``C``."""
    from sheeprl_tpu_torch.data.ring import ring_append_rows

    mask = torch.ones((S, e), dtype=torch.int32, device="cuda")
    if drop == "ragged":
        mask[S - 1, ::2] = 0
    elif drop == "column":
        mask[:, 0] = 0
    pos = torch.randint(0, C, (e,), generator=gen, device="cuda", dtype=torch.int32)
    if wrap:
        pos[:] = C - 1
    valid = torch.full((e,), C, dtype=torch.int32, device="cuda")
    row, _, _ = ring_append_rows(pos, valid, mask, C)
    return row, pos


def _scatter_key(gen, C: int, E: int, S: int, e: int, feat: tuple, dtype, misalign: int = 0):
    """A ring of ``C`` rows and ``E`` env columns, and ``(S, e)`` staged rows
    cut from a byte buffer at ``misalign`` bytes (an unpacked upload's
    segments are only 4-byte aligned)."""
    if dtype == torch.uint8:
        storage = torch.randint(0, 256, (C, E) + feat, generator=gen, device="cuda", dtype=torch.uint8)
        fresh = torch.randint(0, 256, (S, e) + feat, generator=gen, device="cuda", dtype=torch.uint8)
    else:
        storage = torch.randn((C, E) + feat, generator=gen, device="cuda", dtype=dtype)
        fresh = torch.randn((S, e) + feat, generator=gen, device="cuda", dtype=dtype)
    n = fresh.numel() * fresh.element_size()
    buf = torch.zeros(n + 64, dtype=torch.uint8, device="cuda")
    buf[misalign:misalign + n] = fresh.reshape(-1).view(torch.uint8)
    return storage, buf[misalign:misalign + n].view(dtype).reshape(fresh.shape)


def _scatter_case(gen, C: int, E: int, S: int, e: int, feat: tuple, dtype, col_offset: int, *, wrap: bool = False,
                  drop: str = "ragged", misalign: int = 0):
    """One key's ring and staged rows (:func:`_scatter_key`) and their row
    table (:func:`_scatter_rows`)."""
    row, pos = _scatter_rows(gen, C, S, e, wrap=wrap, drop=drop)
    storage, staged = _scatter_key(gen, C, E, S, e, feat, dtype, misalign)
    return storage, staged, row, pos, col_offset


def _scatter_check(storage, staged, row, pos, col_offset) -> dict:
    """The kernel against the plain version on copies of the same ring:
    bit-equal; every row the call does not write keeps its bytes, the row
    before each env's head too; one launch."""
    got, want = storage.clone(), storage.clone()
    before = kernels.LAUNCHES["ragged_ring_scatter"]
    out = kernels.ragged_ring_scatter(got, staged, row, pos, col_offset)
    torch.cuda.synchronize()
    if out.data_ptr() != got.data_ptr() or kernels.LAUNCHES["ragged_ring_scatter"] != before + 1:
        raise AssertionError("ragged_ring_scatter did not update the ring in place with one launch")
    kernels.ragged_ring_scatter_reference(want, staged, row, pos, col_offset)
    if not torch.equal(got, want):
        raise AssertionError(f"ragged_ring_scatter differs from its plain version at ring {tuple(storage.shape)}, "
                             f"staged {tuple(staged.shape)} {staged.dtype}, col_offset {col_offset}")
    parked_ring = storage.clone()
    _parking_scatter(parked_ring, staged, row, pos, col_offset)
    if not torch.equal(parked_ring, want):
        raise AssertionError("the parking form of the plain version differs from the literal one")
    return _untouched_check(storage, got, want, row, pos, col_offset)


def _untouched_check(storage, got, want, row, pos, col_offset) -> dict:
    """Every slot the call does not write keeps its bytes in ``got``, the row
    before each env's head too; the error of the written slots."""
    C = storage.shape[0]
    touched = torch.zeros(storage.shape[:2], dtype=torch.bool, device="cuda")
    m = row < C
    cols = col_offset + torch.arange(row.shape[1], device="cuda").expand_as(row)
    r, c = row[m].long(), cols[m]
    touched[r, c] = True
    if not torch.equal(got[~touched], storage[~touched]):
        raise AssertionError("ragged_ring_scatter changed a slot it does not write")
    parked_rows = ((pos.long() - 1) % C)
    for j in range(row.shape[1]):
        if not touched[parked_rows[j], col_offset + j] and not torch.equal(got[parked_rows[j], col_offset + j],
                                                                            storage[parked_rows[j], col_offset + j]):
            raise AssertionError("the row before an env's head lost its bytes")
    return {"written": int(m.sum()), "max_abs_err": float((got[r, c].double() - want[r, c].double()).abs().max())
            if bool(m.any()) else 0.0}


def _scatter_keys_check(storages: dict, staged: dict, row, pos, col_offset) -> dict:
    """Every key in one ``ragged_ring_scatter_keys`` launch against the
    per-key plain version on copies of the same rings: bit-equal, in place,
    one launch, untouched slots unchanged."""
    got = {k: v.clone() for k, v in storages.items()}
    before = kernels.LAUNCHES["ragged_ring_scatter"]
    out = kernels.ragged_ring_scatter_keys(got, staged, row, pos, col_offset)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["ragged_ring_scatter"] != before + 1 or any(out[k].data_ptr() != got[k].data_ptr() for k in got):
        raise AssertionError("ragged_ring_scatter_keys did not update every ring in place with one launch")
    err = 0.0
    for k, storage in storages.items():
        want = kernels.ragged_ring_scatter_reference(storage.clone(), staged[k], row, pos, col_offset)
        if not torch.equal(got[k], want):
            raise AssertionError(f"ragged_ring_scatter_keys differs from the plain version at key {k!r}: ring "
                                 f"{tuple(storage.shape)}, staged {tuple(staged[k].shape)} {staged[k].dtype}, "
                                 f"col_offset {col_offset}")
        err = max(err, _untouched_check(storage, got[k], want, row, pos, col_offset)["max_abs_err"])
    return {"keys": len(storages), "max_abs_err": err}


def scatter_bound(row, slot_bytes: int, capacity: int) -> dict:
    """The least time of one call: each written slot read once and written
    once (``slot_bytes``: a slot's bytes summed over the call's keys), the
    row indices read once, at the card's memory rate. The arithmetic (an
    address per slot) is nothing beside it."""
    written = int((row < capacity).sum())
    moved = 2 * written * slot_bytes + row.numel() * 4
    return {"bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bound_bytes": moved}


# the other keys of a keys case, after the case's own: every slot size (1, 18
# and 12,288 elements) and both dtypes of the DreamerV3 ring
SCATTER_OTHER_KEYS = [(torch.uint8, (64, 64, 3)), (torch.float32, (18,)), (torch.float32, (1,)), (torch.uint8, (1,)),
                      (torch.float32, (64, 64, 3))]


def _scatter_async_blob(gen) -> dict:
    """The async ring's append at the recipe's shape (``dreamer_sebulba``):
    one actor's blob of 16 staged rows x 4 envs of the 5 ring keys (8 regular
    rows, reset rows of some envs, padding rows dropped) into the
    12,500-row x 8-column ring at col_offset 4, two heads wrapping; bit-equal
    to the plain version and timed as the main path is, beside the plain
    version's parking form and one ``index_put_`` per key."""
    from sheeprl_tpu_torch.data.ring import make_seq_append_layout, pack_burst_blob, ring_append_rows, torch_dtype
    from sheeprl_tpu_torch.data.ring import unpack_burst_blob

    keys, C, E, local, S, off = _sebulba_keys(), 12_500, 8, 4, 16, 4
    rings = {k: (torch.randint(0, 256, (C, E) + shape, generator=gen, device="cuda", dtype=torch.uint8)
                 if np.dtype(dtype) == np.uint8 else
                 torch.randn((C, E) + shape, generator=gen, device="cuda", dtype=torch_dtype(dtype)))
             for k, (shape, dtype) in keys.items()}
    rng = np.random.default_rng(71)
    mask = np.zeros((S, local), np.int32)
    mask[:8] = 1
    mask[8:11] = [[0, 1, 0, 0], [1, 0, 0, 1], [0, 0, 1, 0]]
    values = {k: rng.integers(0, 256 if np.dtype(dtype) == np.uint8 else 2, (S, local) + shape).astype(dtype)
              for k, (shape, dtype) in keys.items()}
    values.update(__mask__=mask, __offset__=np.asarray(off, np.int32))
    layout = make_seq_append_layout(keys, local, S)
    u = unpack_burst_blob(pack_burst_blob(layout, values).cuda(), layout)
    staged = {k: u[k] for k in keys}
    pos = torch.tensor([C - 3, 100, 5_000, C - 1], dtype=torch.int32, device="cuda")
    row, _, _ = ring_append_rows(pos, torch.full((local,), C, dtype=torch.int32, device="cuda"), u["__mask__"], C)
    slot_bytes = sum(int(np.prod(shape)) * np.dtype(dtype).itemsize for shape, dtype in keys.values())
    stamp = {"staged": [S, local], "ring": [C, E], "col_offset": off, "written": int((row < C).sum()),
             **_scatter_keys_check(rings, staged, row, pos, off), **scatter_bound(row, slot_bytes, C)}
    stamp["ms"] = _graph_ms(lambda: kernels.ragged_ring_scatter_keys(rings, staged, row, pos, off))
    stamp["plain_ms"] = _graph_ms(lambda: [_parking_scatter(rings[k], staged[k], row, pos, off) for k in keys])
    puts = {k: _parking_scatter(rings[k], staged[k], row, pos, off) for k in keys}
    stamp["library_ms"] = _graph_ms(lambda: [rings[k].index_put_((r, c), v) for k, (r, c, v) in puts.items()])
    log(f"ragged_ring_scatter async blob ({S} x {local} at col_offset {off}, {stamp['written']} slots): "
        f"{stamp['ms'] * 1e3:.3f} us, plain {stamp['plain_ms'] * 1e3:.2f} us, index_put_ per key "
        f"{stamp['library_ms'] * 1e3:.2f} us, bound {stamp['bound_ms'] * 1e3:.4f} us")
    return stamp


def scatter_phase() -> dict:
    """``ragged_ring_scatter`` against its plain version on the card, bit for
    bit, at uint8 and f32, slots of 1, 18 and 12,288 elements, 1 and 2
    staged rows, 1 and 4 envs, column offsets 0 and 3, dropped slots, an
    all-dropped column, heads wrapping past C and staged rows at 16-, 4- and
    1-byte alignment; each case also through ``ragged_ring_scatter_keys``
    with 1, 2 and 5 keys of mixed dtypes and slot sizes sharing its row
    table. Then the main path: the DreamerV3 ring's 5 keys (the 100,000-row
    64x64x3 uint8 frame, 18 f32 actions, 3 f32 scalars) appended from a
    packed upload of 1 and 2 rows. ``ms`` is device time per call of the
    one 5-key launch at the 1-row append (:func:`_graph_ms`), beside the 5
    per-key launches it replaces (``per_key_ms``); ``plain_ms`` the parking
    form of the plain version over the keys, ``library_ms`` one
    ``index_put_`` per key (without the ``where`` and the gather before
    each). The gradients through the ``autograd.Function`` equal the plain
    scatter's."""
    from sheeprl_tpu_torch.data.ring import make_blob_layouts, pack_burst_blob, torch_dtype, unpack_burst_blob
    from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys

    gen = torch.Generator(device="cuda").manual_seed(17)
    cases, keys_cases = [], 0
    for dtype in (torch.uint8, torch.float32):
        for feat in ((1,), (18,), (64, 64, 3)):
            for S in (1, 2):
                for e in (1, 4):
                    for col_offset in (0, 3):
                        for drop in ("none", "ragged", "column") if e > 1 else ("none", "ragged"):
                            misalign = {0: 0, 1: 4, 2: 1}[len(cases) % 3] if dtype == torch.uint8 else 4 * (len(cases) % 2)
                            row, pos = _scatter_rows(gen, 97, S, e, wrap=len(cases) % 4 == 0, drop=drop)
                            storage, staged = _scatter_key(gen, 97, e + col_offset, S, e, feat, dtype, misalign)
                            res = _scatter_check(storage, staged, row, pos, col_offset)
                            others = [o for o in SCATTER_OTHER_KEYS if o != (dtype, feat)]
                            for n_keys in (1, 2, 5):
                                rings, blocks = {"case": storage}, {"case": staged}
                                for i, (kd, kf) in enumerate(others[: n_keys - 1]):
                                    cut = misalign if kd == torch.uint8 or misalign % 4 == 0 else 4
                                    rings[f"k{i}"], blocks[f"k{i}"] = _scatter_key(gen, 97, e + col_offset, S, e, kf, kd, cut)
                                keys_res = _scatter_keys_check(rings, blocks, row, pos, col_offset)
                                res["max_abs_err"] = max(res["max_abs_err"], keys_res["max_abs_err"])
                                keys_cases += 1
                            cases.append({"dtype": str(dtype).split(".")[-1], "feat": feat, "S": S, "e": e,
                                          "col_offset": col_offset, "drop": drop, "misalign": misalign, **res})
    log(f"ragged_ring_scatter: {len(cases)} cases bit-equal to the plain version, per key and through "
        f"ragged_ring_scatter_keys with 1, 2 and 5 keys ({keys_cases} calls)")
    # the main path: the DreamerV3 ring's 5 keys, one env, appended from a packed upload
    ring_keys = dreamer_ring_keys({"rgb": {"shape": [64, 64, 3]}}, ["rgb"], [], [18], with_is_first=True)
    C = 100_000
    rings = {}
    for k, (shape, dtype) in ring_keys.items():
        if np.dtype(dtype) == np.uint8:
            rings[k] = torch.randint(0, 256, (C, 1) + shape, generator=gen, device="cuda", dtype=torch.uint8)
        else:
            rings[k] = torch.randn((C, 1) + shape, generator=gen, device="cuda", dtype=torch_dtype(dtype))
    slot_bytes = sum(int(np.prod(shape)) * np.dtype(dtype).itemsize for shape, dtype in ring_keys.values())
    rng = np.random.default_rng(17)
    layouts = make_blob_layouts(ring_keys, 1, 1, (1, 2))
    main = {}
    for S in (1, 2):
        values = {k: rng.integers(0, 256 if np.dtype(dtype) == np.uint8 else 2, (S, 1) + shape).astype(dtype)
                  for k, (shape, dtype) in ring_keys.items()}
        values.update(__mask__=np.ones((S, 1), np.int32), __pos__=np.array([C - 1], np.int32),
                      __valid_n__=np.array([C], np.int32), __validmask__=np.zeros(1, np.float32))
        u = unpack_burst_blob(pack_burst_blob(layouts[S], values).cuda(), layouts[S])
        staged = {k: u[k] for k in ring_keys}
        pos = u["__pos__"]  # a wrap for the 2-row append
        row = ((pos[None, :] + torch.arange(S, device="cuda", dtype=torch.int32)[:, None]) % C).to(torch.int32)
        res = _scatter_keys_check(rings, staged, row, pos, 0)
        stamp = {"S": S, **res, **scatter_bound(row, slot_bytes, C)}
        stamp["ms"] = _graph_ms(lambda: kernels.ragged_ring_scatter_keys(rings, staged, row, pos))
        stamp["per_key_ms"] = _graph_ms(lambda: [kernels.ragged_ring_scatter(rings[k], staged[k], row, pos)
                                                 for k in ring_keys])
        stamp["call_ms"] = _time_ms(lambda: kernels.ragged_ring_scatter_keys(rings, staged, row, pos), 200)
        stamp["per_key_call_ms"] = _time_ms(lambda: [kernels.ragged_ring_scatter(rings[k], staged[k], row, pos)
                                                     for k in ring_keys], 200)
        stamp["plain_ms"] = _graph_ms(lambda: [_parking_scatter(rings[k], staged[k], row, pos) for k in ring_keys])
        # one index_put_ per key, rewriting the same bytes
        puts = {k: _parking_scatter(rings[k], staged[k], row, pos) for k in ring_keys}
        stamp["library_ms"] = _graph_ms(lambda: [rings[k].index_put_((r, c), v) for k, (r, c, v) in puts.items()])
        r, c, v = puts["rgb"]
        stamp["library_ms_frame"] = _graph_ms(lambda: rings["rgb"].index_put_((r, c), v))
        main[S] = stamp
        log(f"ragged_ring_scatter main path S={S}, {len(ring_keys)} keys: one launch {stamp['ms'] * 1e3:.3f} us "
            f"(call {stamp['call_ms'] * 1e3:.2f} us), {len(ring_keys)} per-key launches {stamp['per_key_ms'] * 1e3:.3f} us "
            f"(calls {stamp['per_key_call_ms'] * 1e3:.2f} us), plain {stamp['plain_ms'] * 1e3:.2f} us, index_put_ per key "
            f"{stamp['library_ms'] * 1e3:.2f} us (frame alone {stamp['library_ms_frame'] * 1e3:.2f} us), bound "
            f"{stamp['bound_ms'] * 1e3:.4f} us ({stamp['bound_bytes']} bytes)")
    del rings, puts
    async_blob = _scatter_async_blob(gen)
    # the gradients: the plain scatter's VJP, f32 keys only; one key, and every key of a ring
    storage, staged, row, pos, off = _scatter_case(gen, 13, 5, 2, 4, (3,), torch.float32, 1, drop="ragged")
    scale = torch.randn(storage.shape, generator=gen, device="cuda")
    grads = []
    for dev in ("cuda", "cpu"):
        s_leaf = storage.to(dev).clone().requires_grad_(True)
        t_leaf = staged.to(dev).clone().requires_grad_(True)
        out = kernels.ragged_ring_scatter(s_leaf.clone(), t_leaf, row.to(dev), pos.to(dev), off)
        (out * scale.to(dev)).sum().backward()
        grads.append((s_leaf.grad.cpu(), t_leaf.grad.cpu()))
    row, pos = _scatter_rows(gen, 13, 2, 4, drop="ragged")
    rings = {f"k{i}": _scatter_key(gen, 13, 5, 2, 4, kf, kd, 4) for i, (kd, kf) in enumerate(SCATTER_OTHER_KEYS)}
    scales = {k: torch.randn(s.shape, generator=gen, device="cuda") for k, (s, _) in rings.items() if s.is_floating_point()}
    for dev in ("cuda", "cpu"):
        leaves = {k: (s.to(dev).clone().requires_grad_(k in scales), t.to(dev).clone().requires_grad_(k in scales))
                  for k, (s, t) in rings.items()}
        out = kernels.ragged_ring_scatter_keys({k: s.clone() for k, (s, _) in leaves.items()},
                                               {k: t for k, (_, t) in leaves.items()}, row.to(dev), pos.to(dev), 1)
        sum((out[k] * scales[k].to(dev)).sum() for k in scales).backward()
        grads.append(tuple(g for k in scales for g in (leaves[k][0].grad.cpu(), leaves[k][1].grad.cpu())))
    for a, b in zip(grads[0] + grads[2], grads[1] + grads[3]):
        if not torch.equal(a, b):
            raise AssertionError("ragged_ring_scatter's gradient differs from the plain scatter's")
    log("ragged_ring_scatter backward: equal to the plain scatter's gradient, per key and for every key at once")
    m1 = main[1]
    return {
        "name": "ragged_ring_scatter",
        "route": "cuda",
        "source": "sheeprl_tpu_torch/csrc/ring_scatter.cu",
        "replaces": "sheeprl_tpu/ops/kernels/scatter.py:68",
        "launches": None,  # filled from the resident run phase
        "max_abs_err": max([c["max_abs_err"] for c in cases] + [m["max_abs_err"] for m in main.values()]),
        "ms": m1["ms"],
        "plain_ms": m1["plain_ms"],
        "bound_ms": m1["bound_ms"],
        "bound_by": m1["bound_by"],
        "library_ms": m1["library_ms"],  # one index_put_ per key, without the where and the gather before each
        "library_ms_frame": m1["library_ms_frame"],
        "per_key_ms": m1["per_key_ms"],
        "call_ms": m1["call_ms"],
        "per_key_call_ms": m1["per_key_call_ms"],
        "main_two_rows": main[2],
        "async_blob": async_blob,
        "cases": len(cases),
        "keys_cases": keys_cases,
        "grad_equal": True,
    }


# -- 15. one resident dispatch on the card against the CPU ----------------------------


def _resident_ring(rng, keys, capacity: int, n_envs: int) -> dict:
    ring = {"rgb": rng.integers(0, 256, (capacity, n_envs) + tuple(keys["rgb"][0])).astype(np.uint8)}
    ring["actions"] = np.eye(keys["actions"][0][0], dtype=np.float32)[rng.integers(0, keys["actions"][0][0], (capacity, n_envs))]
    ring["rewards"] = ((rng.random((capacity, n_envs, 1)) < 0.1) * 10).astype(np.float32)
    ring["terminated"] = (rng.random((capacity, n_envs, 1)) < 0.02).astype(np.float32)
    ring["is_first"] = (rng.random((capacity, n_envs, 1)) < 0.02).astype(np.float32)
    return ring


def resident_dispatch_phase() -> dict:
    """One device-resident dispatch (full width, B 4 x T 16, H 15) on the card
    against the same dispatch on the CPU, TF32 off: a ring of 256 rows x 2
    envs (env 0 full, env 1 filling) from a seed, a 2-row upload (a regular
    row and env 1's reset row, so env 0's second slot is dropped), one
    granted step with the same injected draws. The ring after the append and
    the windows bit-equal; the losses and parameters held as the train-step
    phase holds them (rtol 1e-4; every element within 2 * lr + 1e-6 and
    99.9 % within 1e-6); one scatter launch for the 5 ring keys on the card."""
    from sheeprl_tpu_torch.data.ring import make_blob_layouts, pack_burst_blob, ring_append_rows, ring_sample_windows
    from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B, C, E = 16, 4, 256, 2
    cfg = _run_cfg([f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}"])
    keys = dreamer_ring_keys(cfg.spaces.obs, ["rgb"], [], [18], with_is_first=True)
    spec = {"capacity": C, "n_envs": E, "grad_chunk": 1, "seq_len": T, "batch_size": B, "ring_keys": keys,
            "stage_buckets": (1, 2), "stage_max": 2}
    rng = np.random.default_rng(19)
    ring = _resident_ring(rng, keys, C, E)
    staged = {k: v[:2].copy() for k, v in _resident_ring(rng, keys, 2, E).items()}
    values = {**staged, "__mask__": np.array([[1, 1], [0, 1]], np.int32), "__pos__": np.array([40, 100], np.int32),
              "__valid_n__": np.array([C, 100], np.int32), "__validmask__": np.ones(1, np.float32)}
    layout = make_blob_layouts(keys, E, 1, (1, 2))[2]
    gen = torch.Generator().manual_seed(20)
    draws = {"env": torch.randint(0, E, (1, B), generator=gen), "u": torch.rand((1, B), generator=gen),
             "noise": [draw_noise(cfg, T, B, [18], gen, "cpu")]}
    results = {}
    for dev in ("cpu", "cuda"):
        modules = build_training_agent(cfg, dev)
        optimizers = make_optimizers(cfg, *modules[:3])
        burst = make_train_step(*modules, optimizers, cfg, ring=spec)
        rb = {k: torch.from_numpy(v.copy()).to(dev) for k, v in ring.items()}
        noise = draws["noise"][0]
        dev_draws = {"env": draws["env"].to(dev), "u": draws["u"].to(dev), "noise": [{
            "posterior": noise["posterior"].to(dev), "imagined_prior": noise["imagined_prior"].to(dev),
            "actions": [u.to(dev) for u in noise["actions"]]}]}
        before = kernels.LAUNCHES["ragged_ring_scatter"]
        t0 = time.perf_counter()
        _, rb, metrics = burst((init_moments(dev), 0), rb, pack_burst_blob(layout, values, pin_memory=dev == "cuda"),
                               None, dev_draws)
        metrics = metrics.cpu()
        seconds = time.perf_counter() - t0
        launched = kernels.LAUNCHES["ragged_ring_scatter"] - before
        _, new_pos, new_valid = ring_append_rows(*(torch.from_numpy(values[k]).to(dev) for k in ("__pos__", "__valid_n__", "__mask__")), C)
        windows = ring_sample_windows(dev_draws["u"][0], dev_draws["env"][0], new_pos, new_valid, C, T).cpu()
        params = {name: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                  for name, m in zip(("world_model", "actor", "critic"), modules)}
        results[dev] = {"rb": {k: v.cpu() for k, v in rb.items()}, "windows": windows, "metrics": metrics,
                        "params": params, "seconds": seconds, "launched": launched}
    card, cpu = results["cuda"], results["cpu"]
    if card["launched"] != 1 or cpu["launched"] != 0:
        raise AssertionError(f"scatter launches: card {card['launched']}, CPU {cpu['launched']}")
    for k in keys:
        if not torch.equal(card["rb"][k], cpu["rb"][k]):
            raise AssertionError(f"the ring's '{k}' after the append differs between the card and the CPU")
    if not torch.equal(card["windows"], cpu["windows"]):
        raise AssertionError("the windows differ between the card and the CPU")
    if not torch.isfinite(card["metrics"]).all():
        raise AssertionError(f"non-finite losses on the card: {card['metrics'].tolist()}")
    torch.testing.assert_close(card["metrics"], cpu["metrics"], rtol=1e-4, atol=1e-5)
    out = {"cpu_s": cpu["seconds"], "cuda_s": card["seconds"], "ring_equal": True, "windows_equal": True,
           "loss_abs_err": dict(zip(METRIC_NAMES, (card["metrics"] - cpu["metrics"]).abs().tolist())),
           "losses_cpu": dict(zip(METRIC_NAMES, cpu["metrics"].tolist()))}
    for name, lr in {"world_model": 1e-4, "actor": 8e-5, "critic": 8e-5}.items():
        diffs = torch.cat([(card["params"][name][k] - cpu["params"][name][k]).abs().reshape(-1) for k in cpu["params"][name]])
        close = float((diffs <= 1e-6).float().mean())
        out[name] = {"max_abs_err": float(diffs.max()), "share_within_1e-6": close}
        if float(diffs.max()) > 2 * lr + 1e-6 or close < 0.999:
            raise AssertionError(f"{name} after the dispatch on the card differs from the CPU: {out[name]}")
    log("resident dispatch (card vs CPU): " + json.dumps(out))
    return out


# -- 16. resident run ----------------------------------------------------------------


def first_episode_end(cfg) -> int:
    """The env step at which the preset's env (seed ``cfg.seed``) first ends
    an episode: the Atari-protocol dummy's lives run out on a schedule that
    does not depend on the actions."""
    from sheeprl_tpu_torch.envs import make_vector_env

    envs = make_vector_env(cfg, int(cfg.seed))
    envs.reset(seed=int(cfg.seed))
    for step in range(1, 5000):
        _, _, terminated, truncated, _ = envs.step(np.zeros((int(cfg.env.num_envs), 1), np.int64))
        if terminated[0] or truncated[0]:
            return step
    raise AssertionError("the dummy env ended no episode in 5000 steps")


def _resident_launch_check(summary: dict, launches: dict, T: int, H: int) -> dict:
    G, flushes = summary["gradient_steps"], summary["replay"]["Replay/flushes"]
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update({
        "two_hot_symlog_loss_lse": 3 * G,
        "two_hot_symlog_loss_lse_bwd": 3 * G,
        "two_hot_symexp_decode": 3 * G,
        "gru_gates": G * (T + H) + summary["player_steps"] + summary["test_steps"],
        "ragged_ring_scatter": flushes,  # one launch for every ring key per dispatch
    })
    if launches != want or not summary["test_steps"]:
        raise AssertionError(f"resident launches {launches} != {want} for {G} gradient steps, {flushes} flushes")
    return want


def _profile_resident_dispatch(checkpoint: str) -> dict:
    """Dispatches of the full-recipe ring restored from the run's checkpoint:
    host time (ending in a synchronize) of append-only and of training
    dispatches (append + 1 gradient step), and PROFILED of each under
    ``torch.profiler`` after a warm-up step: device time, operations and
    the scatter's share, per dispatch."""
    from sheeprl_tpu_torch.replay import DeviceReplayState, SequenceRingDriver
    from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys

    cfg = load_config(find_run_config(checkpoint))
    state = load_checkpoint(checkpoint)
    modules = build_training_agent(cfg, "cuda", state)
    optimizers = make_optimizers(cfg, *modules[:3])
    keys = dreamer_ring_keys(cfg.spaces.obs, ["rgb"], [], [18], with_is_first=True)
    snap = DeviceReplayState.from_dict(state.pop("rb"))
    driver = SequenceRingDriver(
        keys, int(snap.meta["capacity"]), 1, int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size),
        1, lambda ring: make_train_step(*modules, optimizers, cfg, ring=ring), device="cuda", seed=8, restore=snap)
    del snap, state
    rng = np.random.default_rng(18)
    carry = [(init_moments("cuda"), 1)]

    def dispatch(grant: int) -> None:
        row = {k: rng.integers(0, 256 if np.dtype(dtype) == np.uint8 else 2, (1, 1) + shape).astype(dtype)
               for k, (shape, dtype) in keys.items()}
        driver.stage_step(row)
        driver.grant(grant)
        carry[0], _ = driver.pump(carry[0])

    out = {}
    for kind, grant in (("append", 0), ("train", 1)):
        for _ in range(2):
            dispatch(grant)
        torch.cuda.synchronize()
        host = []
        for _ in range(5 if grant == 0 else 3):
            t0 = time.perf_counter()
            dispatch(grant)
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t0)
        # the start of a profiling window can lose a short dispatch's device
        # events: one warm-up step, then PROFILED dispatches, per dispatch
        acts = torch.profiler.ProfilerActivity
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=PROFILED, repeat=1)
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA], schedule=schedule) as prof:
            for _ in range(1 + PROFILED):
                dispatch(grant)
                torch.cuda.synchronize()
                prof.step()
        events = _device_kernels(prof)
        device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / PROFILED
        scatter_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events if "ragged_ring_scatter" in e.key) / PROFILED
        top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
        out[kind] = {
            "host_ms": float(np.median(host) * 1e3),
            "host_ms_all": [h * 1e3 for h in host],
            "device_ms": device_us / 1e3 if device_us > 0 else None,
            "device_busy_share": device_us / 1e3 / (np.median(host) * 1e3) if device_us > 0 else None,
            "device_ops": sum(e.count for e in events) / PROFILED,
            "ragged_ring_scatter": {"device_ms": scatter_us / 1e3, "share": scatter_us / device_us if device_us > 0 else None,
                                    "ops": sum(e.count for e in events if "ragged_ring_scatter" in e.key) / PROFILED},
            "top": [{"name": e.key[:80], "device_ms": getattr(e, "self_device_time_total", 0.0) / 1e3 / PROFILED,
                     "count": e.count / PROFILED} for e in top],
        }
        out[kind]["complete"] = out[kind]["ragged_ring_scatter"]["ops"] == 1
        if not out[kind]["complete"]:  # a measurement, not a check of the path: report it
            log(f"the profile of a {kind} dispatch lost events: {out[kind]['ragged_ring_scatter']['ops']} scatters "
                "per dispatch, not 1")
    return out


def resident_run_phase(workdir: str) -> dict:
    """DreamerV3-S on the device sequence ring through ``run``'s entry point
    at the full recipe with the full 100,000-row ring in card memory:
    ``learning_starts`` past the env's first episode end, then
    RESIDENT_GRADIENT_STEPS gradient steps, ending in a checkpoint that holds
    the ring. At least one 2-row flush (the reset row); every loss finite;
    the launch counts exactly those of the path. Then a resume from that
    checkpoint that must restore the ring's bytes, its heads and its
    generator, and dispatches of the restored ring under ``torch.profiler``."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.replay import DeviceReplayState

    end = first_episode_end(preset(RESIDENT_PRESET))
    starts = end + 8
    total = starts + RESIDENT_GRADIENT_STEPS - 1
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = cli.run([f"preset={RESIDENT_PRESET}", f"algo.learning_starts={starts}", f"algo.total_steps={total}",
                       "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    cfg = load_config(find_run_config(summary["checkpoint"]))
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    G, replay = summary["gradient_steps"], summary["replay"]
    # one env: every flush adds one row, a 2-row flush one more
    two_row = replay["Replay/size"] - replay["Replay/flushes"]
    if not summary["resident"] or summary["device"].split(":")[0] != "cuda" or G != RESIDENT_GRADIENT_STEPS:
        raise AssertionError(f"resident run: resident {summary['resident']}, {G} gradient steps on {summary['device']}")
    if two_row < 1:
        raise AssertionError(f"no 2-row flush in {replay['Replay/flushes']} flushes (first episode end at step {end})")
    if not np.isfinite(np.asarray(summary["metrics"])).all() or len(summary["metrics"]) != summary["train_calls"]:
        raise AssertionError(f"non-finite or missing losses: {summary['metrics']}")
    _resident_launch_check(summary, launches, T, H)
    append_ms = [s * 1e3 for s, n in summary["dispatch_host_s"] if n == 0]
    train_ms = [s * 1e3 for s, n in summary["dispatch_host_s"] if n > 0]
    out = {
        "first_episode_end": end,
        "learning_starts": starts,
        "policy_steps": summary["policy_steps"],
        "gradient_steps": G,
        "player_steps": summary["player_steps"],
        "test_steps": summary["test_steps"],
        "test_reward": summary["test_reward"],
        "flushes": replay["Replay/flushes"],
        "two_row_flushes": two_row,
        "launches": launches,
        "wall_s": wall,
        "env_steps_per_s": summary["loop_steps_per_s"],
        "env_only_steps_per_s": summary["env_steps_per_s"],
        "host_ms_per_dispatch": {
            "append_median": float(np.median(append_ms)), "append_range": [min(append_ms), max(append_ms)],
            "train_median": float(np.median(train_ms)), "train_range": [min(train_ms), max(train_ms)],
        },
        "peak_device_gb": peak_gb,
        "replay": replay,
        "losses": [dict(zip(METRIC_NAMES, row)) for row in summary["metrics"]],
        "checkpoint": summary["checkpoint"],
    }
    for i, row in enumerate(summary["metrics"]):
        log(f"resident run gradient step {i}: " + " ".join(f"{n.split('/')[-1]}={v:.5g}" for n, v in zip(METRIC_NAMES, row)))
    log("resident run: " + json.dumps({k: v for k, v in out.items() if k not in ("losses", "checkpoint")}))

    saved = DeviceReplayState.from_dict(load_checkpoint(summary["checkpoint"])["rb"])
    restored = {}

    class _Recording(dv3.SequenceRingDriver):
        def load_state_dict(self, snap):
            super().load_state_dict(snap)
            restored.update(self.state_dict().arrays)
            return self

    kernels.reset_launches()
    dv3.SequenceRingDriver = _Recording
    try:
        resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                           "algo.learning_starts=2", f"algo.total_steps={summary['policy_steps'] + RESIDENT_RESUME_STEPS}",
                           "checkpoint.save_last=true", "checkpoint.async_save=true", f"log_root={_log_root(summary)}"])
    finally:
        dv3.SequenceRingDriver = _Recording.__bases__[0]
    resume_launches = dict(kernels.LAUNCHES)
    same = {k: torch.equal(restored[k], v) for k, v in saved.arrays.items()}
    if set(restored) != set(saved.arrays) or not all(same.values()):
        raise AssertionError(f"the resume restored a different ring: {same}")
    del saved, restored
    if resumed["start_iter"] != summary["policy_steps"] + 1 or resumed["gradient_steps"] == 0:
        raise AssertionError(f"resident resume: start {resumed['start_iter']}, {resumed['gradient_steps']} gradient steps")
    _resident_launch_check(resumed, resume_launches, T, H)
    out["resume"] = {"start_iter": resumed["start_iter"], "policy_steps": resumed["policy_steps"],
                     "gradient_steps": resumed["gradient_steps"], "test_steps": resumed["test_steps"],
                     "launches": resume_launches, "restored_equal": sorted(same), "losses": resumed["metrics"]}
    log("resident resume: " + json.dumps({k: v for k, v in out["resume"].items() if k != "losses"}))
    out["saves"] = _resident_saves(summary, resumed)
    out["profile"] = _profile_resident_dispatch(summary["checkpoint"])
    log("resident dispatch profile: " + json.dumps(out["profile"]))
    return out


# -- 17-20. evaluation and stateless serving -------------------------------------


def _recording_make_env(frames: list, actions: list, key: str = "rgb"):
    """``make_env`` whose env records every frame (observation ``key``) it
    returns and every action it is given (what the test episode saw and
    did)."""
    from sheeprl_tpu_torch.envs import make_env

    def recording(*args, **kwargs):
        env = make_env(*args, **kwargs)
        reset, step = env.reset, env.step

        def rec_reset(*a, **k):
            out = reset(*a, **k)
            frames.append(out[0][key].copy())
            return out

        def rec_step(action):
            actions.append(int(action))
            out = step(action)
            frames.append(out[0][key].copy())
            return out

        env.reset, env.step = rec_reset, rec_step
        return env

    return recording


def rssm_evaluation_phase(ckpt: str) -> dict:
    """``evaluation`` of the DreamerV3 host run's checkpoint on the card: one
    greedy episode, the reward finite, ``gru_gates`` launched exactly once
    per step (batch 1: the (1, 1536) projection) and no other kernel. Then
    one session served over the socket, fed the episode's frames (reset on
    the first), must give the episode's actions step by step: the episode
    is a serving session, with the same counter draws."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import utils as dv3_utils

    frames, actions = [], []
    make_env = dv3_utils.make_env
    dv3_utils.make_env = _recording_make_env(frames, actions)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        result = cli.evaluation([f"checkpoint_path={ckpt}"])
    finally:
        dv3_utils.make_env = make_env
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps = result["steps"]
    want = dict({name: 0 for name in launches}, gru_gates=steps)
    if result["device"].split(":")[0] != "cuda" or not np.isfinite(result["reward"]) or steps != len(actions):
        raise AssertionError(f"evaluation: {result}, {len(actions)} actions recorded")
    if launches != want:
        raise AssertionError(f"evaluation launches {launches} != {want} for {steps} steps")

    def client(port: int, res: dict) -> None:
        conn = _Conn(port, time.monotonic() + 300)
        served = []
        for t in range(steps):
            resp = conn.ask({"obs": {"rgb": frames[t].tolist()}, "session_id": "episode", "reset": t == 0})
            if "actions" not in resp:
                raise AssertionError(f"served step {t}: {resp}")
            served.append(int(resp["actions"][0][0]))
        res["served"] = served
        conn.close()

    t1 = time.perf_counter()
    served = _serve_with([f"checkpoint_path={ckpt}", "serve.session.buckets=[1,8,32]", "serve.max_wait_ms=2.0"],
                         client)["served"]
    parted = next((t for t, (a, b) in enumerate(zip(served, actions)) if a != b), None)
    if parted is not None:
        raise AssertionError(f"the served session parts from the evaluation episode at step {parted} of {steps}: "
                             f"{served[parted:parted + 5]} != {actions[parted:parted + 5]}")
    out = {"reward": result["reward"], "steps": steps, "device": result["device"], "launches": launches,
           "wall_s": wall, "steps_per_s": steps / wall, "served_equal": True,
           "served_wall_s": time.perf_counter() - t1, "distinct_actions": len(set(actions))}
    log("DreamerV3 evaluation: " + json.dumps(out))
    return out


# 8 clients x 16 requests of 1-4 raw rows, then one request past the top bucket
STATELESS_CLIENTS, STATELESS_REQUESTS, STATELESS_BIG = 8, 16, 200
STATELESS_BUCKETS = (1, 8, 32, 128)
# a batched SAC action against the same row alone on the card: float32
# products at another batch size may be summed in another order
SAC_ROW_ATOL = 1e-5


def _stateless_rows(rng, rows: str, n: int) -> np.ndarray:
    """Raw observations in the env's own ranges: CartPole's (position,
    velocity, angle, angular velocity) for ``rows`` "ppo", or Pendulum's
    (cos, sin, speed) for "sac" or "pendulum"."""
    if rows == "ppo":
        return (rng.uniform(-1, 1, (n, 4)) * np.array([2.4, 2.0, 0.2, 2.0])).astype(np.float32)
    theta, speed = rng.uniform(-np.pi, np.pi, n), rng.uniform(-8.0, 8.0, n)
    return np.stack([np.cos(theta), np.sin(theta), speed], axis=-1).astype(np.float32)


def _profile_stateless_dispatch(policy, rng, rows: str, bucket: int = 8) -> dict:
    """One engine dispatch of ``bucket`` rows: host ms (ending in the
    actions' copy to the host) and, under ``torch.profiler``, device ms
    and operations."""
    from sheeprl_tpu_torch.serve.engine import BucketEngine

    engine = BucketEngine(policy, buckets=STATELESS_BUCKETS)
    obs = policy.prepare({"state": _stateless_rows(rng, rows, bucket)}, bucket)
    for _ in range(5):
        engine.infer(policy.params, obs)
    host = []
    for _ in range(30):
        t0 = time.perf_counter()
        engine.infer(policy.params, obs)
        host.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=10, repeat=1)
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA], schedule=schedule) as prof:
        for _ in range(11):
            engine.infer(policy.params, obs)
            prof.step()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 10
    return {"bucket": bucket, "host_ms": float(np.median(host) * 1e3), "host_ms_range": [min(host) * 1e3, max(host) * 1e3],
            "device_ms": device_us / 1e3 if device_us > 0 else None,
            "device_ops": sum(e.count for e in events) / 10}


def stateless_serve_phase(ckpt: str, algo: str, row_env: str = "") -> dict:
    """``serve`` of a PPO or SAC run's checkpoint on the card through the
    bucket engine (buckets 1, 8, 32, 128): STATELESS_CLIENTS concurrent
    clients send STATELESS_REQUESTS requests each of 1-4 raw rows
    (``row_env`` names their env, :func:`_stateless_rows`; the algorithm's
    by default),
    then one request of STATELESS_BIG rows, which the engine chunks through
    bucket 128. Each served row equals the card's ``greedy_fn`` on that row
    alone (discrete actions exactly, continuous ones within SAC_ROW_ATOL);
    the big request equals its unchunked direct call; the engine's
    dispatches, rows and padded rows agree with a log of every dispatch; no
    repo kernel is launched."""
    from sheeprl_tpu_torch.serve import server as server_module
    from sheeprl_tpu_torch.utils.registry import resolve_policy_builder

    rows_like = row_env or algo
    rng = np.random.default_rng(11 if rows_like == "ppo" else 12)
    plan = [[_stateless_rows(rng, rows_like, int(rng.integers(1, 5))) for _ in range(STATELESS_REQUESTS)]
            for _ in range(STATELESS_CLIENTS)]
    big = _stateless_rows(rng, rows_like, STATELESS_BIG)
    dispatch_log = []

    class _Logged(server_module.BucketEngine):
        def _dispatch(self, params, obs, n, greedy, key, start):
            dispatch_log.append((n, self.bucket_for(n)))
            return super()._dispatch(params, obs, n, greedy, key, start)

    def client(port: int, result: dict) -> None:
        deadline = time.monotonic() + 300
        probe = _Conn(port, deadline)
        result["health_start"] = probe.ask({"health": True})
        answers = [[None] * STATELESS_REQUESTS for _ in range(STATELESS_CLIENTS)]
        latencies, errors = [], []

        def one(i: int) -> None:
            try:
                conn = _Conn(port, deadline)
                for j, rows in enumerate(plan[i]):
                    t0 = time.perf_counter()
                    resp = conn.ask({"obs": {"state": rows.tolist()}, "n": len(rows)})
                    latencies.append(time.perf_counter() - t0)
                    if "actions" not in resp:
                        raise AssertionError(f"client {i} request {j}: {resp}")
                    answers[i][j] = resp["actions"]
                conn.close()
            except BaseException as e:  # reported by the main thread
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(STATELESS_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        result["wall_s"] = time.perf_counter() - t0
        if errors:
            raise errors[0]
        if any(th.is_alive() for th in threads):
            raise TimeoutError("a stateless client did not finish")
        result["health_batched"] = probe.ask({"health": True})
        result["answers"], result["latencies"] = answers, latencies
        resp = probe.ask({"obs": {"state": big.tolist()}, "n": STATELESS_BIG})
        if "actions" not in resp:
            raise AssertionError(f"the {STATELESS_BIG}-row request: {resp}")
        result["big"] = resp["actions"]
        result["health_end"] = probe.ask({"health": True})
        probe.close()

    server_module.BucketEngine = _Logged
    try:
        result = _serve_with([f"checkpoint_path={ckpt}", "serve.buckets=[1,8,32,128]", "serve.max_wait_ms=2.0"],
                             client)
    finally:
        server_module.BucketEngine = _Logged.__bases__[0]
    launches = result["launches"]
    if any(launches.values()):
        raise AssertionError(f"stateless {algo} serving launched repo kernels: {launches}")
    end = result["health_end"]["engine"]
    rows_sent = sum(len(r) for reqs in plan for r in reqs) + STATELESS_BIG
    if (end["kind"] != _Logged.__name__ or not end["device"].startswith("cuda") or end["dispatches"] != len(dispatch_log)
            or end["rows"] != rows_sent or end["rows"] != sum(n for n, _ in dispatch_log)
            or end["padded_rows"] != sum(b - n for n, b in dispatch_log)
            or dispatch_log[-2:] != [(128, 128), (STATELESS_BIG - 128, 128)]):
        raise AssertionError(f"{algo} engine {end} against {len(dispatch_log)} logged dispatches "
                             f"{dispatch_log[-4:]} and {rows_sent} rows sent")

    cfg = load_config(find_run_config(ckpt))
    policy = resolve_policy_builder(algo)(cfg, load_checkpoint(ckpt), "cuda")
    exact = not cfg.spaces.actions.get("continuous")

    def direct(rows: np.ndarray) -> np.ndarray:
        obs = policy.prepare({"state": rows}, len(rows))
        with torch.no_grad():
            return policy.greedy_fn(policy.params, {k: torch.from_numpy(v).cuda() for k, v in obs.items()}).cpu().numpy()

    def check(got, want, what: str) -> float:
        got = np.asarray(got, dtype=want.dtype)
        err = float(np.abs(got.astype(np.float64) - want).max())
        if got.shape != want.shape or (err != 0 if exact else err > SAC_ROW_ATOL):
            raise AssertionError(f"{algo} {what}: served {got.tolist()[:4]} != {want.tolist()[:4]} (max err {err})")
        return err

    row_err = 0.0
    for i, reqs in enumerate(plan):
        for j, rows in enumerate(reqs):
            alone = np.concatenate([direct(rows[r:r + 1]) for r in range(len(rows))])
            row_err = max(row_err, check(result["answers"][i][j], alone, f"client {i} request {j}, rows alone"))
    big_err = check(result["big"], direct(big), f"{STATELESS_BIG}-row request against its unchunked call")
    lat = np.asarray(result["latencies"]) * 1e3
    hb, hs = result["health_batched"]["engine"], result["health_start"]["engine"]
    phase_dispatches = hb["dispatches"] - hs["dispatches"]
    out = {
        "clients": STATELESS_CLIENTS,
        "requests": int(lat.size),
        "rows": int(hb["rows"] - hs["rows"]),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "requests_per_s": lat.size / result["wall_s"],
        "dispatches": int(phase_dispatches),
        "dispatches_per_s": phase_dispatches / result["wall_s"],
        "rows_per_dispatch": (hb["rows"] - hs["rows"]) / max(phase_dispatches, 1),
        "padded_rows": int(hb["padded_rows"] - hs["padded_rows"]),
        "row_alone_max_abs_err": row_err,
        "big_unchunked_max_abs_err": big_err,
        "launches": launches,
        "engine_end": end,
        "dispatch_bucket_8": _profile_stateless_dispatch(policy, rng, rows_like),
    }
    log(f"{algo} stateless serve: " + json.dumps(out))
    return out


def stateless_evaluation_phase(ckpt: str, algo: str, floor: float, run_test_reward: float) -> dict:
    """``evaluation`` of a PPO or SAC run's checkpoint on the card: one greedy
    episode at or above the run's learning floor, no repo kernel launched;
    beside it the run's own end-of-run test episode on the same weights and
    seed."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = cli.evaluation([f"checkpoint_path={ckpt}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if result["device"].split(":")[0] != "cuda" or any(launches.values()) or not result["reward"] >= floor:
        raise AssertionError(f"{algo} evaluation: {result}, launches {launches}, floor {floor}")
    out = {**result, "launches": launches, "wall_s": wall, "steps_per_s": result["steps"] / wall,
           "run_test_reward": run_test_reward, "equals_run_test": result["reward"] == run_test_reward}
    log(f"{algo} evaluation: " + json.dumps(out))
    return out


# -- 20. the fault runtime ---------------------------------------------------------

FAULT_PPO_ITERATIONS, FAULT_NAN_AT = 4, 2  # PPO drill runs: their depth and the poisoned iteration


def _tensors_equal(a, b) -> bool:
    """Two checkpoint subtrees bit-equal: every tensor ``torch.equal``, every
    other leaf ``==``."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_tensors_equal(x, y) for x, y in zip(a, b))
    return a == b


def _all_finite(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return not tree.is_floating_point() or bool(torch.isfinite(tree).all())
    if isinstance(tree, dict):
        return all(_all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_all_finite(v) for v in tree)
    return True


def _on_card(tensors) -> bool:
    return all(t.is_cuda for t in tensors)


def _fault_ppo_run(root: str, *extra) -> dict:
    """``run preset=ppo`` at the full recipe's widths, FAULT_PPO_ITERATIONS
    iterations, a checkpoint every iteration; the summary and the launches."""
    kernels.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        summary = cli.run([f"preset={PPO_PRESET}", f"algo.total_steps={FAULT_PPO_ITERATIONS * 512}",
                           "checkpoint.every=512", "metric.log_level=0", "algo.run_test=false", f"log_root={root}",
                           *extra])
    summary["launches"] = dict(kernels.LAUNCHES)
    summary["warnings"] = [str(w.message) for w in caught if "skipped" in str(w.message) or "rolling" in str(w.message)]
    return summary


def _fault_ppo(workdir: str) -> dict:
    """PPO on the card with ``fault.inject.nan_grads_at``:

    - skip: iteration FAULT_NAN_AT's advantages are NaN, so its 80
      minibatches are skipped; its checkpoint's parameters, Adam moments and
      step counts (copied from the card) bit-equal the previous iteration's;
      everything finite at the end; ``gae`` once per iteration;
    - rollback: iteration 3 poisoned with ``max_consecutive=1``: the sentinel
      loads the latest complete checkpoint (iteration 2), so iteration 3's
      checkpoint holds exactly its agent, Adam state and generator;
    - resume: ``checkpoint.resume_from=latest`` over the rollback run's root
      continues from its newest complete checkpoint for 2 iterations,
      publishing them into a directory of its own and leaving the rollback
      run's manifest as it was;
    - abort: iterations 1 and 2 poisoned with ``max_consecutive=2
      action=abort`` raise ``DivergenceError``."""
    from sheeprl_tpu_torch.fault import DivergenceError, read_manifest

    out = {}
    root = os.path.join(workdir, "skip")
    t0 = time.perf_counter()
    s = _fault_ppo_run(root, f"fault.inject.nan_grads_at=[{FAULT_NAN_AT}]")
    ckpt_dir = os.path.dirname(s["checkpoint"])
    want_skipped = [80.0 if i == FAULT_NAN_AT else 0.0 for i in range(1, FAULT_PPO_ITERATIONS + 1)]
    if s["skipped"] != want_skipped or s["rollbacks"] != 0:
        raise AssertionError(f"PPO skip drill: skipped {s['skipped']} != {want_skipped}, rollbacks {s['rollbacks']}")
    before = load_checkpoint(os.path.join(ckpt_dir, f"ckpt_{(FAULT_NAN_AT - 1) * 512}_0.ckpt"))
    after = load_checkpoint(os.path.join(ckpt_dir, f"ckpt_{FAULT_NAN_AT * 512}_0.ckpt"))
    if not (_tensors_equal(before["agent"], after["agent"])
            and _tensors_equal(before["optimizer"]["state"], after["optimizer"]["state"])):
        raise AssertionError("the skipped PPO iteration moved the parameters or Adam's state")
    final = load_checkpoint(s["checkpoint"])
    steps = {int(v["step"]) for v in final["optimizer"]["state"].values()}
    if not (_all_finite(final["agent"]) and _all_finite(final["optimizer"]["state"])) or steps != {240}:
        raise AssertionError(f"PPO skip drill: final state finite {_all_finite(final['agent'])}, Adam steps {steps}")
    _ppo_launch_check(s, s["launches"])
    out["skip"] = {"skipped": s["skipped"], "launches": s["launches"], "adam_steps": sorted(steps),
                   "losses": s["losses"], "wall_s": time.perf_counter() - t0}
    log("fault PPO skip: " + json.dumps({k: v for k, v in out["skip"].items() if k != "losses"}))

    root = os.path.join(workdir, "rollback")
    s = _fault_ppo_run(root, "fault.inject.nan_grads_at=[3]", "fault.sentinel.max_consecutive=1")
    ckpt_dir = os.path.dirname(s["checkpoint"])
    good = load_checkpoint(os.path.join(ckpt_dir, "ckpt_1024_0.ckpt"))
    rolled = load_checkpoint(os.path.join(ckpt_dir, "ckpt_1536_0.ckpt"))
    same = {k: _tensors_equal(good[k], rolled[k]) for k in ("agent", "rng")}
    same["optimizer"] = _tensors_equal(good["optimizer"]["state"], rolled["optimizer"]["state"])
    if s["rollbacks"] != 1 or not all(same.values()):
        raise AssertionError(f"PPO rollback drill: {s['rollbacks']} rollbacks, restored equal {same}")
    _ppo_launch_check(s, s["launches"])
    out["rollback"] = {"rollbacks": s["rollbacks"], "skipped": s["skipped"], "restored_equal": same,
                       "launches": s["launches"]}
    log("fault PPO rollback: " + json.dumps(out["rollback"]))

    kernels.reset_launches()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        resumed = cli.run([f"preset={PPO_PRESET}", f"log_root={root}", "checkpoint.resume_from=latest",
                           f"algo.total_steps={(FAULT_PPO_ITERATIONS + 2) * 512}", "metric.log_level=0",
                           "algo.run_test=false"])
    launches = dict(kernels.LAUNCHES)
    line = f"checkpoint.resume_from=latest -> {s['checkpoint']}"
    # the resumed run publishes into a directory of its own; the rollback
    # run's keeps its FAULT_PPO_ITERATIONS saves (within keep_last, 5)
    own_dir = os.path.dirname(resumed["checkpoint"])
    manifest = [e["step"] for e in read_manifest(own_dir)]
    kept = sorted(int(f.split("_")[1]) for f in os.listdir(own_dir) if f.endswith(".ckpt"))
    old = [e["step"] for e in read_manifest(ckpt_dir)]
    want_kept = [i * 512 for i in range(FAULT_PPO_ITERATIONS + 1, FAULT_PPO_ITERATIONS + 3)]
    if (line not in printed.getvalue() or resumed["start_iter"] != FAULT_PPO_ITERATIONS + 1
            or resumed["iterations"] != 2 or manifest != want_kept or kept != want_kept or own_dir == ckpt_dir
            or old != [i * 512 for i in range(1, FAULT_PPO_ITERATIONS + 1)]):
        raise AssertionError(f"PPO resume from latest: printed {printed.getvalue()!r}, start {resumed['start_iter']}, "
                             f"manifest {manifest}, files {kept}, the resumed run's old directory {old}")
    _ppo_launch_check(resumed, launches)
    out["resume_latest"] = {"start_iter": resumed["start_iter"], "iterations": resumed["iterations"],
                            "manifest_steps": manifest, "old_run_steps": old, "launches": launches}
    log("fault PPO resume from latest: " + json.dumps(out["resume_latest"]))

    try:
        _fault_ppo_run(os.path.join(workdir, "abort"), "fault.inject.nan_grads_at=[1,2]",
                       "fault.sentinel.max_consecutive=2", "fault.sentinel.action=abort")
    except DivergenceError as e:
        out["abort"] = str(e)
    else:
        raise AssertionError("PPO abort drill: two poisoned iterations with action=abort did not raise")
    log(f"fault PPO abort: {out['abort']}")
    return out


def _sac_ring_arrays(ring, rng, filled_rows: int, max_p: float) -> dict:
    """A ring snapshot holding ``filled_rows`` random rows at random
    priorities and ``max_p``, for ``load_state_dict``."""
    from sheeprl_tpu_torch.replay import DeviceReplayState
    from sheeprl_tpu_torch.replay import sumtree as st

    capacity, n_envs = ring.capacity, ring.n_envs
    arrays = {}
    for k, (shape, _) in ring.specs.items():
        full = np.zeros((capacity, n_envs) + shape, np.float32)
        full[:filled_rows] = rng.normal(size=(filled_rows, n_envs) + shape)
        arrays[f"storage/{k}"] = torch.from_numpy(full)
    arrays["storage/terminated"].zero_()
    leaves = filled_rows * n_envs
    arrays["tree"] = st.update(st.init(capacity * n_envs), torch.arange(leaves),
                               torch.from_numpy(rng.uniform(0.05, 2.0, size=leaves).astype(np.float32)))
    arrays["max_p"] = torch.tensor(max_p)
    meta = {"capacity": capacity, "n_envs": n_envs, "prioritized": True, "host_pos": filled_rows, "host_full": False}
    return DeviceReplayState("uniform", {**arrays, "key": ring.generator.get_state()}, meta)


def _fault_sac_dispatch(filled_rows: int = 4096, beta: float = 0.5) -> dict:
    """One guarded SAC-PER resident dispatch at the full ``sac_per`` width
    whose every drawn row carries a NaN reward (the ring's rewards are NaN),
    after one clean dispatch: its 4 steps are skipped, and the parameters
    (target critics included), the three Adams (step counts on the card),
    the sum-tree and ``max_p`` bit-equal what they were with the staged
    row's fresh leaves appended; the next draw's ``sumtree_sample`` leaves
    equal those of a control tree that appended the row and never took the
    poisoned steps; ``sumtree_sample`` launched once per step."""
    from sheeprl_tpu_torch.algos.sac.sac import make_resident_train_step
    from sheeprl_tpu_torch.replay import sumtree as st

    cfg = preset(SAC_PRESET)
    rng = np.random.default_rng(21)
    agent, optimizers = _sac_parts(cfg, "cuda")
    drb = _sac_ring(cfg, "cuda")
    drb.load_state_dict(_sac_ring_arrays(drb, rng, filled_rows, 2.5))
    train = make_resident_train_step(agent, optimizers, cfg, drb, guard=True)

    def staged():
        return {k: rng.normal(size=(1, drb.n_envs) + shape).astype(np.float32) for k, (shape, _) in drb.specs.items()}

    drb.add(staged())
    _, clean = train(drb.make_job(), [1.0] * 4, beta)
    if float(clean) != 0.0:
        raise AssertionError(f"the clean SAC dispatch skipped {float(clean)} steps")
    state_tensors = list(agent.parameters()) + [t for opt in optimizers for t in opt.state_tensors()]
    if not _on_card(state_tensors):
        raise AssertionError("a SAC parameter or Adam state tensor (step counts included) is not on the card")
    before = [t.detach().clone() for t in state_tensors]
    max_p = drb.max_p.clone()
    drb.storage["rewards"].fill_(float("nan"))
    row = staged()
    row["rewards"][:] = np.nan
    drb.add(row)
    job = drb.make_job()
    fresh = torch.arange(job.pos * drb.n_envs, (job.pos + job.count) * drb.n_envs, device="cuda")
    control = st.update(drb.tree.clone(), fresh, drb.max_p.expand(fresh.shape[0]))
    kernels.reset_launches()
    losses, skipped = train(job, [1.0] * 4, beta)
    launches = dict(kernels.LAUNCHES)
    if float(skipped) != 4.0 or launches["sumtree_sample"] != 4:
        raise AssertionError(f"poisoned SAC dispatch: skipped {float(skipped)}, launches {launches}")
    same = {"state": all(torch.equal(a, b) for a, b in zip(state_tensors, before)),
            "tree": torch.equal(drb.tree, control), "max_p": torch.equal(drb.max_p, max_p)}
    u = torch.rand(int(cfg.algo.per_rank_batch_size), device="cuda", generator=torch.Generator("cuda").manual_seed(22))
    leaf, w = kernels.sumtree_sample(drb.tree, u, job.valid * drb.n_envs, beta)
    leaf_ctl, w_ctl = kernels.sumtree_sample(control, u, job.valid * drb.n_envs, beta)
    same["next_draw"] = torch.equal(leaf, leaf_ctl) and torch.equal(w, w_ctl)
    if not all(same.values()):
        raise AssertionError(f"the poisoned SAC dispatch changed the train state: {same}")
    out = {"skipped": float(skipped), "losses": losses.tolist(), "bit_equal": same, "launches": launches}
    log("fault SAC dispatch: " + json.dumps(out))
    return out


def _fault_rssm_step() -> dict:
    """One guarded DreamerV3-S host-tier gradient step at the full recipe
    (B 16 x T 64, H 15) on a batch whose rewards are NaN, after one clean
    step: the step is skipped, the four modules, the three Adams (step
    counts on the card) and ``Moments`` bit-equal what they were, and the
    kernels launch the step's exact counts (3 fused two-hot losses, their 3
    backward launches, 3 decodes, T + H GRU steps)."""
    cfg = _run_cfg()
    T, B, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), int(cfg.algo.horizon)
    modules = build_training_agent(cfg, "cuda")
    optimizers = make_optimizers(cfg, *modules[:3])
    train = make_train_step(*modules, optimizers, cfg, guard=True)
    gen = torch.Generator(device="cuda").manual_seed(23)
    data = {k: v.cuda() for k, v in _batch(np.random.default_rng(24), T, B, 18).items()}
    moments, _, clean = train(data, init_moments("cuda"), 0, gen)
    if float(clean) != 0.0:
        raise AssertionError("the clean DreamerV3 step was skipped")
    state_tensors = [p for m in modules for p in m.parameters()]
    state_tensors += [t for opt in optimizers.values() for t in opt.state_tensors()]
    if not _on_card(state_tensors):
        raise AssertionError("a DreamerV3 parameter or Adam state tensor (step counts included) is not on the card")
    before = [t.detach().clone() for t in state_tensors]
    moments_before = {k: v.clone() for k, v in moments.items()}
    data["rewards"].fill_(float("nan"))
    kernels.reset_launches()
    moments, metrics, skipped = train(data, moments, 1, gen)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update({"two_hot_symlog_loss_lse": 3, "two_hot_symlog_loss_lse_bwd": 3, "two_hot_symexp_decode": 3,
                 "gru_gates": T + H})
    same = {"state": all(torch.equal(a, b) for a, b in zip(state_tensors, before)),
            "moments": all(torch.equal(moments[k], v) for k, v in moments_before.items())}
    if float(skipped) != 1.0 or launches != want or not all(same.values()):
        raise AssertionError(f"poisoned DreamerV3 step: skipped {float(skipped)}, launches {launches} != {want}, "
                             f"bit-equal {same}")
    out = {"skipped": float(skipped), "bit_equal": same, "launches": launches,
           "reward_loss": float(metrics[0][METRIC_NAMES.index("Loss/reward_loss")]), "tensors": len(state_tensors)}
    log("fault DreamerV3 step: " + json.dumps(out))
    return out


def fault_phase(workdir: str) -> dict:
    """The fault runtime on the card: the PPO drills through ``run``
    (:func:`_fault_ppo`), one poisoned SAC-PER dispatch
    (:func:`_fault_sac_dispatch`) and one poisoned DreamerV3 host-tier
    gradient step (:func:`_fault_rssm_step`)."""
    return {"ppo": _fault_ppo(workdir), "sac": _fault_sac_dispatch(), "rssm": _fault_rssm_step()}


def _resident_saves(summary: dict, resumed: dict) -> dict:
    """The resident run's checkpoints through the manager, each holding the
    100,000-row ring: the run's own, saved synchronously, and the resume's,
    saved asynchronously. Per save: the host ms the training thread spent
    in ``save`` (all of it, synchronously; the staging, asynchronously), the
    writer's write and sha256 seconds, the file's bytes. Both are published
    with matching sizes and digests, each the newest complete checkpoint
    of its own run directory."""
    from sheeprl_tpu_torch.fault import latest_complete, read_manifest

    out = {}
    for mode, run in (("sync", summary), ("async", resumed)):
        ckpt_dir = os.path.dirname(run["checkpoint"])
        entries = {e["file"]: e for e in read_manifest(ckpt_dir)}
        name = os.path.basename(run["checkpoint"])
        timing = run["checkpoint_timings"][-1]
        if name not in entries or entries[name]["bytes"] != os.path.getsize(run["checkpoint"]):
            raise AssertionError(f"the {mode} save of {name} is not published with its size")
        if str(latest_complete(ckpt_dir)) != str(run["checkpoint"]):
            raise AssertionError(f"the newest complete checkpoint is {latest_complete(ckpt_dir)}, not the {mode} save's")
        out[mode] = {"host_ms": timing["blocked_s"] * 1e3, "write_s": timing["write_s"],
                     "digest_s": timing["digest_s"], "bytes": timing["bytes"]}
    log("resident checkpoint saves: " + json.dumps(out))
    return out


# -- 21. non-finite inputs through every kernel ---------------------------------------


def _poison(t: torch.Tensor, rows, gen) -> torch.Tensor:
    """``t`` with a NaN, a +inf and a -inf at a seeded column of the rows
    ``rows[0]``, ``rows[1]`` and ``rows[2]`` of its leading axis."""
    t = t.clone()
    for r, value in zip(rows, (float("nan"), float("inf"), float("-inf"))):
        flat = t[r].reshape(-1)
        flat[int(torch.randint(flat.numel(), (1,), generator=gen))] = value
    return t


def _nonfinite_gru(gen):
    proj = _poison(torch.randn(16, 1536, generator=gen) * 2, (1, 3, 5), gen).cuda()
    h = _poison(torch.randn(16, 512, generator=gen), (7, 9, 11), gen).cuda()
    w, b = (1 + 0.1 * torch.randn(1536, generator=gen)).cuda(), (0.1 * torch.randn(1536, generator=gen)).cuda()
    return [(kernels.gru_gates_ln(proj, h, w, b, GRU_LN_EPS), kernels.gru_gates_ln_reference(proj, h, w, b, GRU_LN_EPS))]


def _two_hot_nonfinite_inputs(gen, rows: int):
    logits = _poison(torch.randn(rows, 255, generator=gen) * 3, (1, 2, 3), gen).cuda()
    value = _poison(torch.randn(rows, 1, generator=gen) * 10, (4, 5, 6), gen).cuda()
    return logits, value


def _two_hot_lse_picked(logits: torch.Tensor, value: torch.Tensor, low: float = -20.0, high: float = 20.0):
    """The two-hot log-prob in the form of the JAX package's Pallas kernel
    (``sheeprl_tpu/ops/kernels/twohot.py`` ``_loss_kernel``), which picks the
    bracket's two bins instead of summing target * logit over every bin: a
    -inf logit outside the bracket leaves the row finite there, where the
    plain reference's 0 * -inf gives NaN."""
    x = torch.sign(value) * torch.log1p(torch.abs(value))
    k = logits.shape[-1]
    bins = torch.linspace(low, high, k, dtype=logits.dtype, device=logits.device)
    below = (torch.sum((bins <= x).long(), dim=-1, keepdim=True) - 1).clip(0, k - 1)
    above = (k - torch.sum((bins > x).long(), dim=-1, keepdim=True)).clip(0, k - 1)
    equal = below == above
    to_below = torch.where(equal, 1.0, torch.abs(bins[below] - x))
    to_above = torch.where(equal, 1.0, torch.abs(bins[above] - x))
    total = to_below + to_above
    norm = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    return (to_above / total * norm.gather(-1, below) + to_below / total * norm.gather(-1, above))[..., 0]


def _nonfinite_two_hot_lse(gen):
    logits, value = _two_hot_nonfinite_inputs(gen, TWO_HOT_LSE_MAIN)
    return [(kernels.two_hot_symlog_loss_lse(logits, value), _two_hot_lse_picked(logits, value))]


def _nonfinite_two_hot_lse_bwd(gen):
    logits, value = _two_hot_nonfinite_inputs(gen, TWO_HOT_LSE_MAIN)
    grad = torch.ones(TWO_HOT_LSE_MAIN, device="cuda")
    leaf = logits.clone().requires_grad_(True)
    kernels.two_hot_symlog_loss_lse(leaf, value).backward(grad)
    lse = torch.logsumexp(logits, dim=-1)
    return [(leaf.grad, kernels.two_hot_symlog_loss_lse_grad_reference(logits, value, lse, grad))]


def _nonfinite_two_hot_decode(gen):
    logits, _ = _two_hot_nonfinite_inputs(gen, 16384)
    return [(kernels.two_hot_symexp_decode(logits), kernels.two_hot_symexp_decode_reference(logits))]


def _nonfinite_gae(gen):
    rewards = _poison(torch.randn(128, 4, 1, generator=gen), (20, 40, 60), gen).cuda()
    values = _poison(torch.randn(128, 4, 1, generator=gen), (70, 90, 110), gen).cuda()
    dones = (torch.rand(128, 4, 1, generator=gen) < 0.05).to(torch.uint8).cuda()
    next_value = _poison(torch.randn(4, 1, generator=gen), (0, 1, 2), gen).cuda()
    got = kernels.gae(rewards, values, dones, next_value, 0.99, 0.95)
    want = kernels.gae_reference(rewards, values, dones, next_value, 0.99, 0.95)
    return list(zip(got, want))


def _nonfinite_sumtree(gen):
    from sheeprl_tpu_torch.replay import sumtree as st

    leaves, batch = SUMTREE_MAIN
    prio = torch.rand(leaves, generator=gen) * 2
    tree = st.update(st.init(leaves), torch.arange(leaves), prio).cuda()
    u = _poison(torch.rand(batch, generator=gen), (3, 5, 7), gen).cuda()
    pairs = []
    for t in (tree, st.update(tree.clone(), torch.tensor([leaves // 3], device="cuda"),
                              torch.tensor([float("nan")], device="cuda"))):
        (leaf, w), (leaf_ref, w_ref) = (kernels.sumtree_sample(t, u, leaves, 0.4),
                                        kernels.sumtree_sample_reference(t, u, leaves, 0.4))
        if not torch.equal(leaf, leaf_ref):
            raise AssertionError("sumtree_sample drew other leaves than its plain version on non-finite inputs")
        pairs.append((w, w_ref))
    return pairs


def _nonfinite_scatter(gen):
    ring = torch.zeros(64, 4, 18, device="cuda")
    staged = _poison(torch.randn(1, 4, 18, generator=gen), (0, 0, 0), gen).cuda()
    row = torch.tensor([[5, 5, 64, 5]], dtype=torch.int32, device="cuda")  # one slot dropped
    pos = torch.tensor([5, 5, 5, 5], dtype=torch.int32, device="cuda")
    got = kernels.ragged_ring_scatter_keys([ring.clone()], [staged], row, pos)[0]
    want = kernels.ragged_ring_scatter_reference(ring.clone(), staged, row, pos)
    return [(got, want)]


#: each kernel of the guarded paths on inputs seeded with NaN, +inf and -inf
#: at the main path's shapes: (kernel output, plain output) pairs, the plain
#: output in the form of the JAX package's Pallas kernel where that differs
NONFINITE_CHECKS = {
    "gru_gates": _nonfinite_gru,
    "two_hot_symlog_loss_lse": _nonfinite_two_hot_lse,
    "two_hot_symlog_loss_lse_bwd": _nonfinite_two_hot_lse_bwd,
    "two_hot_symexp_decode": _nonfinite_two_hot_decode,
    "gae": _nonfinite_gae,
    "sumtree_sample": _nonfinite_sumtree,
    "ragged_ring_scatter": _nonfinite_scatter,
}


def nonfinite_check(name: str, seed: int = 0) -> dict:
    """One kernel against its plain version on non-finite inputs: the same
    non-finite output positions, and some there at all."""
    gen = torch.Generator().manual_seed(seed)
    counts = []
    for got, want in NONFINITE_CHECKS[name](gen):
        got_bad, want_bad = ~torch.isfinite(got.float()), ~torch.isfinite(want.float())
        if not torch.equal(got_bad, want_bad):
            raise AssertionError(f"{name}: {int((got_bad != want_bad).sum())} output positions are finite on one "
                                 "side only (kernel against its plain version)")
        counts.append(int(got_bad.sum()))
    if not any(counts):
        raise AssertionError(f"{name}: the seeded NaN and Inf inputs gave no non-finite output")
    return {"nonfinite_outputs": counts}


def nonfinite_phase() -> dict:
    out = {name: nonfinite_check(name) for name in NONFINITE_CHECKS}
    log("non-finite inputs, kernel against plain: " + json.dumps(out))
    return out


# -- 22-24. run directories, memmapped replay, hot swap ----------------------------

RUNDIR_ITERATIONS, RUNDIR_EVERY = 6, 1024  # PPO iterations of 512 steps; a save every 2 iterations
RUNDIR_NAN_AT = 5  # the second run's poisoned iteration: it rolls back to its own step 2048
# what the JAX PPO loop logs (sheeprl_tpu/algos/ppo/ppo.py): every iteration,
# and at each log point
PPO_INFO_KEYS = {"Info/learning_rate", "Info/clip_coef", "Info/ent_coef"}
PPO_LOG_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss", "Loss/entropy_loss",
                "Time/sps_train", "Time/sps_env_interaction", "Fault/env_restarts", "Fault/skipped_updates"}


def _rundir_run(root: str, run_name: str, *extra) -> dict:
    """``run preset=ppo`` cut to RUNDIR_ITERATIONS iterations, a save every
    RUNDIR_EVERY steps and ``keep_last`` 2; ``gae`` once per iteration."""
    kernels.reset_launches()
    summary = cli.run([f"preset={PPO_PRESET}", f"algo.total_steps={RUNDIR_ITERATIONS * 512}",
                       f"checkpoint.every={RUNDIR_EVERY}", "checkpoint.keep_last=2", "algo.run_test=false",
                       f"metric.log_every={RUNDIR_EVERY}", f"run_name={run_name}", f"log_root={root}", *extra])
    summary["launches"] = dict(kernels.LAUNCHES)
    _ppo_launch_check(summary, summary["launches"])
    return summary


def _host_ms_per_iteration(summary: dict) -> float:
    """The median host time of an iteration (rollout, GAE, update), the
    first one (warm-up) left out."""
    per = [(r + g + u) * 1e3 for r, g, u in zip(summary["rollout_s"], summary["gae_s"], summary["update_s"])]
    return float(np.median(per[1:]))


def _steps_of(ckpt_dir) -> tuple:
    from sheeprl_tpu_torch.fault import read_manifest

    manifest = [int(e["step"]) for e in read_manifest(ckpt_dir)]
    files = sorted(int(p.name.split("_")[1]) for p in Path(ckpt_dir).glob("*.ckpt"))
    return manifest, files


def _check_metrics_jsonl(log_dir: Path, iterations: int) -> dict:
    """``metrics.jsonl`` holds the JAX loop's keys at its steps: the Info
    keys at every iteration, the losses and the two rates at every log
    point, the episode means at the first, and nothing else."""
    rows = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    by_step: dict = {}
    for row in rows:
        by_step.setdefault(row["step"], set()).update(k for k in row if k != "step")
    log_points = [s for s in range(RUNDIR_EVERY, iterations * 512 + 1, RUNDIR_EVERY)]
    want_loss = {"Loss/value_loss", "Loss/policy_loss", "Loss/entropy_loss", "Time/sps_train",
                 "Time/sps_env_interaction"}
    bad = [s for s in range(512, iterations * 512 + 1, 512)
           if not PPO_INFO_KEYS <= by_step.get(s, set()) or not by_step[s] <= PPO_INFO_KEYS | PPO_LOG_KEYS
           or (s in log_points) != bool(want_loss & by_step[s]) or (s in log_points and not want_loss <= by_step[s])]
    if bad or set(by_step) != set(range(512, iterations * 512 + 1, 512)) or "Rewards/rew_avg" not in by_step[log_points[0]]:
        raise AssertionError(f"metrics.jsonl steps {sorted(by_step)}, keys at the wrong steps {bad}: {by_step}")
    rates = {k: [row[k] for row in rows if k in row] for k in ("Time/sps_train", "Time/sps_env_interaction")}
    return {"log_points": log_points, "keys_by_step": {s: sorted(k) for s, k in by_step.items()}, **rates}


def rundir_phase(workdir: str) -> dict:
    """Three runs of ``preset=ppo`` with one seed and one ``run_name`` into
    one ``log_root``: A at ``metric.log_level=1``; B with a NaN planted at
    iteration RUNDIR_NAN_AT (``max_consecutive=1``); C resumed from A's older
    kept step. Each gets its own ``version_N`` (0, 1, 2), keeps its own
    newest 2 saves, and leaves the others' ``config.json`` as written; B's
    sentinel rolls back to B's own step 2048; ``resume_from=latest`` then
    names C's save, the newest. A's ``metrics.jsonl`` holds the JAX loop's
    keys at the JAX loop's steps. Then host ms per iteration at
    ``log_level`` 1 and 0, in turns (1, 0, 0, 1)."""
    from sheeprl_tpu_torch.fault import DivergenceSentinel, latest_complete

    root = os.path.join(workdir, "rundir")
    base = Path(root) / "ppo" / "CartPole-v1" / "rundir"
    t0 = time.perf_counter()
    a = _rundir_run(root, "rundir", "metric.log_level=1")
    a_dir = Path(a["log_dir"])
    written = {p: p.read_bytes() for p in (a_dir / "config.json", a_dir / "checkpoint" / "config.json")}

    rolled = []
    real_recover = DivergenceSentinel.recover

    def recover(self, ckpt_dir, rollback):
        rolled.append(str(latest_complete(ckpt_dir)))
        return real_recover(self, ckpt_dir, rollback)

    DivergenceSentinel.recover = recover
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            b = _rundir_run(root, "rundir", "metric.log_level=0", f"fault.inject.nan_grads_at=[{RUNDIR_NAN_AT}]",
                            "fault.sentinel.max_consecutive=1")
    finally:
        DivergenceSentinel.recover = real_recover
    b_dir = Path(b["log_dir"])
    written.update({p: p.read_bytes() for p in (b_dir / "config.json", b_dir / "checkpoint" / "config.json")})

    older = a_dir / "checkpoint" / f"ckpt_{(RUNDIR_ITERATIONS - 2) * 512}_0.ckpt"
    kernels.reset_launches()
    c = cli.run([f"checkpoint.resume_from={older}", f"log_root={root}", "run_name=rundir", "metric.log_level=0"])
    c["launches"] = dict(kernels.LAUNCHES)
    _ppo_launch_check(c, c["launches"])
    c_dir = Path(c["log_dir"])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        latest = cli.compose_run_config([f"preset={PPO_PRESET}", f"log_root={root}", "checkpoint.resume_from=latest"])

    last, before_last = RUNDIR_ITERATIONS * 512, (RUNDIR_ITERATIONS - 2) * 512
    steps = {"A": _steps_of(a_dir / "checkpoint"), "B": _steps_of(b_dir / "checkpoint"),
             "C": _steps_of(c_dir / "checkpoint")}
    checks = {
        "versions": [p.name for p in (a_dir, b_dir, c_dir)] == ["version_0", "version_1", "version_2"]
        and all(p.parent == base for p in (a_dir, b_dir, c_dir)),
        "own_saves": steps["A"] == steps["B"] == ([before_last, last],) * 2 and steps["C"] == ([last], [last]),
        "configs_unchanged": all(p.read_bytes() == text for p, text in written.items()),
        "rollback_own_dir": rolled == [str(b_dir / "checkpoint" / "ckpt_2048_0.ckpt")] and b["rollbacks"] == 1
        and b["skipped"][RUNDIR_NAN_AT - 1] == 80.0,
        "resume_latest": latest.checkpoint.resume_from == c["checkpoint"]
        and f"checkpoint.resume_from=latest -> {c['checkpoint']}" in printed.getvalue(),
        "resumed_from_older": c["start_iter"] == RUNDIR_ITERATIONS - 1 and c["iterations"] == 2,
    }
    if not all(checks.values()):
        raise AssertionError(f"run directories: {checks}, saves {steps}, rolled back to {rolled}")
    metrics = _check_metrics_jsonl(a_dir, RUNDIR_ITERATIONS)
    out = {"checks": checks, "saves": steps, "rolled_back_to": rolled[0], "metrics": metrics,
           "launches": a["launches"], "launches_b": b["launches"], "launches_c": c["launches"],
           "runs_s": time.perf_counter() - t0}

    # logging's host cost: the same run at log_level 1 and 0, in turns
    timing = {1: [_host_ms_per_iteration(a)], 0: []}
    for level in (0, 0, 1):
        timing[level].append(_host_ms_per_iteration(_rundir_run(root, f"timing_{level}", f"metric.log_level={level}")))
    out["host_ms_per_iteration"] = {"log_level_1": timing[1], "log_level_0": timing[0]}
    out["sps_train_last"], out["sps_env_interaction_last"] = metrics["Time/sps_train"][-1], \
        metrics["Time/sps_env_interaction"][-1]
    log(f"rundir: Time/sps_train {metrics['Time/sps_train']}, Time/sps_env_interaction "
        f"{metrics['Time/sps_env_interaction']}; host ms per iteration at log_level 1 {timing[1]} and 0 {timing[0]}")
    log("rundir: " + json.dumps({k: v for k, v in out.items() if k != "metrics"}))
    return out


MEMMAP_LEARNING_STARTS, MEMMAP_GRADIENT_STEPS = 64, 3
MEMMAP_RESUME_STEPS = 4


def _memmap_run(root: str, memmap: bool, *extra) -> dict:
    """DreamerV3-S host run (full width) with ``buffer.memmap``: the launch
    counts of the path, the buffer files seen at the first batch draw, and
    the timers (on at ``log_level=0`` through ``disable_timer=false``):
    host ms per env step and per gradient-step batch draw."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.utils.timer import timer

    seen = []

    class _Watching(dv3.EnvIndependentReplayBuffer):
        def sample(self, *args, **kwargs):
            if not seen:
                first = self.buffer[0].buffer
                seen.extend(v.filename if hasattr(v, "filename") else None for v in first.values())
            return super().sample(*args, **kwargs)

    total = MEMMAP_LEARNING_STARTS + MEMMAP_GRADIENT_STEPS - 1
    kernels.reset_launches()
    timer.reset()
    dv3.EnvIndependentReplayBuffer = _Watching
    try:
        summary = cli.run([f"preset={RUN_PRESET}", "algo.hybrid_player.enabled=false",
                           f"algo.learning_starts={MEMMAP_LEARNING_STARTS}",
                           f"algo.total_steps={total}", "checkpoint.every=0", "checkpoint.save_last=true",
                           "metric.log_level=0", "metric.disable_timer=false", "algo.run_test=false",
                           f"buffer.memmap={memmap}", f"log_root={root}", *extra])
    finally:
        dv3.EnvIndependentReplayBuffer = _Watching.__bases__[0]
    summary["launches"] = dict(kernels.LAUNCHES)
    times = timer.compute()
    steps = summary["policy_steps"] - (summary["start_iter"] - 1)
    summary["host_ms_per_env_step"] = times["Time/env_interaction_time"] / steps * 1e3
    summary["host_ms_per_batch_draw"] = times["Time/replay_path_time"] / max(1, summary["train_calls"]) * 1e3
    summary["files"] = seen
    return summary


def _dreamer_launch_want(summary: dict, T: int, H: int) -> dict:
    G = summary["gradient_steps"]
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update({"two_hot_symlog_loss_lse": 3 * G, "two_hot_symlog_loss_lse_bwd": 3 * G,
                 "two_hot_symexp_decode": 3 * G,
                 "gru_gates": G * (T + H) + summary["player_steps"] + (summary["test_steps"] or 0)})
    return want


def memmap_phase(workdir: str) -> dict:
    """DreamerV3-S host runs of one seed with ``buffer.memmap`` on and off:
    the first gradient step's losses bit-equal, the memmapped run's files
    under its ``memmap_buffer/rank_0/env_0``, the launch counts of the path;
    a resume of the memmapped run restores the buffer equal to the saved one
    into files of its own run directory; host ms per env step and per batch
    draw both ways, in turns (on, off, off, on)."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3

    root = os.path.join(workdir, "memmap")
    # cuDNN's default convolution weight-gradient accumulates in a run-to-run
    # order: the world model's first update, and so the actor's and critic's
    # first losses after it, would differ in the last bit between two runs
    # of the same data; its deterministic algorithms hold them bit-equal
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {"on": [_memmap_run(root, True)], "off": [_memmap_run(root, False)]}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    on, off = runs["on"][0], runs["off"][0]
    cfg = load_config(find_run_config(on["checkpoint"]))
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    for s in (on, off):
        want = _dreamer_launch_want(s, T, H)
        if s["launches"] != want or s["gradient_steps"] < MEMMAP_GRADIENT_STEPS or s["device"].split(":")[0] != "cuda":
            raise AssertionError(f"memmap run: launches {s['launches']} != {want}, {s['gradient_steps']} gradient steps")
    env_dir = Path(on["log_dir"]) / "memmap_buffer" / "rank_0" / "env_0"
    keys = ["actions", "is_first", "rewards", "rgb", "terminated", "truncated"]
    if sorted(on["files"]) != [str(env_dir / f"{k}.memmap") for k in keys] or any(off["files"]):
        raise AssertionError(f"memmap files {on['files']} (want {keys} under {env_dir}); in memory {off['files']}")
    if on["metrics"][0] != off["metrics"][0]:
        raise AssertionError(f"first gradient step's losses differ: {on['metrics'][0]} != {off['metrics'][0]}")

    saved = load_checkpoint(on["checkpoint"])["rb"]
    restored = []

    class _Recording(dv3.EnvIndependentReplayBuffer):
        def load_state_dict(self, state):
            super().load_state_dict(state)
            restored.append((self.state_dict(), [v.filename for v in self.buffer[0].buffer.values()]))

    kernels.reset_launches()
    dv3.EnvIndependentReplayBuffer = _Recording
    try:
        resumed = cli.run([f"checkpoint.resume_from={on['checkpoint']}", "metric.log_level=0", "algo.learning_starts=2",
                           f"algo.total_steps={on['policy_steps'] + MEMMAP_RESUME_STEPS}", "checkpoint.save_last=false",
                           f"log_root={root}"])
    finally:
        dv3.EnvIndependentReplayBuffer = _Recording.__bases__[0]
    resume_launches = dict(kernels.LAUNCHES)
    (state, files), = restored
    same = state["rng"] == saved["rng"] and all(
        got[k] == want[k] for got, want in zip(state["envs"], saved["envs"]) for k in ("pos", "full", "rng"))
    same = same and all(torch.equal(got["buffer"][k], v) for got, want in zip(state["envs"], saved["envs"])
                        for k, v in want["buffer"].items())
    own = Path(resumed["log_dir"]) / "memmap_buffer" / "rank_0" / "env_0"
    if not same or sorted(files) != [str(own / f"{k}.memmap") for k in keys] or own == env_dir:
        raise AssertionError(f"memmap resume: buffer restored equal {same}, files {files} (want under {own})")
    if resume_launches != _dreamer_launch_want(resumed, T, H) or resumed["gradient_steps"] == 0:
        raise AssertionError(f"memmap resume launches {resume_launches}")

    for memmap in (False, True):  # the timing pair's second half, in turns
        runs["on" if memmap else "off"].append(_memmap_run(root, memmap))
    out = {
        "first_step_losses_bit_equal": True,
        "first_step_losses": dict(zip(METRIC_NAMES, on["metrics"][0])),
        "losses_equal_every_step": [a == b for a, b in zip(on["metrics"], off["metrics"])],
        "files": sorted(Path(f).name for f in on["files"]),
        "launches": on["launches"], "launches_off": off["launches"], "resume_launches": resume_launches,
        "resume_restored_equal": True,
        "host_ms_per_env_step": {k: [r["host_ms_per_env_step"] for r in v] for k, v in runs.items()},
        "host_ms_per_batch_draw": {k: [r["host_ms_per_batch_draw"] for r in v] for k, v in runs.items()},
        "gradient_steps": on["gradient_steps"],
    }
    log("memmap: " + json.dumps(out))
    return out


HOTSWAP_ITERATIONS = 6  # the training run publishes a save every iteration (512 steps)
HOTSWAP_CLIENTS = 8
HOTSWAP_POLL_S = 0.2


def hotswap_phase(workdir: str) -> dict:
    """``serve`` of a PPO checkpoint with ``serve.watch=true`` and
    ``watch_poll_s`` HOTSWAP_POLL_S while the run that wrote it trains on and
    publishes a save per iteration into the watched directory, and
    HOTSWAP_CLIENTS clients keep sending requests of 1-4 rows. Versions only
    go up per client; no request fails; every answer equals the card's
    greedy program of the save its version was published from; a rotted
    save planted after the run is quarantined while serving goes on. The
    training run launches ``gae`` once per iteration and serving launches no
    kernel. Prints the publish-to-first-served latency."""
    from sheeprl_tpu_torch.fault.inject import plant_torn_checkpoint
    from sheeprl_tpu_torch.fault.manager import CheckpointManager, complete_entries, read_manifest
    from sheeprl_tpu_torch.serve import server as server_module
    from sheeprl_tpu_torch.utils.registry import resolve_policy_builder

    root = os.path.join(workdir, "hotswap")
    ckpt_dir = Path(root) / "ppo" / "CartPole-v1" / "hotswap" / "version_0" / "checkpoint"
    gate, train = threading.Event(), {}
    real_save = CheckpointManager.save

    def gated_save(self, path, state, step=None, config=None):
        if int(step or 0) > 512:  # the run's later saves wait until the clients are sending
            gate.wait(300)
        return real_save(self, path, state, step=step, config=config)

    def train_run() -> None:
        try:
            train["summary"] = cli.run([f"preset={PPO_PRESET}", f"algo.total_steps={HOTSWAP_ITERATIONS * 512}",
                                        "checkpoint.every=512", "checkpoint.keep_last=0", "metric.log_level=0",
                                        "algo.run_test=false", "run_name=hotswap", f"log_root={root}"])
        except BaseException as e:  # reported by the main thread
            train["error"] = e

    watchers = []

    class _Recorded(server_module.CheckpointWatcher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            watchers.append(self)

    kernels.reset_launches()
    CheckpointManager.save = gated_save
    trainer = threading.Thread(target=train_run, daemon=True)
    trainer.start()
    deadline = time.monotonic() + 300
    while not (ckpt_dir.is_dir() and complete_entries(ckpt_dir)) and "error" not in train:
        if time.monotonic() > deadline:
            raise TimeoutError("the hot-swap training run published no checkpoint")
        time.sleep(0.05)
    first = complete_entries(ckpt_dir)[0][2]
    rng = np.random.default_rng(21)
    records, errors = [], []
    planted = {}

    def client(port: int, result: dict) -> None:
        stop = threading.Event()
        probe = _Conn(port, deadline)

        def one(i: int) -> None:
            try:
                conn = _Conn(port, deadline)
                local = np.random.default_rng(100 + i)
                while not stop.is_set():
                    rows = _stateless_rows(local, "ppo", int(local.integers(1, 5)))
                    resp = conn.ask({"obs": {"state": rows.tolist()}, "n": len(rows)})
                    if "actions" not in resp:
                        raise AssertionError(f"client {i}: {resp}")
                    records.append((i, time.time(), int(resp["version"]), rows, np.asarray(resp["actions"])))
                conn.close()
            except BaseException as e:  # reported by the main thread
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(HOTSWAP_CLIENTS)]
        for th in threads:
            th.start()
        gate.set()
        trainer.join(timeout=600)
        final_step = HOTSWAP_ITERATIONS * 512
        while probe.ask({"health": True})["weights"]["step"] != final_step and time.monotonic() < deadline:
            time.sleep(0.05)
        planted["path"] = plant_torn_checkpoint(ckpt_dir, f"ckpt_{final_step + 512}_0.ckpt",
                                                load_checkpoint(ckpt_dir / f"ckpt_{final_step}_0.ckpt"),
                                                step=final_step + 512)
        planted["time"] = time.time()
        while not probe.ask({"health": True}).get("watcher", {}).get("quarantined") and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)  # serving goes on past the quarantine
        stop.set()
        for th in threads:
            th.join(timeout=60)
        result["health"] = probe.ask({"health": True})
        probe.close()

    server_module.CheckpointWatcher = _Recorded
    try:
        result = _serve_with([f"checkpoint_path={first}", "serve.watch=true", f"serve.watch_poll_s={HOTSWAP_POLL_S}",
                              "serve.buckets=[1,8,32,128]", "serve.max_wait_ms=2.0"], client, reset=False)
    finally:
        server_module.CheckpointWatcher = _Recorded.__bases__[0]
        CheckpointManager.save = real_save
        gate.set()
    trainer.join(timeout=60)
    launches = dict(kernels.LAUNCHES)
    if "error" in train:
        raise train["error"]
    if errors:
        raise errors[0]
    summary = train["summary"]
    _ppo_launch_check(summary, launches)  # gae once per training iteration; serving launched nothing
    history = watchers[0].history
    step_of = {0: 512, **{v: s for s, v, _ in history}}
    cfg = load_config(find_run_config(first))
    builder = resolve_policy_builder("ppo")
    mismatched, by_version = 0, {}
    for i, t, version, rows, actions in records:
        by_version.setdefault(version, []).append((rows, actions))
    for version, pairs in by_version.items():
        policy = builder(cfg, load_checkpoint(ckpt_dir / f"ckpt_{step_of[version]}_0.ckpt"), "cuda")
        for rows, actions in pairs:
            obs = policy.prepare({"state": rows}, len(rows))
            with torch.no_grad():
                want = policy.greedy_fn(policy.params, {k: torch.from_numpy(v).cuda() for k, v in obs.items()})
            mismatched += int(not np.array_equal(actions, want.cpu().numpy()))
    monotone = all([v for c, _, v, _, _ in records if c == i] == sorted(v for c, _, v, _, _ in records if c == i)
                   for i in range(HOTSWAP_CLIENTS))
    manifest_time = {int(e["step"]): float(e["time"]) for e in read_manifest(ckpt_dir)}
    latency = []
    for step, version, published in history:
        served = [t for _, t, v, _, _ in records if v >= version]
        if served:
            latency.append({"step": step, "version": version, "manifest_to_served_ms": (min(served) - manifest_time[step]) * 1e3,
                            "publish_to_served_ms": (min(served) - published) * 1e3})
    health = result["health"]
    after_rot = [v for _, t, v, _, _ in records if t > planted["time"]]
    checks = {
        "every_request_answered_equal": mismatched == 0 and len(records) > 100,
        "monotone_per_client": monotone,
        "swapped_each_save": [s for s, _, _ in history] == sorted(s for s, _, _ in history)
        and history[-1][0] == HOTSWAP_ITERATIONS * 512 and len(by_version) >= 3,
        "quarantined": health["watcher"]["quarantined"] == [str(planted["path"])] and health["status"] == "ok"
        and health["weights"]["step"] == HOTSWAP_ITERATIONS * 512,
        "serving_after_rot": len(after_rot) > 0 and max(after_rot) == history[-1][1],
    }
    if not all(checks.values()):
        raise AssertionError(f"hot swap: {checks}, history {history}, {mismatched} mismatched answers, health {health}")
    out = {"checks": checks, "requests": len(records), "versions_served": sorted(by_version),
           "published_steps": [s for s, _, _ in history], "launches": launches, "latency": latency,
           "watcher": health["watcher"], "serve_launches_zero": True}
    log("hot swap: " + json.dumps(out))
    return out


# -- 25-30. the PPO family: A2C, recurrent PPO, continuous PPO ------------------------

A2C_PRESET, RECURRENT_PRESET = "a2c", "ppo_recurrent"
A2C_UPDATES = 8  # full-width A2C updates held card against CPU, each from the card's state
# learning floors (PERF.md). A2C: the best mean return over A2C_WINDOW
# consecutive episodes of the full 25,000-step recipe, because its last-10
# mean is a gamble (CPU runs read 9.5-145.4 across seeds: the policy
# collapses on some); the JAX recipe's CPU run reads a best of 252.0 (last-10
# 58.2), random play ~22. Recurrent PPO: the last-10 mean at
# RECURRENT_ITERATIONS of the recipe's 49 iterations; the JAX recipe's CPU
# run at that cut reads 364.1
A2C_WINDOW, A2C_RETURN_BAR = 10, 100.0
RECURRENT_ITERATIONS = 16
RECURRENT_LAST_EPISODES, RECURRENT_RETURN_BAR = 10, 150.0
CONTINUOUS_ITERATIONS = 4  # continuous PPO on Pendulum-v1: finite losses and card-vs-CPU checks, no floor
RECURRENT_SESSIONS, RECURRENT_SESSION_STEPS = 8, 16


def _family_launch_check(name: str, summary: dict, launches: dict) -> None:
    """``gae`` exactly once per iteration, no other kernel."""
    want = dict({k: 0 for k in kernels.LAUNCHES}, gae=summary["iterations"])
    if launches != want:
        raise AssertionError(f"{name} launches {launches} != {want} for {summary['iterations']} iterations")


def _capture_grads(optimizer) -> dict:
    """Keep the gradients each ``optimizer.step`` is handed."""
    seen = {"grads": []}
    step = optimizer.step

    def capturing(grads):
        seen["grads"] = [g.detach().clone() for g in grads]
        step(grads)

    optimizer.step = capturing
    return seen


def _grad_rel_err(card, cpu) -> float:
    """The whole gradient, every parameter's in one vector: its distance from
    the CPU's over the CPU's norm."""
    g_card = torch.cat([g.cpu().reshape(-1) for g in card])
    g_cpu = torch.cat([g.reshape(-1) for g in cpu])
    return float((g_card - g_cpu).norm() / g_cpu.norm().clamp(min=1e-30))


def _max_param_err(a: dict, b: dict) -> float:
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in b)


def _profile_call(fn, reps: int = 3) -> dict:
    """``fn`` (ending in a host read) after one warm-up call: host ms, and
    device ms, operations and the top kernels under ``torch.profiler``."""
    fn()
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        fn()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
    lstm_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events
                  if any(w in e.key.lower() for w in ("lstm", "rnn")))
    return {
        "host_ms": float(np.median(host) * 1e3),
        "host_ms_all": [h * 1e3 for h in host],
        "device_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": device_us / 1e3 / (np.median(host) * 1e3) if device_us > 0 else None,
        "device_ops": sum(e.count for e in events),
        "lstm_device_ms": lstm_us / 1e3,
        "top": [{"name": e.key[:80], "device_ms": getattr(e, "self_device_time_total", 0.0) / 1e3, "count": e.count}
                for e in top],
    }


def _cartpole_batch(rng, rows: int) -> dict:
    data = {
        "state": (rng.uniform(-1, 1, (rows, 4)) * np.array([2.4, 2.0, 0.2, 2.0])).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)],
        "values": rng.normal(size=(rows, 1)).astype(np.float32),
        "returns": (rng.normal(size=(rows, 1)) * 3).astype(np.float32),
        "advantages": rng.normal(size=(rows, 1)).astype(np.float32),
        "rewards": np.ones((rows, 1), np.float32),
        "dones": (rng.uniform(size=(rows, 1)) < 0.05).astype(np.uint8),
    }
    return {k: torch.from_numpy(v) for k, v in data.items()}


def a2c_update_phase() -> dict:
    """A2C_UPDATES full-width A2C updates (20 rows = 4 envs x 5 steps, 4
    minibatches of 5, ``loss_reduction`` sum, the gradients summed, clipped
    at 0.5, one RMSprop step) on the card, each held against the same
    update on the CPU taken from the card's weights and RMSprop state just
    before it, TF32 off: the two losses within rtol 1e-5 (atol 1e-6), the
    summed gradient within PPO_GRAD_RTOL of its norm (float32 sums in
    another order; tanh has no kink), and the CPU's clipped RMSprop step on
    the card's own gradient within PPO_ADAM_ATOL of the card's step."""
    from sheeprl_tpu_torch.algos.a2c.a2c import make_optimizer, make_train_step
    from sheeprl_tpu_torch.algos.a2c.agent import build_agent

    cfg = preset(A2C_PRESET)
    rows = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
    spaces = {"state": {"shape": [4]}}
    parts = {}
    for dev in ("cpu", "cuda"):
        agent, _ = build_agent(cfg, (2,), False, spaces, dev)
        optimizer = make_optimizer(cfg, agent)
        parts[dev] = (agent, optimizer, make_train_step(agent, optimizer, cfg, rows), _capture_grads(optimizer))
    (cpu_agent, cpu_opt, cpu_train, cpu_seen), (card_agent, card_opt, card_train, card_seen) = parts["cpu"], parts["cuda"]
    rng = np.random.default_rng(21)
    gen = torch.Generator().manual_seed(22)
    worst = {"loss_max_rel_err": 0.0, "grad_max_rel_err": 0.0, "rmsprop_max_abs_err": 0.0, "param_max_abs_err": 0.0}
    for _ in range(A2C_UPDATES):
        data = _cartpole_batch(rng, rows)
        perm = torch.randperm(rows, generator=gen)
        before = {k: v.detach().cpu().clone() for k, v in card_agent.state_dict().items()}
        opt_before = copy.deepcopy(card_opt.state_dict())
        cpu_agent.load_state_dict(before)
        cpu_opt.load_state_dict(copy.deepcopy(opt_before))
        on_card = card_train({k: v.cuda() for k, v in data.items()}, perm=perm.cuda()).cpu()
        on_cpu = cpu_train(data, perm=perm)
        torch.testing.assert_close(on_card, on_cpu, rtol=1e-5, atol=1e-6)
        worst["loss_max_rel_err"] = max(worst["loss_max_rel_err"],
                                        float(((on_card - on_cpu).abs() / on_cpu.abs().clamp(min=1e-12)).max()))
        err = _grad_rel_err(card_seen["grads"], cpu_seen["grads"])
        if err > PPO_GRAD_RTOL:
            raise AssertionError(f"one A2C update on the card: the summed gradient is {err} of its norm from the CPU's")
        worst["grad_max_rel_err"] = max(worst["grad_max_rel_err"], err)
        card_state = card_agent.state_dict()
        worst["param_max_abs_err"] = max(worst["param_max_abs_err"], _max_param_err(card_state, cpu_agent.state_dict()))
        cpu_agent.load_state_dict(before)
        cpu_opt.load_state_dict(copy.deepcopy(opt_before))
        cpu_opt.step([g.cpu() for g in card_seen["grads"]])
        step_err = _max_param_err(card_state, cpu_agent.state_dict())
        if step_err > PPO_ADAM_ATOL:
            raise AssertionError(f"one RMSprop step on the card moved a parameter {step_err} from the CPU's "
                                 "on the same gradient")
        worst["rmsprop_max_abs_err"] = max(worst["rmsprop_max_abs_err"], step_err)
    out = {"updates": A2C_UPDATES, "rows": rows, "minibatches": rows // int(cfg.algo.per_rank_batch_size), **worst}
    log("A2C update (card vs CPU): " + json.dumps(out))
    return out


def _best_window_mean(returns, window: int) -> float:
    r = np.asarray(returns, dtype=np.float64)
    return float(np.convolve(r, np.ones(window) / window, mode="valid").max()) if r.size >= window else float("nan")


def a2c_run_phase(workdir: str) -> dict:
    """A2C on CartPole-v1 through ``run`` at the JAX recipe (25,000 steps, 4
    envs x 5 steps: 1,250 iterations, each one accumulated RMSprop update):
    ``gae`` launched exactly once per iteration and no other kernel; every
    loss finite; the best mean return over A2C_WINDOW consecutive episodes
    at least A2C_RETURN_BAR; a resume from the last checkpoint for two more
    iterations, its counters going on; ``evaluation`` of the checkpoint
    equal to the run's own test episode, no kernel launched; one update
    from the checkpoint under ``torch.profiler``."""
    from sheeprl_tpu_torch.algos.a2c.a2c import make_optimizer, make_train_step
    from sheeprl_tpu_torch.algos.a2c.agent import build_agent

    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run([f"preset={A2C_PRESET}", "metric.log_level=0", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    iters, steps = summary["iterations"], summary["policy_steps"]
    if iters != 1250 or steps != 25000 or summary["device"].split(":")[0] != "cuda":
        raise AssertionError(f"A2C run took {iters} iterations, {steps} steps on {summary['device']}")
    _family_launch_check("A2C", summary, launches)
    if not np.isfinite(np.asarray(summary["losses"])).all():
        raise AssertionError("non-finite A2C losses")
    returns = [ret for _, _, ret, _ in summary["episodes"]]
    best = _best_window_mean(returns, A2C_WINDOW)
    if not best >= A2C_RETURN_BAR:
        raise AssertionError(f"A2C did not learn CartPole: best mean over {A2C_WINDOW} episodes {best}")
    rollout_ms = [s * 1e3 for s in summary["rollout_s"]]
    update_ms = [s * 1e3 for s in summary["update_s"]]
    out = {
        "iterations": iters, "policy_steps": steps, "launches": launches, "wall_s": wall,
        "env_steps_per_s": summary["env_steps_per_s"],
        "host_ms_per_iteration": {"rollout_median": float(np.median(rollout_ms)),
                                  "gae_median": float(np.median([s * 1e3 for s in summary["gae_s"]])),
                                  "update_median": float(np.median(update_ms))},
        "episodes": len(returns), "first_10_mean_return": float(np.mean(returns[:10])),
        f"best_{A2C_WINDOW}_mean_return": best, "last_10_mean_return": float(np.mean(returns[-10:])),
        "test_reward": summary["test_reward"], "test_steps": summary["test_steps"],
        "losses_last": summary["losses"][-1], "checkpoint": summary["checkpoint"],
        "saves": len(summary["checkpoint_timings"]) if summary.get("checkpoint_timings") is not None else None,
    }
    log("A2C run: " + json.dumps({k: v for k, v in out.items() if k != "checkpoint"}))

    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                       f"algo.total_steps={steps + 40}", "algo.run_test=false", f"log_root={workdir}"])
    resume_launches = dict(kernels.LAUNCHES)
    if resumed["start_iter"] != iters + 1 or resumed["iterations"] != 2 or resumed["policy_steps"] != steps + 40:
        raise AssertionError(f"A2C resume: start {resumed['start_iter']}, {resumed['iterations']} iterations")
    _family_launch_check("A2C resume", resumed, resume_launches)
    out["resume"] = {"start_iter": resumed["start_iter"], "launches": resume_launches, "losses": resumed["losses"]}

    kernels.reset_launches()
    t1 = time.perf_counter()
    result = cli.evaluation([f"checkpoint_path={summary['checkpoint']}"])
    eval_launches = dict(kernels.LAUNCHES)
    if (result["device"].split(":")[0] != "cuda" or any(eval_launches.values())
            or result["reward"] != summary["test_reward"] or result["steps"] != summary["test_steps"]):
        raise AssertionError(f"A2C evaluation {result} against the run's test {summary['test_reward']}, "
                             f"launches {eval_launches}")
    out["evaluation"] = {**result, "launches": eval_launches, "wall_s": time.perf_counter() - t1,
                         "equals_run_test": True}
    log("A2C resume and evaluation: " + json.dumps({"resume": out["resume"], "evaluation": out["evaluation"]}))

    cfg = load_config(find_run_config(summary["checkpoint"]))
    state = load_checkpoint(summary["checkpoint"])
    agent, _ = build_agent(cfg, (2,), False, cfg.spaces.obs, "cuda", state["agent"])
    optimizer = make_optimizer(cfg, agent)
    optimizer.load_state_dict(state["optimizer"])
    train = make_train_step(agent, optimizer, cfg, 20)
    data = {k: v.cuda() for k, v in _cartpole_batch(np.random.default_rng(23), 20).items()}
    gen = torch.Generator(device="cuda").manual_seed(24)
    out["profile"] = _profile_call(lambda: train(data, generator=gen).cpu())
    log("A2C update profile: " + json.dumps(out["profile"]))
    return out


def ppo_recurrent_run_phase(workdir: str) -> dict:
    """Recurrent PPO on CartPole-v1 through ``run`` at the full recipe's
    widths (16 envs x 512 steps, sequences of 16, 8 epochs x 8 minibatches,
    LSTM 64), its depth cut to RECURRENT_ITERATIONS of the recipe's 49
    iterations: ``gae`` launched exactly once per iteration and no other
    kernel; every loss finite; the last RECURRENT_LAST_EPISODES episodes'
    mean return at least RECURRENT_RETURN_BAR; a one-iteration resume from
    the checkpoint; one update under ``torch.profiler``. The first
    iteration's rollout is kept for the update phase."""
    from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as rec_loop
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent

    recorded = {}
    prepare = rec_loop.prepare_update

    def keep(local, returns, advantages, *args):
        if not recorded:
            recorded["args"] = ({k: np.array(v) for k, v in local.items()}, np.array(returns), np.array(advantages),
                                *args[:-1])
        return prepare(local, returns, advantages, *args)

    per_iter = 16 * 512
    kernels.reset_launches()
    rec_loop.prepare_update = keep
    t0 = time.perf_counter()
    try:
        summary = cli.run([f"preset={RECURRENT_PRESET}", f"algo.total_steps={RECURRENT_ITERATIONS * per_iter}",
                           "metric.log_level=0", f"log_root={workdir}"])
    finally:
        rec_loop.prepare_update = prepare
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    iters = summary["iterations"]
    if iters != RECURRENT_ITERATIONS or summary["device"].split(":")[0] != "cuda":
        raise AssertionError(f"recurrent PPO run took {iters} iterations on {summary['device']}")
    _family_launch_check("recurrent PPO", summary, launches)
    if not np.isfinite(np.asarray(summary["losses"])).all():
        raise AssertionError(f"non-finite recurrent PPO losses: {summary['losses']}")
    returns = [ret for _, _, ret, _ in summary["episodes"]]
    last = float(np.mean(returns[-RECURRENT_LAST_EPISODES:]))
    if len(returns) < RECURRENT_LAST_EPISODES or not last >= RECURRENT_RETURN_BAR:
        raise AssertionError(f"recurrent PPO did not learn CartPole: last {RECURRENT_LAST_EPISODES} mean {last}")
    ms = {k: [s * 1e3 for s in summary[k]] for k in ("rollout_s", "gae_s", "update_s")}
    out = {
        "iterations": iters, "policy_steps": summary["policy_steps"], "launches": launches, "wall_s": wall,
        "env_steps_per_s": summary["env_steps_per_s"], "sequences": summary["sequences"],
        "host_ms_per_iteration": {f"{k[:-2]}_median": float(np.median(v)) for k, v in ms.items()},
        "host_ms_ranges": {k[:-2]: [min(v), max(v)] for k, v in ms.items()},
        "episodes": len(returns), "first_10_mean_return": float(np.mean(returns[:10])),
        "last_10_mean_return": last, f"best_{A2C_WINDOW}_mean_return": _best_window_mean(returns, A2C_WINDOW),
        "test_reward": summary["test_reward"], "test_steps": summary["test_steps"],
        "losses_first": summary["losses"][0], "losses_last": summary["losses"][-1],
        "checkpoint": summary["checkpoint"],
    }
    log("recurrent PPO run: " + json.dumps({k: v for k, v in out.items() if k != "checkpoint"}))

    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                       f"algo.total_steps={summary['policy_steps'] + per_iter}", "algo.run_test=false",
                       f"log_root={workdir}"])
    resume_launches = dict(kernels.LAUNCHES)
    if resumed["start_iter"] != iters + 1 or resumed["iterations"] != 1:
        raise AssertionError(f"recurrent PPO resume: start {resumed['start_iter']}, {resumed['iterations']} iterations")
    _family_launch_check("recurrent PPO resume", resumed, resume_launches)
    if not np.isfinite(np.asarray(resumed["losses"])).all():
        raise AssertionError(f"non-finite recurrent PPO losses after the resume: {resumed['losses']}")
    out["resume"] = {"start_iter": resumed["start_iter"], "launches": resume_launches, "losses": resumed["losses"]}
    log("recurrent PPO resume: " + json.dumps(out["resume"]))

    cfg = load_config(find_run_config(summary["checkpoint"]))
    state = load_checkpoint(summary["checkpoint"])
    agent, _ = build_agent(cfg, (2,), False, cfg.spaces.obs, "cuda", state["agent"])
    optimizer = rec_loop.make_optimizer(cfg, agent)
    optimizer.load_state_dict(state["optimizer"])
    data = rec_loop.prepare_update(*recorded["args"], "cuda")
    train = rec_loop.make_train_step(agent, optimizer, cfg, int(data["mask"].shape[1]))
    gen = torch.Generator(device="cuda").manual_seed(25)
    out["profile"] = {"sequences": int(data["mask"].shape[1]),
                      **_profile_call(lambda: train(data, 0.2, 0.001, generator=gen).cpu())}
    log("recurrent PPO update profile: " + json.dumps(out["profile"]))
    out["recorded"] = recorded["args"]
    return out


def _recurrent_kinks(card: dict, cpu: dict, batch: dict, clip: float) -> tuple:
    """The kinks one recurrent step crossed on one machine only, and the kink
    inputs it had: ReLU inputs (the MLPs' LayerNorm outputs) of another
    sign, and real (masked-in) steps whose policy ratio lies on another side
    of 1 -+ clip (or within 1e-5 of it on either machine)."""
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(card["relu"], cpu["relu"]))
    inputs = sum(a.numel() for a in cpu["relu"])
    valid = batch["mask"].cpu().reshape(-1) > 0
    sides = []
    for seen in (card, cpu):
        logprob = (torch.log_softmax(seen["logits"][0], -1) * batch["actions"].cpu()).sum(-1).reshape(-1)
        ratio = torch.exp(logprob - batch["logprobs"].cpu().reshape(-1))
        sides.append((torch.sign(ratio - (1 - clip)), torch.sign(ratio - (1 + clip)),
                      torch.minimum((ratio - (1 - clip)).abs(), (ratio - (1 + clip)).abs()) <= 1e-5))
    rows = ((sides[0][0] != sides[1][0]) | (sides[0][1] != sides[1][1]) | sides[0][2] | sides[1][2]) & valid
    return flips + int(rows.sum()), inputs + int(valid.sum())


def ppo_recurrent_update_phase(recorded: tuple) -> dict:
    """One full-width recurrent PPO update from the run's first recorded
    16 x 512 rollout, chunked into sequences of 16 and bucketed (``S_pad``
    = 8 * 2**k), 8 epochs x 8 minibatches of ``S_pad / 8`` sequences; every
    one of its 64 minibatch steps on the card held against the same step on
    the CPU from the card's weights and Adam state just before it, TF32 off:
    the step's three losses within rtol 1e-5 (atol 1e-6); the whole gradient
    within PPO_GRAD_RTOL of its norm on a step that crossed no kink (cuDNN's
    LSTM and the CPU's sum in other orders), within PPO_KINK_GRAD_RTOL on one
    that did, with at most PPO_KINK_SHARE of its kink inputs crossed, or
    one; the CPU's Adam step on the card's own gradients within
    PPO_ADAM_ATOL."""
    from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as rec_loop
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset(RECURRENT_PRESET)
    data = rec_loop.prepare_update(*recorded, "cpu")
    s_pad = int(data["mask"].shape[1])
    epochs, nb = int(cfg.algo.update_epochs), int(cfg.algo.per_rank_num_batches)
    mb = s_pad // nb
    one = apply_overrides(cfg, ["algo.update_epochs=1", "algo.per_rank_num_batches=1"])
    clip, ent = float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)
    parts = {}
    for dev in ("cpu", "cuda"):
        agent, _ = build_agent(cfg, (2,), False, {"state": {"shape": [4]}}, dev)
        optimizer = rec_loop.make_optimizer(cfg, agent)
        seen = _capture_grads(optimizer)
        seen.update(relu=[], logits=[])
        for module in agent.modules():
            if isinstance(module, torch.nn.LayerNorm):
                module.register_forward_hook(lambda m, i, o, s=seen: s["relu"].append(o.detach().cpu()))
        agent.actor_head_0.register_forward_hook(lambda m, i, o, s=seen: s["logits"].append(o.detach().cpu()))
        parts[dev] = (agent, optimizer, rec_loop.make_train_step(agent, optimizer, one, mb), seen)
    (cpu_agent, cpu_opt, cpu_train, cpu_seen), (card_agent, card_opt, card_train, card_seen) = parts["cpu"], parts["cuda"]
    perms = torch.stack([torch.randperm(s_pad, generator=torch.Generator().manual_seed(30 + e)) for e in range(epochs)])
    own = torch.arange(mb).reshape(1, mb)
    worst = {"loss_max_rel_err": 0.0, "param_max_abs_err": 0.0, "adam_max_abs_err": 0.0,
             "grad_max_rel_err": 0.0, "kink_grad_max_rel_err": 0.0}
    kinks = kink_steps = 0
    t0 = time.perf_counter()
    for e in range(epochs):
        for m in range(nb):
            rows = perms[e, m * mb:(m + 1) * mb]
            batch = {k: v[:, rows].contiguous() for k, v in data.items()}
            before = {k: v.detach().cpu().clone() for k, v in card_agent.state_dict().items()}
            adam_before = copy.deepcopy(card_opt.state_dict())
            cpu_agent.load_state_dict(before)
            cpu_opt.load_state_dict(copy.deepcopy(adam_before))
            for seen in (cpu_seen, card_seen):
                seen["relu"].clear()
                seen["logits"].clear()
            on_card = card_train({k: v.cuda() for k, v in batch.items()}, clip, ent, perms=own.cuda()).cpu()
            on_cpu = cpu_train(batch, clip, ent, perms=own)
            torch.testing.assert_close(on_card, on_cpu, rtol=1e-5, atol=1e-6)
            worst["loss_max_rel_err"] = max(worst["loss_max_rel_err"],
                                            float(((on_card - on_cpu).abs() / on_cpu.abs().clamp(min=1e-12)).max()))
            card_state = card_agent.state_dict()
            worst["param_max_abs_err"] = max(worst["param_max_abs_err"], _max_param_err(card_state, cpu_agent.state_dict()))
            crossed, inputs = _recurrent_kinks(card_seen, cpu_seen, batch, clip)
            if crossed > max(1.0, PPO_KINK_SHARE * inputs):
                raise AssertionError(f"one recurrent PPO step crossed {crossed} of its {inputs} kinks on one machine only")
            kinks, kink_steps = kinks + crossed, kink_steps + int(crossed > 0)
            key, bound = ("kink_grad_max_rel_err", PPO_KINK_GRAD_RTOL) if crossed else ("grad_max_rel_err", PPO_GRAD_RTOL)
            err = _grad_rel_err(card_seen["grads"], cpu_seen["grads"])
            if err > bound:
                raise AssertionError(f"one recurrent PPO step ({crossed} kinks crossed) on the card: the gradient is "
                                     f"{err} of its norm from the CPU's")
            worst[key] = max(worst[key], err)
            cpu_agent.load_state_dict(before)
            cpu_opt.load_state_dict(copy.deepcopy(adam_before))
            cpu_opt.step([g.cpu() for g in card_seen["grads"]])
            adam = _max_param_err(card_state, cpu_agent.state_dict())
            if adam > PPO_ADAM_ATOL:
                raise AssertionError(f"one Adam step on the card moved a parameter {adam} from the CPU's on the same "
                                     "gradients")
            worst["adam_max_abs_err"] = max(worst["adam_max_abs_err"], adam)
    out = {"sequences": s_pad, "real_sequences": int((data["mask"].sum(0) > 0).sum()), "minibatch": mb,
           "steps": epochs * nb, "kinks_crossed": kinks, "steps_with_kinks": kink_steps,
           "wall_s": time.perf_counter() - t0, **worst}
    log("recurrent PPO update (card vs CPU, every minibatch step): " + json.dumps(out))
    return out


def ppo_recurrent_serve_phase(ckpt: str) -> dict:
    """``evaluation`` of the recurrent run's checkpoint on the card (one
    greedy episode, no kernel launched), then ``serve`` of it on the card
    through the session engine (buckets 1, 8, 32): RECURRENT_SESSIONS
    concurrent sessions x RECURRENT_SESSION_STEPS steps of CartPole-range
    observations, each session's actions again from a session stepped
    alone (a batched row equals the row alone); then one session fed the
    evaluation episode's observations gives its actions step by step. No
    repo kernel is launched on the serving path. Client p50/p99 and the
    sessions' requests/s."""
    from sheeprl_tpu_torch.algos.ppo_recurrent import utils as rec_utils

    frames, actions = [], []
    make_env = rec_utils.make_env
    rec_utils.make_env = _recording_make_env(frames, actions, key="state")
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        result = cli.evaluation([f"checkpoint_path={ckpt}"])
    finally:
        rec_utils.make_env = make_env
    eval_wall = time.perf_counter() - t0
    eval_launches = dict(kernels.LAUNCHES)
    steps = result["steps"]
    if (result["device"].split(":")[0] != "cuda" or any(eval_launches.values()) or steps != len(actions)
            or not np.isfinite(result["reward"])):
        raise AssertionError(f"recurrent PPO evaluation {result}, {len(actions)} actions, launches {eval_launches}")
    rng = np.random.default_rng(26)
    plan = [[_stateless_rows(rng, "ppo", 1)[0] for _ in range(RECURRENT_SESSION_STEPS)] for _ in range(RECURRENT_SESSIONS)]

    def client(port: int, res: dict) -> None:
        deadline = time.monotonic() + 300
        probe = _Conn(port, deadline)
        res["health_start"] = probe.ask({"health": True})
        answers = [[None] * RECURRENT_SESSION_STEPS for _ in range(RECURRENT_SESSIONS)]
        latencies, errors = [], []

        def session(i: int) -> None:
            try:
                conn = _Conn(port, deadline)
                for t, row in enumerate(plan[i]):
                    t1 = time.perf_counter()
                    resp = conn.ask({"obs": {"state": row.tolist()}, "session_id": f"s{i}"})
                    latencies.append(time.perf_counter() - t1)
                    if "actions" not in resp:
                        raise AssertionError(f"session s{i} step {t}: {resp}")
                    answers[i][t] = int(resp["actions"][0][0])
                conn.close()
            except BaseException as e:  # reported by the main thread
                errors.append(e)

        t1 = time.perf_counter()
        threads = [threading.Thread(target=session, args=(i,), daemon=True) for i in range(RECURRENT_SESSIONS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        res["wall_s"] = time.perf_counter() - t1
        if errors:
            raise errors[0]
        if any(th.is_alive() for th in threads):
            raise TimeoutError("a session client did not finish")
        res["health_batched"] = probe.ask({"health": True})
        res["answers"], res["latencies"] = answers, latencies
        res["alone"] = [[int(probe.ask({"obs": {"state": row.tolist()}, "session_id": f"alone{i}"})["actions"][0][0])
                         for row in plan[i]] for i in range(RECURRENT_SESSIONS)]
        res["episode"] = [int(probe.ask({"obs": {"state": frames[t].tolist()}, "session_id": "episode"})["actions"][0][0])
                          for t in range(steps)]
        res["health_end"] = probe.ask({"health": True})
        probe.close()

    t2 = time.perf_counter()
    served = _serve_with([f"checkpoint_path={ckpt}", "serve.session.buckets=[1,8,32]", "serve.max_wait_ms=2.0"], client)
    if any(served["launches"].values()):
        raise AssertionError(f"recurrent PPO serving launched repo kernels: {served['launches']}")
    if served["alone"] != served["answers"]:
        bad = next(i for i in range(RECURRENT_SESSIONS) if served["alone"][i] != served["answers"][i])
        raise AssertionError(f"session s{bad} batched {served['answers'][bad]} != alone {served['alone'][bad]}")
    parted = next((t for t, (a, b) in enumerate(zip(served["episode"], actions)) if a != b), None)
    if parted is not None:
        raise AssertionError(f"the served session parts from the evaluation episode at step {parted} of {steps}")
    lat = np.asarray(served["latencies"]) * 1e3
    hb, hs = served["health_batched"]["engine"], served["health_start"]["engine"]
    dispatches = hb["dispatches"] - hs["dispatches"]
    out = {
        "evaluation": {**result, "launches": eval_launches, "wall_s": eval_wall, "steps_per_s": steps / eval_wall},
        "sessions": RECURRENT_SESSIONS, "steps": RECURRENT_SESSION_STEPS, "requests": int(lat.size),
        "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
        "requests_per_s": lat.size / served["wall_s"], "dispatches": int(dispatches),
        "rows_per_dispatch": lat.size / max(dispatches, 1), "batched_equals_alone": True,
        "episode_replayed": True, "launches": served["launches"], "sessions_end": served["health_end"]["sessions"],
        "served_wall_s": time.perf_counter() - t2,
    }
    log("recurrent PPO serve and evaluation: " + json.dumps(out))
    return out


def ppo_continuous_phase(workdir: str) -> dict:
    """PPO on Pendulum-v1 (the continuous head) through ``run`` at the full
    recipe's widths (4 envs x 128 steps, 10 epochs x 8 minibatches of 64),
    CONTINUOUS_ITERATIONS iterations: ``gae`` exactly once per iteration and
    no other kernel, every loss finite (no learning floor: a few iterations
    learn nothing measurable). One full-width update on the card against
    the CPU from the same weights, batch and permutations (held as the
    CartPole MLP update is: losses within rtol 1e-5, parameters within 2e-4
    and 99.9 % within 1e-5). Then the checkpoint served statelessly (8
    clients x 16 requests of 1-4 Pendulum rows) and evaluated (one greedy
    episode, no kernel launched)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run([f"preset={PPO_PRESET}", "env.id=Pendulum-v1", f"algo.total_steps={CONTINUOUS_ITERATIONS * 512}",
                       "metric.log_level=0", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if summary["iterations"] != CONTINUOUS_ITERATIONS or summary["device"].split(":")[0] != "cuda":
        raise AssertionError(f"continuous PPO run: {summary['iterations']} iterations on {summary['device']}")
    _family_launch_check("continuous PPO", summary, launches)
    if not np.isfinite(np.asarray(summary["losses"])).all():
        raise AssertionError(f"non-finite continuous PPO losses: {summary['losses']}")
    out = {"iterations": summary["iterations"], "launches": launches, "wall_s": wall,
           "env_steps_per_s": summary["env_steps_per_s"], "losses_last": summary["losses"][-1],
           "episodes": [ret for _, _, ret, _ in summary["episodes"]], "test_reward": summary["test_reward"]}
    log("continuous PPO run: " + json.dumps(out))

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(find_run_config(summary["checkpoint"]))
    rows = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
    rng = np.random.default_rng(27)
    data = {"state": torch.from_numpy(_stateless_rows(rng, "pendulum", rows)),
            "actions": torch.from_numpy((rng.normal(size=(rows, 1)) * 1.5).astype(np.float32)),
            "logprobs": torch.from_numpy((-1.4 + 0.3 * rng.normal(size=(rows, 1))).astype(np.float32)),
            "values": torch.from_numpy(rng.normal(size=(rows, 1)).astype(np.float32)),
            "returns": torch.from_numpy((rng.normal(size=(rows, 1)) * 3).astype(np.float32)),
            "advantages": torch.from_numpy(rng.normal(size=(rows, 1)).astype(np.float32)),
            "rewards": torch.from_numpy(-np.ones((rows, 1), np.float32)),
            "dones": torch.zeros((rows, 1), dtype=torch.uint8)}
    perms = draw_permutations(int(cfg.algo.update_epochs), rows, torch.Generator().manual_seed(28), "cpu")
    results = {}
    for dev in ("cpu", "cuda"):
        agent, _ = build_ppo_agent(cfg, (1,), True, cfg.spaces.obs, dev)
        train = make_ppo_train_step(agent, make_ppo_optimizer(cfg, agent), cfg, rows)
        losses = train({k: v.to(dev) for k, v in data.items()}, float(cfg.algo.clip_coef), float(cfg.algo.ent_coef),
                       perms=perms.to(dev))[0].cpu()
        results[dev] = (losses, {k: v.detach().cpu() for k, v in agent.state_dict().items()})
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=1e-5, atol=1e-6)
    diffs = torch.cat([(results["cuda"][1][k] - results["cpu"][1][k]).abs().reshape(-1) for k in results["cpu"][1]])
    close = float((diffs <= 1e-5).float().mean())
    if float(diffs.max()) > 2e-4 or close < 0.999:
        raise AssertionError(f"continuous PPO parameters after one update on the card differ from the CPU: "
                             f"max {float(diffs.max())}, {close} within 1e-5")
    out["update"] = {"losses_cpu": dict(zip(PPO_LOSS_NAMES, results["cpu"][0].tolist())),
                     "loss_abs_err": (results["cuda"][0] - results["cpu"][0]).abs().tolist(),
                     "param_max_abs_err": float(diffs.max()), "param_share_within_1e-5": close}
    log("continuous PPO update (card vs CPU): " + json.dumps(out["update"]))
    out["serve"] = stateless_serve_phase(summary["checkpoint"], "ppo", row_env="pendulum")
    out["evaluation"] = stateless_evaluation_phase(summary["checkpoint"], "ppo", -float("inf"), summary["test_reward"])
    if not out["evaluation"]["equals_run_test"] or out["evaluation"]["steps"] != 200:
        raise AssertionError(f"continuous PPO evaluation {out['evaluation']} against the run's test "
                             f"{summary['test_reward']}")
    return out


# -- 31-37. slice 13: continuous DreamerV3, the decoupled RSSM, DroQ, SAC-AE, sample_next_obs --

CONTINUOUS_PRESET = "dreamer_v3_continuous_dummy"
CONTINUOUS_ACTIONS = 2  # the continuous dummy env's Box
# the gradients of one step, card against CPU: the whole vector's distance
# over its norm (float32 sums in another order through 15 imagined steps)
CONTINUOUS_GRAD_RTOL = 2e-3
# a bf16-mixed step, card against CPU: the losses' relative gap and each
# gradient's cosine (see _bf16_step_check)
BF16_LOSS_RTOL, BF16_GRAD_COS, BF16_NOISE_FACTOR = 2e-2, 0.999, 4.0
# a served session alone against its rows in a batch, by the run's compute
# dtype: float32 matmuls of other batch sizes differ in rounding; bf16 ones by
# a few bf16 steps of an action near 1 (2^-8) at the first step
SOLO_ATOL_F32, SOLO_ATOL_BF16 = 1e-5, 2e-2
# cuts of scale for the runs (the preset's 500,000 rows hold 6.1 GB of frames,
# which a resume would copy): a 20,000-row host buffer, a 40,000-row ring
CONTINUOUS_HOST_BUFFER, CONTINUOUS_RING_BUFFER = 20000, 40000
CONTINUOUS_TRAIN_ITERS, CONTINUOUS_RESUME_STEPS = 3, 16
DROQ_CARD_STEPS = 4  # critic steps of the card-vs-CPU train call (the recipe grants 80 per iteration)
DROQ_TOTAL_STEPS, DROQ_BUFFER = 164, 20000
SAC_AE_CARD_BATCH, SAC_AE_BUFFER, SAC_AE_TRAIN_ITERS, SAC_AE_SGD_LR = 2, 20000, 3, 1e-3
SAC_NEXT_OBS_STEPS = 512


def _continuous_cfg(extra=()):
    cfg = apply_overrides(preset(CONTINUOUS_PRESET), list(extra))
    cfg["spaces"] = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}},
                     "actions": {"shape": [CONTINUOUS_ACTIONS], "low": [-1.0] * CONTINUOUS_ACTIONS,
                                 "high": [1.0] * CONTINUOUS_ACTIONS, "continuous": True}}
    return apply_overrides(cfg, [])


def _continuous_batch(rng, T: int, B: int) -> dict:
    data = {
        "rgb": rng.integers(0, 256, (1, T, B, 64, 64, 3)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (1, T, B, CONTINUOUS_ACTIONS)).astype(np.float32),
        "rewards": rng.normal(size=(1, T, B, 1)).astype(np.float32),
        "terminated": np.zeros((1, T, B, 1), np.float32),
        "is_first": np.zeros((1, T, B, 1), np.float32),
    }
    data["terminated"][0, T // 2, 0] = 1.0
    data["is_first"][0, T // 2 + 1, 0] = 1.0
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _params_check(name: str, card: dict, cpu: dict, lr: float) -> dict:
    """Adam's first step moves an element by about ``lr`` times its
    gradient's sign, so an element whose gradient is within float32 noise of
    zero may move either way: every element within 2 * lr + 1e-6 of the
    CPU's, at least 99.9 % within 1e-6 (train_step_phase's rule)."""
    diffs = torch.cat([(card[k] - cpu[k]).abs().reshape(-1) for k in cpu])
    out = {"max_abs_err": float(diffs.max()), "share_within_1e-6": float((diffs <= 1e-6).float().mean())}
    if out["max_abs_err"] > 2 * lr + 1e-6 or out["share_within_1e-6"] < 0.999:
        raise AssertionError(f"{name} after the step on the card differs from the CPU: {out}")
    return out


def _backward_chain_checks(T: int, B: int, H: int, hidden: int, bins: int) -> dict:
    """``gru_gates_ln``'s and the decode's autograd backward (the plain chain,
    recomputed as the JAX ``custom_vjp`` bwd does) at the continuous step's
    own shapes, against the plain forward's own gradient on the card: the
    imagination's (T*B, 3 hidden) projection and the (H+1, T*B, bins)
    reward and value logits. The GRU's within 1e-5 of the gradient's
    largest element (a recomputed chain: the same ops on the same inputs);
    the decode's within 1e-4, held against the CPU's form, which decodes the
    log-normalised logits where the card's decodes the raw ones (equal in
    exact arithmetic; 8.9e-6 apart in float32 on the card)."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    rows = T * B
    out = {}
    proj = torch.randn((rows, 3 * hidden), device="cuda", generator=gen)
    h = torch.randn((rows, hidden), device="cuda", generator=gen).tanh()
    w = 1 + 0.1 * torch.randn((3 * hidden,), device="cuda", generator=gen)
    b = 0.1 * torch.randn((3 * hidden,), device="cuda", generator=gen)
    up = torch.randn((rows, hidden), device="cuda", generator=gen)
    grads = []
    for fn in (kernels.gru_gates_ln, kernels.gru_gates_ln_reference):
        leaves = [t.clone().requires_grad_(True) for t in (proj, h, w, b)]
        torch.autograd.backward(fn(*leaves, GRU_LN_EPS), up)
        grads.append([t.grad for t in leaves])
    err = max(float((g - r).abs().max() / r.abs().max().clamp(min=1e-30)) for g, r in zip(*grads))
    out["gru_gates_ln_backward"] = {"shape": [rows, 3 * hidden], "max_rel_err": err}
    logits = 3 * torch.randn((H + 1, rows, bins), device="cuda", generator=gen)
    up = torch.randn((H + 1, rows, 1), device="cuda", generator=gen)
    grads = []
    for fn in (kernels.two_hot_mean,
               lambda lg: kernels.two_hot_symexp_decode_reference(lg - torch.logsumexp(lg, -1, keepdim=True))):
        leaf = logits.clone().requires_grad_(True)
        torch.autograd.backward(fn(leaf), up)
        grads.append(leaf.grad)
    err_dec = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max().clamp(min=1e-30))
    out["two_hot_symexp_decode_backward"] = {"shape": [H + 1, rows, bins], "max_rel_err": err_dec}
    if err > 1e-5 or err_dec > 1e-4 or not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError(f"a kernel's backward at the continuous step's shapes disagrees: {out}")
    return out


def continuous_step_phase() -> dict:
    """One continuous DreamerV3-S gradient step (full width, B 4 x T 16, H
    15, the ``scaled_normal`` actor learning by dynamics backpropagation) on
    the card against the same step on the CPU, TF32 off: the same seeded
    weights, batch and injected noise; coupled and with ``decoupled_rssm``,
    each at ``32-true`` and at the recipe's ``bf16-mixed``.

    ``32-true``: the ten losses within rtol 1e-4; the world model's, actor's
    and critic's gradients (what each optimizer is handed) within
    CONTINUOUS_GRAD_RTOL of their norm; the updated parameters by
    train_step_phase's rule. ``bf16-mixed`` (:func:`_bf16_step_check`, every
    categorical draw decided by :func:`_decisive_uniforms`): the losses
    within BF16_LOSS_RTOL, each gradient's cosine to the CPU's at least
    BF16_GRAD_COS, or within BF16_NOISE_FACTOR times the CPU's own bfloat16
    distance from its float32 step of the same layout on the same inputs; the
    parameters' gap after Adam reported, not held (Adam turns a gradient's
    rounding near 0 into a step of either sign). Then the two plain backward
    chains on the actor's path held at the recipe's shapes
    (:func:`_backward_chain_checks`)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B = 16, 4
    out = {}
    reference = {}
    decoupled = ["algo.world_model.decoupled_rssm=true"]
    for name, extra in (("coupled_f32", ["fabric.precision=32-true"]), ("coupled", []),
                        ("decoupled_f32", ["fabric.precision=32-true"] + decoupled), ("decoupled", decoupled)):
        cfg = _continuous_cfg([f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}"] + extra)
        data = _continuous_batch(np.random.default_rng(4), T, B)
        noise = draw_noise(cfg, T, B, [CONTINUOUS_ACTIONS], torch.Generator().manual_seed(5), "cpu", continuous=True)
        discrete = int(cfg.algo.world_model.discrete_size)
        noise["posterior"], noise["imagined_prior"] = (_decisive_uniforms(noise[k], discrete, 6 + i) for i, k in
                                                       enumerate(("posterior", "imagined_prior")))
        results = {}
        for dev in ("cpu", "cuda"):
            modules = build_training_agent(cfg, dev)
            optimizers = make_optimizers(cfg, *modules[:3])
            seen = {k: _capture_grads(opt) for k, opt in optimizers.items()}
            train = make_train_step(*modules, optimizers, cfg)
            dev_noise = {"posterior": noise["posterior"].to(dev), "imagined_prior": noise["imagined_prior"].to(dev),
                         "actions": [u.to(dev) for u in noise["actions"]]}
            t0 = time.perf_counter()
            _, metrics, _ = train({k: v.to(dev) for k, v in data.items()}, init_moments(dev), 0, noise=[dev_noise])
            metrics = metrics.cpu()
            seconds = time.perf_counter() - t0
            params = {n: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                      for n, m in zip(("world_model", "actor", "critic"), modules)}
            results[dev] = (metrics[0], params, seconds, {k: v["grads"] for k, v in seen.items()})
        if name.endswith("_f32"):
            reference[name.split("_")[0]] = (results["cpu"][0], results["cpu"][3])
        if not torch.isfinite(results["cuda"][0]).all():
            raise AssertionError(f"non-finite losses on the card: {results['cuda'][0].tolist()}")
        step = {"cpu_s": results["cpu"][2], "cuda_s": results["cuda"][2],
                "loss_abs_err": dict(zip(METRIC_NAMES, (results["cuda"][0] - results["cpu"][0]).abs().tolist()))}
        if name.endswith("_f32"):
            torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=1e-4, atol=1e-5)
            for opt_name in ("world", "actor", "critic"):
                err = _grad_rel_err(results["cuda"][3][opt_name], results["cpu"][3][opt_name])
                step[f"{opt_name}_grad_rel_err"] = err
                if err > CONTINUOUS_GRAD_RTOL:
                    raise AssertionError(f"{name} continuous step: the {opt_name} gradient on the card is {err} of "
                                         "its norm from the CPU's")
            for module, lr in (("world_model", 1e-4), ("actor", 8e-5), ("critic", 8e-5)):
                step[module] = _params_check(f"{name} {module}", results["cuda"][1][module], results["cpu"][1][module],
                                             lr)
        else:
            step.update(_bf16_step_check(f"continuous {name} step", results["cuda"][0], results["cpu"][0],
                                         results["cuda"][3], results["cpu"][3], *reference.get(name, ())))
            for module in ("world_model", "actor", "critic"):
                step[f"{module}_param_max_abs_err"] = _max_param_err(results["cuda"][1][module],
                                                                     results["cpu"][1][module])
        out[name] = step
        log(f"continuous {name} step (card vs CPU): " + json.dumps(step))
    cfg = preset(CONTINUOUS_PRESET)
    out["backward_chains"] = _backward_chain_checks(
        int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), int(cfg.algo.horizon),
        int(cfg.algo.world_model.recurrent_model.recurrent_state_size), int(cfg.algo.critic.bins))
    log("continuous backward chains (kernel vs plain, on the card): " + json.dumps(out["backward_chains"]))
    return out


def _decisive_uniforms(u: torch.Tensor, classes: int, seed: int) -> torch.Tensor:
    """Gumbel-max uniforms, shaped as ``u`` (flat groups of ``classes``),
    that decide each draw: per group one class at 1 - 2^-20 (its Gumbel
    noise ~13.9), the rest at 0.5 (~0.37), so the drawn class outruns any
    gap the stochastic heads' unimixed log-probabilities (at most
    log(0.01 / 32) ~ -8.1 apart) can open. A card-against-CPU step in
    bfloat16 then draws the same classes on both devices: with uniform
    noise, a draw within bfloat16 rounding of a tie goes either way, and one
    such flip moves a step's losses by percents."""
    grouped = torch.full(u.shape, 0.5).reshape(*u.shape[:-1], -1, classes)
    pick = torch.randint(classes, grouped.shape[:-1], generator=torch.Generator().manual_seed(seed))
    grouped.scatter_(-1, pick[..., None], 1.0 - 2.0**-20)
    return grouped.reshape(u.shape)


def _decisive_tree(noise, discrete: Optional[int], seed: int = 50):
    """A Dreamer step's noise with every categorical draw decided
    (:func:`_decisive_uniforms`): the stochastic state's uniforms where the
    state is categorical (``discrete`` classes a group; None for V1's
    Gaussian state, whose normals are left as they are), and each discrete
    actor head's uniforms."""
    if isinstance(noise, dict):
        return {k: (_decisive_uniforms(v, discrete, seed + i) if k in ("posterior", "imagined_prior")
                    and discrete is not None else
                    [_decisive_uniforms(u, u.shape[-1], seed + i + j) for j, u in enumerate(v)] if k == "actions"
                    else _decisive_tree(v, discrete, seed + 10 * (i + 1)))
                for i, (k, v) in enumerate(noise.items())}
    return noise


def _cosine_distance(a, b) -> float:
    a = torch.cat([g.detach().cpu().double().reshape(-1) for g in a])
    b = torch.cat([g.detach().cpu().double().reshape(-1) for g in b])
    return float(1.0 - (a @ b) / (a.norm() * b.norm()).clamp(min=1e-300))


def _bf16_step_check(name: str, card_losses, cpu_losses, card_grads: dict, cpu_grads: dict,
                     f32_losses=None, f32_grads: Optional[dict] = None) -> dict:
    """A ``bf16-mixed`` step on the card against the same step on the CPU:
    every loss finite and within BF16_LOSS_RTOL relative (1e-3 absolute) of
    the CPU's; each optimizer's gradient (one vector) at cosine
    BF16_GRAD_COS or more from the CPU's. Given the CPU's ``32-true``
    losses and gradients of the same step, a bound also reaches
    BF16_NOISE_FACTOR times the CPU's own bfloat16 distance from them:
    bfloat16's noise, which the two devices draw independently (they round
    their products and sums in other orders, and a categorical draw within
    rounding of a tie can go either way), so the card's distance from the
    CPU is about twice the CPU's from float32. The card's own distance from
    float32 is reported, not used."""
    card_losses, cpu_losses = card_losses.float().cpu(), cpu_losses.float().cpu()
    if not torch.isfinite(card_losses).all():
        raise AssertionError(f"{name}: non-finite losses on the card: {card_losses.tolist()}")
    gap = (card_losses - cpu_losses).abs()
    bound = BF16_LOSS_RTOL * cpu_losses.abs() + 1e-3
    out = {"loss_rel_err": float((gap / cpu_losses.abs().clamp(min=1e-30)).max())}
    if f32_losses is not None:
        f32_losses = f32_losses.float().cpu()
        bound = torch.maximum(bound, BF16_NOISE_FACTOR * (cpu_losses - f32_losses).abs())
        out.update(loss_gap=gap.tolist(), cpu_loss_gap_f32=(cpu_losses - f32_losses).abs().tolist(),
                   card_loss_gap_f32=(card_losses - f32_losses).abs().tolist())
    if bool((gap > bound).any()):
        raise AssertionError(f"{name}: losses on the card {card_losses.tolist()} against the CPU's "
                             f"{cpu_losses.tolist()} (bounds {bound.tolist()}; {out})")
    for opt_name in card_grads:
        d = _cosine_distance(card_grads[opt_name], cpu_grads[opt_name])
        limit = 1.0 - BF16_GRAD_COS
        row = {"cos": 1.0 - d}
        if f32_grads is not None:
            d_cpu = _cosine_distance(cpu_grads[opt_name], f32_grads[opt_name])
            row.update(cos_cpu_f32=1.0 - d_cpu,
                       cos_card_f32=1.0 - _cosine_distance(card_grads[opt_name], f32_grads[opt_name]))
            limit = max(limit, BF16_NOISE_FACTOR * d_cpu)
        if d > limit:
            raise AssertionError(f"{name}: the {opt_name} gradient on the card is at cosine {1 - d} from the "
                                 f"CPU's (bound {1 - limit}): {row}")
        out[f"{opt_name}_grad"] = row
    return out


def _backward_chain_cost(prof) -> dict:
    """Device ms and operations of the kernels launched under the autograd
    engine's range of each wrapper's backward (the plain chains)."""
    nodes = {"_GruGatesLnBackward": "gru_gates_ln", "_TwoHotSymexpDecodeBackward": "two_hot_symexp_decode"}
    out = {v: {"calls": 0, "device_ms": 0.0, "ops": 0} for v in nodes.values()}
    prefix = "autograd::engine::evaluate_function: "
    for e in prof.events():
        if e.name.startswith(prefix) and e.name[len(prefix):] in nodes:
            out[nodes[e.name[len(prefix):]]]["calls"] += 1
        launched = getattr(e, "kernels", None) or []
        if not launched:
            continue
        parent = e.cpu_parent
        while parent is not None and not (parent.name.startswith(prefix) and parent.name[len(prefix):] in nodes):
            parent = parent.cpu_parent
        if parent is not None:
            cost = out[nodes[parent.name[len(prefix):]]]
            cost["ops"] += len(launched)
            cost["device_ms"] += sum(getattr(k, "duration", 0.0) for k in launched) / 1e3
    return out


def _profile_continuous_step(checkpoint: str, precision: Optional[str] = None) -> dict:
    """One full-recipe continuous gradient step (B 16 x T 64, H 15) from the
    run's checkpoint after two warm-up steps, at the run's precision or at
    ``precision``: host ms, device ms and operations, and what the two plain
    backward chains on the actor's path cost inside it
    (:func:`_backward_chain_cost`)."""
    cfg = load_config(find_run_config(checkpoint))
    if precision is not None:
        cfg = apply_overrides(cfg, [f"fabric.precision={precision}"])
    modules = build_training_agent(cfg, "cuda", load_checkpoint(checkpoint))
    optimizers = make_optimizers(cfg, *modules[:3])
    train = make_train_step(*modules, optimizers, cfg)
    T, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    data = {k: v.cuda() for k, v in _continuous_batch(np.random.default_rng(6), T, B).items()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    moments = init_moments("cuda")
    for _ in range(2):
        moments = train(data, moments, 1, gen)[0]
    torch.cuda.synchronize()
    host = []
    for _ in range(2):
        t0 = time.perf_counter()
        moments = train(data, moments, 1, gen)[0]
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        moments = train(data, moments, 1, gen)[0]
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    chains = _backward_chain_cost(prof)
    H = int(cfg.algo.horizon)
    if chains["gru_gates_ln"]["calls"] < T + H or chains["two_hot_symexp_decode"]["calls"] < 2:
        raise AssertionError(f"the plain backward chains did not run on the actor's path: {chains}")
    return {"precision": str(cfg.fabric.precision), "host_ms": float(np.median(host) * 1e3),
            "host_ms_all": [x * 1e3 for x in host], "device_ms": device_us / 1e3 if device_us > 0 else None,
            "device_ops": sum(e.count for e in events), "backward_chains": chains}


def _continuous_launches(summary: dict, launches: dict, T: int, H: int, ring: bool = False) -> dict:
    want = _dreamer_launch_want(summary, T, H)
    if ring:
        want["ragged_ring_scatter"] = summary["replay"]["Replay/flushes"]
    if launches != want:
        raise AssertionError(f"continuous launches {launches} != {want} for {summary['gradient_steps']} gradient steps")
    return want


def _continuous_run(workdir: str, extra, iters: int) -> tuple:
    cfg = preset(CONTINUOUS_PRESET)
    n_envs = int(cfg.env.num_envs)
    starts = int(cfg.algo.learning_starts)
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run([f"preset={CONTINUOUS_PRESET}", "algo.hybrid_player.enabled=false",
                       f"algo.total_steps={starts + n_envs * (iters - 1)}",
                       "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0",
                       f"log_root={workdir}"] + list(extra))
    return summary, dict(kernels.LAUNCHES), time.perf_counter() - t0


def continuous_run_phase(workdir: str) -> dict:
    """``run preset=dreamer_v3_continuous_dummy`` on the card at the recipe
    (4 envs, DreamerV3-S, B 16 x T 64, H 15, ``learning_starts`` 1300, replay
    ratio 0.5) on the host buffer cut to CONTINUOUS_HOST_BUFFER rows, for
    CONTINUOUS_TRAIN_ITERS training iterations: exact launch counts (per
    gradient step 3 + 3 two-hot and 3 decodes, T + H ``gru_gates_ln``; one
    per player and test-episode step), finite losses, a checkpoint, the test
    episode; a resume of CONTINUOUS_RESUME_STEPS steps from the checkpoint's
    buffer with the path's counts; one gradient step profiled."""
    summary, launches, wall = _continuous_run(workdir, [f"buffer.size={CONTINUOUS_HOST_BUFFER}"],
                                              CONTINUOUS_TRAIN_ITERS)
    cfg = load_config(find_run_config(summary["checkpoint"]))
    if cfg.fabric.precision != "bf16-mixed":
        raise AssertionError(f"continuous run at {cfg.fabric.precision}: the recipe asks for bf16-mixed")
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    G = summary["gradient_steps"]
    if summary["device"].split(":")[0] != "cuda" or G < 4 or summary["resident"] or not summary["test_steps"]:
        raise AssertionError(f"continuous run: {G} gradient steps on {summary['device']}, resident "
                             f"{summary['resident']}, test {summary['test_steps']}")
    if not np.isfinite(np.asarray(summary["metrics"])).all() or not np.isfinite(summary["test_reward"]):
        raise AssertionError(f"continuous run: non-finite losses or test return {summary['metrics']}")
    if summary["test_steps"] != CONTINUOUS_EPISODE_STEPS:
        raise AssertionError(f"continuous test episode {summary['test_steps']} steps: the env with action repeat 2 "
                             f"ends after {CONTINUOUS_EPISODE_STEPS}")
    _continuous_launches(summary, launches, T, H)
    out = {"gradient_steps": G, "policy_steps": summary["policy_steps"], "player_steps": summary["player_steps"],
           "test_steps": summary["test_steps"], "test_reward": summary["test_reward"], "launches": launches,
           "wall_s": wall, "host_ms_per_gradient_step": [s / g * 1e3 for s, g in summary["train_host_s"]],
           "losses": [dict(zip(METRIC_NAMES, row)) for row in summary["metrics"]],
           "checkpoint": summary["checkpoint"]}
    log("continuous run: " + json.dumps({k: v for k, v in out.items() if k not in ("losses", "checkpoint")}))
    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                       "algo.learning_starts=8", f"algo.total_steps={summary['policy_steps'] + CONTINUOUS_RESUME_STEPS}",
                       "checkpoint.save_last=false", "algo.run_test=false", f"log_root={_log_root(summary)}"])
    resume_launches = dict(kernels.LAUNCHES)
    if resumed["start_iter"] * 4 != summary["policy_steps"] + 4 or resumed["gradient_steps"] == 0:
        raise AssertionError(f"continuous resume: start {resumed['start_iter']}, {resumed['gradient_steps']} steps")
    _continuous_launches(resumed, resume_launches, T, H)
    out["resume"] = {"start_iter": resumed["start_iter"], "gradient_steps": resumed["gradient_steps"],
                     "launches": resume_launches}
    out["profile"] = _profile_continuous_step(summary["checkpoint"])
    out["profile_32_true"] = _profile_continuous_step(summary["checkpoint"], "32-true")
    log("continuous gradient step profile, bf16-mixed and 32-true: " + json.dumps(
        [out["profile"], out["profile_32_true"]]))
    return out


def continuous_ring_phase(workdir: str) -> dict:
    """The same preset with ``decoupled_rssm`` on the device ring (cut to
    CONTINUOUS_RING_BUFFER rows; the recipe's bytes reported): one
    ``ragged_ring_scatter`` launch per flush carrying the 2-wide float
    action column, the path's other counts, finite losses, and a resume that
    restores the ring."""
    from sheeprl_tpu_torch.replay import estimate_ring_bytes
    from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys

    ring = ["algo.world_model.decoupled_rssm=true", "buffer.device_resident=true",
            f"buffer.size={CONTINUOUS_RING_BUFFER}", "algo.run_test=false"]
    summary, launches, wall = _continuous_run(workdir, ring, CONTINUOUS_TRAIN_ITERS)
    cfg = load_config(find_run_config(summary["checkpoint"]))
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    if not summary["resident"] or summary["gradient_steps"] < 4:
        raise AssertionError(f"ring run: resident {summary['resident']}, {summary['gradient_steps']} gradient steps")
    if not np.isfinite(np.asarray(summary["metrics"])).all():
        raise AssertionError(f"ring run: non-finite losses {summary['metrics']}")
    _continuous_launches(summary, launches, T, H, ring=True)
    saved = load_checkpoint(summary["checkpoint"])["rb"]["arrays"]["storage/actions"]
    if saved.dtype != torch.float32 or saved.shape[-1] != CONTINUOUS_ACTIONS or not bool(saved.abs().sum() > 0):
        raise AssertionError(f"the ring's action column: {saved.dtype} {tuple(saved.shape)}")
    keys = dreamer_ring_keys(cfg.spaces.obs, list(cfg.algo.cnn_keys.encoder), [], (CONTINUOUS_ACTIONS,), True)
    full = preset(CONTINUOUS_PRESET)
    recipe_bytes = estimate_ring_bytes(keys, int(full.buffer.size) // int(full.env.num_envs), int(full.env.num_envs),
                                       sequence={"seq_len": T, "batch_size": int(full.algo.per_rank_batch_size)})
    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                       "algo.learning_starts=8", f"algo.total_steps={summary['policy_steps'] + CONTINUOUS_RESUME_STEPS}",
                       "checkpoint.save_last=false", f"log_root={_log_root(summary)}"])
    resume_launches = dict(kernels.LAUNCHES)
    if not resumed["resident"] or resumed["gradient_steps"] == 0:
        raise AssertionError(f"ring resume: {resumed['gradient_steps']} gradient steps, resident {resumed['resident']}")
    _continuous_launches(resumed, resume_launches, T, H, ring=True)
    out = {"gradient_steps": summary["gradient_steps"], "player_steps": summary["player_steps"],
           "test_steps": summary["test_steps"], "flushes": summary["replay"]["Replay/flushes"], "launches": launches,
           "wall_s": wall, "recipe_ring_bytes": recipe_bytes, "cut_ring_rows": CONTINUOUS_RING_BUFFER,
           "resume": {"gradient_steps": resumed["gradient_steps"], "launches": resume_launches,
                      "test_steps": resumed["test_steps"]}}
    log("continuous decoupled ring run: " + json.dumps(out))
    return out


def continuous_serve_phase(ckpt: str) -> dict:
    """The continuous run's checkpoint through ``serve`` on the card: 8
    concurrent sessions x 16 steps with one client reset, each action 2
    floats within the Box; session s0's frames alone give its batched
    actions, every step within SOLO_ATOL_F32 at a float32 compute dtype
    (matmuls of other batch sizes round otherwise). At a bfloat16 one the
    first step is held within SOLO_ATOL_BF16 and the rest reported: a
    product's rounding at another batch size moves a posterior draw within
    bfloat16 rounding of a tie to the other class now and then, and the
    session's later steps part from there. One ``gru_gates_ln`` launch per
    dispatch. Then, in sample mode, a session fed the run's sampled test
    episode's frames gives its actions exactly."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import utils as dv3_utils

    bf16 = Precision.from_config(load_config(find_run_config(ckpt))).compute_dtype != torch.float32
    solo_atol = SOLO_ATOL_BF16 if bf16 else SOLO_ATOL_F32
    rng = np.random.default_rng(12)
    frames = [[rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8) for _ in range(N_STEPS)]
              for _ in range(N_SESSIONS)]
    result = _serve_with([f"checkpoint_path={ckpt}", "serve.session.buckets=[1,8,32]", "serve.max_wait_ms=2.0"],
                         _sessions_client(frames))
    acts = np.asarray(result["actions"], dtype=np.float64)
    if acts.shape != (N_SESSIONS, N_STEPS, 1, CONTINUOUS_ACTIONS) or np.abs(acts).max() > 1.0:
        raise AssertionError(f"continuous served actions of shape {acts.shape}, max {np.abs(acts).max()}")
    solo_gap = np.abs(np.asarray(result["solo"], dtype=np.float64) - acts[0])
    solo_err = float(solo_gap.max())
    held = float(solo_gap[0].max()) if bf16 else solo_err
    if held > solo_atol:
        raise AssertionError(f"session alone differs from the batched rows by {held} (every step: {solo_err})")
    end = result["health_end"]["engine"]
    dispatches = end["dispatches"] + end["warmup_dispatches"]
    if result["launches"]["gru_gates"] != dispatches or result["launches"]["gru_gates"] < 1:
        raise AssertionError(f"gru_gates launched {result['launches']['gru_gates']} times for {dispatches} dispatches")
    lat = np.asarray(result["latencies"]) * 1e3

    # the run's own (sampled) test episode, replayed by a served session
    cfg = load_config(find_run_config(ckpt))
    policy = serve_policy_dreamer_v3(cfg, load_checkpoint(ckpt), "cuda")
    episode_frames, episode_actions = [], []
    make_env = dv3_utils.make_env

    def recording(*args, **kwargs):
        env = make_env(*args, **kwargs)
        reset, step = env.reset, env.step

        def rec_reset(*a, **k):
            o = reset(*a, **k)
            episode_frames.append(o[0]["rgb"].copy())
            return o

        def rec_step(action):
            episode_actions.append(np.asarray(action, np.float32).reshape(-1).tolist())
            o = step(action)
            episode_frames.append(o[0]["rgb"].copy())
            return o

        env.reset, env.step = rec_reset, rec_step
        return env

    dv3_utils.make_env = recording
    try:
        reward, steps = dv3_utils.test(policy.params, cfg, "cuda", greedy=False)
    finally:
        dv3_utils.make_env = make_env

    def client(port: int, res: dict) -> None:
        conn = _Conn(port, time.monotonic() + 300)
        res["served"] = [conn.ask({"obs": {"rgb": episode_frames[t].tolist()}, "session_id": "episode",
                                   "reset": t == 0})["actions"][0] for t in range(steps)]
        conn.close()

    served = _serve_with([f"checkpoint_path={ckpt}", "serve.mode=sample", "serve.session.buckets=[1,8]",
                          "serve.max_wait_ms=2.0"], client)["served"]
    replay_err = float(np.abs(np.asarray(served, np.float64) - np.asarray(episode_actions, np.float64)).max())
    if replay_err > 0.0:
        raise AssertionError(f"the served session parts from the test episode by {replay_err}")
    out = {"sessions": N_SESSIONS, "steps": N_STEPS, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "requests_per_s": lat.size / result["wall_s"],
           "solo_max_abs_err": solo_err, "solo_held_err": held, "launches": result["launches"],
           "episode_steps": steps,
           "episode_reward": reward, "replayed_equal": True}
    log("continuous sessions: " + json.dumps(out))
    return out


class _Sgd:
    """Stands in for a ``ClippedOptimizer`` in a card-vs-CPU comparison: a
    plain SGD step at ``lr`` on the optimizer's parameters."""

    def __init__(self, optimizer, lr: float) -> None:
        self.params = list(optimizer.params)
        self.lr = lr

    def step(self, grads) -> None:
        with torch.no_grad():
            torch._foreach_add_(self.params, list(grads), alpha=-self.lr)


def _zero_launch_check(name: str, launches: dict) -> None:
    if any(launches.values()):
        raise AssertionError(f"{name} is a host-buffer path and launched kernels: {launches}")


def droq_phase(workdir: str) -> dict:
    """DroQ on the card. One train call at the recipe's width (hidden 256,
    batch 256, dropout 0.01; DROQ_CARD_STEPS critic steps, then actor and
    entropy steps) against the same call on the CPU, on the same weights,
    batches, normals and dropout masks, TF32 off: the losses within rtol
    1e-4, the parameters by train_step_phase's rule at lr 3e-4. Then ``run
    preset=droq`` (Pendulum-v1, 4 envs, replay ratio 20: 80 critic steps an
    iteration) for DROQ_TOTAL_STEPS steps on a DROQ_BUFFER-row buffer, no
    kernel launched, a resume, and ``evaluation`` equal to the run's test
    episode."""
    from sheeprl_tpu_torch.algos.droq.agent import build_agent as build_droq
    from sheeprl_tpu_torch.algos.droq.droq import draw_noise as droq_noise
    from sheeprl_tpu_torch.algos.droq.droq import make_train_step as droq_train_step
    from sheeprl_tpu_torch.algos.sac.sac import make_optimizers as sac_optimizers

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset("droq")
    space = {"shape": [1], "low": [-2.0], "high": [2.0], "continuous": True}
    B, G = int(cfg.algo.per_rank_batch_size), DROQ_CARD_STEPS
    rng = np.random.default_rng(13)

    def batch(lead):
        return {"observations": rng.normal(size=(*lead, 3)).astype(np.float32),
                "next_observations": rng.normal(size=(*lead, 3)).astype(np.float32),
                "actions": rng.uniform(-2, 2, size=(*lead, 1)).astype(np.float32),
                "rewards": rng.normal(size=(*lead, 1)).astype(np.float32),
                "terminated": (rng.uniform(size=(*lead, 1)) < 0.1).astype(np.float32)}

    critic_data, actor_data = batch((G, B)), batch((B,))
    ref_agent, _ = build_droq(cfg, 3, space, "cpu")
    noise = droq_noise(ref_agent, G, B, torch.Generator().manual_seed(14), "cpu")
    results = {}
    for dev in ("cpu", "cuda"):
        agent, _ = build_droq(cfg, 3, space, dev)
        train = droq_train_step(agent, sac_optimizers(cfg, agent), cfg)
        dev_noise = {k: v.to(dev) for k, v in noise.items()}
        losses = train({k: torch.from_numpy(v).to(dev) for k, v in critic_data.items()},
                       {k: torch.from_numpy(v).to(dev) for k, v in actor_data.items()}, noise=dev_noise).cpu()
        results[dev] = (losses, {k: v.detach().cpu() for k, v in agent.state_dict().items()})
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=1e-4, atol=1e-6)
    out = {"train_call": {"critic_steps": G, "loss_abs_err": (results["cuda"][0] - results["cpu"][0]).abs().tolist(),
                          "params": _params_check("DroQ agent", results["cuda"][1], results["cpu"][1], 3e-4)}}

    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run(["preset=droq", f"algo.total_steps={DROQ_TOTAL_STEPS}", f"buffer.size={DROQ_BUFFER}",
                       "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _zero_launch_check("DroQ run", launches)
    if summary["device"].split(":")[0] != "cuda" or summary["gradient_steps"] < 80 or summary["test_steps"] != 200:
        raise AssertionError(f"DroQ run: {summary['gradient_steps']} gradient steps, test {summary['test_steps']}")
    if not np.isfinite(np.asarray(summary["losses"])).all():
        raise AssertionError(f"DroQ run: non-finite losses {summary['losses']}")
    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                       "algo.learning_starts=4", f"algo.total_steps={DROQ_TOTAL_STEPS + 16}", "algo.run_test=false",
                       "checkpoint.save_last=false", f"log_root={_log_root(summary)}"])
    resume_launches = dict(kernels.LAUNCHES)
    _zero_launch_check("DroQ resume", resume_launches)
    kernels.reset_launches()
    evaluated = cli.evaluation([f"checkpoint_path={summary['checkpoint']}"])
    if evaluated["reward"] != summary["test_reward"] or resumed["gradient_steps"] == 0:
        raise AssertionError(f"DroQ evaluation {evaluated} against the run's test {summary['test_reward']}; "
                             f"resume {resumed['gradient_steps']} gradient steps")
    out.update(gradient_steps=summary["gradient_steps"], train_calls=summary["train_calls"], wall_s=wall,
               host_ms_per_train_call=float(np.median(summary["train_s"]) * 1e3), launches=launches,
               resume={"gradient_steps": resumed["gradient_steps"], "launches": resume_launches},
               evaluation={"reward": evaluated["reward"], "launches": dict(kernels.LAUNCHES)},
               test_reward=summary["test_reward"])
    _zero_launch_check("DroQ evaluation", dict(kernels.LAUNCHES))
    log("DroQ: " + json.dumps(out))
    return out


def sac_ae_phase(workdir: str) -> dict:
    """SAC-AE on the card. One train call of 2 gradient steps from step 1
    (the first skips the EMAs and the actor, the second takes both; both
    update the decoder) at the recipe's full width (conv trunk 4 x 512,
    features 64, hidden 1024), batch cut to SAC_AE_CARD_BATCH, against the
    same call on the CPU with the same weights, batch and draws, TF32 off,
    each of the five optimizers an SGD at SAC_AE_SGD_LR: Adam's first step
    moves an element with a near-zero gradient by lr either way, and over
    512-channel convolutions those flips part the two machines' second
    step by percents, which would hide a real fault. The losses within
    rtol 1e-4, each optimizer's last gradient within CONTINUOUS_GRAD_RTOL of
    its norm, every parameter within 1e-6. The recipe's Adams run in the
    run below. Then ``run preset=sac_ae`` at batch 128 on a
    SAC_AE_BUFFER-row buffer for SAC_AE_TRAIN_ITERS training iterations, no
    kernel launched, a resume, ``evaluation`` equal to the run's test
    episode, and one recipe gradient step (batch 128, every gate on)
    profiled."""
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent as build_sac_ae
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import draw_noise as sac_ae_noise
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_optimizers as sac_ae_optimizers
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_train_step as sac_ae_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = apply_overrides(preset("sac_ae"), [f"algo.per_rank_batch_size={SAC_AE_CARD_BATCH}"])
    cfg["spaces"] = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}},
                     "actions": {"shape": [2], "low": [-1.0, -1.0], "high": [1.0, 1.0], "continuous": True}}
    cfg = apply_overrides(cfg, [])
    B, G = SAC_AE_CARD_BATCH, 2
    rng = np.random.default_rng(15)
    data = {"rgb": rng.integers(0, 256, (G, B, 64, 64, 3)).astype(np.float32),
            "next_rgb": rng.integers(0, 256, (G, B, 64, 64, 3)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (G, B, 2)).astype(np.float32),
            "rewards": rng.normal(size=(G, B, 1)).astype(np.float32),
            "terminated": (rng.uniform(size=(G, B, 1)) < 0.25).astype(np.float32)}
    ref_agent, _ = build_sac_ae(cfg, "cpu")
    noise = sac_ae_noise(ref_agent, cfg, G, B, torch.Generator().manual_seed(16), "cpu")
    del ref_agent
    results = {}
    for dev in ("cpu", "cuda"):
        agent, _ = build_sac_ae(cfg, dev)
        optimizers = {k: _Sgd(opt, SAC_AE_SGD_LR) for k, opt in sac_ae_optimizers(cfg, agent).items()}
        seen = {k: _capture_grads(opt) for k, opt in optimizers.items()}
        train = sac_ae_train_step(agent, optimizers, cfg)
        dev_noise = {"next": noise["next"].to(dev), "actor": noise["actor"].to(dev),
                     "pixels": {k: v.to(dev) for k, v in noise["pixels"].items()}}
        t0 = time.perf_counter()
        losses = train({k: torch.from_numpy(v).to(dev) for k, v in data.items()}, 1, noise=dev_noise).cpu()
        results[dev] = (losses, {k: v.detach().cpu() for k, v in agent.state_dict().items()}, time.perf_counter() - t0,
                        {k: v["grads"] for k, v in seen.items()})
        del agent, train, optimizers
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=1e-4, atol=1e-6)
    grads = {k: _grad_rel_err(results["cuda"][3][k], results["cpu"][3][k]) for k in results["cpu"][3]}
    param_err = _max_param_err(results["cuda"][1], results["cpu"][1])
    if max(grads.values()) > CONTINUOUS_GRAD_RTOL or param_err > 1e-6:
        raise AssertionError(f"SAC-AE train call on the card: gradients {grads}, parameters {param_err} from the CPU")
    out = {"train_call": {"steps": G, "batch": B, "cpu_s": results["cpu"][2], "cuda_s": results["cuda"][2],
                          "loss_abs_err": (results["cuda"][0] - results["cpu"][0]).abs().tolist(),
                          "grad_rel_err": grads, "param_max_abs_err": param_err}}
    del results

    full = preset("sac_ae")
    n_envs, starts = int(full.env.num_envs), int(full.algo.learning_starts)
    total = starts + n_envs * (SAC_AE_TRAIN_ITERS - 1)
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run(["preset=sac_ae", f"algo.total_steps={total}", f"buffer.size={SAC_AE_BUFFER}",
                       "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _zero_launch_check("SAC-AE run", launches)
    if summary["device"].split(":")[0] != "cuda" or summary["gradient_steps"] < 4 or not summary["test_steps"]:
        raise AssertionError(f"SAC-AE run: {summary['gradient_steps']} gradient steps, test {summary['test_steps']}")
    if not np.isfinite(np.asarray(summary["losses"])).all():
        raise AssertionError(f"SAC-AE run: non-finite losses {summary['losses']}")
    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                       "algo.learning_starts=4", f"algo.total_steps={total + 12}", "algo.run_test=false",
                       "checkpoint.save_last=false", f"log_root={_log_root(summary)}"])
    resume_launches = dict(kernels.LAUNCHES)
    _zero_launch_check("SAC-AE resume", resume_launches)
    kernels.reset_launches()
    evaluated = cli.evaluation([f"checkpoint_path={summary['checkpoint']}"])
    evaluated["launches"] = dict(kernels.LAUNCHES)
    _zero_launch_check("SAC-AE evaluation", evaluated["launches"])
    if evaluated["reward"] != summary["test_reward"] or resumed["gradient_steps"] == 0:
        raise AssertionError(f"SAC-AE evaluation {evaluated} against {summary['test_reward']}; resume "
                             f"{resumed['gradient_steps']} gradient steps")
    # one recipe gradient step (batch 128, every gate on) from the run's checkpoint, profiled
    run_cfg = load_config(find_run_config(summary["checkpoint"]))
    agent, _ = build_sac_ae(run_cfg, "cuda", load_checkpoint(summary["checkpoint"])["agent"])
    train = sac_ae_train_step(agent, sac_ae_optimizers(run_cfg, agent), run_cfg)
    B = int(run_cfg.algo.per_rank_batch_size)
    batch = {"rgb": torch.randint(0, 256, (1, B, 64, 64, 3), device="cuda").float(),
             "next_rgb": torch.randint(0, 256, (1, B, 64, 64, 3), device="cuda").float(),
             "actions": torch.rand((1, B, 2), device="cuda") * 2 - 1, "rewards": torch.zeros((1, B, 1), device="cuda"),
             "terminated": torch.zeros((1, B, 1), device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(17)
    profile = _profile_call(lambda: train(batch, 2, generator=gen).cpu())
    profile.pop("lstm_device_ms")
    del agent, train, batch
    out.update(gradient_steps=summary["gradient_steps"], wall_s=wall, launches=launches, profile=profile,
               host_ms_per_train_call=[s * 1e3 for s in summary["train_s"]],
               resume={"gradient_steps": resumed["gradient_steps"], "launches": resume_launches},
               evaluation={"reward": evaluated["reward"], "steps": evaluated["steps"], "launches": evaluated["launches"]},
               test_reward=summary["test_reward"])
    log("SAC-AE: " + json.dumps(out))
    return out


def sac_next_obs_phase(workdir: str) -> dict:
    """``run preset=sac buffer.sample_next_obs=true`` on the card at full
    width for SAC_NEXT_OBS_STEPS steps: the host buffer stores no next
    observation, every loss finite, no kernel launched."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run(["preset=sac", "algo.hybrid_player.enabled=false", "buffer.sample_next_obs=true",
                       f"algo.total_steps={SAC_NEXT_OBS_STEPS}",
                       "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _zero_launch_check("SAC sample_next_obs run", launches)
    stored = set(load_checkpoint(summary["checkpoint"])["rb"]["buffer"])
    if "next_observations" in stored or summary["resident"] or summary["gradient_steps"] < 100:
        raise AssertionError(f"sample_next_obs run: stored {sorted(stored)}, {summary['gradient_steps']} steps")
    if not np.isfinite(np.asarray(summary["losses"])).all():
        raise AssertionError(f"sample_next_obs run: non-finite losses {summary['losses']}")
    out = {"gradient_steps": summary["gradient_steps"], "stored_keys": sorted(stored), "launches": launches,
           "wall_s": wall, "test_reward": summary["test_reward"]}
    log("SAC sample_next_obs: " + json.dumps(out))
    return out


# -- 38-41. Plan2Explore, the classic-control envs, dry runs ----------------------

EXPLORE_PRESET = "p2e_dv3_exploration_atari_dummy"
FINETUNE_PRESET = "p2e_dv3_finetuning_atari_dummy"
# cuts of scale for the P2E runs: 1 env (the recipe's 4 would need 256 steps to
# fill a 64-step window per env), learning_starts 128, 6 gradient steps
EXPLORE_LEARNING_STARTS, EXPLORE_GRADIENT_STEPS, EXPLORE_RESUME_STEPS = 128, 6, 4
# the finetuning run on the exploration's buffer: the first grant at step 8, then 1 a step
FINETUNE_LEARNING_STARTS, FINETUNE_TOTAL_STEPS = 8, 12
# the gradients of one exploration step, card against CPU, as CONTINUOUS_GRAD_RTOL
EXPLORE_GRAD_RTOL = 2e-3
# JAX make_env's episode of the continuous preset's env: the counter at 2 per
# agent step (action repeat 2) ends on the step after 128 (tests/test_torch_action_repeat.py)
CONTINUOUS_EPISODE_STEPS = 65
CLASSIC_ENVS, CLASSIC_PPO_ITERATIONS = ("Acrobot-v1", "MountainCar-v0"), 4


def _explore_launch_want(summary: dict, T: int, H: int) -> dict:
    """One exploration gradient step: T + 2H ``gru_gates_ln`` (the dynamic
    rollout, two imaginations), 7 fused two-hot losses and 7 backward
    launches (the reward and two per critic update, three critics), 8
    decodes (the two exploration critics' values and the reward in the
    exploration imagination, the task's value and reward, the three critic
    targets); one GRU step per player and test-episode step."""
    G = summary["gradient_steps"]
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update({"two_hot_symlog_loss_lse": 7 * G, "two_hot_symlog_loss_lse_bwd": 7 * G,
                 "two_hot_symexp_decode": 8 * G,
                 "gru_gates": G * (T + 2 * H) + summary["player_steps"] + (summary["test_steps"] or 0)})
    return want


def _explore_cfg(extra=()):
    cfg = apply_overrides(preset(EXPLORE_PRESET), list(extra))
    cfg["spaces"] = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}}, "actions": {"n": [18], "continuous": False}}
    return apply_overrides(cfg, [])


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def explore_step_phase() -> dict:
    """One P2E-DV3 exploration gradient step (full width, B 4 x T 16, H 15,
    8 ensemble members) on the card against the same step on the CPU, TF32
    off: the same seeded weights, batch and injected noise. The fifteen
    metrics (the intrinsic reward among them) within rtol 1e-4; each of the
    eight optimizers' gradients (the world model, the ensembles, both
    actors, the task critic and the two exploration critics; the targets
    move by the EMA alone) within EXPLORE_GRAD_RTOL of its norm; every
    module's parameters by train_step_phase's rule, the targets (a copy of
    the critics before the step) exactly."""
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as p2e
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import STATE_KEYS, build_agent as build_p2e_agent

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B = 16, 4
    cfg = _explore_cfg([f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}"])
    names = p2e.metric_names(p2e.critics_spec(cfg))
    data = _batch(np.random.default_rng(4), T, B, 18)
    noise = p2e.draw_noise(cfg, T, B, [18], torch.Generator().manual_seed(5), "cpu")
    results = {}
    for dev in ("cpu", "cuda"):
        agent = build_p2e_agent(cfg, dev)
        optimizers = p2e.make_optimizers(cfg, agent)
        seen = {k: _capture_grads(opt) for k, opt in optimizers.items()}
        train = p2e.make_train_step(agent, optimizers, cfg)
        t0 = time.perf_counter()
        _, metrics = train({k: v.to(dev) for k, v in data.items()}, p2e.initial_moments(agent, dev), 0,
                           noise=[_to_device(noise, dev)])
        metrics = metrics.cpu()
        seconds = time.perf_counter() - t0
        params = {k: {n: v.detach().cpu() for n, v in sd.items()} for k, sd in agent.state().items()}
        results[dev] = (metrics[0], params, seconds, {k: v["grads"] for k, v in seen.items()})
    card, cpu = results["cuda"], results["cpu"]
    if not torch.isfinite(card[0]).all():
        raise AssertionError(f"non-finite exploration losses on the card: {card[0].tolist()}")
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-4, atol=1e-5)
    intrinsic = names.index("Rewards/intrinsic")
    out = {"cpu_s": cpu[2], "cuda_s": card[2],
           "loss_abs_err": dict(zip(names, (card[0] - cpu[0]).abs().tolist())),
           "intrinsic_reward": {"card": float(card[0][intrinsic]), "cpu": float(cpu[0][intrinsic])}}
    if not out["intrinsic_reward"]["card"] > 0:
        raise AssertionError(f"the ensembles' disagreement is not positive: {out['intrinsic_reward']}")
    for opt_name in card[3]:
        err = _grad_rel_err(card[3][opt_name], cpu[3][opt_name])
        out[f"{opt_name}_grad_rel_err"] = err
        if err > EXPLORE_GRAD_RTOL:
            raise AssertionError(f"exploration step: the {opt_name} gradient on the card is {err} of its norm from "
                                 "the CPU's")
    lrs = {"world_model": 1e-4, "ensembles": 1e-4, "actor_task": 8e-5, "actor_exploration": 8e-5, "critic_task": 8e-5,
           "critics_exploration": 8e-5, "target_critic_task": 0.0}
    for key in STATE_KEYS:
        out[key] = _params_check(f"exploration {key}", card[1][key], cpu[1][key], lrs[key])
    log("exploration step (card vs CPU): " + json.dumps(out))
    return out


def _ensembles_cost(agent, optimizer, T: int, B: int, H: int, gen) -> dict:
    """The ensembles' work in one exploration gradient step at its shapes,
    alone under ``torch.profiler``: their forward on the (T, B) latents and
    actions, the MSE loss's backward and their Adam step, and the intrinsic
    reward's forward over the (H + 1, T*B) imagined latents and actions."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _grads

    ens = agent.ensembles
    width, out_width = ens.model.dense_0.kernel.shape[1], ens.out.kernel.shape[2]
    x = torch.randn((T, B, width), device="cuda", generator=gen)
    target = torch.randn((T, B, out_width), device="cuda", generator=gen)
    imagined = torch.randn((H + 1, T * B, width), device="cuda", generator=gen)
    params = list(ens.parameters())

    def work():
        outs = ens(x)
        loss = ((outs[:, :-1] - target[None, 1:]) ** 2).sum(-1).mean(dim=(1, 2)).sum()
        optimizer.step(_grads(loss, params))
        with torch.no_grad():
            reward = ens(imagined).var(dim=0, unbiased=False).mean(-1, keepdim=True)
        return reward

    work()
    torch.cuda.synchronize()
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    return {"device_ms": sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e3,
            "device_ops": sum(e.count for e in events)}


def _profile_explore_step(checkpoint: str) -> dict:
    """One full-recipe exploration gradient step (B 16 x T 64, H 15, 8
    members) from the run's checkpoint after two warm-up steps: host ms,
    device ms and operations (``torch.profiler``), each kernel's share, and
    the ensembles' share (:func:`_ensembles_cost` over the step's device
    ms)."""
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as p2e
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent as build_p2e_agent

    cfg = load_config(find_run_config(checkpoint))
    state = load_checkpoint(checkpoint)
    agent = build_p2e_agent(cfg, "cuda", state)
    optimizers = p2e.make_optimizers(cfg, agent)
    train = p2e.make_train_step(agent, optimizers, cfg)
    T, B, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), int(cfg.algo.horizon)
    data = {k: v.cuda() for k, v in _batch(np.random.default_rng(6), T, B, 18).items()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    moments = p2e.initial_moments(agent, "cuda")
    for _ in range(2):
        moments = train(data, moments, 1, gen)[0]
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        moments = train(data, moments, 1, gen)[0]
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        moments = train(data, moments, 1, gen)[0]
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    share = {}
    for kernel, needle in (("two_hot", "two_hot_"), ("gru_gates", "gru_gates_")):
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in events if needle in e.key)
        share[kernel] = {"device_ms": us / 1e3, "share": us / device_us if device_us > 0 else None,
                         "ops": sum(e.count for e in events if needle in e.key)}
    ensembles = _ensembles_cost(agent, optimizers["ensembles"], T, B, H, gen)
    ensembles["share"] = ensembles["device_ms"] * 1e3 / device_us if device_us > 0 else None
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    return {
        "host_ms": float(np.median(host) * 1e3),
        "host_ms_all": [h * 1e3 for h in host],
        "device_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": device_us / 1e3 / (np.median(host) * 1e3) if device_us > 0 else None,
        "device_ops": sum(e.count for e in events),
        "kernels": share,
        "ensembles": ensembles,
        "top": [{"name": e.key[:80], "device_ms": getattr(e, "self_device_time_total", 0.0) / 1e3, "count": e.count}
                for e in top],
    }


def _evaluation_check(name: str, ckpt: str, summary: dict) -> dict:
    """``evaluation`` of a P2E checkpoint on the card: the run's own test
    episode (the task actor, sampled from the run's seed), one GRU step per
    episode step and no other launch."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = cli.evaluation([f"checkpoint_path={ckpt}"])
    launches = dict(kernels.LAUNCHES)
    want = dict({k: 0 for k in kernels.LAUNCHES}, gru_gates=result["steps"])
    if (result["reward"], result["steps"]) != (summary["test_reward"], summary["test_steps"]) or launches != want:
        raise AssertionError(f"{name} evaluation {result} (launches {launches}) is not the run's test episode "
                             f"({summary['test_reward']}, {summary['test_steps']} steps)")
    return {"reward": result["reward"], "steps": result["steps"], "launches": launches,
            "steps_per_s": result["steps"] / (time.perf_counter() - t0)}


def explore_run_phase(workdir: str) -> dict:
    """``run preset=p2e_dv3_exploration_atari_dummy`` on the card at the
    recipe's widths (DreamerV3-S, B 16 x T 64, H 15, 8 ensemble members, the
    100,000-row host buffer), on 1 env with ``learning_starts``
    EXPLORE_LEARNING_STARTS and EXPLORE_GRADIENT_STEPS gradient steps: the
    exact launch counts (:func:`_explore_launch_want`), the fifteen metrics
    finite, the task actor's zero-shot test episode; a resume of
    EXPLORE_RESUME_STEPS steps from the checkpoint's buffer with the path's
    counts; ``evaluation`` of the checkpoint; one gradient step profiled."""
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as p2e

    total = EXPLORE_LEARNING_STARTS + EXPLORE_GRADIENT_STEPS - 1
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run([f"preset={EXPLORE_PRESET}", "env.num_envs=1", f"algo.learning_starts={EXPLORE_LEARNING_STARTS}",
                       f"algo.total_steps={total}", "checkpoint.every=0", "checkpoint.save_last=true",
                       "metric.log_level=0", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cfg = load_config(find_run_config(summary["checkpoint"]))
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    G = summary["gradient_steps"]
    if (G != EXPLORE_GRADIENT_STEPS or summary["device"].split(":")[0] != "cuda" or not summary["test_steps"]
            or not np.isfinite(summary["test_reward"])):
        raise AssertionError(f"exploration run: {G} gradient steps on {summary['device']}, test "
                             f"{summary['test_steps']} steps, return {summary['test_reward']}")
    if not np.isfinite(np.asarray(summary["metrics"])).all() or len(summary["metrics"]) != G:
        raise AssertionError(f"exploration run: non-finite or missing metrics {summary['metrics']}")
    want = _explore_launch_want(summary, T, H)
    if launches != want:
        raise AssertionError(f"exploration launches {launches} != {want} for {G} gradient steps")
    names = p2e.metric_names(p2e.critics_spec(cfg))
    out = {"gradient_steps": G, "policy_steps": summary["policy_steps"], "player_steps": summary["player_steps"],
           "test_steps": summary["test_steps"], "test_reward": summary["test_reward"], "launches": launches,
           "wall_s": wall, "host_ms_per_gradient_step": [s / g * 1e3 for s, g in summary["train_host_s"]],
           "env_steps_per_s": summary["env_steps_per_s"],
           "metrics": [dict(zip(names, row)) for row in summary["metrics"]], "checkpoint": summary["checkpoint"],
           "checkpoint_bytes": os.path.getsize(summary["checkpoint"])}
    log("exploration run: " + json.dumps({k: v for k, v in out.items() if k not in ("metrics", "checkpoint")}))
    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                       "algo.learning_starts=2", f"algo.total_steps={summary['policy_steps'] + EXPLORE_RESUME_STEPS}",
                       "checkpoint.save_last=false", "algo.run_test=false", f"log_root={_log_root(summary)}"])
    resume_launches = dict(kernels.LAUNCHES)
    if (resumed["start_iter"] != summary["policy_steps"] + 1 or resumed["gradient_steps"] == 0
            or resume_launches != _explore_launch_want(resumed, T, H)
            or not np.isfinite(np.asarray(resumed["metrics"])).all()):
        raise AssertionError(f"exploration resume: start {resumed['start_iter']}, {resumed['gradient_steps']} "
                             f"gradient steps, launches {resume_launches}")
    out["resume"] = {"start_iter": resumed["start_iter"], "gradient_steps": resumed["gradient_steps"],
                     "player_steps": resumed["player_steps"], "launches": resume_launches}
    log("exploration resume: " + json.dumps(out["resume"]))
    out["evaluation"] = _evaluation_check("exploration", summary["checkpoint"], summary)
    log("exploration evaluation: " + json.dumps(out["evaluation"]))
    out["profile"] = _profile_explore_step(summary["checkpoint"])
    log("exploration gradient step profile: " + json.dumps(out["profile"]))
    return out


def finetune_phase(workdir: str, explore_ckpt: str) -> dict:
    """``run preset=p2e_dv3_finetuning_atari_dummy
    checkpoint.exploration_ckpt_path=<the exploration run's checkpoint>
    buffer.load_from_exploration=true`` on the card: the exploration's
    buffer and its 1 env, DreamerV3's gradient step from the first grant at
    step FINETUNE_LEARNING_STARTS, the player switched from the exploration
    actor to the task actor at that step, DreamerV3's exact launch counts
    (one GRU step per player step from the first: no random prefill, as in
    JAX); then ``evaluation`` of its checkpoint."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run([f"preset={FINETUNE_PRESET}", f"checkpoint.exploration_ckpt_path={explore_ckpt}",
                       "buffer.load_from_exploration=true", f"algo.learning_starts={FINETUNE_LEARNING_STARTS}",
                       f"algo.total_steps={FINETUNE_TOTAL_STEPS}", "checkpoint.every=0", "checkpoint.save_last=true",
                       "metric.log_level=0", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cfg = load_config(find_run_config(summary["checkpoint"]))
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    G = summary["gradient_steps"]
    if (summary["switched_at"] != FINETUNE_LEARNING_STARTS or G != FINETUNE_TOTAL_STEPS - FINETUNE_LEARNING_STARTS + 1
            or summary["player_steps"] != FINETUNE_TOTAL_STEPS or int(cfg.env.num_envs) != 1):
        raise AssertionError(f"finetuning: switched at {summary['switched_at']}, {G} gradient steps, "
                             f"{summary['player_steps']} player steps, {cfg.env.num_envs} envs")
    want = _dreamer_launch_want(summary, T, H)
    if launches != want or not np.isfinite(np.asarray(summary["metrics"])).all():
        raise AssertionError(f"finetuning launches {launches} != {want}, or non-finite losses {summary['metrics']}")
    rows = [env["pos"] for env in load_checkpoint(summary["checkpoint"])["rb"]["envs"]]
    out = {"gradient_steps": G, "switched_at": summary["switched_at"], "player_steps": summary["player_steps"],
           "test_steps": summary["test_steps"], "test_reward": summary["test_reward"], "launches": launches,
           "wall_s": wall, "host_ms_per_gradient_step": [s / g * 1e3 for s, g in summary["train_host_s"]],
           "buffer_rows": rows, "losses": [dict(zip(METRIC_NAMES, row)) for row in summary["metrics"]]}
    log("finetuning run: " + json.dumps({k: v for k, v in out.items() if k != "losses"}))
    out["evaluation"] = _evaluation_check("finetuning", summary["checkpoint"], summary)
    log("finetuning evaluation: " + json.dumps(out["evaluation"]))
    return out


def classic_ppo_phase(workdir: str) -> dict:
    """PPO at the recipe's widths (4 envs x 128 steps, 10 x 8 minibatches)
    on Acrobot-v1 and on MountainCar-v0 through ``run``, CLASSIC_PPO_ITERATIONS
    iterations each: ``gae`` exactly once per iteration and no other kernel,
    every loss finite, every episode within the env's step limit; then
    ``evaluation`` of each checkpoint, no kernel."""
    out = {}
    for env_id in CLASSIC_ENVS:
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary = cli.run([f"preset={PPO_PRESET}", f"env.id={env_id}", "metric.log_level=0",
                           f"algo.total_steps={CLASSIC_PPO_ITERATIONS * 4 * 128}", f"log_root={workdir}"])
        launches = dict(kernels.LAUNCHES)
        if summary["iterations"] != CLASSIC_PPO_ITERATIONS or summary["device"].split(":")[0] != "cuda":
            raise AssertionError(f"{env_id} PPO: {summary['iterations']} iterations on {summary['device']}")
        _ppo_launch_check(summary, launches)
        limit = 500 if env_id == "Acrobot-v1" else 200
        lengths = [ep_len for *_, ep_len in summary["episodes"]]
        if not np.isfinite(np.asarray(summary["losses"])).all() or not lengths or max(lengths) > limit:
            raise AssertionError(f"{env_id} PPO: losses {summary['losses'][-1]}, episode lengths {lengths[:8]}")
        kernels.reset_launches()
        result = cli.evaluation([f"checkpoint_path={summary['checkpoint']}"])
        if any(kernels.LAUNCHES.values()) or not 0 < result["steps"] <= limit:
            raise AssertionError(f"{env_id} evaluation {result}, launches {dict(kernels.LAUNCHES)}")
        out[env_id] = {"iterations": summary["iterations"], "launches": launches, "episodes": len(lengths),
                       "mean_return": float(np.mean([ret for _, _, ret, _ in summary["episodes"]])),
                       "wall_s": time.perf_counter() - t0, "env_steps_per_s": summary["env_steps_per_s"],
                       "evaluation": {"reward": result["reward"], "steps": result["steps"]}}
        log(f"{env_id} PPO: " + json.dumps(out[env_id]))
    return out


def dry_run_phase(workdir: str) -> dict:
    """``dry_run=true`` on the card at each family's recipe width, against
    a ``total_steps`` and ``learning_starts`` it must ignore: one iteration,
    the family's exact launch counts (``gae`` once for the PPO family; the
    DreamerV3 and P2E counts at sequence length 1, which the 2-row dry-run
    buffer holds, as the JAX package's dry-run tests set it; none for the SAC
    family), finite losses; a finetuning dry run from the exploration's."""
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration  # noqa: F401 - the TRAINERS entry

    seq1 = ["algo.per_rank_sequence_length=1"]
    coupled = ["algo.hybrid_player.enabled=false"]  # the coupled topology, as JAX's coupled exps set it
    families = {"ppo": (PPO_PRESET, [], 4 * 128), "a2c": ("a2c", [], 4 * 5),
                "ppo_recurrent": ("ppo_recurrent", [], 16 * 512), "dreamer_v3": (RUN_PRESET, seq1 + coupled, 1),
                "sac": ("sac", coupled, 4), "droq": ("droq", [], 4), "sac_ae": ("sac_ae", ["buffer.memmap=false"], 4),
                "p2e_dv3_exploration": (EXPLORE_PRESET, seq1, 4)}
    common = ["dry_run=true", "algo.total_steps=1000000", "algo.learning_starts=500000", "checkpoint.every=0",
              "checkpoint.save_last=true", "metric.log_level=0", f"log_root={workdir}"]
    out = {}
    for name, (preset_name, extra, steps) in families.items():
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary = cli.run([f"preset={preset_name}"] + common + extra)
        launches = dict(kernels.LAUNCHES)
        losses = summary.get("metrics") or summary.get("losses") or []
        if summary["policy_steps"] != steps or not np.isfinite(np.asarray(losses, dtype=np.float64)).all():
            raise AssertionError(f"{name} dry run: {summary['policy_steps']} policy steps (want {steps})")
        if name in ("ppo", "a2c", "ppo_recurrent"):
            want = dict({k: 0 for k in kernels.LAUNCHES}, gae=1)
        elif name == "dreamer_v3":
            want = _dreamer_launch_want(summary, 1, int(preset(RUN_PRESET).algo.horizon))
        elif name == "p2e_dv3_exploration":
            want = _explore_launch_want(summary, 1, int(preset(EXPLORE_PRESET).algo.horizon))
        else:
            want = {k: 0 for k in kernels.LAUNCHES}
        if launches != want or (name not in ("ppo", "a2c", "ppo_recurrent") and not summary["gradient_steps"]):
            raise AssertionError(f"{name} dry run: launches {launches} != {want}, "
                                 f"{summary.get('gradient_steps')} gradient steps")
        out[name] = {"policy_steps": summary["policy_steps"], "gradient_steps": summary.get("gradient_steps"),
                     "launches": launches, "wall_s": time.perf_counter() - t0}
        if name == "p2e_dv3_exploration":
            explore_ckpt = summary["checkpoint"]
    kernels.reset_launches()
    summary = cli.run([f"preset={FINETUNE_PRESET}", f"checkpoint.exploration_ckpt_path={explore_ckpt}"] + common + seq1)
    launches = dict(kernels.LAUNCHES)
    want = _dreamer_launch_want(summary, 1, int(preset(EXPLORE_PRESET).algo.horizon))
    if summary["policy_steps"] != 4 or summary["switched_at"] != 4 or launches != want:
        raise AssertionError(f"finetuning dry run: {summary['policy_steps']} steps, switched at "
                             f"{summary['switched_at']}, launches {launches} != {want}")
    out["p2e_dv3_finetuning"] = {"policy_steps": 4, "gradient_steps": summary["gradient_steps"], "launches": launches}
    log("dry runs: " + json.dumps(out))
    return out


# -- 42-45. Dreamer V2 and Plan2Explore on Dreamer V2 -----------------------------

V2_PRESET = "dreamer_v2_atari_dummy"
V2_EPISODE_PRESET = "dreamer_v2_ms_pacman_dummy"
V2_EXPLORE_PRESET = "p2e_dv2_exploration_atari_dummy"
V2_FINETUNE_PRESET = "p2e_dv2_finetuning_atari_dummy"
# cuts of scale for the V2 runs: 1 env (the recipe's 4 would need 200 steps to
# fill a 50-step window per env), learning_starts 128; the replay ratio of 0.2
# then grants a gradient step every 5 env steps (the JAX loop's Ratio clamps
# per_rank_pretrain_steps to the 1 step it first sees, so it grants none up front)
V2_LEARNING_STARTS, V2_GRADIENT_STEPS, V2_RESUME_STEPS = 128, 6, 12
# the episode buffer stores an episode at its end: seed 5's first ends at step
# 366, and the ms_pacman recipe's ratio of 0.0625 grants a step every 16
V2_EPISODE_LEARNING_STARTS, V2_EPISODE_GRADIENT_STEPS, V2_EPISODE_RESUME_STEPS = 368, 3, 32
V2_EXPLORE_GRADIENT_STEPS, V2_FINETUNE_TOTAL_STEPS = 4, 23
# gradients card against CPU: the discrete actor's as the DreamerV3 step's;
# the trunc_normal actor's through 15 imagined RSSM steps as the continuous one's
V2_GRAD_RTOL = 2e-3


def _v2_launch_want(summary: dict, per_step: int) -> dict:
    """``gru_gates_ln`` ``per_step`` times a gradient step (T + H for Dreamer
    V2 and finetuning, T + 2H for a P2E-DV2 exploration step), once per
    player and test-episode step; no other kernel (V2's heads are Normal)."""
    want = {name: 0 for name in kernels.LAUNCHES}
    want["gru_gates"] = summary["gradient_steps"] * per_step + summary["player_steps"] + (summary["test_steps"] or 0)
    return want


def _v2_cfg(name: str, extra=(), continuous: bool = False):
    cfg = apply_overrides(preset(name), list(extra))
    actions = ({"shape": [CONTINUOUS_ACTIONS], "low": [-1.0] * CONTINUOUS_ACTIONS,
                "high": [1.0] * CONTINUOUS_ACTIONS, "continuous": True} if continuous
               else {"n": [18], "continuous": False})
    cfg["spaces"] = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}}, "actions": actions}
    return apply_overrides(cfg, [])


def v2_step_phase() -> dict:
    """One Dreamer V2 gradient step at the full recipe's widths (recurrent
    600, dense 400 x 4, CNN multiplier 48; B 4 x T 16, H 15) on the card
    against the same step on the CPU, TF32 off, from the same seeded weights,
    batch and injected draws: the discrete actor at ``objective_mix`` 1 (the
    recipe) and a ``trunc_normal`` actor at ``objective_mix`` 0 on the
    continuous dummy env's 2 actions (its gradient through the imagined RSSM
    steps, ``gru_gates_ln``'s plain backward chain). The ten metrics within
    rtol 1e-4; each optimizer's gradient within V2_GRAD_RTOL of its norm; the
    parameters after AdamW by train_step_phase's rule; the card's AdamW
    fused and capturable."""
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent as build_v2_agent

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B = 16, 4
    out = {}
    for kind, continuous, extra in (("discrete", False, []), ("trunc_normal", True, ["algo.actor.objective_mix=0.0"])):
        cfg = _v2_cfg(V2_PRESET, [f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}"] + extra,
                      continuous)
        data = (_continuous_batch if continuous else lambda r, t, b: _batch(r, t, b, 18))(np.random.default_rng(8), T, B)
        results = {}
        for dev in ("cpu", "cuda"):
            modules = build_v2_agent(cfg, dev)
            optimizers = dv2.make_optimizers(cfg, *modules[:3])
            if dev == "cuda":
                group = optimizers["world"].optimizer.param_groups[0]
                if not (isinstance(optimizers["world"].optimizer, torch.optim.AdamW) and group["fused"]
                        and group["capturable"] and group["weight_decay"] == 1e-6):
                    raise AssertionError(f"the card's V2 optimizer is not a fused capturable AdamW: {group}")
            if dev == "cpu":
                noise = dv2.draw_noise(cfg, T, B, modules[1], torch.Generator().manual_seed(9), "cpu")
            seen = {k: _capture_grads(opt) for k, opt in optimizers.items()}
            train = dv2.make_train_step(*modules, optimizers, cfg)
            t0 = time.perf_counter()
            metrics = train({k: v.to(dev) for k, v in data.items()}, 0, noise=[_to_device(noise, dev)]).cpu()
            seconds = time.perf_counter() - t0
            params = {name: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                      for name, m in zip(("world_model", "actor", "critic", "target_critic"), modules)}
            results[dev] = (metrics[0], params, seconds, {k: v["grads"] for k, v in seen.items()})
        card, cpu = results["cuda"], results["cpu"]
        if not torch.isfinite(card[0]).all():
            raise AssertionError(f"V2 {kind} step: non-finite losses on the card: {card[0].tolist()}")
        torch.testing.assert_close(card[0], cpu[0], rtol=1e-4, atol=1e-5)
        row = {"cpu_s": cpu[2], "cuda_s": card[2],
               "loss_abs_err": dict(zip(METRIC_NAMES, (card[0] - cpu[0]).abs().tolist()))}
        for name in card[3]:
            err = _grad_rel_err(card[3][name], cpu[3][name])
            row[f"{name}_grad_rel_err"] = err
            if err > V2_GRAD_RTOL:
                raise AssertionError(f"V2 {kind} step: the {name} gradient on the card is {err} of its norm from the CPU's")
        lrs = {"world_model": 3e-4, "actor": 8e-5, "critic": 8e-5, "target_critic": 0.0}
        for name in lrs:
            row[name] = _params_check(f"V2 {kind} {name}", card[1][name], cpu[1][name], lrs[name])
        out[kind] = row
        log(f"V2 {kind} step (card vs CPU): " + json.dumps(row))
    return out


def _profile_v2_step(checkpoint: str, explore: bool = False) -> dict:
    """One full-recipe gradient step (B 16 x T 50, H 15) from a run's
    checkpoint after two warm-up steps: host ms, device ms and operations
    (``torch.profiler``), ``gru_gates_ln``'s share, the top kernels and, for
    a P2E-DV2 exploration step, the ensembles' share (:func:`_ensembles_cost`
    over the step's device ms)."""
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent as build_v2_agent
    from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as p2e
    from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent as build_p2e_agent

    cfg = load_config(find_run_config(checkpoint))
    state = load_checkpoint(checkpoint)
    if explore:
        agent = build_p2e_agent(cfg, "cuda", state)
        optimizers = p2e.make_optimizers(cfg, agent)
        train = p2e.make_train_step(agent, optimizers, cfg)
    else:
        modules = build_v2_agent(cfg, "cuda", state)
        optimizers = dv2.make_optimizers(cfg, *modules[:3])
        train = dv2.make_train_step(*modules, optimizers, cfg)
    T, B, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), int(cfg.algo.horizon)
    data = {k: v.cuda() for k, v in _batch(np.random.default_rng(6), T, B, 18).items()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    for _ in range(2):
        train(data, 1, gen)
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        train(data, 1, gen)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA], record_shapes=True) as prof:
        train(data, 1, gen)
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    forward_ln, backward_ln = _gru_layer_norms(prof, 3 * int(cfg.algo.world_model.recurrent_model.recurrent_state_size))
    if forward_ln:
        raise AssertionError(f"{forward_ln} LayerNorms of the GRU projection remain in a V2 step's forward")
    gru_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events if "gru_gates_" in e.key)
    conv_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events
                  if any(w in e.key.lower() for w in ("conv", "wgrad", "dgrad", "fprop", "implicit")))
    out = {
        "host_ms": float(np.median(host) * 1e3),
        "host_ms_all": [h * 1e3 for h in host],
        "device_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": device_us / 1e3 / (np.median(host) * 1e3) if device_us > 0 else None,
        "device_ops": sum(e.count for e in events),
        "gru_layer_norms": {"forward": forward_ln, "backward": backward_ln},
        "gru_gates": {"device_ms": gru_us / 1e3, "share": gru_us / device_us if device_us > 0 else None,
                      "ops": sum(e.count for e in events if "gru_gates_" in e.key)},
        "convolution_share": conv_us / device_us if device_us > 0 else None,
        "top": [{"name": e.key[:80], "device_ms": getattr(e, "self_device_time_total", 0.0) / 1e3, "count": e.count}
                for e in sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]],
    }
    if explore:
        ensembles = _ensembles_cost(agent, optimizers["ensembles"], T, B, H, gen)
        ensembles["share"] = ensembles["device_ms"] * 1e3 / device_us if device_us > 0 else None
        out["ensembles"] = ensembles
    return out


def _v2_run(args, per_step: int, name: str) -> tuple:
    """``cli.run(args)`` with the counts zeroed just before and checked just
    after (:func:`_v2_launch_want`); finite metrics, on the card."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run(args)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if summary["device"].split(":")[0] != "cuda" or not np.isfinite(np.asarray(summary["metrics"])).all():
        raise AssertionError(f"{name}: on {summary['device']}, metrics {summary['metrics'][:2]}")
    want = _v2_launch_want(summary, per_step)
    if launches != want:
        raise AssertionError(f"{name} launches {launches} != {want} ({summary['gradient_steps']} gradient steps)")
    return summary, launches, wall


def _v2_resume_check(name: str, summary: dict, resumed: dict) -> dict:
    """A resume starts where its checkpoint ended, from exactly its buffer
    (``buffer_digest``: rows, per-key sums, heads, generators) and its
    gradient-step count, and trains."""
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import buffer_digest

    saved = load_checkpoint(summary["checkpoint"])
    if (resumed["start_iter"] != summary["policy_steps"] + 1 or resumed["restored_buffer"] != buffer_digest(saved["rb"])
            or resumed["cum_restored"] != saved["cum"] or resumed["gradient_steps"] == 0):
        raise AssertionError(f"{name} resume: start {resumed['start_iter']}, restored {resumed['restored_buffer']} "
                             f"cum {resumed['cum_restored']} (saved {saved['cum']}), {resumed['gradient_steps']} steps")
    return {"start_iter": resumed["start_iter"], "gradient_steps": resumed["gradient_steps"],
            "restored_rows": resumed["restored_buffer"]["rows"], "cum_restored": resumed["cum_restored"]}


def _v2_summary(summary: dict, launches: dict, wall: float) -> dict:
    return {"gradient_steps": summary["gradient_steps"], "policy_steps": summary["policy_steps"],
            "player_steps": summary["player_steps"], "test_steps": summary["test_steps"],
            "test_reward": summary["test_reward"], "launches": launches, "wall_s": wall,
            "host_ms_per_gradient_step": [s / g * 1e3 for s, g in summary["train_host_s"]],
            "env_steps_per_s": summary["env_steps_per_s"], "checkpoint": summary["checkpoint"],
            "checkpoint_bytes": os.path.getsize(summary["checkpoint"])}


def v2_run_phase(workdir: str) -> dict:
    """``run preset=dreamer_v2_atari_dummy`` on the card at the recipe's
    widths (B 16 x T 50, H 15, the 100,000-row sequential buffer), on 1 env
    with ``learning_starts`` V2_LEARNING_STARTS and V2_GRADIENT_STEPS
    gradient steps: exact ``gru_gates_ln`` counts (T + H a gradient step, 1 a
    player or test-episode step), the greedy test episode; a resume of
    V2_RESUME_STEPS steps from exactly the saved buffer and gradient-step
    count; ``evaluation`` of the checkpoint equal to the run's test episode;
    one gradient step profiled."""
    total = V2_LEARNING_STARTS + 5 * V2_GRADIENT_STEPS
    cfg = preset(V2_PRESET)
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    summary, launches, wall = _v2_run(
        [f"preset={V2_PRESET}", "env.num_envs=1", f"algo.learning_starts={V2_LEARNING_STARTS}",
         f"algo.total_steps={total}", "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0",
         f"log_root={workdir}"], T + H, "V2 run")
    if summary["gradient_steps"] != V2_GRADIENT_STEPS or not summary["test_steps"]:
        raise AssertionError(f"V2 run: {summary['gradient_steps']} gradient steps, test {summary['test_steps']}")
    out = _v2_summary(summary, launches, wall)
    out["losses"] = [dict(zip(METRIC_NAMES, row)) for row in summary["metrics"]]
    log("V2 run: " + json.dumps({k: v for k, v in out.items() if k not in ("losses", "checkpoint")}))
    resumed, resume_launches, _ = _v2_run(
        [f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0", "algo.learning_starts=2",
         f"algo.total_steps={total + V2_RESUME_STEPS}", "checkpoint.save_last=false", "algo.run_test=false",
         f"log_root={_log_root(summary)}"], T + H, "V2 resume")
    out["resume"] = dict(_v2_resume_check("V2", summary, resumed), launches=resume_launches,
                         player_steps=resumed["player_steps"])
    log("V2 resume: " + json.dumps(out["resume"]))
    out["evaluation"] = _evaluation_check("V2", summary["checkpoint"], summary)
    log("V2 evaluation: " + json.dumps(out["evaluation"]))
    out["profile"] = _profile_v2_step(summary["checkpoint"])
    log("V2 gradient step profile: " + json.dumps(out["profile"]))
    return out


def v2_episode_phase(workdir: str) -> dict:
    """``run preset=dreamer_v2_ms_pacman_dummy`` on the card (the episode
    buffer with ``prioritize_ends``, the continue head, B 32 x T 50) on 1
    env: training waits for the first stored episode (seed 5's ends at step
    366), then V2_EPISODE_GRADIENT_STEPS steps with exact counts and a
    positive continue loss; a resume whose ``EpisodeBuffer`` is the saved
    one."""
    cfg = preset(V2_EPISODE_PRESET)
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    total = V2_EPISODE_LEARNING_STARTS + 16 * V2_EPISODE_GRADIENT_STEPS
    summary, launches, wall = _v2_run(
        [f"preset={V2_EPISODE_PRESET}", "env.num_envs=1", f"algo.learning_starts={V2_EPISODE_LEARNING_STARTS}",
         f"algo.total_steps={total}", "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0",
         "algo.run_test=false", f"log_root={workdir}"], T + H, "V2 episode run")
    continue_loss = [row[METRIC_NAMES.index("Loss/continue_loss")] for row in summary["metrics"]]
    if (summary["gradient_steps"] != V2_EPISODE_GRADIENT_STEPS or summary["buffer_type"] != "episode"
            or not all(c > 0 for c in continue_loss)):
        raise AssertionError(f"V2 episode run: {summary['gradient_steps']} steps on {summary['buffer_type']}, "
                             f"continue losses {continue_loss}")
    out = _v2_summary(summary, launches, wall)
    out["continue_loss"] = continue_loss
    log("V2 episode run: " + json.dumps({k: v for k, v in out.items() if k != "checkpoint"}))
    resumed, resume_launches, _ = _v2_run(
        [f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0", "algo.learning_starts=2",
         f"algo.total_steps={total + V2_EPISODE_RESUME_STEPS}", "checkpoint.save_last=false", "algo.run_test=false",
         f"log_root={_log_root(summary)}"], T + H, "V2 episode resume")
    out["resume"] = dict(_v2_resume_check("V2 episode", summary, resumed), launches=resume_launches,
                         episodes=resumed["restored_buffer"]["episodes"])
    log("V2 episode resume: " + json.dumps(out["resume"]))
    return out


def p2e_dv2_phase(workdir: str) -> dict:
    """``run preset=p2e_dv2_exploration_atari_dummy`` on the card (recurrent
    400, 10 ensemble members of 400 x 4, B 16 x T 50, H 15) on 1 env for
    V2_EXPLORE_GRADIENT_STEPS steps: T + 2H ``gru_gates_ln`` a step, exactly,
    the intrinsic reward positive, one step profiled with the ensembles'
    share; then ``run preset=p2e_dv2_finetuning_atari_dummy`` from its
    checkpoint with ``buffer.load_from_exploration=true`` (the player on the
    task actor from the first granted step, T + H a step); ``evaluation`` of
    both checkpoints equal to their runs' test episodes."""
    from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration import METRIC_NAMES as EXPLORE_NAMES

    cfg = preset(V2_EXPLORE_PRESET)
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    total = V2_LEARNING_STARTS + 5 * V2_EXPLORE_GRADIENT_STEPS
    summary, launches, wall = _v2_run(
        [f"preset={V2_EXPLORE_PRESET}", "env.num_envs=1", f"algo.learning_starts={V2_LEARNING_STARTS}",
         f"algo.total_steps={total}", "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0",
         f"log_root={workdir}"], T + 2 * H, "P2E-DV2 exploration run")
    intrinsic = [row[EXPLORE_NAMES.index("Rewards/intrinsic")] for row in summary["metrics"]]
    if summary["gradient_steps"] != V2_EXPLORE_GRADIENT_STEPS or not all(r > 0 for r in intrinsic):
        raise AssertionError(f"P2E-DV2 exploration: {summary['gradient_steps']} steps, intrinsic rewards {intrinsic}")
    out = {"exploration": _v2_summary(summary, launches, wall)}
    out["exploration"]["metrics"] = [dict(zip(EXPLORE_NAMES, row)) for row in summary["metrics"]]
    log("P2E-DV2 exploration run: " + json.dumps({k: v for k, v in out["exploration"].items()
                                                  if k not in ("metrics", "checkpoint")}))
    out["exploration"]["evaluation"] = _evaluation_check("P2E-DV2 exploration", summary["checkpoint"], summary)
    out["exploration"]["profile"] = _profile_v2_step(summary["checkpoint"], explore=True)
    log("P2E-DV2 exploration step profile: " + json.dumps(out["exploration"]["profile"]))
    fine, fine_launches, fine_wall = _v2_run(
        [f"preset={V2_FINETUNE_PRESET}", f"checkpoint.exploration_ckpt_path={summary['checkpoint']}",
         "buffer.load_from_exploration=true", "algo.learning_starts=8", f"algo.total_steps={V2_FINETUNE_TOTAL_STEPS}",
         "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0", f"log_root={workdir}"],
        T + H, "P2E-DV2 finetuning run")
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import buffer_digest

    first_grant = 8 + 5  # the fresh Ratio's first call at step 8 grants none, then one every 5
    if (fine["switched_at"] != first_grant or fine["player_steps"] != V2_FINETUNE_TOTAL_STEPS
            or fine["restored_buffer"] != buffer_digest(load_checkpoint(summary["checkpoint"])["rb"])):
        raise AssertionError(f"P2E-DV2 finetuning: switched at {fine['switched_at']}, {fine['player_steps']} player "
                             f"steps, restored {fine['restored_buffer']}")
    out["finetuning"] = _v2_summary(fine, fine_launches, fine_wall)
    out["finetuning"]["switched_at"] = fine["switched_at"]
    log("P2E-DV2 finetuning run: " + json.dumps({k: v for k, v in out["finetuning"].items() if k != "checkpoint"}))
    out["finetuning"]["evaluation"] = _evaluation_check("P2E-DV2 finetuning", fine["checkpoint"], fine)
    log("P2E-DV2 evaluations: " + json.dumps({k: out[k]["evaluation"] for k in ("exploration", "finetuning")}))
    return out


# -- 46-48. Dreamer V1 and Plan2Explore on Dreamer V1 -----------------------------

V1_PRESET = "dreamer_v1_atari_dummy"
V1_EXPLORE_PRESET = "p2e_dv1_exploration_atari_dummy"
V1_FINETUNE_PRESET = "p2e_dv1_finetuning_atari_dummy"
# cuts of scale for the V1 runs: 1 env, learning_starts 128 (past the 50-step
# window); the replay ratio of 0.1 grants a gradient step every 10 env steps
V1_LEARNING_STARTS, V1_GRADIENT_STEPS, V1_RESUME_STEPS = 128, 3, 20
V1_FINETUNE_LEARNING_STARTS, V1_FINETUNE_TOTAL_STEPS = 8, 40
# the step's learning rates (the recipe's Adam), for the parameter rule of _params_check
V1_LRS = {"world_model": 6e-4, "actor": 8e-5, "critic": 8e-5}


def _v1_step_card_and_cpu(cfg, T: int, B: int) -> dict:
    """One V1 gradient step on the CPU and on the card from the same seeded
    weights, batch and injected draws: per device its metrics, parameters,
    seconds and each optimizer's gradients; the card's modules, optimizers
    and train step for the profile; the card's launches."""
    from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as dv1
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as build_v1_agent
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_optimizers as make_v1_optimizers

    data = {k: v for k, v in _batch(np.random.default_rng(11), T, B, 18).items() if k != "is_first"}
    results = {}
    for dev in ("cpu", "cuda"):
        modules = build_v1_agent(cfg, dev)
        optimizers = make_v1_optimizers(cfg, *modules)
        if dev == "cpu":
            noise = dv1.draw_noise(cfg, T, B, modules[1], torch.Generator().manual_seed(12), "cpu")
        seen = {k: _capture_grads(opt) for k, opt in optimizers.items()}
        train = dv1.make_train_step(*modules, optimizers, cfg)
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = train({k: v.to(dev) for k, v in data.items()}, noise=[_to_device(noise, dev)]).cpu()
        seconds = time.perf_counter() - t0
        results[dev] = {"metrics": metrics[0], "seconds": seconds, "launches": dict(kernels.LAUNCHES),
                        "grads": {k: v["grads"] for k, v in seen.items()},
                        "params": {n: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                                   for n, m in zip(("world_model", "actor", "critic"), modules)},
                        "modules": modules, "optimizers": optimizers, "train": train, "data": data}
    return results


def _v1_adam_check(cfg, card: dict, cpu: dict) -> dict:
    """Each module after the step. Each device's own step: every element
    within 2 * lr + 1e-6 of the CPU's (Adam's first step moves an element by
    about lr times its gradient's sign, and the gradients of a 2,500-row
    step differ in float32 rounding; the share within 1e-6 is reported).
    Adam on the card's own gradients: the CPU's optimizer from the same
    seeded weights, handed the card's gradients, lands within PPO_ADAM_ATOL
    of the card's parameters."""
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as build_v1_agent
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_optimizers as make_v1_optimizers

    fresh = build_v1_agent(cfg, "cpu")
    optimizers = make_v1_optimizers(cfg, *fresh)
    out = {}
    for (name, lr), module, key in zip(V1_LRS.items(), fresh, ("world", "actor", "critic")):
        diffs = torch.cat([(card["params"][name][k] - cpu["params"][name][k]).abs().reshape(-1)
                           for k in cpu["params"][name]])
        optimizers[key].step([g.cpu() for g in card["grads"][key]])
        on_card_grads = _max_param_err(card["params"][name], {k: v.detach() for k, v in module.state_dict().items()})
        out[name] = {"max_abs_err": float(diffs.max()), "share_within_1e-6": float((diffs <= 1e-6).float().mean()),
                     "adam_on_card_grads_max_abs_err": on_card_grads}
        if out[name]["max_abs_err"] > 2 * lr + 1e-6 or on_card_grads > PPO_ADAM_ATOL:
            raise AssertionError(f"V1 {name} after the step on the card differs from the CPU: {out[name]}")
    return out


def _v1_gru_cost(world_model, T: int, B: int, H: int, imaginations: int, gen) -> dict:
    """The recurrent model's work in one V1 gradient step at its shapes,
    alone under ``torch.profiler`` (``Linear``, ELU and the flax-form GRU
    cell: V1's GRU has no kernel): T steps at B rows and ``imaginations``
    times H steps at T*B rows, forward and backward to the parameters and
    the inputs."""
    rm = world_model.recurrent_model
    rec, width = rm.rnn.hidden_size, rm.fc.in_features
    xs = [torch.randn((T, B, width), device="cuda", generator=gen, requires_grad=True)]
    xs += [torch.randn((H, T * B, width), device="cuda", generator=gen, requires_grad=True)
           for _ in range(imaginations)]
    params = list(rm.parameters())

    def work():
        total = 0.0
        for x in xs:
            h = torch.zeros((x.shape[1], rec), device="cuda")
            for t in range(x.shape[0]):
                h = rm(x[t], h)
                total = total + h.sum()
        return torch.autograd.grad(total, params + xs)

    work()
    torch.cuda.synchronize()
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    return {"device_ms": sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e3,
            "device_ops": sum(e.count for e in events)}


def _profile_v1(train, data: dict, world_model, H: int, imaginations: int, agent=None, optimizer=None) -> dict:
    """One full-recipe V1 (or P2E-DV1 exploration) gradient step after two
    warm-up steps: host ms, device ms and operations (``torch.profiler``),
    the convolutions' share, the recurrent model's share
    (:func:`_v1_gru_cost` over the step's device ms), the top kernels and,
    with ``agent``, the ensembles' share (:func:`_ensembles_cost`)."""
    T, B = data["actions"].shape[1:3]
    gen = torch.Generator(device="cuda").manual_seed(13)
    for _ in range(2):
        train(data, generator=gen)
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        train(data, generator=gen)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        train(data, generator=gen)
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    conv_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events
                  if any(w in e.key.lower() for w in ("conv", "wgrad", "dgrad", "fprop", "implicit")))
    gru = _v1_gru_cost(world_model, T, B, H, imaginations, gen)
    out = {
        "host_ms": float(np.median(host) * 1e3),
        "host_ms_all": [h * 1e3 for h in host],
        "device_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": device_us / 1e3 / (np.median(host) * 1e3) if device_us > 0 else None,
        "device_ops": sum(e.count for e in events),
        "convolution_share": conv_us / device_us if device_us > 0 else None,
        "recurrent_model": dict(gru, share=gru["device_ms"] * 1e3 / device_us if device_us > 0 else None),
        "top": [{"name": e.key[:80], "device_ms": getattr(e, "self_device_time_total", 0.0) / 1e3, "count": e.count}
                for e in sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]],
    }
    if agent is not None:
        ensembles = _ensembles_cost(agent, optimizer, T, B, H - 1, gen)  # V1 imagines H rows, no start row
        ensembles["share"] = ensembles["device_ms"] * 1e3 / device_us if device_us > 0 else None
        out["ensembles"] = ensembles
    return out


def v1_step_phase() -> dict:
    """One Dreamer V1 gradient step at the full recipe (B 50 x T 50, H 15;
    stochastic 30, recurrent 200, dense 400 x 4, CNN multiplier 32) on the
    card against the same step on the CPU, TF32 off, from the same seeded
    weights, batch and injected draws: the discrete actor learning by
    dynamics backpropagation through 15 imagined RSSM steps. The ten metrics
    within rtol 1e-4; each Adam's gradient within V2_GRAD_RTOL of its norm;
    the parameters after Adam as :func:`_v1_adam_check` holds them; no
    kernel launched. Then the step profiled on the card (host, device, operations,
    the convolutions' and the recurrent model's shares)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _v2_cfg(V1_PRESET)
    T, B, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), int(cfg.algo.horizon)
    results = _v1_step_card_and_cpu(cfg, T, B)
    card, cpu = results["cuda"], results["cpu"]
    _zero_launch_check("V1 step", card["launches"])
    if not torch.isfinite(card["metrics"]).all():
        raise AssertionError(f"V1 step: non-finite losses on the card: {card['metrics'].tolist()}")
    torch.testing.assert_close(card["metrics"], cpu["metrics"], rtol=1e-4, atol=1e-5)
    out = {"T": T, "B": B, "H": H, "cpu_s": cpu["seconds"], "cuda_s": card["seconds"], "launches": card["launches"],
           "loss_abs_err": dict(zip(METRIC_NAMES, (card["metrics"] - cpu["metrics"]).abs().tolist()))}
    for name in card["grads"]:
        err = _grad_rel_err(card["grads"][name], cpu["grads"][name])
        out[f"{name}_grad_rel_err"] = err
        if err > V2_GRAD_RTOL:
            raise AssertionError(f"V1 step: the {name} gradient on the card is {err} of its norm from the CPU's")
    out.update(_v1_adam_check(cfg, card, cpu))
    log("V1 step (card vs CPU): " + json.dumps(out))
    data = {k: v.cuda() for k, v in card["data"].items()}
    out["profile"] = _profile_v1(card["train"], data, card["modules"][0], H, 1)
    log("V1 gradient step profile: " + json.dumps(out["profile"]))
    return out


def _v1_run(args, name: str) -> tuple:
    """``cli.run(args)`` with the counts zeroed just before and read just
    after: no kernel on a V1 path; finite metrics, on the card."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run(args)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if summary["device"].split(":")[0] != "cuda" or not np.isfinite(np.asarray(summary["metrics"])).all():
        raise AssertionError(f"{name}: on {summary['device']}, metrics {summary['metrics'][:2]}")
    _zero_launch_check(name, launches)
    return summary, launches, wall


def _v1_evaluation_check(name: str, ckpt: str, summary: dict) -> dict:
    """``evaluation`` of a V1-family checkpoint on the card: the run's own
    test episode, and no kernel launched."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = cli.evaluation([f"checkpoint_path={ckpt}"])
    launches = dict(kernels.LAUNCHES)
    _zero_launch_check(f"{name} evaluation", launches)
    if (result["reward"], result["steps"]) != (summary["test_reward"], summary["test_steps"]):
        raise AssertionError(f"{name} evaluation {result} is not the run's test episode "
                             f"({summary['test_reward']}, {summary['test_steps']} steps)")
    return {"reward": result["reward"], "steps": result["steps"], "launches": launches,
            "steps_per_s": result["steps"] / (time.perf_counter() - t0)}


def v1_run_phase(workdir: str) -> dict:
    """``run preset=dreamer_v1_atari_dummy`` on the card at the recipe's
    widths (B 50 x T 50, H 15, the 100,000-row sequential buffer) on 1 env,
    ``learning_starts`` V1_LEARNING_STARTS and V1_GRADIENT_STEPS gradient
    steps, the player's epsilon exploration on, the greedy test episode, no
    kernel launched; a resume of V1_RESUME_STEPS steps from exactly the saved
    buffer; ``evaluation`` of the checkpoint equal to the run's test episode;
    a ``dry_run``."""
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DreamerV1Learner

    total = V1_LEARNING_STARTS + 10 * V1_GRADIENT_STEPS
    summary, launches, wall = _v1_run(
        [f"preset={V1_PRESET}", "env.num_envs=1", f"algo.learning_starts={V1_LEARNING_STARTS}",
         f"algo.total_steps={total}", "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0",
         f"log_root={workdir}"], "V1 run")
    expl = DreamerV1Learner.metric_names.index("Params/exploration_amount")
    if (summary["gradient_steps"] != V1_GRADIENT_STEPS or not summary["test_steps"]
            or any(row[expl] != 0.3 for row in summary["metrics"])):
        raise AssertionError(f"V1 run: {summary['gradient_steps']} gradient steps, test {summary['test_steps']}")
    out = _v2_summary(summary, launches, wall)
    out["losses"] = [dict(zip(DreamerV1Learner.metric_names, row)) for row in summary["metrics"]]
    log("V1 run: " + json.dumps({k: v for k, v in out.items() if k not in ("losses", "checkpoint")}))
    resumed, resume_launches, _ = _v1_run(
        [f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0", "algo.learning_starts=2",
         f"algo.total_steps={total + V1_RESUME_STEPS}", "checkpoint.save_last=false", "algo.run_test=false",
         f"log_root={_log_root(summary)}"], "V1 resume")
    out["resume"] = dict(_v2_resume_check("V1", summary, resumed), launches=resume_launches,
                         player_steps=resumed["player_steps"])
    log("V1 resume: " + json.dumps(out["resume"]))
    out["evaluation"] = _v1_evaluation_check("V1", summary["checkpoint"], summary)
    log("V1 evaluation: " + json.dumps(out["evaluation"]))
    dry, dry_launches, dry_wall = _v1_run(
        [f"preset={V1_PRESET}", "dry_run=true", "algo.per_rank_sequence_length=1", "algo.replay_ratio=0.25",
         "algo.total_steps=1000000",
         "algo.learning_starts=500000", "checkpoint.every=0", "metric.log_level=0", f"log_root={workdir}"],
        "V1 dry run")
    if (dry["policy_steps"], dry["gradient_steps"], dry["test_steps"]) != (4, 1, 1):
        raise AssertionError(f"V1 dry run: {dry['policy_steps']} steps, {dry['gradient_steps']} gradient steps")
    out["dry_run"] = {"policy_steps": dry["policy_steps"], "gradient_steps": dry["gradient_steps"],
                      "launches": dry_launches, "wall_s": dry_wall}
    log("V1 dry run: " + json.dumps(out["dry_run"]))
    return out


def p2e_dv1_phase(workdir: str) -> dict:
    """``run preset=p2e_dv1_exploration_atari_dummy`` on the card (stochastic
    60, recurrent 400, 10 ensemble members of 400 x 4, B 50 x T 50, H 15) on
    1 env for V1_GRADIENT_STEPS steps, the intrinsic reward positive, no
    kernel launched; one exploration step profiled with the ensembles' and
    the recurrent model's shares; then ``run
    preset=p2e_dv1_finetuning_atari_dummy`` from its checkpoint with
    ``buffer.load_from_exploration=true`` (the player on the task actor from
    the first granted step); ``evaluation`` of both checkpoints equal to
    their runs' test episodes."""
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import buffer_digest
    from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as p2e
    from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent as build_p2e_agent

    total = V1_LEARNING_STARTS + 10 * V1_GRADIENT_STEPS
    summary, launches, wall = _v1_run(
        [f"preset={V1_EXPLORE_PRESET}", "env.num_envs=1", f"algo.learning_starts={V1_LEARNING_STARTS}",
         f"algo.total_steps={total}", "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0",
         f"log_root={workdir}"], "P2E-DV1 exploration run")
    intrinsic = [row[summary["metric_names"].index("Rewards/intrinsic")] for row in summary["metrics"]]
    if summary["gradient_steps"] != V1_GRADIENT_STEPS or not all(r > 0 for r in intrinsic):
        raise AssertionError(f"P2E-DV1 exploration: {summary['gradient_steps']} steps, intrinsic rewards {intrinsic}")
    out = {"exploration": _v2_summary(summary, launches, wall)}
    out["exploration"]["metrics"] = [dict(zip(summary["metric_names"], row)) for row in summary["metrics"]]
    log("P2E-DV1 exploration run: " + json.dumps({k: v for k, v in out["exploration"].items()
                                                  if k not in ("metrics", "checkpoint")}))
    out["exploration"]["evaluation"] = _v1_evaluation_check("P2E-DV1 exploration", summary["checkpoint"], summary)

    cfg = load_config(find_run_config(summary["checkpoint"]))
    agent = build_p2e_agent(cfg, "cuda", load_checkpoint(summary["checkpoint"]))
    optimizers = p2e.make_optimizers(cfg, agent)
    T, B, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size), int(cfg.algo.horizon)
    data = {k: v.cuda() for k, v in _batch(np.random.default_rng(14), T, B, 18).items() if k != "is_first"}
    out["exploration"]["profile"] = _profile_v1(p2e.make_train_step(agent, optimizers, cfg), data,
                                                agent.world_model, H, 2, agent, optimizers["ensembles"])
    log("P2E-DV1 exploration step profile: " + json.dumps(out["exploration"]["profile"]))
    del agent, optimizers, data

    fine, fine_launches, fine_wall = _v1_run(
        [f"preset={V1_FINETUNE_PRESET}", f"checkpoint.exploration_ckpt_path={summary['checkpoint']}",
         "buffer.load_from_exploration=true", f"algo.learning_starts={V1_FINETUNE_LEARNING_STARTS}",
         f"algo.total_steps={V1_FINETUNE_TOTAL_STEPS}", "checkpoint.every=0", "checkpoint.save_last=true",
         "metric.log_level=0", f"log_root={workdir}"], "P2E-DV1 finetuning run")
    # the fresh Ratio's first call at step 8 grants none, then one every 10
    first_grant = V1_FINETUNE_LEARNING_STARTS + 10
    if (fine["switched_at"] != first_grant or fine["player_steps"] != V1_FINETUNE_TOTAL_STEPS
            or fine["restored_buffer"] != buffer_digest(load_checkpoint(summary["checkpoint"])["rb"])):
        raise AssertionError(f"P2E-DV1 finetuning: switched at {fine['switched_at']}, {fine['player_steps']} player "
                             f"steps, restored {fine['restored_buffer']}")
    out["finetuning"] = _v2_summary(fine, fine_launches, fine_wall)
    out["finetuning"]["switched_at"] = fine["switched_at"]
    log("P2E-DV1 finetuning run: " + json.dumps({k: v for k, v in out["finetuning"].items() if k != "checkpoint"}))
    out["finetuning"]["evaluation"] = _v1_evaluation_check("P2E-DV1 finetuning", fine["checkpoint"], fine)
    log("P2E-DV1 evaluations: " + json.dumps({k: out[k]["evaluation"] for k in ("exploration", "finetuning")}))
    return out


# -- 49-51. Anakin: the single run and the population on the card's own envs --


@contextlib.contextmanager
def _host_reads(counts: list, where: Optional[list] = None):
    """Counts the synchronizing CUDA calls (each a read of the card by the
    host) of the ``dispatch_block`` calls made inside, one count per block:
    ``torch.cuda.set_sync_debug_mode("warn")`` warns at each one. ``where``
    collects each block's warnings' source lines."""
    real = ppo_anakin.dispatch_block

    def counted(block, *args, **kwargs):
        previous = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = real(block, *args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(previous)
        syncs = [w for w in caught if "called a synchronizing cuda operation" in str(w.message).lower()]
        counts.append(len(syncs))
        if where is not None:
            where.append([f"{Path(w.filename).name}:{w.lineno}: {w.message}" for w in syncs])
        return out

    ppo_anakin.dispatch_block = counted
    ppo_anakin_population.dispatch_block = counted
    try:
        yield counts
    finally:
        ppo_anakin.dispatch_block = real
        ppo_anakin_population.dispatch_block = real


def _anakin_checks(name: str, summary: dict, launches: dict, reads: list, iterations: int) -> None:
    """``gae`` exactly once per iteration, no other kernel; one host read per
    block; every loss finite."""
    want = dict({k: 0 for k in kernels.LAUNCHES}, gae=iterations)
    if summary["iterations"] != iterations or launches != want:
        raise AssertionError(f"{name}: {summary['iterations']} iterations, launches {launches} != {want}")
    if reads != [1] * summary["blocks"]:
        raise AssertionError(f"{name}: host reads per block {reads}, want one in each of {summary['blocks']} blocks")
    if not np.isfinite(np.asarray(summary["losses"])).all():
        raise AssertionError(f"{name}: non-finite losses {summary['losses']}")
    if summary["device"].split(":")[0] != "cuda":
        raise AssertionError(f"{name} ran on {summary['device']}")


def _cuda_draws(draws: dict, device) -> dict:
    return {k: [u.to(device) for u in v] if isinstance(v, list) else v.to(device) for k, v in draws.items()}


def anakin_iteration_phase() -> dict:
    """One full-recipe Anakin iteration (4 envs x 128 steps of CartPole, GAE,
    10 epochs x 8 minibatches, guarded) on the card against the same
    iteration on the CPU, TF32 off: the same seeded weights, env reset and
    injected draws (action uniforms, reset uniforms, permutations drawn on
    the CPU). Held: every episode's end, return and length exactly (the same
    actions were drawn); the last observations within 1e-4; the losses
    within rtol 1e-4; the parameters after the 80 Adam steps within 2e-4 and
    at least 99 % of them within 1e-5, as the PPO update phase (9) holds a
    PPO update."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset(ANAKIN_PRESET)
    env, obs_key = ppo_anakin.anakin_env(cfg)
    N, T, epochs = int(cfg.env.num_envs), int(cfg.algo.rollout_steps), int(cfg.algo.update_epochs)
    spaces = env.spaces(obs_key)["obs"]
    template, _ = build_ppo_agent(cfg, (2,), False, spaces, "cpu")
    draws = ppo_anakin.draw_iteration(env, template, (N,), T, (epochs,), N * T, torch.Generator().manual_seed(21),
                                      torch.Generator().manual_seed(22), "cpu")
    start = torch.rand((N, 4), generator=torch.Generator().manual_seed(23))
    results = {}
    for dev in ("cpu", "cuda"):
        agent, _ = build_ppo_agent(cfg, (2,), False, spaces, dev)
        optimizer = make_ppo_optimizer(cfg, agent)
        optimizer.set_lr(float(np.float32(cfg.algo.optimizer.lr)))
        benv = BatchedDeviceEnv(env, N)
        params = env.default_params(dev)
        state, obs = benv.reset(params, noise=start.to(dev))
        carry = ppo_anakin.AnakinCarry(state, obs, torch.zeros(N, device=dev),
                                       torch.zeros(N, dtype=torch.int32, device=dev))
        block = ppo_anakin.make_anakin_block(agent, optimizer, cfg, benv, obs_key, guard=True)
        coefs = torch.tensor([float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)]).to(dev)
        t0 = time.perf_counter()
        carry, metrics = ppo_anakin.dispatch_block(block, carry, 1, params, coefs[0], coefs[1],
                                                   draws=[_cuda_draws(draws, dev)])
        results[dev] = (metrics, {k: v.detach().cpu() for k, v in agent.state_dict().items()}, carry.obs.cpu(),
                        time.perf_counter() - t0)
    (m_cpu, p_cpu, o_cpu, s_cpu), (m_card, p_card, o_card, s_card) = results["cpu"], results["cuda"]
    for k in ("ep_done", "ep_ret", "ep_len"):
        if not np.array_equal(m_card[k], m_cpu[k]):
            raise AssertionError(f"Anakin iteration: the card's {k} differs from the CPU's")
    diffs = torch.cat([(p_card[k] - p_cpu[k]).abs().reshape(-1) for k in p_cpu])
    row = {
        "episodes": int(m_cpu["ep_done"].sum()),
        "obs_max_abs_err": float((o_card - o_cpu).abs().max()),
        "losses_cpu": {k: float(m_cpu[k][0]) for k in ("pg", "v", "ent")},
        "loss_rel_err": {k: float(abs(m_card[k][0] - m_cpu[k][0]) / max(abs(m_cpu[k][0]), 1e-12))
                         for k in ("pg", "v", "ent")},
        "skipped": float(m_card["bad"][0]),
        "param_max_abs_err": float(diffs.max()),
        "param_share_within_1e-5": float((diffs <= 1e-5).float().mean()),
        "cpu_s": s_cpu, "cuda_s": s_card,
    }
    log("Anakin iteration (card vs CPU): " + json.dumps(row))
    if row["obs_max_abs_err"] > 1e-4 or row["skipped"] != 0:
        raise AssertionError(f"Anakin iteration: {row}")
    for k in ("pg", "v", "ent"):
        if abs(m_card[k][0] - m_cpu[k][0]) > 1e-4 * abs(m_cpu[k][0]) + 1e-6:
            raise AssertionError(f"Anakin iteration: loss {k} {m_card[k][0]} on the card, {m_cpu[k][0]} on the CPU")
    if row["param_max_abs_err"] > 2e-4 or row["param_share_within_1e-5"] < 0.99:
        raise AssertionError(f"Anakin iteration: parameters after the update differ: {row}")
    return row


def _profile_anakin_iteration(checkpoint: str) -> dict:
    """One iteration of the single run (a block of one, with its read) from
    the run's checkpoint, after one warm-up block: host ms of one, then the
    device ms and operations of another under ``torch.profiler``, and the
    profile's device-to-host copies and stream or device synchronisations
    (the host's reads)."""
    cfg = load_config(find_run_config(checkpoint))
    state = load_checkpoint(checkpoint)
    env, obs_key = ppo_anakin.anakin_env(cfg)
    agent, _ = build_ppo_agent(cfg, (2,), False, cfg.spaces.obs, "cuda", state["agent"])
    optimizer = make_ppo_optimizer(cfg, agent)
    optimizer.load_state_dict(state["optimizer"])
    N = int(cfg.env.num_envs)
    benv = BatchedDeviceEnv(env, N)
    params = env.default_params("cuda")
    gens = [torch.Generator(device="cuda").manual_seed(s) for s in (31, 32, 33)]
    env_state, obs = benv.reset(params, generator=gens[2])
    carry = [ppo_anakin.AnakinCarry(env_state, obs, torch.zeros(N, device="cuda"),
                                    torch.zeros(N, dtype=torch.int32, device="cuda"))]
    block = ppo_anakin.make_anakin_block(agent, optimizer, cfg, benv, obs_key, guard=True)
    coefs = torch.tensor([float(cfg.algo.clip_coef), float(cfg.algo.ent_coef)]).to("cuda")

    def one():
        carry[0], _ = ppo_anakin.dispatch_block(block, carry[0], 1, params, coefs[0], coefs[1],
                                                rollout_gen=gens[0], train_gen=gens[1])

    one()  # warm-up
    t0 = time.perf_counter()
    one()
    host = [time.perf_counter() - t0]
    # the card's activity alone (its kernels, copies and runtime calls): the ~30,000 operations' host-side
    # records would take the profiler longer to process than the iteration takes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        one()
    averages = prof.key_averages()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
    counts = {e.key: e.count for e in averages}
    return {
        "host_ms": float(np.median(host) * 1e3),
        "host_ms_all": [h * 1e3 for h in host],
        "device_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": device_us / 1e3 / (np.median(host) * 1e3) if device_us > 0 else None,
        "device_ops": sum(e.count for e in events),
        "top": [{"name": e.key[:80], "device_ms": getattr(e, "self_device_time_total", 0.0) / 1e3, "count": e.count}
                for e in top],
        # the block's one read: a device-to-host copy and its stream's synchronisation (the profiler's own
        # start and stop add a device synchronisation)
        "dtoh_copies": sum(c for k, c in counts.items() if "dtoh" in k.lower().replace(" ", "")),
        "stream_synchronizations": counts.get("cudaStreamSynchronize", 0),
        "device_synchronizations": counts.get("cudaDeviceSynchronize", 0),
    }


def anakin_run_phase(workdir: str) -> dict:
    """``run preset=ppo_anakin`` (CartPole-v1, 4 envs x 128 steps, the JAX
    recipe's widths; 9-iteration blocks from its 5,000-step logs) for the
    recipe's ANAKIN_ITERATIONS iterations: ``gae`` exactly once per
    iteration and no other kernel; one host read of the card per block (the
    block's metrics), counted; the last PPO_LAST_EPISODES episodes' mean
    return at least PPO_RETURN_BAR at the end (and reported at ANAKIN_HALF
    iterations); env steps/s and host ms per block; one iteration profiled;
    then a resume of one iteration with the same checks."""
    reads: list = []
    where: list = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    steps = ANAKIN_ITERATIONS * 4 * 128
    with _host_reads(reads, where):
        summary = cli.run([f"preset={ANAKIN_PRESET}", f"algo.total_steps={steps}", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if reads != [1] * len(reads):
        log(f"Anakin run: synchronising calls by block: {json.dumps(where)}")
    _anakin_checks("Anakin run", summary, launches, reads, ANAKIN_ITERATIONS)
    returns = [ret for _, _, ret, _ in summary["episodes"]]
    last = float(np.mean(returns[-PPO_LAST_EPISODES:]))
    if len(returns) < PPO_LAST_EPISODES or last < PPO_RETURN_BAR:
        raise AssertionError(f"Anakin did not learn CartPole: mean return of the last {PPO_LAST_EPISODES} "
                             f"episodes {last}")
    block_ms = [b * 1e3 for b in summary["block_s"]]
    out = {
        "iterations": summary["iterations"], "blocks": summary["blocks"], "iters_per_block": summary["iters_per_block"],
        "policy_steps": summary["policy_steps"], "launches": launches, "host_reads_per_block": reads, "wall_s": wall,
        "env_steps_per_s": summary["env_steps_per_s"],
        "host_ms_per_block": {"median": float(np.median(block_ms)), "range": [min(block_ms), max(block_ms)],
                              "per_iteration_median": float(np.median(
                                  [b / n for b, n in zip(block_ms, [summary["iters_per_block"]] * len(block_ms))]))},
        "episodes": len(returns), "first_10_mean_return": float(np.mean(returns[:10])), "last_10_mean_return": last,
        "last_10_mean_return_at_half": float(np.mean(
            [ret for step, _, ret, _ in summary["episodes"] if step <= ANAKIN_HALF * 512][-PPO_LAST_EPISODES:])),
        "test_reward": summary["test_reward"], "checkpoint": summary["checkpoint"],
        "losses_last": dict(zip(PPO_LOSS_NAMES, summary["losses"][-1])),
    }
    log("Anakin run: " + json.dumps({k: v for k, v in out.items() if k != "checkpoint"}))
    out["profile"] = _profile_anakin_iteration(summary["checkpoint"])
    log("Anakin iteration profile: " + json.dumps(out["profile"]))

    reads = []
    kernels.reset_launches()
    with _host_reads(reads):
        resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", f"algo.total_steps={steps + 512}",
                           "algo.run_test=false", f"log_root={workdir}"])
    resume_launches = dict(kernels.LAUNCHES)
    if resumed["start_iter"] != ANAKIN_ITERATIONS + 1:
        raise AssertionError(f"Anakin resume started at iteration {resumed['start_iter']}")
    _anakin_checks("Anakin resume", resumed, resume_launches, reads, 1)
    out["resume"] = {"start_iter": resumed["start_iter"], "launches": resume_launches, "host_reads_per_block": reads,
                     "losses": resumed["losses"]}
    log("Anakin resume: " + json.dumps(out["resume"]))
    return out


def population_run_phase(workdir: str) -> dict:
    """``run preset=ppo_anakin_population`` with POPULATION_SIZE members
    (an lr grid) and PBT on, cut to POPULATION_ITERATIONS iterations: ``gae``
    exactly once per iteration (the per-member entry, all members in one
    launch), one host read per block, a PBT step per block; a resume of one
    iteration; ``evaluation`` of the checkpoint equal to the run's test
    episode of its best member; then a population of one against the single
    run, two iterations each: the checkpoints' parameters bit-equal."""
    reads: list = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    steps = POPULATION_ITERATIONS * 4 * 128
    common = [f"algo.total_steps={steps}", f"log_root={workdir}"]
    with _host_reads(reads):
        summary = cli.run(["preset=ppo_anakin_population", f"algo.population.size={POPULATION_SIZE}",
                           "algo.population.hparams={lr: [0.0005, 0.001, 0.002, 0.003]}",
                           "algo.population.pbt.enabled=true", *common])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _anakin_checks("population run", summary, launches, reads, POPULATION_ITERATIONS)
    if summary["pbt_steps"] != summary["blocks"] or summary["population_size"] != POPULATION_SIZE:
        raise AssertionError(f"population run: {summary['pbt_steps']} PBT steps in {summary['blocks']} blocks")
    if not np.isfinite(np.asarray(summary["fitness"])).all():
        raise AssertionError(f"population fitness {summary['fitness']}")
    block_ms = [b * 1e3 for b in summary["block_s"]]
    out = {
        "iterations": summary["iterations"], "blocks": summary["blocks"], "members": POPULATION_SIZE,
        "launches": launches, "host_reads_per_block": reads, "wall_s": wall, "pbt_steps": summary["pbt_steps"],
        "env_steps_per_s": summary["env_steps_per_s"],
        "env_steps_per_s_all_members": summary["env_steps_per_s"] * POPULATION_SIZE,
        "host_ms_per_block": {"median": float(np.median(block_ms)), "range": [min(block_ms), max(block_ms)]},
        "fitness_last": summary["fitness"][-1], "best_member": summary["best_member"], "hparams": summary["hparams"],
        "test_reward": summary["test_reward"], "checkpoint": summary["checkpoint"],
    }
    log("population run: " + json.dumps({k: v for k, v in out.items() if k != "checkpoint"}))

    reads = []
    kernels.reset_launches()
    with _host_reads(reads):
        resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", f"algo.total_steps={steps + 512}",
                           "algo.run_test=false", f"log_root={workdir}"])
    resume_launches = dict(kernels.LAUNCHES)
    if resumed["start_iter"] != POPULATION_ITERATIONS + 1 or resumed["population_size"] != POPULATION_SIZE:
        raise AssertionError(f"population resume: start {resumed['start_iter']}, {resumed['population_size']} members")
    _anakin_checks("population resume", resumed, resume_launches, reads, 1)
    out["resume"] = {"start_iter": resumed["start_iter"], "launches": resume_launches, "host_reads_per_block": reads}

    kernels.reset_launches()
    evaluated = cli.evaluation([f"checkpoint_path={summary['checkpoint']}"])
    eval_launches = dict(kernels.LAUNCHES)
    if evaluated["reward"] != summary["test_reward"] or any(eval_launches.values()):
        raise AssertionError(f"population evaluation {evaluated} (launches {eval_launches}) is not the best "
                             f"member's test episode ({summary['test_reward']})")
    out["evaluation"] = {"reward": evaluated["reward"], "steps": evaluated["steps"], "launches": eval_launches}

    one = ["metric.log_level=0", "algo.run_test=false", "algo.total_steps=1024", "algo.iters_per_block=1",
           f"log_root={workdir}/one"]
    kernels.reset_launches()
    single = cli.run([f"preset={ANAKIN_PRESET}", *one])
    single_launches = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    member = cli.run(["preset=ppo_anakin_population", "algo.population.size=1", "algo.population.hparams={}", *one])
    member_launches = dict(kernels.LAUNCHES)
    a, b = load_checkpoint(single["checkpoint"]), load_checkpoint(member["checkpoint"])
    equal = all(torch.equal(b["agent"][k][0], v) for k, v in a["agent"].items())
    if not equal or single["losses"] != member["losses"] or single_launches != member_launches:
        raise AssertionError(f"a population of one differs from the single run on the card: {single['losses']} "
                             f"vs {member['losses']}, launches {single_launches} vs {member_launches}")
    out["one_member"] = {"bit_equal": equal, "iterations": single["iterations"], "launches_single": single_launches,
                         "launches_population": member_launches}
    log("population resume, evaluation, one member: " + json.dumps(
        {k: out[k] for k in ("resume", "evaluation", "one_member")}))
    return out


# -- 53-57. the async topologies: the pipeline on the card, Sebulba and decoupled PPO and SAC ------------

SEBULBA_PPO_PRESET, DECOUPLED_PPO_PRESET = "ppo_sebulba", "ppo_decoupled"
SEBULBA_SAC_PRESET, DECOUPLED_SAC_PRESET = "sac_sebulba_per", "sac_decoupled"
# the Sebulba PPO run takes the sync PPO run's depth (never cut below it);
# its learning bar (PERF.md): the port's CPU runs of the preset read a last-10 mean of 219.6-310.5
# at 64 iterations (seeds 1, 7, 42), every item 4 versions stale (the queue
# of 2 and 2 actors); a random policy reads ~22, a pipeline that raced its
# snapshots or slabs would train on garbage
SEBULBA_PPO_ITERATIONS, SEBULBA_PPO_RETURN_BAR = PPO_ITERATIONS, 150.0
SEBULBA_PROFILED_ITEMS = 3  # a short run under torch.profiler (the card's kernels only) for its busy share
DECOUPLED_PPO_ITERATIONS = 8
# the Sebulba SAC-PER run: 2,048 steps of 4 envs x 2 actors in blocks of 8
# (32 granted steps a dispatch), a save at 1,024 and a resume of 256 steps
SEBULBA_SAC_STEPS, SEBULBA_SAC_RESUME_STEPS, SEBULBA_SAC_SAVE_EVERY = 2048, 256, 1024
DECOUPLED_SAC_STEPS, DECOUPLED_SAC_RESUME_STEPS = 1024, 256
# the append-free dispatch card against CPU: a written priority's gap in |TD| units
# (a Pendulum Q of up to 16 / (1 - 0.99) = 1,600 has a float32 ulp of 1.2e-4: 8 ulps), and
# the tree's internal nodes, sums of such leaves, relative (an H100 read 3.4e-4 relative
# on a leaf of a 2,048-step critic's tree against the CPU)
SAC_TD_ATOL, SAC_NODE_RTOL = 1e-3, 2e-3
SNAPSHOT_ADAM_STEPS = 12  # in-place Adam steps on the learner's stream while an actor reads the snapshot
STAGER_SLAB_FLOATS = 16 << 20  # a 64 MiB slab: its upload is long enough to be in flight when the ring comes round
SLEEP_CYCLES = int(0.2 * SM_CLOCK_HZ)  # ~200 ms of one spinning kernel on the learner's stream


def _async_launch_check(name: str, launches: dict, **want_counts) -> None:
    want = dict({k: 0 for k in kernels.LAUNCHES}, **want_counts)
    if launches != want:
        raise AssertionError(f"{name} launches {launches} != {want}")


def _streams_check(name: str, streams: dict, actors_key: str = "actors", learner_key: str = "learner") -> None:
    """The actors (or the player) worked on streams of their own: none is the
    learner's, none the legacy default stream (handle 0)."""
    actors = streams[actors_key] if isinstance(streams[actors_key], list) else [streams[actors_key]]
    if not actors or 0 in actors or streams[learner_key] in actors:
        raise AssertionError(f"{name}: actor streams {actors} against the learner's {streams[learner_key]}")


def _snapshot_isolation() -> dict:
    """Publish the CartPole agent (recipe widths), then SNAPSHOT_ADAM_STEPS
    in-place Adam steps on the learner's (the default) stream while an actor
    thread on its own stream reads the snapshot: the snapshot stays bit-equal
    to the published parameters, every actor forward equals the published
    parameters' forward, and the live parameters moved."""
    from sheeprl_tpu_torch.parallel.pipeline import ParamServer, side_stream

    cfg = _ppo_cfg(False)
    agent, _ = build_ppo_agent(cfg, (2,), False, {"state": {"shape": [4]}}, "cuda")
    optimizer = make_ppo_optimizer(cfg, agent)
    gen = torch.Generator(device="cuda").manual_seed(53)
    obs = {"state": torch.randn(512, 4, generator=gen, device="cuda")}
    server = ParamServer(agent)
    server.publish()
    published = {k: v.detach().clone() for k, v in agent.state_dict().items()}
    torch.cuda.synchronize()
    done, reads, errors = threading.Event(), [], []

    def actor():
        try:
            _, ctx = side_stream("cuda")
            with ctx, torch.no_grad():
                version, snap = server.pull()
                try:
                    while (not done.is_set() or len(reads) < 8) and len(reads) < 4096:
                        reads.append(snap(obs)[1].clone())
                finally:
                    server.release(version)
                torch.cuda.current_stream().synchronize()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    thread = threading.Thread(target=actor, name="snapshot-reader", daemon=True)
    thread.start()
    params = list(agent.parameters())
    try:
        for _ in range(SNAPSHOT_ADAM_STEPS):
            actor_outs, values = agent(obs)
            loss = values.square().mean() + sum(o.square().mean() for o in actor_outs)
            optimizer.step(torch.autograd.grad(loss, params))
    finally:
        done.set()
        thread.join(timeout=120)
    if thread.is_alive() or errors:
        raise AssertionError(f"the snapshot reader did not end cleanly: {errors}")
    torch.cuda.synchronize()
    ref, _ = build_ppo_agent(cfg, (2,), False, {"state": {"shape": [4]}}, "cuda", published)
    with torch.no_grad():
        want = ref(obs)[1]
    version, snap = server.pull()
    snap_equal = all(torch.equal(v, published[k]) for k, v in snap.state_dict().items())
    server.release(version)
    moved = max(float((v - published[k]).abs().max()) for k, v in agent.state_dict().items())
    reads_equal = all(torch.equal(r, want) for r in reads)
    out = {"adam_steps": SNAPSHOT_ADAM_STEPS, "actor_reads": len(reads), "snapshot_bit_equal": snap_equal,
           "reads_bit_equal": reads_equal, "live_max_move": moved}
    if not (snap_equal and reads_equal and moved > 0):
        raise AssertionError(f"snapshot isolation on the card: {out}")
    return out


def _stager_on_card() -> dict:
    """A ring of 2 slabs of 64 MiB on an actor stream, both filled, then
    uploaded back to back, then slab 0 acquired again at once. The refill
    waits for slab 0's copy (its event done when acquire returns; in flight
    when asked), and the learner, after the item's event, reads slab 0's
    first contents bit for bit although the host slab was overwritten."""
    from sheeprl_tpu_torch.parallel.pipeline import DoubleBufferedStager, StagedItem, side_stream

    stager = DoubleBufferedStager("cuda", slots=2)
    template = {"x": ((STAGER_SLAB_FLOATS,), np.float32)}
    first = np.arange(STAGER_SLAB_FLOATS, dtype=np.float32)
    _, ctx = side_stream("cuda")
    with ctx:
        # the actor stream's cached blocks for both copies: a fresh cudaMalloc
        # between the two uploads would wait for the first
        warm = [torch.empty(STAGER_SLAB_FLOATS, device="cuda") for _ in range(2)]
        del warm
        slab0, slab1 = stager.acquire(template), stager.acquire(template)
        slab0["x"][:] = first
        slab1["x"][:] = -1.0
        t0 = time.perf_counter()
        item0 = StagedItem.record(stager.upload(slab0))
        event0 = slab0.event
        item1 = StagedItem.record(stager.upload(slab1))
        in_flight = not event0.query()
        again = stager.acquire(template)  # slab 0: must wait for its copy
        waited = time.perf_counter() - t0
        done_at_refill = event0.query()
        again["x"][:] = 7.0  # overwrite the host slab, as the next rollout would
    data0, data1 = item0.wait(), item1.wait()  # the learner's stream
    equal0 = torch.equal(data0["x"].cpu(), torch.from_numpy(first))
    equal1 = bool((data1["x"] == -1.0).all())
    out = {"slab_mib": STAGER_SLAB_FLOATS * 4 / 2**20, "first_copy_in_flight_at_refill_request": in_flight,
           "first_copy_done_at_refill": done_at_refill, "refill_wait_ms": waited * 1e3,
           "item0_bit_equal": equal0, "item1_bit_equal": equal1, "same_slab": again is slab0}
    if not (done_at_refill and equal0 and equal1 and again is slab0):
        raise AssertionError(f"stager on the card: {out}")
    return out


def _gae_first_use() -> dict:
    """Two threads, each on its own stream, call ``gae`` at once on a fresh
    build directory: one nvcc (``_build._LOCK``), both results bit-equal to
    the plain version."""
    from sheeprl_tpu_torch.parallel.pipeline import side_stream

    gen = torch.Generator(device="cuda").manual_seed(54)
    inputs = _gae_inputs(gen, 128, 4, (1,), torch.float32, torch.uint8)
    want = kernels.gae_reference(*inputs, 0.99, 0.95)
    torch.cuda.synchronize()
    saved_dir, saved_lib = _build.BUILD_DIR, _build._LOADED.pop("gae", None)
    before = _build.BUILD_COUNTS.get("gae", 0)
    barrier, results, errors = threading.Barrier(2, timeout=120), {}, []

    def worker(i):
        try:
            _, ctx = side_stream("cuda")
            with ctx:
                barrier.wait()
                r, a = kernels.gae(*inputs, 0.99, 0.95)
                torch.cuda.current_stream().synchronize()
                results[i] = (r, a)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        with tempfile.TemporaryDirectory() as fresh:
            _build.BUILD_DIR = Path(fresh)
            t0 = time.perf_counter()
            threads = [threading.Thread(target=worker, args=(i,), name=f"first-use-{i}", daemon=True) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            seconds = time.perf_counter() - t0
            built = sorted(p.name for p in Path(fresh).glob("gae-*.so"))
    finally:
        _build.BUILD_DIR = saved_dir
        if saved_lib is not None:
            _build._LOADED["gae"] = saved_lib
    builds = _build.BUILD_COUNTS.get("gae", 0) - before
    equal = [torch.equal(results[i][0], want[0]) and torch.equal(results[i][1], want[1]) for i in sorted(results)]
    out = {"builds": builds, "libraries": built, "results_bit_equal": equal, "seconds": seconds}
    if errors or builds != 1 or len(built) != 1 or equal != [True, True]:
        raise AssertionError(f"gae's concurrent first use: {out}, errors {errors}")
    return out


def _streams_overlap() -> dict:
    """A ~200 ms spinning kernel on the learner's (the default) stream, then
    ``gae`` on an actor stream: the actor's work ends while the learner's
    kernel still runs. A stream that synchronised with the legacy default
    stream would have waited for it."""
    from sheeprl_tpu_torch.parallel.pipeline import side_stream

    gen = torch.Generator(device="cuda").manual_seed(55)
    inputs = _gae_inputs(gen, 128, 4, (1,), torch.float32, torch.uint8)
    kernels.gae(*inputs, 0.99, 0.95)
    torch.cuda.synchronize()
    learner_done = torch.cuda.Event()
    t0 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES)
    learner_done.record()
    stream, ctx = side_stream("cuda")
    with ctx:
        kernels.gae(*inputs, 0.99, 0.95)
        actor_done = torch.cuda.Event()
        actor_done.record()
    actor_done.synchronize()
    actor_ms = (time.perf_counter() - t0) * 1e3
    learner_busy = not learner_done.query()
    learner_done.synchronize()
    learner_ms = (time.perf_counter() - t0) * 1e3
    out = {"actor_stream": int(stream.cuda_stream), "learner_stream": int(torch.cuda.current_stream().cuda_stream),
           "actor_done_ms": actor_ms, "learner_done_ms": learner_ms, "learner_still_busy": learner_busy}
    if not learner_busy or actor_ms > learner_ms / 2:
        raise AssertionError(f"the actor stream waited for the learner's: {out}")
    return out


def pipeline_card_phase() -> dict:
    """The pipeline's card-side guarantees (53): snapshot isolation under
    in-place Adam, the stager's event-gated ring, ``gae``'s concurrent first
    use, and an actor stream that does not queue behind the learner's. The
    ``gae`` launches here are checks, not a path's."""
    out = {"snapshot": _snapshot_isolation(), "stager": _stager_on_card(), "gae_first_use": _gae_first_use(),
           "overlap": _streams_overlap()}
    log("pipeline on the card: " + json.dumps(out))
    return out


def _device_busy(prof, wall_s: float) -> dict:
    """Device time of a profiled window: the union of every kernel's
    interval over the window's wall time, and kernels by stream."""
    events = [e for e in prof.events() if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_stream = {}
    for e in events:
        key = str(getattr(e, "device_resource_id", "?"))
        count, us = by_stream.get(key, (0, 0.0))
        by_stream[key] = (count + 1, us + e.time_range.end - e.time_range.start)
    return {"kernels": len(events), "device_busy_ms": busy / 1e3 if events else None,
            "device_busy_share": busy / 1e6 / wall_s if events else None,
            "by_stream": {k: {"kernels": n, "device_ms": us / 1e3} for k, (n, us) in by_stream.items()}}


def _profile_actor_step(checkpoint: str, steps: int = 50) -> dict:
    """One Sebulba PPO actor step (4 envs of CartPole): observations up,
    the act program, actions down, on an actor stream from the run's
    checkpoint: host ms per step, device ms of the act program (CUDA
    events), operations (``torch.profiler``)."""
    from sheeprl_tpu_torch.algos.ppo.ppo_sebulba import draw_act_noise, make_act_step
    from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs
    from sheeprl_tpu_torch.parallel.pipeline import side_stream

    cfg = load_config(find_run_config(checkpoint))
    agent, _ = build_ppo_agent(cfg, (2,), False, cfg.spaces.obs, "cuda", load_checkpoint(checkpoint)["agent"])
    agent.requires_grad_(False)
    act = make_act_step(False)
    rng = np.random.default_rng(56)
    obs = [{"state": rng.uniform(-0.05, 0.05, (4, 4)).astype(np.float32)} for _ in range(steps)]
    _, ctx = side_stream("cuda")
    with ctx, torch.no_grad():
        noise = draw_act_noise(torch.Generator(device="cuda").manual_seed(57), steps, 4, (2,), False, "cuda")

        def step(t):
            return act(agent, prepare_obs(obs[t], [], 4, "cuda"), [n[t] for n in noise]).cpu()

        for t in range(5):
            step(t)
        host, device = [], []
        for t in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            prepared = prepare_obs(obs[t], [], 4, "cuda")
            start.record()
            actions = act(agent, prepared, [n[t] for n in noise])
            end.record()
            actions.cpu()
            host.append(time.perf_counter() - t0)
            device.append(start.elapsed_time(end))
        acts = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            step(0)
    events = _device_kernels(prof)
    return {"host_ms": float(np.median(host) * 1e3), "host_ms_range": [min(host) * 1e3, max(host) * 1e3],
            "device_ms_events": float(np.median(device)),
            "device_ms_profiler": sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e3 or None,
            "device_ops": sum(e.count for e in events)}


def ppo_sebulba_run_phase(workdir: str) -> dict:
    """``run preset=ppo_sebulba`` (54) on CartPole-v1 at the recipe (2 actors
    x 4 envs x 128 steps an item, queue 2, publish every update) for
    SEBULBA_PPO_ITERATIONS items: ``gae`` launched exactly once per item
    trained on or in flight at the stop, no other kernel; the staleness
    within its bound; every loss finite; the last-10 mean return at least
    SEBULBA_PPO_RETURN_BAR; the actors on streams of their own. Then a
    resume for one more item, ``evaluation`` of the checkpoint, one update
    and one actor step profiled, and a short run under ``torch.profiler`` for
    the card's busy share."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    steps = SEBULBA_PPO_ITERATIONS * 512
    summary = cli.run([f"preset={SEBULBA_PPO_PRESET}", f"algo.total_steps={steps}", "metric.log_level=0",
                       f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    pipe, iters = summary["pipeline"], summary["iterations"]
    if iters != SEBULBA_PPO_ITERATIONS or summary["device"].split(":")[0] != "cuda" or summary["policy_steps"] != steps:
        raise AssertionError(f"Sebulba PPO: {iters} items, {summary['policy_steps']} steps on {summary['device']}")
    _async_launch_check("Sebulba PPO", launches, gae=iters + summary["items_in_flight_at_shutdown"])
    if pipe["staleness_max"] > pipe["staleness_bound"]:
        raise AssertionError(f"Sebulba PPO staleness {pipe['staleness_max']} past its bound {pipe['staleness_bound']}")
    if not np.isfinite(np.asarray(summary["losses"])).all() or len(summary["losses"]) != iters:
        raise AssertionError("non-finite or missing Sebulba PPO losses")
    _streams_check("Sebulba PPO", summary["streams"])
    returns = [ret for _, _, ret, _ in summary["episodes"]]
    last = float(np.mean(returns[-PPO_LAST_EPISODES:]))
    if len(returns) < PPO_LAST_EPISODES or last < SEBULBA_PPO_RETURN_BAR:
        raise AssertionError(f"Sebulba PPO did not learn CartPole: last-{PPO_LAST_EPISODES} mean {last}")
    update_ms = np.asarray(summary["update_s"]) * 1e3
    out = {
        "iterations": iters, "policy_steps": summary["policy_steps"], "launches": launches,
        "items_in_flight_at_shutdown": summary["items_in_flight_at_shutdown"], "wall_s": wall,
        "env_steps_per_s": steps / wall, "learner_starved_share": pipe["Pipeline/learner_starved_s"] / wall,
        "actor_stall_s": pipe["Pipeline/actor_stall_s"], "staleness_hist": pipe["staleness_hist"],
        "staleness_max": pipe["staleness_max"], "staleness_bound": pipe["staleness_bound"],
        "pipeline": {k: v for k, v in pipe.items() if k.startswith("Pipeline/")}, "snapshots": pipe["snapshots"],
        "streams": summary["streams"], "host_ms_per_update": {"median": float(np.median(update_ms)),
                                                              "range": [float(update_ms.min()), float(update_ms.max())]},
        "episodes": len(returns), "first_10_mean_return": float(np.mean(returns[:10])), "last_10_mean_return": last,
        "test_reward": summary["test_reward"], "losses_last": dict(zip(PPO_LOSS_NAMES, summary["losses"][-1])),
        "checkpoint": summary["checkpoint"],
    }
    log("Sebulba PPO run: " + json.dumps({k: v for k, v in out.items() if k != "checkpoint"}))

    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                       f"algo.total_steps={steps + 512}", "algo.run_test=false", f"log_root={workdir}"])
    resume_launches = dict(kernels.LAUNCHES)
    if resumed["start_iter"] != iters + 1 or resumed["iterations"] != 1 or resumed["policy_steps"] != steps + 512:
        raise AssertionError(f"Sebulba PPO resume: start {resumed['start_iter']}, {resumed['iterations']} items")
    _async_launch_check("Sebulba PPO resume", resume_launches, gae=1 + resumed["items_in_flight_at_shutdown"])
    out["resume"] = {"start_iter": resumed["start_iter"], "policy_steps": resumed["policy_steps"],
                     "launches": resume_launches, "losses": resumed["losses"],
                     "items_in_flight_at_shutdown": resumed["items_in_flight_at_shutdown"]}
    log("Sebulba PPO resume: " + json.dumps(out["resume"]))
    out["evaluation"] = stateless_evaluation_phase(summary["checkpoint"], "ppo_sebulba", 0.0, summary["test_reward"])
    out["profile_update_guarded"] = _profile_ppo_update(summary["checkpoint"], guard=True)
    out["profile_actor_step"] = _profile_actor_step(summary["checkpoint"])
    log("Sebulba PPO update and actor step: " + json.dumps({k: out[k] for k in ("profile_update_guarded",
                                                                              "profile_actor_step")}))
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        short = cli.run([f"preset={SEBULBA_PPO_PRESET}", f"algo.total_steps={SEBULBA_PROFILED_ITEMS * 512}",
                         "metric.log_level=0", "algo.run_test=false", "checkpoint.every=0",
                         "checkpoint.save_last=false", f"log_root={workdir}/profiled"])
    short_wall = time.perf_counter() - t0
    out["profiled_run"] = {"iterations": short["iterations"], "wall_s": short_wall, **_device_busy(prof, short_wall),
                           "learner_starved_share": short["pipeline"]["Pipeline/learner_starved_s"] / short_wall,
                           "streams": short["streams"]}
    log("Sebulba PPO profiled run: " + json.dumps(out["profiled_run"]))
    return out


def ppo_decoupled_run_phase(workdir: str) -> dict:
    """``run preset=ppo_decoupled`` (55) for DECOUPLED_PPO_ITERATIONS
    iterations: the player's ``gae`` exactly once per iteration on its own
    stream, no other kernel, every loss finite, checkpoints by the player and
    the trainer; a resume for one more iteration."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    steps = DECOUPLED_PPO_ITERATIONS * 512
    summary = cli.run([f"preset={DECOUPLED_PPO_PRESET}", f"algo.total_steps={steps}", "metric.log_level=0",
                       f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if summary["iterations"] != DECOUPLED_PPO_ITERATIONS or summary["device"].split(":")[0] != "cuda":
        raise AssertionError(f"decoupled PPO: {summary['iterations']} iterations on {summary['device']}")
    _async_launch_check("decoupled PPO", launches, gae=DECOUPLED_PPO_ITERATIONS)
    _streams_check("decoupled PPO", summary["streams"], "player", "trainer")
    if not np.isfinite(np.asarray(summary["losses"])).all():
        raise AssertionError("non-finite decoupled PPO losses")
    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0",
                       f"algo.total_steps={steps + 512}", "algo.run_test=false", f"log_root={workdir}"])
    resume_launches = dict(kernels.LAUNCHES)
    if resumed["start_iter"] != DECOUPLED_PPO_ITERATIONS + 1 or resumed["iterations"] != 1:
        raise AssertionError(f"decoupled PPO resume: start {resumed['start_iter']}, {resumed['iterations']} iterations")
    _async_launch_check("decoupled PPO resume", resume_launches, gae=1)
    out = {"iterations": summary["iterations"], "launches": launches, "wall_s": wall, "env_steps_per_s": steps / wall,
           "host_ms_per_update": float(np.median(summary["update_s"]) * 1e3), "streams": summary["streams"],
           "test_reward": summary["test_reward"], "losses_last": summary["losses"][-1],
           "resume": {"start_iter": resumed["start_iter"], "launches": resume_launches}}
    log("decoupled PPO run: " + json.dumps(out))
    return out


def _priority_gaps(card, cpu) -> tuple:
    """Two rings' sum-trees after one step from a shared one: the largest gap
    of the written leaves in |TD| units (a leaf is ``(|TD| + eps)^alpha``;
    leaves no step wrote are equal), and the internal nodes' largest
    relative gap."""
    P, inv = card.tree_leaves, 1.0 / card.per_alpha
    a, b = card.tree.cpu().double(), cpu.tree.double()
    td = ((a[P:].clamp(min=0) ** inv) - (b[P:].clamp(min=0) ** inv)).abs().max()
    nodes = ((a[1:P] - b[1:P]).abs() / b[1:P].abs().clamp(min=1e-12)).max()
    return float(td), float(nodes)


def _sac_append_free_check(checkpoint: str, steps: int = 4, beta: float = 0.5) -> dict:
    """The append-free dispatch (one granted step each) card against CPU from
    the Sebulba run's checkpoint, each step from the card's state just
    before it, on the card's own draws (the card ring's generator): losses
    and parameters at the tolerances of the SAC update phase (12); the
    written priorities in |TD| units within SAC_TD_ATOL (a trained critic's
    TD error cancels two Q values up to ~1,600 in magnitude on Pendulum, so
    float32 rounding of each, in another sum order on each device, moves a
    small TD error, and its priority, by far more than 1e-5 relative), the
    tree's internal nodes within SAC_NODE_RTOL."""
    from sheeprl_tpu_torch.algos.sac.sac import make_resident_train_step
    from sheeprl_tpu_torch.replay import DeviceReplayState

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(find_run_config(checkpoint))
    state = load_checkpoint(checkpoint)
    snap = DeviceReplayState.from_dict(state["rb"])
    parts = {dev: _sac_parts(cfg, dev, state["agent"]) for dev in ("cpu", "cuda")}
    rings = {dev: _sac_ring(cfg, dev) for dev in ("cpu", "cuda")}
    for ring in rings.values():  # the card's draw generator stays the card ring's: the CPU's takes its own state
        ring.load_state_dict(DeviceReplayState(snap.kind, {**snap.arrays, "key": ring.generator.get_state()}, snap.meta))
    trains = {dev: make_resident_train_step(parts[dev][0], parts[dev][1], cfg, rings[dev], append=False)
              for dev in parts}
    for dev, (_, opts) in parts.items():
        for opt, name in zip(opts, ("actor_optimizer", "qf_optimizer", "alpha_optimizer")):
            opt.load_state_dict(copy.deepcopy(state[name]))
    B, worst, launches = int(cfg.algo.per_rank_batch_size), {"loss_rel": 0.0, "param": 0.0}, 0
    for g in range(steps):
        card_agent, card_opts = parts["cuda"]
        cpu_agent, cpu_opts = parts["cpu"]
        cpu_agent.load_state_dict(card_agent.state_dict())
        for a, b in zip(cpu_opts, card_opts):
            a.load_state_dict(copy.deepcopy(b.state_dict()))
        rings["cpu"].tree.copy_(rings["cuda"].tree.cpu())
        rings["cpu"].max_p.copy_(rings["cuda"].max_p.cpu())
        gen = rings["cuda"].generator
        draws = {"u": torch.rand((1, B), generator=gen, device="cuda"),
                 "next": torch.randn((1, B, 1), generator=gen, device="cuda"),
                 "actor": torch.randn((1, B, 1), generator=gen, device="cuda")}
        out = {}
        for dev in ("cuda", "cpu"):
            before = kernels.LAUNCHES["sumtree_sample"]
            ctl = rings[dev].make_ctl_job([1.0], beta)
            out[dev] = trains[dev](ctl, draws={k: v.to(dev) for k, v in draws.items()})[0].cpu()
            if dev == "cuda":
                launches += kernels.LAUNCHES["sumtree_sample"] - before
        torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-6)
        card_state, cpu_state = card_agent.state_dict(), cpu_agent.state_dict()
        diff = max(float((card_state[k].cpu() - cpu_state[k]).abs().max()) for k in cpu_state)
        if diff > 2e-5:
            raise AssertionError(f"append-free SAC step {g} on the card moved a parameter {diff} from the CPU's")
        td_gap, node_gap = _priority_gaps(rings["cuda"], rings["cpu"])
        if td_gap > SAC_TD_ATOL or node_gap > SAC_NODE_RTOL:
            raise AssertionError(f"append-free SAC step {g}: written priorities {td_gap} apart in |TD|, "
                                 f"tree nodes {node_gap} relative")
        worst["loss_rel"] = max(worst["loss_rel"], float(((out["cuda"] - out["cpu"]).abs()
                                                          / out["cpu"].abs().clamp(min=1e-12)).max()))
        worst["param"] = max(worst["param"], diff)
        worst["td"], worst["node_rel"] = max(worst.get("td", 0.0), td_gap), max(worst.get("node_rel", 0.0), node_gap)
    if launches != steps:
        raise AssertionError(f"the card's append-free dispatches launched sumtree_sample {launches} times for {steps}")
    return {"steps": steps, "loss_max_rel_err": worst["loss_rel"], "param_max_abs_err": worst["param"],
            "priority_max_td_gap": worst["td"], "tree_node_max_rel_err": worst["node_rel"],
            "valid_rows": rings["cuda"].valid_rows}


def sac_sebulba_per_run_phase(workdir: str) -> dict:
    """``run preset=sac_sebulba_per`` (56) on Pendulum-v1 at full width (2
    actors x 4 envs, blocks of 8, a 1,000,000-transition ring with PER) for
    SEBULBA_SAC_STEPS steps: ``sumtree_sample`` launched exactly once per
    granted gradient step, no other kernel; the governor within ratio + 1 of
    ``ratio * (consumed - prefill)``; every loss finite; the actors on
    streams of their own. Then a resume from the mid-run save that restores
    the ring, the tree, ``max_p`` and the draw generator bit for bit, and
    one append-free dispatch card against CPU."""
    from sheeprl_tpu_torch.algos.sac import sac_sebulba as seb_module
    from sheeprl_tpu_torch.algos.sac.sac import LOSS_NAMES as SAC_LOSS_NAMES
    from sheeprl_tpu_torch.replay import DeviceReplayState

    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run([f"preset={SEBULBA_SAC_PRESET}", f"algo.total_steps={SEBULBA_SAC_STEPS}", "metric.log_level=0",
                       f"checkpoint.every={SEBULBA_SAC_SAVE_EVERY}", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    pipe = summary["pipeline"]
    if summary["device"].split(":")[0] != "cuda" or not summary["prioritized"] or summary["policy_steps"] < SEBULBA_SAC_STEPS:
        raise AssertionError(f"Sebulba SAC: {summary['policy_steps']} steps on {summary['device']}")
    _async_launch_check("Sebulba SAC", launches, sumtree_sample=summary["gradient_steps"])
    ratio = float(preset(SEBULBA_SAC_PRESET).algo.replay_ratio)
    consumed, grads = pipe["Pipeline/env_steps_consumed"], pipe["Pipeline/grad_steps"]
    governor_gap = abs(grads - ratio * (consumed - summary["governor_offset"]))
    if grads != summary["gradient_steps"] or governor_gap > ratio + 1:
        raise AssertionError(f"Sebulba SAC governor: {grads} steps for {consumed} consumed, gap {governor_gap}")
    if not np.isfinite(np.asarray(summary["losses"])).all() or len(summary["losses"]) != summary["train_calls"]:
        raise AssertionError("non-finite or missing Sebulba SAC losses")
    _streams_check("Sebulba SAC", summary["streams"])
    returns = [ret for _, _, ret, _ in summary["episodes"]]
    train_ms, append_ms = (np.asarray(summary[k]) * 1e3 for k in ("train_s", "append_s"))
    out = {
        "policy_steps": summary["policy_steps"], "gradient_steps": summary["gradient_steps"],
        "train_calls": summary["train_calls"], "grad_max": summary["grad_max"], "launches": launches, "wall_s": wall,
        "env_steps_per_s": summary["policy_steps"] / wall, "governor_gap": governor_gap,
        "learner_starved_share": pipe["Pipeline/learner_starved_s"] / wall, "actor_stall_s": pipe["Pipeline/actor_stall_s"],
        "staleness_hist": pipe["staleness_hist"], "staleness_max": pipe["staleness_max"],
        "staleness_bound": pipe["staleness_bound"], "prefill_publishes": pipe["prefill_publishes"],
        "pipeline": {k: v for k, v in pipe.items() if k.startswith("Pipeline/")}, "streams": summary["streams"],
        "host_ms_per_blob": {"append_median": float(np.median(append_ms)), "train_median": float(np.median(train_ms))},
        "episodes": len(returns), "last_10_mean_return": float(np.mean(returns[-10:])) if returns else None,
        "test_reward": summary["test_reward"], "replay": summary["replay"],
        "losses_last": dict(zip(SAC_LOSS_NAMES, summary["losses"][-1])), "checkpoint": summary["checkpoint"],
    }
    log("Sebulba SAC-PER run: " + json.dumps({k: v for k, v in out.items() if k != "checkpoint"}))

    mid = str(Path(summary["checkpoint"]).with_name(f"ckpt_{SEBULBA_SAC_SAVE_EVERY}_0.ckpt"))
    saved = DeviceReplayState.from_dict(load_checkpoint(mid)["rb"])
    restored = {}

    class _Recording(seb_module.DeviceReplayBuffer):
        def load_state_dict(self, snap):
            super().load_state_dict(snap)
            restored.update(self.state_dict().arrays)
            return self

    kernels.reset_launches()
    seb_module.DeviceReplayBuffer = _Recording
    try:
        resumed = cli.run([f"checkpoint.resume_from={mid}", "metric.log_level=0", "algo.run_test=false",
                           f"algo.total_steps={SEBULBA_SAC_SAVE_EVERY + SEBULBA_SAC_RESUME_STEPS}",
                           "checkpoint.save_last=false", "algo.learning_starts=0", f"log_root={_log_root(summary)}"])
    finally:
        seb_module.DeviceReplayBuffer = _Recording.__bases__[0]
    resume_launches = dict(kernels.LAUNCHES)
    same = {k: torch.equal(restored[k], v) for k, v in saved.arrays.items()}
    if not all(same.values()) or not {"tree", "max_p", "key"} <= set(same):
        raise AssertionError(f"the Sebulba resume restored a different ring: {same}")
    _async_launch_check("Sebulba SAC resume", resume_launches, sumtree_sample=resumed["gradient_steps"])
    if resumed["gradient_steps"] == 0 or resumed["policy_steps"] < SEBULBA_SAC_SAVE_EVERY + SEBULBA_SAC_RESUME_STEPS:
        raise AssertionError(f"Sebulba SAC resume: {resumed['policy_steps']} steps, {resumed['gradient_steps']} grads")
    out["resume"] = {"start_iter": resumed["start_iter"], "policy_steps": resumed["policy_steps"],
                     "gradient_steps": resumed["gradient_steps"], "launches": resume_launches,
                     "restored_equal": sorted(same)}
    log("Sebulba SAC resume: " + json.dumps(out["resume"]))
    out["append_free_dispatch"] = _sac_append_free_check(mid)
    log("Sebulba SAC append-free dispatch (card vs CPU, per step): " + json.dumps(out["append_free_dispatch"]))
    return out


def sac_decoupled_run_phase(workdir: str) -> dict:
    """``run preset=sac_decoupled`` (57) for DECOUPLED_SAC_STEPS steps (the
    player's host buffer and governor, its uploads on its own stream; no
    kernel on this path), then a resume of DECOUPLED_SAC_RESUME_STEPS."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run([f"preset={DECOUPLED_SAC_PRESET}", f"algo.total_steps={DECOUPLED_SAC_STEPS}", "metric.log_level=0",
                       f"checkpoint.every={DECOUPLED_SAC_STEPS // 2}", f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if summary["device"].split(":")[0] != "cuda" or summary["gradient_steps"] == 0:
        raise AssertionError(f"decoupled SAC: {summary['gradient_steps']} gradient steps on {summary['device']}")
    _async_launch_check("decoupled SAC", launches)
    _streams_check("decoupled SAC", summary["streams"], "player", "trainer")
    if not np.isfinite(np.asarray(summary["losses"])).all():
        raise AssertionError("non-finite decoupled SAC losses")
    kernels.reset_launches()
    resumed = cli.run([f"checkpoint.resume_from={summary['checkpoint']}", "metric.log_level=0", "algo.run_test=false",
                       f"algo.total_steps={DECOUPLED_SAC_STEPS + DECOUPLED_SAC_RESUME_STEPS}", "algo.learning_starts=0",
                       f"log_root={workdir}"])
    resume_launches = dict(kernels.LAUNCHES)
    _async_launch_check("decoupled SAC resume", resume_launches)
    if resumed["gradient_steps"] == 0 or not np.isfinite(np.asarray(resumed["losses"])).all():
        raise AssertionError(f"decoupled SAC resume: {resumed['gradient_steps']} gradient steps")
    out = {"policy_steps": summary["policy_steps"], "gradient_steps": summary["gradient_steps"],
           "train_calls": summary["train_calls"], "launches": launches, "wall_s": wall,
           "env_steps_per_s": summary["policy_steps"] / wall, "streams": summary["streams"],
           "host_ms_per_train_call": float(np.median(summary["train_s"]) * 1e3), "test_reward": summary["test_reward"],
           "resume": {"start_iter": resumed["start_iter"], "policy_steps": resumed["policy_steps"],
                      "gradient_steps": resumed["gradient_steps"], "launches": resume_launches}}
    log("decoupled SAC run: " + json.dumps(out))
    return out


# -- 58-59. dreamer_sebulba on the card ------------------------------------------------

SEBULBA_RSSM_PRESET = "dreamer_sebulba_atari_dummy"
# the run: the recipe's 1,024-step prefill (256 rows of 4 envs), then blocks of 8 rows, each
# granting one full 32-step dispatch at replay ratio 1
SEBULBA_RSSM_FULL_DISPATCHES = 4
# the resume from the run's last save: JAX shifts the prefill by the resumed iteration, so the
# restored Ratio first grants -132 steps (its previous count), and 39 rows of 4 grants later the
# backlog is 24: 5 items, one dispatch
SEBULBA_RSSM_RESUME_ITEMS = 5
SEBULBA_RSSM_APPEND_CAP = 40  # rows per env column of the two-actor append check: 6 blobs of >= 8 rows wrap it
SEBULBA_RSSM_APPEND_BLOBS = 6
SEBULBA_RSSM_ACT_STEPS = 50  # act steps profiled
# ~3 s of work on the learner's stream ahead of a publish's copy: far longer than an act step
SEBULBA_PREFER_READY_SLEEP = 15 * SLEEP_CYCLES


def _sebulba_keys():
    from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys

    return dreamer_ring_keys({"rgb": {"shape": [64, 64, 3]}}, ["rgb"], [], [18], with_is_first=True)


def _fill_row(views: dict, rng) -> None:
    for v in views.values():
        v[...] = rng.integers(0, 256, v.shape) if v.dtype == np.uint8 else rng.normal(size=v.shape)


def _write_block(writer, rng, block: int) -> int:
    """``block`` regular rows of random bytes, each followed by a reset row
    of the envs a coin marks done, as an actor writes them (at most 2 x
    ``block`` rows). Returns the reset rows."""
    resets = 0
    for _ in range(block):
        _fill_row(writer.row(np.ones(writer.local_envs, np.int32)), rng)
        done = rng.random(writer.local_envs) < 0.3
        if done.any():
            _fill_row(writer.row(done.astype(np.int32)), rng)
            resets += 1
    return resets


def _sebulba_appends() -> dict:
    """Two actor threads, each on its own stream, write blocks of 8 rows with
    ragged reset rows into their writers at env columns 0 and 4 and upload
    them; the learner appends each blob through ``ragged_ring_scatter_keys``
    into a ring of SEBULBA_RSSM_APPEND_CAP rows x 8 columns (every column
    wraps) and the same bytes into the same ring on the CPU (the plain
    version): storage and heads bit-equal after every blob, one launch per
    blob."""
    import queue as queue_mod

    from sheeprl_tpu_torch.parallel.pipeline import StagedItem, side_stream
    from sheeprl_tpu_torch.replay import AsyncSequenceRing, SeqBlobWriter

    keys, local, actors, block, C = _sebulba_keys(), 4, 2, 8, SEBULBA_RSSM_APPEND_CAP
    E = local * actors
    card = AsyncSequenceRing(keys, C, E, local, 64, 2 * block, device="cuda")
    cpu = AsyncSequenceRing(keys, C, E, local, 64, 2 * block)
    items, errors, streams = queue_mod.Queue(), [], set()

    def actor(aid: int) -> None:
        try:
            stream, ctx = side_stream("cuda")
            streams.add(int(stream.cuda_stream))
            with ctx:
                writer, rng = SeqBlobWriter(card, aid * local), np.random.default_rng(60 + aid)
                for _ in range(SEBULBA_RSSM_APPEND_BLOBS):
                    resets = _write_block(writer, rng, block)
                    blob, counts = writer.ship()
                    items.put((aid, StagedItem.record({"blob": blob}), counts, resets))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            items.put(None)

    threads = [threading.Thread(target=actor, args=(a,), name=f"seq-writer-{a}", daemon=True) for a in range(actors)]
    before = kernels.LAUNCHES["ragged_ring_scatter"]
    for t in threads:
        t.start()
    resets, order = 0, []
    try:
        for _ in range(actors * SEBULBA_RSSM_APPEND_BLOBS):
            got = items.get(timeout=300)
            if got is None:
                break
            aid, staged, counts, r = got
            blob = staged.wait()["blob"]
            env_counts = np.zeros(E, np.int64)
            env_counts[aid * local:(aid + 1) * local] = counts
            card.append(blob, aid * local)
            card.note_append(env_counts, blob.numel())
            host = blob.cpu()
            cpu.append(host, aid * local)
            cpu.note_append(env_counts, host.numel())
            for k in keys:
                if not torch.equal(card.state["storage"][k].cpu(), cpu.state["storage"][k]):
                    raise AssertionError(f"blob {len(order)} of actor {aid}: the card's ring '{k}' differs from the CPU's")
            for h in ("pos", "valid"):
                if not torch.equal(card.state[h].cpu(), cpu.state[h]):
                    raise AssertionError(f"blob {len(order)} of actor {aid}: the card's {h} differ from the CPU's")
            resets += r
            order.append(aid)
    finally:
        for t in threads:
            t.join(timeout=120)
    if errors:
        raise errors[0]
    launches = kernels.LAUNCHES["ragged_ring_scatter"] - before
    out = {"blobs": len(order), "order": order, "reset_rows": resets, "launches": launches,
           "host_valid": card.host_valid.tolist(), "host_pos": card.host_pos.tolist(), "streams": sorted(streams),
           "learner_stream": int(torch.cuda.current_stream().cuda_stream)}
    if (len(order) != actors * SEBULBA_RSSM_APPEND_BLOBS or launches != len(order) or not resets
            or not (card.host_valid == C).all() or len(streams) != actors or 0 in streams):
        raise AssertionError(f"the two-actor appends on the card: {out}")
    if not np.array_equal(card.host_pos, card.state["pos"].cpu().numpy()):
        raise AssertionError("the host mirror of the heads differs from the card's")
    return out


def _writer_refill() -> dict:
    """A writer of 2 slabs on an actor stream held by a ~200 ms kernel: its
    first slab's upload is still in flight when the next-but-one block
    begins, which waits for that upload's event; the learner then reads the
    first blob bit for bit though the host slab was overwritten."""
    from sheeprl_tpu_torch.parallel.pipeline import StagedItem, side_stream
    from sheeprl_tpu_torch.replay import AsyncSequenceRing, SeqBlobWriter

    ring = AsyncSequenceRing(_sebulba_keys(), 64, 8, 4, 64, 16, device="cuda")
    rng = np.random.default_rng(62)
    _, ctx = side_stream("cuda")
    with ctx:
        writer = SeqBlobWriter(ring, 4)
        slab0 = writer._slab
        _write_block(writer, rng, 8)
        first = slab0.blob.numpy().copy()
        torch.cuda._sleep(SLEEP_CYCLES)  # the upload queues behind ~200 ms on the actor's stream
        t0 = time.perf_counter()
        blob0, _ = writer.ship()
        event0 = slab0.event
        in_flight = not event0.query()
        item0 = StagedItem.record({"blob": blob0})
        _write_block(writer, rng, 8)
        writer.ship()  # the next block begins on slab 0 again: it waits for slab 0's upload
        waited = time.perf_counter() - t0
        done_at_refill, refilled = event0.query(), writer._slab is slab0
        _write_block(writer, rng, 8)  # the next block overwrites slab 0's host bytes
    equal = bool(np.array_equal(item0.wait()["blob"].cpu().numpy(), first))
    out = {"upload_in_flight_at_ship": in_flight, "upload_done_at_refill": done_at_refill,
           "refill_wait_ms": waited * 1e3, "same_slab": refilled, "first_blob_bit_equal": equal}
    if not (in_flight and done_at_refill and refilled and equal):
        raise AssertionError(f"the writer's event-gated refill on the card: {out}")
    return out


def _sebulba_ring_state(rng, keys, C: int, E: int):
    """A random ring of C rows x E columns and ragged heads (every column at
    least a 16-row window): a DeviceReplayState and its arrays."""
    from sheeprl_tpu_torch.replay import DeviceReplayState

    ring = _resident_ring(rng, keys, C, E)
    pos = np.array([40, 100, 255, 0, 17, 200, 3, 90], np.int32)[:E]
    valid = np.array([C, 100, C, C, 17, C, C, 90], np.int32)[:E]
    arrays = {f"storage/{k}": torch.from_numpy(v) for k, v in ring.items()}
    arrays.update(pos=torch.from_numpy(pos), valid=torch.from_numpy(valid))
    return DeviceReplayState("sequence", arrays, {"capacity": C, "n_envs": E, "seq_len": 16})


def _sebulba_blob_rows(rng, keys, local: int):
    """Two regular rows of an actor's 4 envs and a reset row of two of them."""
    def row():
        return {k: (rng.integers(0, 256, (local,) + shape) if np.dtype(dtype) == np.uint8
                    else rng.normal(size=(local,) + shape)).astype(dtype) for k, (shape, dtype) in keys.items()}

    ones = np.ones(local, np.int32)
    return [(row(), ones), (row(), ones), (row(), np.array([0, 1, 0, 1], np.int32))]


def _sebulba_dispatch() -> dict:
    """One append (an actor's blob at env columns 4-7) and one guarded
    append-free dispatch (full width, B 4 x T 16, H 15, one granted step of 2)
    on the card against the same on the CPU from the same seeded weights,
    ring and injected draws, TF32 off: the ring after the append and the
    windows bit-equal; the eleven metrics and the parameters held as the
    resident dispatch (15) holds them; one scatter launch on the card."""
    from sheeprl_tpu_torch.data.ring import pack_burst_blob, ring_sample_windows
    from sheeprl_tpu_torch.replay import AsyncSequenceRing

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B, C, local = 16, 4, 256, 4
    E = 2 * local
    cfg = _v2_cfg(SEBULBA_RSSM_PRESET, [f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}"])
    keys = _sebulba_keys()
    spec = {"capacity": C, "n_envs": E, "grad_chunk": 2, "seq_len": T, "batch_size": B, "decoupled": True}
    rng = np.random.default_rng(63)
    snap = _sebulba_ring_state(rng, keys, C, E)
    rows = _sebulba_blob_rows(rng, keys, local)
    counts = np.zeros(E, np.int64)
    counts[local:] = sum(m for _, m in rows)
    gen = torch.Generator().manual_seed(64)
    draws = {"env": torch.randint(0, E, (1, B), generator=gen), "u": torch.rand((1, B), generator=gen),
             "noise": [draw_noise(cfg, T, B, [18], gen, "cpu")]}
    results = {}
    for dev in ("cpu", "cuda"):
        modules = build_training_agent(cfg, dev)
        optimizers = make_optimizers(cfg, *modules[:3])
        train, ctl = make_train_step(*modules, optimizers, cfg, ring=spec, guard=True)
        ring = AsyncSequenceRing(keys, C, E, local, T, 16, device=dev).load_state_dict(snap)
        before = kernels.LAUNCHES["ragged_ring_scatter"]
        ring.append(ring.pack_rows(rows, local).to(dev), local)
        ring.note_append(counts, 0)
        launched = kernels.LAUNCHES["ragged_ring_scatter"] - before
        dev_draws = {"env": draws["env"].to(dev), "u": draws["u"].to(dev), "noise": [_to_device(draws["noise"][0], dev)]}
        t0 = time.perf_counter()
        _, metrics = train((init_moments(dev), 0), ring.state, pack_burst_blob(ctl, {"__validmask__": np.array([1, 0], np.float32)}),
                           ring.host_valid, None, dev_draws)
        metrics = metrics.cpu()
        seconds = time.perf_counter() - t0
        windows = ring_sample_windows(dev_draws["u"][0], dev_draws["env"][0], ring.state["pos"], ring.state["valid"],
                                      C, T).cpu()
        params = {name: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                  for name, m in zip(("world_model", "actor", "critic"), modules)}
        results[dev] = {"storage": {k: v.cpu() for k, v in ring.state["storage"].items()}, "windows": windows,
                        "heads": (ring.state["pos"].cpu(), ring.state["valid"].cpu()), "metrics": metrics,
                        "params": params, "seconds": seconds, "launched": launched}
    card, cpu = results["cuda"], results["cpu"]
    if card["launched"] != 1 or cpu["launched"] != 0:
        raise AssertionError(f"scatter launches of the append: card {card['launched']}, CPU {cpu['launched']}")
    if not all(torch.equal(card["storage"][k], cpu["storage"][k]) for k in keys) or not all(
            torch.equal(a, b) for a, b in zip(card["heads"], cpu["heads"])):
        raise AssertionError("the async ring after the append differs between the card and the CPU")
    if not torch.equal(card["windows"], cpu["windows"]):
        raise AssertionError("the dispatch's windows differ between the card and the CPU")
    if not torch.isfinite(card["metrics"]).all() or card["metrics"].numel() != len(METRIC_NAMES) + 1:
        raise AssertionError(f"the card's dispatch metrics: {card['metrics'].tolist()}")
    torch.testing.assert_close(card["metrics"], cpu["metrics"], rtol=1e-4, atol=1e-5)
    out = {"cpu_s": cpu["seconds"], "cuda_s": card["seconds"], "ring_equal": True, "windows_equal": True,
           "loss_abs_err": dict(zip(METRIC_NAMES + ("Fault/skipped_fraction",),
                                    (card["metrics"] - cpu["metrics"]).abs().tolist()))}
    for name, lr in {"world_model": 1e-4, "actor": 8e-5, "critic": 8e-5}.items():
        diffs = torch.cat([(card["params"][name][k] - cpu["params"][name][k]).abs().reshape(-1)
                           for k in cpu["params"][name]])
        close = float((diffs <= 1e-6).float().mean())
        out[name] = {"max_abs_err": float(diffs.max()), "share_within_1e-6": close}
        if float(diffs.max()) > 2 * lr + 1e-6 or close < 0.999:
            raise AssertionError(f"{name} after the dispatch on the card differs from the CPU: {out[name]}")
    return out


def _sebulba_act_inputs(cfg, n: int, seed: int):
    """An act step's inputs from a seed: frames, carries (every row one-hot
    where the carry is), ``is_first`` on rows 0 and 3, and decisive draws."""
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs

    rng = np.random.default_rng(seed)
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    H = int(cfg.algo.world_model.recurrent_model.recurrent_state_size)
    obs = {k: torch.from_numpy(v) for k, v in prepare_obs(
        {"rgb": rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)}, cnn_keys=["rgb"], num_envs=n).items()}
    stoch = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, D, (n, S))), D).float().reshape(n, S * D)
    carry = (torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, 18, n)), 18).float(),
             torch.from_numpy(rng.normal(size=(n, H)).astype(np.float32)).tanh(), stoch)
    first = torch.tensor([[1.0], [0.0], [0.0], [1.0]])[:n]
    noise = {"posterior": _decisive_uniforms(torch.rand(n, S * D), D, seed + 1),
             "actions": [_decisive_uniforms(torch.rand(n, 18), 18, seed + 2)]}
    return obs, carry, first, noise


def _sebulba_act() -> dict:
    """One act step (full width, 4 envs, ``is_first`` on two rows) on the
    card against the CPU from the same seeded weights and decisive draws:
    the recurrent state and the representation logits within atol 1e-3 (the
    model phase's), the posterior and the actions the same one-hots; one
    ``gru_gates`` launch on the card."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba import make_act_step, player_subset

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _v2_cfg(SEBULBA_RSSM_PRESET)
    obs, carry, first, noise = _sebulba_act_inputs(cfg, 4, 65)
    out = {}
    for dev in ("cpu", "cuda"):
        wm, actor, _, _ = build_training_agent(cfg, dev)
        agent, act_step = player_subset(wm, actor), make_act_step(wm, actor)
        before = kernels.LAUNCHES["gru_gates"]
        with torch.no_grad():
            _, cat, rec, stoch = act_step(agent, _to_device(obs, dev), *(c.to(dev) for c in carry), first.to(dev),
                                          _to_device(noise, dev))
            logits = wm.representation(rec, wm.encoder(_to_device(obs, dev)))
        out[dev] = (cat.cpu(), rec.cpu(), stoch.cpu(), logits.cpu(), kernels.LAUNCHES["gru_gates"] - before)
    rec_err = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    logit_err = float((out["cuda"][3] - out["cpu"][3]).abs().max())

    def same_draw(a, b):  # the straight-through hard + p - p leaves an ulp: the same one-hots once rounded
        return torch.equal(a.round(), b.round()) and float((a - b).abs().max()) <= 1e-6

    res = {"recurrent_max_abs_err": rec_err, "logits_max_abs_err": logit_err, "gru_launches": out["cuda"][4],
           "actions_equal": same_draw(out["cuda"][0], out["cpu"][0]),
           "posterior_equal": same_draw(out["cuda"][2], out["cpu"][2])}
    if rec_err > 1e-3 or logit_err > 1e-3 or not (res["actions_equal"] and res["posterior_equal"]) or out["cuda"][4] != 1:
        raise AssertionError(f"the act step on the card disagrees with the CPU: {res}")
    return res


def _prefer_ready() -> dict:
    """``ParamServer.pull(prefer_ready=True)`` on the card. The learner's
    stream holds a ~3 s kernel (device work queued ahead of a publish: a
    train dispatch's tail), then a publish whose copy queues behind it. An
    actor on its own stream pulls meanwhile: ``prefer_ready`` gives it the
    previous version, whose copy is done, and its act step ends within
    milliseconds while the newest copy still waits; a default pull gives the
    newest version, and the act step on it ends only after that copy.

    Measured beside it, not checked: the same pull while the learner's host
    is inside a one-step dispatch queued behind the kernel. A DreamerV3 step
    is ~13,000 launches; the host stops in ``cudaLaunchKernel`` once the
    CUDA launch queue is full, and the actor's act step then waits with it
    (its timestamps say whether before or after its pull returned)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba import make_act_step, player_subset
    from sheeprl_tpu_torch.data.ring import pack_burst_blob
    from sheeprl_tpu_torch.parallel.pipeline import ParamServer, side_stream
    from sheeprl_tpu_torch.replay import AsyncSequenceRing

    T, B, C, E = 16, 4, 256, 8
    cfg = _v2_cfg(SEBULBA_RSSM_PRESET, [f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}"])
    modules = build_training_agent(cfg, "cuda")
    optimizers = make_optimizers(cfg, *modules[:3])
    train, ctl = make_train_step(*modules, optimizers, cfg, guard=True, ring={
        "capacity": C, "n_envs": E, "grad_chunk": 1, "seq_len": T, "batch_size": B, "decoupled": True})
    ring = AsyncSequenceRing(_sebulba_keys(), C, E, 4, T, 16, device="cuda").load_state_dict(
        _sebulba_ring_state(np.random.default_rng(66), _sebulba_keys(), C, E))
    server = ParamServer(player_subset(modules[0], modules[1]))
    for _ in range(3):  # versions 1-3: the pool's snapshots exist before the measured publishes
        server.publish()
    act_step = make_act_step(modules[0], modules[1])
    obs, act_carry, first, noise = _sebulba_act_inputs(cfg, 4, 67)
    obs, first, noise = _to_device(obs, "cuda"), first.cuda(), _to_device(noise, "cuda")
    act_carry = [c.cuda() for c in act_carry]
    ctl_blob = pack_burst_blob(ctl, {"__validmask__": np.ones(1, np.float32)})
    # the loop's carry: the step count on the card (a Python int would be copied over, synchronously)
    state = (init_moments("cuda"), torch.zeros((), dtype=torch.int64, device="cuda"))
    for _ in range(2):  # warm-up: the first calls allocate
        state, _ = train(state, ring.state, ctl_blob, ring.host_valid, ring.generator)

    def act_on(prefer_ready: bool) -> dict:
        t0 = time.perf_counter()
        version, agent = server.pull(prefer_ready=prefer_ready)
        pulled = time.perf_counter()
        act_step(agent, obs, *act_carry, first, noise)
        torch.cuda.current_stream().synchronize()
        server.release(version)
        return {"version": version, "pull_ms": (pulled - t0) * 1e3, "act_ms": (time.perf_counter() - t0) * 1e3}

    def on_actor_stream(fn) -> dict:
        out, errors = {}, []

        def run():
            try:
                _, ctx = side_stream("cuda")
                with ctx, torch.no_grad():
                    out.update(fn())
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        thread = threading.Thread(target=run, name="prefer-ready-actor", daemon=True)
        thread.start()
        return out, errors, thread

    out, errors, thread = on_actor_stream(lambda: act_on(True))  # the warm-up act step
    thread.join(timeout=300)
    if errors or thread.is_alive():
        raise AssertionError(f"the actor's warm-up act step did not finish: {errors}")
    torch.cuda.synchronize()
    # 1. the newest copy queued behind ~3 s: prefer_ready acts on the previous version at once
    torch.cuda._sleep(SEBULBA_PREFER_READY_SLEEP)
    newest = server.publish()
    newest_event = server._current.event

    def both():
        ready = act_on(True)
        ready["newest_copy_pending"] = not newest_event.query()
        return {"ready": ready, "default": act_on(False)}

    got, errors, thread = on_actor_stream(both)
    thread.join(timeout=300)
    if errors or thread.is_alive():
        raise AssertionError(f"the prefer_ready actor did not end cleanly: {errors}")
    torch.cuda.synchronize()
    # 2. measured: the same pull while the learner's host is inside a dispatch queued behind ~3 s
    torch.cuda._sleep(SEBULBA_PREFER_READY_SLEEP)
    newest_2 = server.publish()
    in_dispatch = threading.Event()
    waited, errors_2, thread = on_actor_stream(lambda: (in_dispatch.wait(timeout=120), time.sleep(0.05),
                                                        act_on(True))[2])
    t0 = time.perf_counter()
    in_dispatch.set()
    train(state, ring.state, ctl_blob, ring.host_valid, ring.generator)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    thread.join(timeout=300)
    torch.cuda.synchronize()
    res = {"newest": newest, "ready": got["ready"], "default": got["default"],
           "ready_fallbacks": server.stats.ready_fallbacks, "snapshots": server.snapshots,
           "inside_a_dispatch": {"newest": newest_2, **waited, "learner_enqueue_ms": enqueue_ms,
                                 "errors": [repr(e) for e in errors_2]}}
    ready, default = got["ready"], got["default"]
    if not (newest == 4 and ready["version"] == 3 and ready["newest_copy_pending"] and ready["act_ms"] < 1000
            and default["version"] == 4 and default["act_ms"] > ready["act_ms"]):
        raise AssertionError(f"prefer_ready on the card: {res}")
    return res


def rssm_sebulba_card_phase() -> dict:
    """``dreamer_sebulba``'s pieces on the card (58): two actors' blobs
    appended at env columns 0 and 4 bit-equal to the plain version; the
    writer's slab refilled only after its upload's event; one append-free
    dispatch and one act step against the CPU; ``prefer_ready`` while the
    newest snapshot's copy waits on the learner's stream. The kernel
    launches here are checks, not a path's."""
    out = {"appends": _sebulba_appends(), "writer_refill": _writer_refill(), "dispatch": _sebulba_dispatch(),
           "act_step": _sebulba_act(), "prefer_ready": _prefer_ready()}
    log("dreamer_sebulba on the card: " + json.dumps(out))
    return out


def _profile_sebulba_act_step(checkpoint: str, steps: int = SEBULBA_RSSM_ACT_STEPS) -> dict:
    """One actor step of the run's checkpoint on an actor stream (4 envs):
    frames up, the act step, the actions down: host ms per step, the act
    step's span between CUDA events (which holds the host's launch gaps),
    and its kernels' device time and operations (``torch.profiler``)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba import make_act_step, player_subset
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
    from sheeprl_tpu_torch.parallel.pipeline import side_stream

    cfg = load_config(find_run_config(checkpoint))
    wm, actor, _, _ = build_training_agent(cfg, "cuda", load_checkpoint(checkpoint))
    agent, act_step = player_subset(wm, actor), make_act_step(wm, actor)
    _, carry, first, noise = _sebulba_act_inputs(cfg, 4, 68)
    rng = np.random.default_rng(69)
    frames = [rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8) for _ in range(steps)]
    _, ctx = side_stream("cuda")
    with ctx, torch.no_grad():
        carry, first, noise = [c.cuda() for c in carry], first.cuda(), _to_device(noise, "cuda")

        def step(t):
            obs = {k: torch.from_numpy(v).cuda() for k, v in prepare_obs({"rgb": frames[t]}, cnn_keys=["rgb"],
                                                                          num_envs=4).items()}
            return obs, act_step(agent, obs, *carry, first, noise)[1]

        for t in range(5):
            step(t)[1].cpu()
        host, device = [], []
        for t in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            obs = {k: torch.from_numpy(v).cuda() for k, v in prepare_obs({"rgb": frames[t]}, cnn_keys=["rgb"],
                                                                          num_envs=4).items()}
            start.record()
            actions = act_step(agent, obs, *carry, first, noise)[1]
            end.record()
            actions.cpu()
            host.append(time.perf_counter() - t0)
            device.append(start.elapsed_time(end))
        acts = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            step(0)[1].cpu()
    events = _device_kernels(prof)
    return {"host_ms": float(np.median(host) * 1e3), "host_ms_range": [min(host) * 1e3, max(host) * 1e3],
            "device_ms_events": float(np.median(device)),
            "device_ms_profiler": sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e3 or None,
            "device_ops": sum(e.count for e in events)}


def _sebulba_dispatch_alone(checkpoint: str, grant: int) -> dict:
    """One ``grant``-step append-free dispatch of the run's checkpoint (its
    modules, optimizers and ring) alone on the card: host ms to enqueue it,
    and to its end."""
    from sheeprl_tpu_torch.data.ring import pack_burst_blob
    from sheeprl_tpu_torch.replay import AsyncSequenceRing, DeviceReplayState
    from sheeprl_tpu_torch.utils.burst import dreamer_ring_keys

    cfg = load_config(find_run_config(checkpoint))
    state = load_checkpoint(checkpoint)
    modules = build_training_agent(cfg, "cuda", state)
    optimizers = make_optimizers(cfg, *modules[:3])
    for name, opt in optimizers.items():
        opt.load_state_dict(state["optimizers"][name])
    snap = DeviceReplayState.from_dict(state.pop("rb"))
    C, E = int(snap.meta["capacity"]), int(snap.meta["n_envs"])
    local = int(cfg.env.num_envs)
    T, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    keys = dreamer_ring_keys(cfg.spaces.obs, ["rgb"], [], [18], with_is_first=True)
    ring = AsyncSequenceRing(keys, C, E, local, T, 2 * int(cfg.algo.sebulba.rollout_block), device="cuda",
                             seed=7).load_state_dict(snap)
    del snap, state
    train, ctl = make_train_step(*modules, optimizers, cfg, guard=True, ring={
        "capacity": C, "n_envs": E, "grad_chunk": grant, "seq_len": T, "batch_size": B, "decoupled": True})
    blob = pack_burst_blob(ctl, {"__validmask__": np.ones(grant, np.float32)})
    carry = (init_moments("cuda"), torch.zeros((), dtype=torch.int64, device="cuda"))
    carry, _ = train(carry, ring.state, blob, ring.host_valid, ring.generator)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, metrics = train(carry, ring.state, blob, ring.host_valid, ring.generator)
    enqueued = time.perf_counter() - t0
    float(metrics[-1])
    return {"grant": grant, "host_ms_enqueue": enqueued * 1e3, "host_ms_to_end": (time.perf_counter() - t0) * 1e3}


def _sebulba_launch_check(name: str, summary: dict, launches: dict, T: int, H: int) -> dict:
    G = summary["gradient_steps"]
    want = {"ragged_ring_scatter": summary["replay"]["Replay/flushes"],
            "gru_gates": summary["act_steps"] + G * (T + H) + (summary["test_steps"] or 0),
            "two_hot_symlog_loss_lse": 3 * G, "two_hot_symlog_loss_lse_bwd": 3 * G, "two_hot_symexp_decode": 3 * G}
    _async_launch_check(name, launches, **want)
    return want


def _one_session_client(frames):
    """One session of len(frames) steps, then a health probe."""

    def client(port: int, result: dict) -> None:
        conn = _Conn(port, time.monotonic() + 300)
        result["actions"] = []
        for frame in frames:
            resp = conn.ask({"obs": {"rgb": frame.tolist()}, "session_id": "u"})
            if "actions" not in resp:
                raise AssertionError(f"session step {len(result['actions'])}: {resp}")
            result["actions"].append(resp["actions"])
        result["health"] = conn.ask({"health": True})
        conn.close()

    return client


def rssm_sebulba_run_phase(workdir: str) -> dict:
    """``run preset=dreamer_sebulba_atari_dummy`` (59) at the recipe on the
    card: 2 actor threads x 4 envs on their own streams, the 1,024-step
    prefill, then SEBULBA_RSSM_FULL_DISPATCHES full 32-step dispatches into
    the 100,000-row ring, the test episode, a checkpoint of the whole ring.
    Launches exactly: ``ragged_ring_scatter`` once per committed blob,
    ``gru_gates`` once per act step and test step and T + H a gradient step,
    the two-hot kernels 3 a gradient step each; the governor within ratio + 1
    of its grants; the staleness within ``2 x bound + prefill_publishes``;
    every loss finite; the actors' streams their own. Then a resume from the
    latest save that must restore the ring, its heads, its generator and
    ``Ratio`` bit for bit and train on, ``evaluation`` of the run's
    checkpoint, one served session, one dispatch alone and an act step
    profiled."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_sebulba as seb_module
    from sheeprl_tpu_torch.replay import DeviceReplayState

    cfg = preset(SEBULBA_RSSM_PRESET)
    per_item = int(cfg.env.num_envs) * int(cfg.algo.sebulba.rollout_block)
    steps = int(cfg.algo.learning_starts) + SEBULBA_RSSM_FULL_DISPATCHES * per_item
    T, H, ratio = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon), float(cfg.algo.replay_ratio)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = cli.run([f"preset={SEBULBA_RSSM_PRESET}", f"algo.total_steps={steps}", "metric.log_level=0",
                       f"log_root={workdir}"])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    pipe, G = summary["pipeline"], summary["gradient_steps"]
    grad_max = summary["grad_max"]
    full = [s for s, n in summary["dispatch_host_s"] if n == grad_max]
    if summary["device"].split(":")[0] != "cuda" or summary["policy_steps"] != steps or len(full) < SEBULBA_RSSM_FULL_DISPATCHES:
        raise AssertionError(f"dreamer_sebulba: {summary['policy_steps']} steps, {len(full)} full dispatches on "
                             f"{summary['device']}")
    want = _sebulba_launch_check("dreamer_sebulba", summary, launches, T, H)
    consumed = pipe["Pipeline/env_steps_consumed"]
    governor_gap = abs(G - ratio * (consumed - summary["prefill_policy_steps"]))
    if pipe["Pipeline/grad_steps"] != G or governor_gap > ratio + 1:
        raise AssertionError(f"dreamer_sebulba governor: {G} steps for {consumed} consumed, gap {governor_gap}")
    if pipe["staleness_max"] > 2 * pipe["staleness_bound"] + pipe["prefill_publishes"]:
        raise AssertionError(f"dreamer_sebulba staleness {pipe['staleness_max']} past 2 x {pipe['staleness_bound']} + "
                             f"{pipe['prefill_publishes']}")
    if not np.isfinite(np.asarray(summary["metrics"])).all() or len(summary["metrics"]) != summary["train_calls"]:
        raise AssertionError("non-finite or missing dreamer_sebulba losses")
    _streams_check("dreamer_sebulba", summary["streams"])
    out = {
        "policy_steps": summary["policy_steps"], "gradient_steps": G, "train_calls": summary["train_calls"],
        "full_dispatches": len(full), "grad_max": grad_max, "act_steps": summary["act_steps"],
        "test_steps": summary["test_steps"], "test_reward": summary["test_reward"], "launches": launches,
        "launches_want": want, "wall_s": wall, "env_steps_per_s": summary["policy_steps"] / wall,
        "governor_gap": governor_gap, "learner_starved_share": pipe["Pipeline/learner_starved_s"] / wall,
        "actor_stall_s": pipe["Pipeline/actor_stall_s"], "staleness_hist": pipe["staleness_hist"],
        "staleness_max": pipe["staleness_max"], "staleness_bound": pipe["staleness_bound"],
        "prefill_publishes": pipe["prefill_publishes"], "ready_fallbacks": pipe["ready_fallbacks"],
        "streams": summary["streams"], "replay": summary["replay"],
        "host_ms_per_dispatch_in_pipeline": {"enqueue_median": float(np.median(full) * 1e3),
                                             "enqueue_range": [min(full) * 1e3, max(full) * 1e3]},
        "host_ms_per_append": float(np.median(summary["append_s"]) * 1e3),
        "peak_device_gb": torch.cuda.max_memory_allocated() / 2**30,
        "losses_last": dict(zip(METRIC_NAMES, summary["metrics"][-1])), "checkpoint": summary["checkpoint"],
    }
    log("dreamer_sebulba run: " + json.dumps({k: v for k, v in out.items() if k != "checkpoint"}))

    saved = load_checkpoint(summary["checkpoint"])
    saved_ring = DeviceReplayState.from_dict(saved.pop("rb"))
    restored = {}

    class _Ring(seb_module.AsyncSequenceRing):
        def load_state_dict(self, snap):
            super().load_state_dict(snap)
            restored.update(self.state_dict().arrays)
            return self

    class _Ratio(seb_module.Ratio):
        def load_state_dict(self, s):
            super().load_state_dict(s)
            restored["ratio"] = self.state_dict()
            return self

    kernels.reset_launches()
    seb_module.AsyncSequenceRing, seb_module.Ratio = _Ring, _Ratio
    try:
        resumed = cli.run([f"preset={SEBULBA_RSSM_PRESET}", "checkpoint.resume_from=latest", "metric.log_level=0",
                           "algo.run_test=false", "algo.learning_starts=0", "checkpoint.save_last=false",
                           f"algo.total_steps={steps + SEBULBA_RSSM_RESUME_ITEMS * per_item}", f"log_root={workdir}"])
    finally:
        seb_module.AsyncSequenceRing, seb_module.Ratio = _Ring.__bases__[0], _Ratio.__bases__[0]
    resume_launches = dict(kernels.LAUNCHES)
    same = {k: torch.equal(restored[k].cpu(), v.cpu()) for k, v in saved_ring.arrays.items()}
    same["ratio"] = restored.get("ratio") == saved["ratio"]
    del saved_ring, restored
    if not all(same.values()) or not {"key", "pos", "valid"} <= set(same):
        raise AssertionError(f"the dreamer_sebulba resume restored a different ring or Ratio: {same}")
    if resumed["gradient_steps"] == 0 or resumed["start_iter"] != steps // int(cfg.env.num_envs) + 1:
        raise AssertionError(f"dreamer_sebulba resume: start {resumed['start_iter']}, {resumed['gradient_steps']} steps")
    _sebulba_launch_check("dreamer_sebulba resume", resumed, resume_launches, T, H)
    out["resume"] = {"start_iter": resumed["start_iter"], "policy_steps": resumed["policy_steps"],
                     "gradient_steps": resumed["gradient_steps"], "act_steps": resumed["act_steps"],
                     "launches": resume_launches, "restored_equal": sorted(same)}
    log("dreamer_sebulba resume: " + json.dumps(out["resume"]))

    kernels.reset_launches()
    evaluation = cli.evaluation([f"checkpoint_path={summary['checkpoint']}"])
    eval_launches = dict(kernels.LAUNCHES)
    _async_launch_check("dreamer_sebulba evaluation", eval_launches, gru_gates=evaluation["steps"])
    out["evaluation"] = {**evaluation, "launches": eval_launches}
    rng = np.random.default_rng(70)
    frames = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(N_STEPS)]
    served = _serve_with([f"checkpoint_path={summary['checkpoint']}", "serve.session.buckets=[1,8]"],
                         _one_session_client(frames))
    engine = served["health"]["engine"]
    dispatches = engine["dispatches"] + engine["warmup_dispatches"]
    if (len(served["actions"]) != N_STEPS or any(not (0 <= a[0][0] < 18) for a in served["actions"])
            or served["launches"]["gru_gates"] != dispatches):
        raise AssertionError(f"dreamer_sebulba served session: {served['actions']}, {served['launches']}, {engine}")
    out["serve"] = {"steps": N_STEPS, "launches": served["launches"], "dispatches": dispatches}
    out["dispatch_alone"] = _sebulba_dispatch_alone(summary["checkpoint"], grad_max)
    out["act_step"] = _profile_sebulba_act_step(summary["checkpoint"])
    log("dreamer_sebulba evaluation, serving, a dispatch alone, an act step: " + json.dumps(
        {k: out[k] for k in ("evaluation", "serve", "dispatch_alone", "act_step")}))
    return out


# -- 60-63. the hybrid host player and the profiler ---------------------------------

HYBRID_TRAIN_EVERY = 16  # the preset's algo.hybrid_player.train_every
HYBRID_LEARNING_STARTS = 128
HYBRID_TOTAL = 160  # grants 1 a step from 128: bursts of 16 at 143 and 159, finish's 1 at the end
HYBRID_RESUME_TOTAL = 216  # the restored Ratio grants again past 195: a burst of 16 and finish's 5
HYBRID_SAC_TOTAL = 1024  # 256 iterations of 4 envs: 3 bursts of 256 grants and finish's tail
HYBRID_SAC_RESUME_TOTAL = 1792
PROFILER_ITERATIONS = 3  # the trace's window: iterations 1 and 2


def _params_rule(name: str, card: dict, cpu: dict, lr: float, steps: int, share: float) -> dict:
    """Parameters after ``steps`` Adam steps on the two machines: every
    element within 2 lr a step (Adam moves an element whose gradient is near
    0 by up to lr either way) plus 1e-6, and ``share`` of them within 1e-6."""
    diffs = torch.cat([(card[k] - cpu[k]).abs().reshape(-1) for k in cpu])
    out = {"max_abs_err": float(diffs.max()), "share_within_1e-6": float((diffs <= 1e-6).float().mean())}
    if out["max_abs_err"] > 2 * lr * steps + 1e-6 or out["share_within_1e-6"] < share:
        raise AssertionError(f"{name} after the burst on the card differs from the CPU: {out}")
    return out


def hybrid_burst_card_phase(card: str = "cuda") -> dict:
    """60. One DreamerV3-S hybrid burst (full width, B 4 x T 16, H 15; the
    harness's spec on 1 env at train_every 16: grad_chunk 16 and the 19-row
    bucket) on the card, TF32 off, from seeded weights, a seeded ring and
    injected draws: 18 staged rows appended by one ``ragged_ring_scatter_keys``
    launch, bit-equal to the plain scatter on the CPU, then the 16 granted
    steps. Each step is held against the CPU from the card's own state just
    before it, on the card's own gradients: the CPU's Adam (one twin per
    optimizer, loaded with the card's parameters and moments) takes the card's
    gradients, and the card's parameters after the step agree with it by the
    resident dispatch's rule, 99.9 % within 1e-6 and every element within
    2 lr + 1e-6 (Adam moves an element with a near-zero gradient by up to lr
    either way). The first step's gradients, from the shared initial state,
    within 1e-3 of the CPU's as whole vectors. Then the host snapshot: a pull after the burst's event equals the
    card's parameters rounded to bf16, bit for bit, and a snapshot packed
    before a second burst is unchanged by it. Reports an unheld burst's host
    time and its span on the card, and the blocking pull's ms and bytes."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_sebulba import player_subset
    from sheeprl_tpu_torch.data.ring import effective_stage_buckets, make_blob_layouts, pack_burst_blob
    from sheeprl_tpu_torch.utils.burst import HostSnapshot, dreamer_ring_keys, dreamer_stage_sizes

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B, C, E, G = 16, 4, 512, 1, HYBRID_TRAIN_EVERY
    cfg = _run_cfg([f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}"])
    keys = dreamer_ring_keys(cfg.spaces.obs, ["rgb"], [], [18], with_is_first=True)
    stage_max, stage_buckets = dreamer_stage_sizes(HYBRID_TRAIN_EVERY, E, C)
    buckets = effective_stage_buckets(stage_buckets, stage_max)
    spec = {"capacity": C, "n_envs": E, "grad_chunk": G, "seq_len": T, "batch_size": B, "ring_keys": keys,
            "stage_buckets": buckets, "stage_max": stage_max}
    bucket, rows = buckets[0], 18
    rng = np.random.default_rng(60)
    ring = _resident_ring(rng, keys, C, E)
    fresh = _resident_ring(rng, keys, rows, E)
    staged = {k: np.zeros((bucket,) + v.shape[1:], v.dtype) for k, v in fresh.items()}
    for k, v in fresh.items():
        staged[k][:rows] = v
    mask = np.zeros((bucket, E), np.int32)
    mask[:rows] = 1
    layout = make_blob_layouts(keys, E, G, buckets)[bucket]
    gen = torch.Generator().manual_seed(61)
    draws = {"env": torch.zeros((G, B), dtype=torch.int64), "u": torch.rand((G, B), generator=gen),
             "noise": [draw_noise(cfg, T, B, [18], gen, "cpu") for _ in range(G)]}
    lrs = {"world": 1e-4, "actor": 8e-5, "critic": 8e-5}
    twins = make_optimizers(cfg, *build_training_agent(cfg, "cpu")[:3])  # the CPU's Adams, fed the card's state

    def on(dev, noise):
        return {"posterior": noise["posterior"].to(dev), "imagined_prior": noise["imagined_prior"].to(dev),
                "actions": [u.to(dev) for u in noise["actions"]]}

    steps = {name: [] for name in lrs}  # per step: (max abs err, share within 1e-6) of the card's Adam step

    def held(name, opt):
        """The card's step of optimizer ``name`` against the CPU twin's on the
        card's own gradients and pre-step state."""
        def step(g):
            twin = twins[name]
            with torch.no_grad():
                for t, p in zip(twin.params, opt.params):
                    t.copy_(p.detach().cpu())
            twin.load_state_dict(copy.deepcopy(opt.state_dict()))
            twin.step([x.detach().cpu() for x in g])
            out = opt_steps[name](g)
            diffs = torch.cat([(p.detach().cpu() - t.detach()).abs().reshape(-1) for p, t in zip(opt.params, twin.params)])
            steps[name].append((float(diffs.max()), float((diffs <= 1e-6).float().mean())))
            return out
        return step

    results, opt_steps = {}, {}
    for role, dev in (("ref", "cpu"), ("card", card)):
        modules = build_training_agent(cfg, dev)
        optimizers = make_optimizers(cfg, *modules[:3])
        first_grads = {}
        for name, opt in optimizers.items():  # the gradients of the first step, from the shared state
            inner = held(name, opt) if role == "card" else opt.step
            if role == "card":
                opt_steps[name] = opt.step

            def hooked(g, step=inner, name=name):
                if name not in first_grads:
                    first_grads[name] = torch.cat([x.detach().reshape(-1).cpu() for x in g])
                return step(g)
            opt.step = hooked
        burst = make_train_step(*modules, optimizers, cfg, ring=spec)
        rb = {k: torch.from_numpy(v.copy()).to(dev) for k, v in ring.items()}
        granted = G if role == "card" else 1  # the CPU's reference: the append and the first step
        values = {**staged, "__mask__": mask, "__pos__": np.array([300], np.int32),
                  "__valid_n__": np.array([300], np.int32),
                  "__validmask__": (np.arange(G) < granted).astype(np.float32)}
        dev_draws = {"env": draws["env"].to(dev), "u": draws["u"].to(dev), "noise": [on(dev, n) for n in draws["noise"]]}
        before = kernels.LAUNCHES["ragged_ring_scatter"]
        t0 = time.perf_counter()
        (moments, cum), rb, metrics = burst((init_moments(dev), 0), rb,
                                            pack_burst_blob(layout, values, pin_memory=dev != "cpu"), None, dev_draws)
        results[role] = {
            "modules": modules, "optimizers": optimizers, "burst": burst, "rb": {k: v.cpu() for k, v in rb.items()},
            "metrics": metrics.cpu(),
            "grads": first_grads, "host_s": time.perf_counter() - t0, "cum": int(cum),
            "launched": kernels.LAUNCHES["ragged_ring_scatter"] - before,
        }
    cpu, crd = results["ref"], results["card"]
    if card == "cuda" and (crd["launched"] != 1 or cpu["launched"] != 0):
        raise AssertionError(f"scatter launches: card {crd['launched']}, CPU {cpu['launched']}")
    for k in keys:
        if not torch.equal(crd["rb"][k], cpu["rb"][k]):
            raise AssertionError(f"the ring's '{k}' after the burst's append differs from the plain scatter's")
    if crd["cum"] != G or not torch.isfinite(crd["metrics"]).all():
        raise AssertionError(f"the card's burst took {crd['cum']} steps, losses {crd['metrics'].tolist()}")
    out = {"grad_chunk": G, "bucket": bucket, "cpu_first_step_s": cpu["host_s"], "held_burst_s": crd["host_s"],
           "first_step_grad_rel_err": {}, "adam_on_card_gradients": {}}
    for name in lrs:
        a, b = crd["grads"][name], cpu["grads"][name]
        rel = float((a - b).norm() / b.norm().clamp(min=1e-30))
        out["first_step_grad_rel_err"][name] = rel
        if rel > 1e-3:
            raise AssertionError(f"the first step's {name} gradient differs between the card and the CPU: {rel}")
        worst = {"max_abs_err": max(m for m, _ in steps[name]), "min_share_within_1e-6": min(sh for _, sh in steps[name]),
                 "steps": len(steps[name])}
        out["adam_on_card_gradients"][name] = worst
        if worst["steps"] != G or worst["max_abs_err"] > 2 * lrs[name] + 1e-6 or worst["min_share_within_1e-6"] < 0.999:
            raise AssertionError(f"the card's {name} Adam steps differ from the CPU's on the same gradients: {worst}")
    if card == "cuda":  # a second burst, unheld, timed: its enqueue on the host, its span on the card (events)
        for name, opt in crd["optimizers"].items():
            opt.step = opt_steps[name]
        again = {**staged, "__mask__": np.zeros_like(mask), "__pos__": np.array([300 + rows], np.int32),
                 "__valid_n__": np.array([300 + rows], np.int32), "__validmask__": np.ones(G, np.float32)}
        dev_draws = {"env": draws["env"].to(card), "u": draws["u"].to(card),
                     "noise": [on(card, n) for n in draws["noise"]]}
        rb = {k: v.to(card) for k, v in crd["rb"].items()}
        blob = pack_burst_blob(layout, again, pin_memory=True)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        crd["burst"]((init_moments(card), G), rb, blob, None, dev_draws)
        out["burst_host_s"] = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        out["burst_device_span_ms"] = start.elapsed_time(end)
    # the snapshot of the player's subset, on the card after the burst
    wm, actor = crd["modules"][0], crd["modules"][1]
    card_sub = player_subset(wm, actor)
    host_sub = copy.deepcopy(card_sub).to("cpu")
    card_t = [*card_sub.parameters(), *card_sub.buffers()]
    snap = HostSnapshot(card_t, [*host_sub.parameters(), *host_sub.buffers()], torch.bfloat16)
    pulls = []
    for _ in range(5):
        t0 = time.perf_counter()
        snap.pull()
        pulls.append(time.perf_counter() - t0)
    if not all(torch.equal(h, c.detach().cpu().to(torch.bfloat16).float())
               for h, c in zip([*host_sub.parameters(), *host_sub.buffers()], card_t)):
        raise AssertionError("the snapshot's pull is not the card's parameters rounded to bf16")
    before_second = [c.detach().cpu().clone() for c in card_t]
    if not snap.refresh_async(version=1):
        raise AssertionError("a refresh with no copy in flight was skipped")
    one = {**staged, "__mask__": np.zeros_like(mask), "__pos__": np.array([300 + rows], np.int32),
           "__valid_n__": np.array([300 + rows], np.int32), "__validmask__": np.eye(1, G, dtype=np.float32)[0]}
    crd["burst"]((init_moments(card), G), {k: v.to(card) for k, v in crd["rb"].items()},
                 pack_burst_blob(layout, one, pin_memory=card != "cpu"), None,
                 {"env": draws["env"][:1].to(card), "u": draws["u"][:1].to(card), "noise": [on(card, draws["noise"][0])]})
    deadline = time.monotonic() + 60
    while not snap.poll():
        if time.monotonic() > deadline:
            raise AssertionError("the snapshot's copy never landed")
        time.sleep(0.001)
    host_after = [*host_sub.parameters(), *host_sub.buffers()]
    if not all(torch.equal(h, b.to(torch.bfloat16).float()) for h, b in zip(host_after, before_second)):
        raise AssertionError("a snapshot packed before a burst changed with the burst's in-place updates")
    if all(torch.equal(b, c.detach().cpu()) for b, c in zip(before_second, card_t)):
        raise AssertionError("the second burst moved no player parameter")
    out["snapshot"] = {"bytes": snap.nbytes, "pull_ms": float(np.median(pulls) * 1e3),
                       "pull_ms_all": [p * 1e3 for p in pulls], "bf16_bit_equal": True, "isolated": True}
    log("hybrid burst (card vs CPU): " + json.dumps(out))
    return out


def _act_ms(summary: dict) -> dict:
    inside = [s * 1e3 for s, busy in summary["act_host_s"] if busy]
    outside = [s * 1e3 for s, busy in summary["act_host_s"] if not busy]
    med = lambda v: float(np.median(v)) if v else None  # noqa: E731
    return {"inside_burst_ms": med(inside), "outside_burst_ms": med(outside), "inside_n": len(inside),
            "outside_n": len(outside)}


def _hybrid_launch_check(summary: dict, launches: dict, T: int, H: int) -> dict:
    """A hybrid DreamerV3 run's exact counts: the trainer's steps launch the
    kernels, one scatter a flush, the card's test episode one GRU step each;
    the host player, on the CPU, launches none."""
    G = summary["gradient_steps"]
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update({
        "two_hot_symlog_loss_lse": 3 * G,
        "two_hot_symlog_loss_lse_bwd": 3 * G,
        "two_hot_symexp_decode": 3 * G,
        "gru_gates": G * (T + H) + (summary["test_steps"] or 0),
        "ragged_ring_scatter": summary["replay"]["Replay/flushes"],
    })
    if launches != want:
        raise AssertionError(f"hybrid launches {launches} != {want} for {G} gradient steps")
    return want


def hybrid_rssm_run_phase(workdir: str, card: str = "cuda") -> dict:
    """61. ``run preset=dreamer_v3_100k_atari_dummy`` at its default
    ``algo.hybrid_player.enabled=auto``, which is on on the card: the full
    recipe (B 16 x T 64, H 15), ``learning_starts`` 128, 160 steps: the host
    player on the CPU, bursts of 16 grants on the trainer thread (at 143 and
    159, finish's 1). The exact launch counts; every loss finite; the
    checkpoint's host buffer patched; a resume mirrors it into the ring and
    trains a burst. Reports env steps/s, the bursts' host seconds, the act
    step's host ms inside and outside a burst and the snapshot's age. (On
    the CPU, a rehearsal, ``auto`` is off: it is turned on.)"""
    extra = [] if card == "cuda" else ["fabric.accelerator=cpu", "algo.hybrid_player.enabled=true"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    s = cli.run([f"preset={RUN_PRESET}", f"algo.learning_starts={HYBRID_LEARNING_STARTS}",
                 f"algo.total_steps={HYBRID_TOTAL}", "checkpoint.every=0", "checkpoint.save_last=true",
                 "metric.log_level=0", f"log_root={workdir}"] + extra)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    cfg = load_config(find_run_config(s["checkpoint"]))
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    if not s["hybrid"] or s["resident"] or s["gradient_steps"] != HYBRID_TOTAL - HYBRID_LEARNING_STARTS + 1:
        raise AssertionError(f"hybrid run: hybrid={s['hybrid']}, {s['gradient_steps']} gradient steps")
    if s["bursts"] != 3 or s["grad_chunk"] != HYBRID_TRAIN_EVERY or not np.isfinite(np.asarray(s["metrics"])).all():
        raise AssertionError(f"hybrid run: {s['bursts']} bursts of {s['grad_chunk']}, losses {s['metrics']}")
    want = _hybrid_launch_check(s, launches, T, H) if card == "cuda" else None
    env = load_checkpoint(s["checkpoint"])["rb"]["envs"][0]
    if env["pos"] != HYBRID_TOTAL or env["buffer"]["truncated"][HYBRID_TOTAL - 1].item() != 1:
        raise AssertionError("the hybrid run's checkpoint holds no patched host buffer")
    kernels.reset_launches()
    r = cli.run([f"checkpoint.resume_from={s['checkpoint']}", f"algo.total_steps={HYBRID_RESUME_TOTAL}",
                 "algo.learning_starts=2", "algo.run_test=false", "metric.log_level=0", f"log_root={workdir}"] + extra)
    resume_launches = dict(kernels.LAUNCHES)
    if not r["hybrid"] or r["ring_restored"] != [[HYBRID_TOTAL], [HYBRID_TOTAL]] or r["bursts"] < 1:
        raise AssertionError(f"hybrid resume: ring {r['ring_restored']}, {r['bursts']} bursts")
    if card == "cuda":
        _hybrid_launch_check(r, resume_launches, T, H)
    # the coupled loop on the same steps, grants and card, for the comparison
    t0 = time.perf_counter()
    coupled = cli.run([f"preset={RUN_PRESET}", "algo.hybrid_player.enabled=false",
                       f"algo.learning_starts={HYBRID_LEARNING_STARTS}", f"algo.total_steps={HYBRID_TOTAL}",
                       "checkpoint.every=0", "checkpoint.save_last=false", "metric.log_level=0", "algo.run_test=false",
                       f"log_root={os.path.join(workdir, 'coupled')}"] + extra[:1])
    if coupled["hybrid"] or coupled["gradient_steps"] != s["gradient_steps"]:
        raise AssertionError(f"the coupled run took {coupled['gradient_steps']} gradient steps")
    out = {
        "coupled": {"env_steps_per_s": coupled["env_steps_per_s"], "loop_steps_per_s": coupled["loop_steps_per_s"],
                    "wall_s": time.perf_counter() - t0,
                    "train_host_s": float(sum(t for t, _ in coupled["train_host_s"]))},
        "launches": launches, "want": want, "gradient_steps": s["gradient_steps"], "bursts": s["bursts"],
        "player_steps": s["player_steps"], "test_steps": s["test_steps"], "wall_s": wall,
        "env_steps_per_s": s["env_steps_per_s"], "loop_steps_per_s": s["loop_steps_per_s"],
        "trained_burst_host_s": [t for t, trained in s["burst_host_s"] if trained],
        "burst_host_s": s["burst_host_s"], "flush_host_ms": float(np.median(s["flush_host_s"]) * 1e3),
        "act": _act_ms(s), "snapshot_age": s["snapshot_age"], "snapshot": s["snapshot"], "losses_last": s["metrics"][-1],
        "resume": {"launches": resume_launches, "gradient_steps": r["gradient_steps"], "bursts": r["bursts"],
                   "ring_restored": r["ring_restored"], "test_steps": 0},
    }
    log("hybrid DreamerV3 run: " + json.dumps({k: v for k, v in out.items() if k not in ("launches", "want")}))
    return out


def _sac_burst_accounting(cfg, iters: int) -> tuple:
    """JAX's SAC burst accounting for a fresh run of ``iters`` iterations:
    ``Ratio``'s grants from ``learning_starts``, a flush whenever a full
    chunk is queued or the staging rows are about to overflow, the tail at
    the end. Returns ``(grad_chunk, grants, trained bursts)``."""
    from sheeprl_tpu_torch.utils.utils import Ratio

    n_envs, train_every = int(cfg.env.num_envs), 64
    chunk = round(float(cfg.algo.replay_ratio) * n_envs * train_every)
    starts = int(cfg.algo.learning_starts) // n_envs
    stage_max = min(starts + 2 * train_every + 1, int(cfg.buffer.size) // n_envs)
    ratio, prefill = Ratio(float(cfg.algo.replay_ratio)), starts - int(starts > 0)
    staged = backlog = grants = trained = 0
    for it in range(1, iters + 2):
        if it <= iters:
            staged += 1
            if it >= starts:
                backlog += ratio(it * n_envs - prefill + n_envs)
        while (it > iters and (staged or backlog)) or backlog >= chunk or staged >= stage_max - 1:
            take = min(chunk, backlog)
            staged, backlog, grants, trained = 0, backlog - take, grants + take, trained + int(take > 0)
            if it <= iters and backlog < chunk:
                break
    return chunk, grants, trained


def hybrid_sac_run_phase(workdir: str, card: str = "cuda") -> dict:
    """62. SAC's hybrid path. One burst (full width, the preset's chunk of
    256 on 4 envs, 4 granted) on the card against the CPU from the same
    weights, ring and injected draws, TF32 off: the 64 staged rows appended
    with wrap-around bit-equal, the parameters by the train-step rule over 4
    steps. Then ``run preset=sac`` at ``auto`` on the card: bursts of 256
    grants on the trainer thread, the exact grant accounting, no kernel
    (``sumtree_sample`` 0: the burst samples uniformly), finite losses, a
    resume; env steps/s and the bursts' host seconds beside a coupled
    ``preset=sac`` run of the same length in the same call."""
    from sheeprl_tpu_torch.algos.sac.sac import make_burst_train_step
    from sheeprl_tpu_torch.data.ring import pack_burst_blob

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = preset("sac")
    C, E, G, granted, rows = 2048, 4, 256, 4, 64
    dims = {"observations": 3, "next_observations": 3, "actions": 1, "rewards": 1, "terminated": 1}
    rng = np.random.default_rng(62)
    ring = {k: rng.normal(size=(C, E, d)).astype(np.float32) for k, d in dims.items()}
    ring["terminated"] = (rng.random((C, E, 1)) < 0.01).astype(np.float32)
    stage_max = 2 * 64 + 26
    values = {k: np.zeros((stage_max, E, d), np.float32) for k, d in dims.items()}
    for k, d in dims.items():
        values[k][:rows] = rng.normal(size=(rows, E, d))
    valid = np.zeros(G, np.float32)
    valid[:granted] = 1.0
    values.update(__pos__=np.asarray(C - 20, np.int32), __count__=np.asarray(rows, np.int32),
                  __valid_n__=np.asarray(C, np.int32), __flags__=valid.copy(), __valid__=valid)
    gen = torch.Generator().manual_seed(63)
    B = int(cfg.algo.per_rank_batch_size)
    draws = {"pos": torch.randint(0, C, (granted, B), generator=gen), "env": torch.randint(0, E, (granted, B), generator=gen),
             "next": torch.randn((granted, B, 1), generator=gen), "actor": torch.randn((granted, B, 1), generator=gen)}
    results = {}
    for dev in ("cpu", card):
        agent, opts = _sac_parts(cfg, dev)
        burst, layout = make_burst_train_step(agent, opts, cfg, C, E, stage_max, G, dims)
        rb = {k: torch.from_numpy(v.copy()).to(dev) for k, v in ring.items()}
        t0 = time.perf_counter()
        losses = burst(rb, pack_burst_blob(layout, values, pin_memory=dev != "cpu"), None,
                       {k: v.to(dev) for k, v in draws.items()})
        losses = losses.cpu()
        results[dev] = {"rb": {k: v.cpu() for k, v in rb.items()}, "losses": losses, "s": time.perf_counter() - t0,
                        "params": {k: v.detach().cpu() for k, v in agent.state_dict().items()}}
    for k in dims:
        if not torch.equal(results[card]["rb"][k], results["cpu"]["rb"][k]):
            raise AssertionError(f"the SAC burst's append of '{k}' differs between the card and the CPU")
    torch.testing.assert_close(results[card]["losses"], results["cpu"]["losses"], rtol=1e-4, atol=1e-5)
    lr = max(float(cfg.algo.actor.optimizer.lr), float(cfg.algo.critic.optimizer.lr), float(cfg.algo.alpha.optimizer.lr))
    step_check = _params_rule("the SAC agent", results[card]["params"], results["cpu"]["params"], lr, granted, 0.99)

    extra = [] if card == "cuda" else ["fabric.accelerator=cpu"]
    runs = {}
    for name, hybrid in (("hybrid", "auto" if card == "cuda" else "true"), ("coupled", "false")):
        kernels.reset_launches()
        t0 = time.perf_counter()
        s = cli.run(["preset=sac", f"algo.hybrid_player.enabled={hybrid}", f"algo.total_steps={HYBRID_SAC_TOTAL}",
                     "checkpoint.every=0", "checkpoint.save_last=true", "metric.log_level=0", "algo.run_test=false",
                     f"log_root={os.path.join(workdir, name)}"] + extra)
        s["wall_s"], s["launches"] = time.perf_counter() - t0, dict(kernels.LAUNCHES)
        runs[name] = s
    s, coupled = runs["hybrid"], runs["coupled"]
    chunk, grants, trained = _sac_burst_accounting(load_config(find_run_config(s["checkpoint"])),
                                                   HYBRID_SAC_TOTAL // E)
    if not s["burst"] or s["grad_chunk"] != chunk or s["gradient_steps"] != grants or s["bursts"] != trained:
        raise AssertionError(f"hybrid SAC: burst={s['burst']} chunk {s['grad_chunk']} (want {chunk}), "
                             f"{s['gradient_steps']} steps (want {grants}), {s['bursts']} bursts (want {trained})")
    if coupled["burst"] or coupled["gradient_steps"] != grants or not np.isfinite(np.asarray(s["losses"])).all():
        raise AssertionError(f"coupled SAC took {coupled['gradient_steps']} steps; hybrid losses {s['losses']}")
    if card == "cuda":
        _zero_launch_check("the hybrid SAC run", s["launches"])
    kernels.reset_launches()
    r = cli.run([f"checkpoint.resume_from={s['checkpoint']}", f"algo.total_steps={HYBRID_SAC_RESUME_TOTAL}",
                 "metric.log_level=0", f"log_root={os.path.join(workdir, 'hybrid')}"] + extra)
    resume_launches = dict(kernels.LAUNCHES)
    if not r["burst"] or r["gradient_steps"] <= 0 or not np.isfinite(np.asarray(r["losses"])).all():
        raise AssertionError(f"hybrid SAC resume: burst={r['burst']}, {r['gradient_steps']} gradient steps")
    if card == "cuda":
        _zero_launch_check("the hybrid SAC resume", resume_launches)
    out = {
        "burst_vs_cpu": {"cpu_s": results["cpu"]["s"], "card_s": results[card]["s"], "params": step_check,
                         "ring_equal": True},
        "launches": s["launches"], "grad_chunk": chunk, "gradient_steps": grants, "bursts": trained,
        "wall_steps_per_s": HYBRID_SAC_TOTAL / s["wall_s"], "wall_s": s["wall_s"],
        "trained_burst_host_s": [t for t, trained in s["burst_host_s"] if trained],
        "act": _act_ms(s), "snapshot": s["snapshot"],
        "env_and_submit_steps_per_s": s["env_steps_per_s"],
        "coupled": {"env_steps_per_s": coupled["env_steps_per_s"], "wall_s": coupled["wall_s"],
                    "wall_steps_per_s": HYBRID_SAC_TOTAL / coupled["wall_s"],
                    "train_s": float(np.sum(coupled["train_s"])), "gradient_steps": coupled["gradient_steps"]},
        "resume": {"launches": resume_launches, "gradient_steps": r["gradient_steps"], "bursts": r["bursts"]},
    }
    log("hybrid SAC: " + json.dumps({k: v for k, v in out.items() if k not in ("launches",)}))
    return out


def profiler_card_phase(workdir: str, card: str = "cuda") -> dict:
    """63. ``metric.profiler``: a PPO run of PROFILER_ITERATIONS iterations
    with ``metric.profiler.enabled=true start_iter=1 num_iters=2`` writes a
    Chrome trace under ``<log_dir>/profiler`` that holds the card's kernel
    events, ``gae``'s once an iteration of the window among them; its launch
    counts equal the same run's without the profiler."""
    extra = [] if card == "cuda" else ["fabric.accelerator=cpu"]
    common = [f"preset={PPO_PRESET}", f"algo.total_steps={PROFILER_ITERATIONS * 512}", "metric.log_level=0",
              "algo.run_test=false", "checkpoint.every=0", "checkpoint.save_last=false"] + extra
    out = {}
    for name, flags in (("profiled", ["metric.profiler.enabled=true", "metric.profiler.start_iter=1",
                                      "metric.profiler.num_iters=2"]), ("plain", [])):
        kernels.reset_launches()
        t0 = time.perf_counter()
        s = cli.run(common + flags + [f"log_root={os.path.join(workdir, name)}"])
        out[name] = {"launches": dict(kernels.LAUNCHES), "wall_s": time.perf_counter() - t0, "trace": s["profiler"]}
    if out["profiled"]["launches"] != out["plain"]["launches"] or out["plain"]["trace"] is not None:
        raise AssertionError(f"profiled launches {out['profiled']['launches']} != {out['plain']['launches']}")
    trace = out["profiled"]["trace"]
    if not trace or not trace.endswith("trace_1_3.json"):
        raise AssertionError(f"the profiled run wrote no trace of iterations 1-2: {trace}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") == "kernel"]
    gae = [e for e in device if "gae" in str(e.get("name", ""))]
    out["trace_bytes"] = os.path.getsize(trace)
    out["kernel_events"], out["gae_events"] = len(device), len(gae)
    out["gae_kernel_us"] = [float(e.get("dur", 0.0)) for e in gae]
    if card == "cuda" and (len(gae) != 2 or out["profiled"]["launches"]["gae"] != PROFILER_ITERATIONS):
        raise AssertionError(f"the trace holds {len(gae)} gae kernel events of {len(device)} (want 2)")
    out["launches"] = out["profiled"]["launches"]
    log("profiler: " + json.dumps({k: v for k, v in out.items() if k not in ("profiled", "plain", "launches")}))
    return out



# -- lanes -------------------------------------------------------------------
#
# After the kernel phases (1-3, 11, 14, 21), which the main process runs
# alone so that their times see an idle card, the path phases run in LANES:
# one worker process each (``python3 chip_smoke.py --lane NAME --out FILE``),
# all at once on the one card. A lane runs its groups in order, each a chain
# of phases that hand on a checkpoint or a recording; its own kernels'
# launch counts are its process's, zeroed and read around each path as in a
# serial run. A worker pickles its results and seconds by phase to FILE; the
# main process fails if any worker fails, and stops the others then.


def _lane_rssm(timed) -> dict:
    cfg = preset("dreamer_v3_S_atari100k")
    r = {"model": timed("model", model_phase, cfg), "step": timed("step", step_phase, cfg),
         "train_step": timed("train_step", train_step_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["run"] = timed("run", run_phase, workdir)
        r["serve"] = timed("serve", serve_phase, r["run"]["checkpoint"])
        r["rssm_evaluation"] = timed("rssm_evaluation", rssm_evaluation_phase, r["run"]["checkpoint"])
    return r


def _lane_ppo(timed) -> dict:
    r = {"ppo_update": timed("ppo_update", ppo_update_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["ppo_run"] = run = timed("ppo_run", ppo_run_phase, workdir)
        r["ppo_serve"] = timed("ppo_serve", stateless_serve_phase, run["checkpoint"], "ppo")
        r["ppo_evaluation"] = timed("ppo_evaluation", stateless_evaluation_phase, run["checkpoint"], "ppo",
                                    PPO_RETURN_BAR, run["test_reward"])
    return r


def _lane_sac(timed) -> dict:
    r = {"sac_update": timed("sac_update", sac_update_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["sac_run"] = run = timed("sac_run", sac_run_phase, workdir)
        r["sac_serve"] = timed("sac_serve", stateless_serve_phase, run["checkpoint"], "sac")
        r["sac_evaluation"] = timed("sac_evaluation", stateless_evaluation_phase, run["checkpoint"], "sac",
                                    SAC_RETURN_BAR, run["test_reward"])
    return r


def _lane_resident(timed) -> dict:
    r = {"resident_dispatch": timed("resident_dispatch", resident_dispatch_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["resident_run"] = timed("resident_run", resident_run_phase, workdir)
    return r


def _lane_runtime(timed) -> dict:
    r = {}
    for name, fn in (("fault", fault_phase), ("rundir", rundir_phase), ("memmap", memmap_phase),
                     ("hotswap", hotswap_phase)):
        with tempfile.TemporaryDirectory() as workdir:
            r[name] = timed(name, fn, workdir)
    return r


def _lane_onpolicy(timed) -> dict:
    r = {"a2c_update": timed("a2c_update", a2c_update_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["a2c_run"] = timed("a2c_run", a2c_run_phase, workdir)
        r["ppo_recurrent_run"] = recurrent = timed("ppo_recurrent_run", ppo_recurrent_run_phase, workdir)
        r["ppo_recurrent_update"] = timed("ppo_recurrent_update", ppo_recurrent_update_phase, recurrent.pop("recorded"))
        r["ppo_recurrent_serve"] = timed("ppo_recurrent_serve", ppo_recurrent_serve_phase, recurrent["checkpoint"])
        r["ppo_continuous"] = timed("ppo_continuous", ppo_continuous_phase, workdir)
    return r


def _lane_continuous(timed) -> dict:
    r = {"continuous_step": timed("continuous_step", continuous_step_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["continuous_run"] = timed("continuous_run", continuous_run_phase, workdir)
        r["continuous_serve"] = timed("continuous_serve", continuous_serve_phase, r["continuous_run"]["checkpoint"])
    with tempfile.TemporaryDirectory() as workdir:
        r["continuous_ring"] = timed("continuous_ring", continuous_ring_phase, workdir)
    return r


def _lane_offpolicy(timed) -> dict:
    with tempfile.TemporaryDirectory() as workdir:
        return {name: timed(name, fn, workdir)
                for name, fn in (("droq", droq_phase), ("sac_ae", sac_ae_phase), ("sac_next_obs", sac_next_obs_phase))}


def _lane_explore(timed) -> dict:
    r = {"explore_step": timed("explore_step", explore_step_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["explore_run"] = timed("explore_run", explore_run_phase, workdir)
        r["finetune"] = timed("finetune", finetune_phase, workdir, r["explore_run"]["checkpoint"])
    return r


def _lane_classic(timed) -> dict:
    with tempfile.TemporaryDirectory() as workdir:
        return {"classic_ppo": timed("classic_ppo", classic_ppo_phase, workdir),
                "dry_runs": timed("dry_run", dry_run_phase, workdir)}


def _lane_v2(timed) -> dict:
    r = {"v2_step": timed("v2_step", v2_step_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["v2_run"] = timed("v2_run", v2_run_phase, workdir)
        r["v2_episode"] = timed("v2_episode", v2_episode_phase, workdir)
        r["p2e_dv2"] = timed("p2e_dv2", p2e_dv2_phase, workdir)
    return r


def _lane_v1(timed) -> dict:
    r = {"v1_step": timed("v1_step", v1_step_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["v1_run"] = timed("v1_run", v1_run_phase, workdir)
        r["p2e_dv1"] = timed("p2e_dv1", p2e_dv1_phase, workdir)
    return r


def _lane_anakin(timed) -> dict:
    r = {"anakin_iteration": timed("anakin_iteration", anakin_iteration_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["anakin_run"] = timed("anakin_run", anakin_run_phase, workdir)
    return r


def _lane_population(timed) -> dict:
    with tempfile.TemporaryDirectory() as workdir:
        return {"population_run": timed("population_run", population_run_phase, workdir)}


def _lane_bf16(timed) -> dict:
    return {"bf16_families": timed("bf16_families", bf16_families_phase)}


def _lane_pipeline(timed) -> dict:
    return {"pipeline_card": timed("pipeline_card", pipeline_card_phase)}


def _lane_async_ppo(timed) -> dict:
    with tempfile.TemporaryDirectory() as workdir:
        return {"ppo_sebulba_run": timed("ppo_sebulba_run", ppo_sebulba_run_phase, workdir),
                "ppo_decoupled_run": timed("ppo_decoupled_run", ppo_decoupled_run_phase, workdir)}


def _lane_async_sac(timed) -> dict:
    with tempfile.TemporaryDirectory() as workdir:
        return {"sac_sebulba_per_run": timed("sac_sebulba_per_run", sac_sebulba_per_run_phase, workdir),
                "sac_decoupled_run": timed("sac_decoupled_run", sac_decoupled_run_phase, workdir)}


def _lane_hybrid(timed) -> dict:
    r = {"hybrid_burst_card": timed("hybrid_burst_card", hybrid_burst_card_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["hybrid_rssm_run"] = timed("hybrid_rssm_run", hybrid_rssm_run_phase, workdir)
        r["hybrid_sac_run"] = timed("hybrid_sac_run", hybrid_sac_run_phase, workdir)
        r["profiler_card"] = timed("profiler_card", profiler_card_phase, workdir)
    return r


def _lane_sebulba_rssm(timed) -> dict:
    r = {"rssm_sebulba_card": timed("rssm_sebulba_card", rssm_sebulba_card_phase)}
    with tempfile.TemporaryDirectory() as workdir:
        r["rssm_sebulba_run"] = timed("rssm_sebulba_run", rssm_sebulba_run_phase, workdir)
    return r


#: each lane's groups, run in order by one worker; balanced on a serial
#: run's seconds by phase (the SAC run alone is ~200 s); the async PPO runs
#: in the Anakin lane, the async SAC runs in the SAC lane, the pipeline's
#: card checks (a ~25 s rebuild of gae among them) and the Anakin population
#: in the PPO/DreamerV3 lane; dreamer_sebulba (58-59), then the hybrid player
#: and the profiler (60-63), in a fifth lane, as every other lane was near ~360 s
LANES = {
    "sac": (_lane_sac, _lane_classic, _lane_bf16, _lane_async_sac),
    "anakin": (_lane_anakin, _lane_onpolicy, _lane_async_ppo),
    "ppo_rssm": (_lane_ppo, _lane_rssm, _lane_resident, _lane_explore, _lane_pipeline, _lane_population),
    "families": (_lane_runtime, _lane_continuous, _lane_offpolicy, _lane_v2, _lane_v1),
    "sebulba_rssm": (_lane_sebulba_rssm, _lane_hybrid),
}
#: torch threads of a lane: the first four split the host's cores as they did
#: alone; the dreamer_sebulba lane's learner and actors mostly launch kernels
#: under the GIL, so it takes one, and runs the hybrid player's phases (60-63)
#: after them: a sixth lane of their own slowed the others by 12-26 % on 8 cores
LANE_THREADS = {"sebulba_rssm": 1}
_LANE_TAG = ""


def _timer(phase_s: dict):
    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        return out
    return timed


def _exit_with_parent() -> None:
    """A worker ends itself when the process that started it is gone."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(2.0)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def lane_main(name: str, out: str) -> int:
    global _LANE_TAG
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card", file=sys.stderr)
        return 1
    _exit_with_parent()
    _LANE_TAG = f"[{name}] "
    # the CPU's cores shared between the lanes; TF32 off, as every
    # card-vs-CPU phase sets it
    torch.set_num_threads(LANE_THREADS.get(name, max(1, len(os.sched_getaffinity(0)) // 4)))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()  # loads what the main process built
    phase_s, results = {}, {}
    timed = _timer(phase_s)
    for group in LANES[name]:
        results.update(group(timed))
    with open(out, "wb") as f:
        pickle.dump({"results": results, "phase_s": phase_s}, f)
    return 0


def run_lanes(phase_s: dict) -> dict:
    """Every lane's worker at once; their results merged. Fails, after
    stopping the others, as soon as one worker fails."""
    results = {}
    torch.cuda.empty_cache()  # the kernel phases' cached blocks, for the workers
    with tempfile.TemporaryDirectory() as tmp:
        procs, started = {}, {}
        try:
            for name in LANES:
                out = os.path.join(tmp, f"{name}.pkl")
                procs[name] = (subprocess.Popen([sys.executable, os.path.abspath(__file__), "--lane", name, "--out", out]),
                               out)
                started[name] = time.perf_counter()
            pending = set(procs)
            while pending:
                time.sleep(0.5)
                for name in sorted(pending):
                    rc = procs[name][0].poll()
                    if rc is None:
                        continue
                    pending.discard(name)
                    if rc != 0:
                        raise RuntimeError(f"lane {name} failed (exit {rc})")
                    phase_s[f"lane_{name}"] = round(time.perf_counter() - started[name], 1)
                    with open(procs[name][1], "rb") as f:
                        done = pickle.load(f)
                    results.update(done["results"])
                    phase_s.update(done["phase_s"])
                    log(f"lane {name} done in {phase_s[f'lane_{name}']} s")
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return results


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--lane" and sys.argv[3] == "--out":
        return lane_main(sys.argv[2], sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_s = {}
    timed = _timer(phase_s)

    card = timed("device", device_phase)
    chase_lib = timed("build", build_phase)
    floor = timed("floor", launch_floor_ms, str(chase_lib))
    gru = timed("gru_gates", gru_gates_phase, 16)
    two_hot = timed("two_hot", two_hot_phase)
    two_hot += timed("two_hot_lse", two_hot_lse_phase)
    gae_row = timed("gae", gae_phase)
    sumtree_row = timed("sumtree", sumtree_phase, str(chase_lib))
    scatter_row = timed("ring_scatter", scatter_phase)
    nonfinite = timed("nonfinite", nonfinite_phase)
    R = timed("lanes", run_lanes, phase_s)
    run, resident_run, fault, rundir, memmap = R["run"], R["resident_run"], R["fault"], R["rundir"], R["memmap"]
    ppo_run, sac_run, a2c_run, recurrent_run = R["ppo_run"], R["sac_run"], R["a2c_run"], R["ppo_recurrent_run"]
    recurrent_serve, continuous, continuous_run = R["ppo_recurrent_serve"], R["ppo_continuous"], R["continuous_run"]
    droq, sac_ae, explore, finetune = R["droq"], R["sac_ae"], R["explore_run"], R["finetune"]
    v2_run, v2_episode, p2e_dv2, v1_run, p2e_dv1 = R["v2_run"], R["v2_episode"], R["p2e_dv2"], R["v1_run"], R["p2e_dv1"]
    anakin_run, population = R["anakin_run"], R["population_run"]
    paths = {"run": run, "run_resume": run["resume"], "serve": R["serve"], "evaluation": R["rssm_evaluation"],
             "ppo_run": ppo_run, "ppo_serve": R["ppo_serve"], "ppo_evaluation": R["ppo_evaluation"], "sac_run": sac_run,
             "sac_serve": R["sac_serve"], "sac_evaluation": R["sac_evaluation"], "resident_run": resident_run,
             "resident_resume": resident_run["resume"],
             "fault_ppo_skip": fault["ppo"]["skip"], "fault_ppo_rollback": fault["ppo"]["rollback"],
             "fault_ppo_resume_latest": fault["ppo"]["resume_latest"], "fault_sac_dispatch": fault["sac"],
             "fault_rssm_step": fault["rssm"], "rundir": rundir, "rundir_rollback": {"launches": rundir["launches_b"]},
             "rundir_resume": {"launches": rundir["launches_c"]}, "memmap": memmap,
             "memmap_off": {"launches": memmap["launches_off"]}, "memmap_resume": {"launches": memmap["resume_launches"]},
             "hotswap": R["hotswap"], "a2c_run": a2c_run, "a2c_resume": a2c_run["resume"],
             "a2c_evaluation": a2c_run["evaluation"], "ppo_recurrent_run": recurrent_run,
             "ppo_recurrent_resume": recurrent_run["resume"], "ppo_recurrent_serve": recurrent_serve,
             "ppo_recurrent_evaluation": recurrent_serve["evaluation"], "ppo_continuous_run": continuous,
             "ppo_continuous_serve": continuous["serve"], "ppo_continuous_evaluation": continuous["evaluation"],
             "dreamer_continuous_run": continuous_run, "dreamer_continuous_resume": continuous_run["resume"],
             "dreamer_continuous_serve": R["continuous_serve"], "dreamer_decoupled_ring": R["continuous_ring"],
             "dreamer_decoupled_ring_resume": R["continuous_ring"]["resume"], "droq_run": droq,
             "droq_resume": droq["resume"], "droq_evaluation": droq["evaluation"], "sac_ae_run": sac_ae,
             "sac_ae_resume": sac_ae["resume"], "sac_ae_evaluation": sac_ae["evaluation"],
             "sac_next_obs_run": R["sac_next_obs"], "explore_run": explore, "explore_resume": explore["resume"],
             "explore_evaluation": explore["evaluation"], "finetune_run": finetune,
             "finetune_evaluation": finetune["evaluation"],
             **{f"ppo_{env_id}": run for env_id, run in R["classic_ppo"].items()},
             **{f"dry_run_{name}": run for name, run in R["dry_runs"].items()},
             "v2_run": v2_run, "v2_resume": v2_run["resume"], "v2_evaluation": v2_run["evaluation"],
             "v2_episode_run": v2_episode, "v2_episode_resume": v2_episode["resume"],
             "p2e_dv2_exploration": p2e_dv2["exploration"],
             "p2e_dv2_exploration_evaluation": p2e_dv2["exploration"]["evaluation"],
             "p2e_dv2_finetuning": p2e_dv2["finetuning"],
             "p2e_dv2_finetuning_evaluation": p2e_dv2["finetuning"]["evaluation"],
             "v1_step": R["v1_step"], "v1_run": v1_run, "v1_resume": v1_run["resume"],
             "v1_evaluation": v1_run["evaluation"], "v1_dry_run": v1_run["dry_run"],
             "p2e_dv1_exploration": p2e_dv1["exploration"],
             "p2e_dv1_exploration_evaluation": p2e_dv1["exploration"]["evaluation"],
             "p2e_dv1_finetuning": p2e_dv1["finetuning"],
             "p2e_dv1_finetuning_evaluation": p2e_dv1["finetuning"]["evaluation"],
             "anakin_run": anakin_run, "anakin_resume": anakin_run["resume"], "population_run": population,
             "population_resume": population["resume"], "population_evaluation": population["evaluation"],
             "anakin_one_member_single": {"launches": population["one_member"]["launches_single"]},
             "anakin_one_member_population": {"launches": population["one_member"]["launches_population"]},
             "ppo_sebulba": R["ppo_sebulba_run"], "ppo_sebulba_resume": R["ppo_sebulba_run"]["resume"],
             "ppo_sebulba_evaluation": R["ppo_sebulba_run"]["evaluation"], "ppo_decoupled": R["ppo_decoupled_run"],
             "ppo_decoupled_resume": R["ppo_decoupled_run"]["resume"], "sac_sebulba_per": R["sac_sebulba_per_run"],
             "sac_sebulba_per_resume": R["sac_sebulba_per_run"]["resume"], "sac_decoupled": R["sac_decoupled_run"],
             "sac_decoupled_resume": R["sac_decoupled_run"]["resume"], "dreamer_sebulba": R["rssm_sebulba_run"],
             "dreamer_sebulba_resume": R["rssm_sebulba_run"]["resume"],
             "dreamer_sebulba_evaluation": R["rssm_sebulba_run"]["evaluation"],
             "dreamer_sebulba_serve": R["rssm_sebulba_run"]["serve"]}
    hybrid, hybrid_sac, profiled = R["hybrid_rssm_run"], R["hybrid_sac_run"], R["profiler_card"]
    paths.update({"hybrid_rssm": hybrid, "hybrid_rssm_resume": hybrid["resume"], "hybrid_sac": hybrid_sac,
                  "hybrid_sac_resume": hybrid_sac["resume"], "profiler_ppo": profiled})
    rows = [gru] + two_hot + [gae_row, sumtree_row, scatter_row]
    for row in rows:
        row["launches_by_path"] = {name: path["launches"][row["name"]] for name, path in paths.items()}
        row["floor_ms"] = floor  # an empty kernel's time, timed as the row's ms
        if row["name"] in nonfinite:
            row["nonfinite_outputs"] = nonfinite[row["name"]]["nonfinite_outputs"]
    # the test episodes inside the run paths: one GRU step each, counted exactly there
    gru["launches_by_path"].update(run_test=run["test_steps"], run_resume_test=run["resume"]["test_steps"],
                                   resident_test=resident_run["test_steps"],
                                   resident_resume_test=resident_run["resume"]["test_steps"],
                                   dreamer_continuous_test=continuous_run["test_steps"],
                                   explore_test=explore["test_steps"], finetune_test=finetune["test_steps"],
                                   v2_test=v2_run["test_steps"], p2e_dv2_exploration_test=p2e_dv2["exploration"]["test_steps"],
                                   p2e_dv2_finetuning_test=p2e_dv2["finetuning"]["test_steps"],
                                   dreamer_sebulba_test=R["rssm_sebulba_run"]["test_steps"],
                                   hybrid_rssm_test=hybrid["test_steps"],
                                   dreamer_sebulba_act_steps=R["rssm_sebulba_run"]["act_steps"],
                                   dreamer_sebulba_resume_act_steps=R["rssm_sebulba_run"]["resume"]["act_steps"])
    gru["eval_shape"]["floor_ms"] = floor
    for row in [gru] + two_hot:
        row["launches"] = run["launches"][row["name"]]
    scatter_row["launches"] = resident_run["launches"]["ragged_ring_scatter"]
    gae_row["launches"] = ppo_run["launches"]["gae"]
    gae_row["launches_by_path"]["ppo_resume"] = ppo_run["resume"]["launches"]["gae"]
    for name, path in (("a2c", a2c_run), ("ppo_recurrent", recurrent_run), ("ppo_continuous", continuous)):
        gae_row["paths"][name]["launches"] = path["launches"]["gae"]
    gae_row["paths"]["ppo"]["launches"] = ppo_run["launches"]["gae"]
    gae_row["paths"]["ppo_anakin"] = {"launches": anakin_run["launches"]["gae"], "iterations": anakin_run["iterations"]}
    gae_row["per_member"]["launches"] = population["launches"]["gae"]
    gae_row["per_member"]["iterations"] = population["iterations"]
    sumtree_row["launches"] = sac_run["launches"]["sumtree_sample"]
    sumtree_row["launches_by_path"]["sac_resume"] = sac_run["resume"]["launches"]["sumtree_sample"]
    # the async paths: gae once per Sebulba item trained on or in flight at the stop, once per
    # decoupled iteration; sumtree_sample once per Sebulba gradient step
    seb = R["ppo_sebulba_run"]
    gae_row["paths"]["ppo_sebulba"] = {"launches": seb["launches"]["gae"], "items": seb["iterations"],
                                       "in_flight_at_shutdown": seb["items_in_flight_at_shutdown"]}
    gae_row["paths"]["ppo_decoupled"] = {"launches": R["ppo_decoupled_run"]["launches"]["gae"],
                                         "iterations": R["ppo_decoupled_run"]["iterations"]}
    sumtree_row["paths"] = {"sac_sebulba_per": {"launches": R["sac_sebulba_per_run"]["launches"]["sumtree_sample"],
                                                "gradient_steps": R["sac_sebulba_per_run"]["gradient_steps"]}}
    # dreamer_sebulba: one scatter per committed blob, at col_offset 0 and 4
    seb_rssm = R["rssm_sebulba_run"]
    scatter_row["paths"] = {"dreamer_sebulba": {"launches": seb_rssm["launches"]["ragged_ring_scatter"],
                                                "blobs": seb_rssm["replay"]["Replay/flushes"]}}
    rows.append(_gru_bf16_kernel_row(gru, floor, continuous_run, R["continuous_serve"], R["continuous_ring"]))
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s; seconds by phase: {json.dumps(phase_s)}")
    print(json.dumps({"nonfinite": nonfinite, **R}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
