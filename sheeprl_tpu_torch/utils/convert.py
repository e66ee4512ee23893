"""Carry weights across from the JAX package: flax parameter trees, held as
numpy arrays, to the port's ``state_dict``s; and a JAX sequence-ring
snapshot to the port's (:func:`sequence_ring_from_jax`); a JAX host
``EnvIndependentReplayBuffer`` to the port's buffer state
(:func:`host_env_buffer_from_jax`).

The port's modules keep the flax submodule names, so a leaf's path is its
``state_dict`` key once the ``params`` collection level is dropped. Leaves
change by name:

- Dense ``kernel`` ``(in, out)`` -> Linear ``weight`` ``(out, in)``;
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW;
- ConvTranspose ``kernel`` (a kernel under a ``ConvTranspose_0`` module) ->
  ConvTranspose2d ``weight`` ``(in, out, kh, kw)``, spatially flipped: flax
  applies its kernel to the dilated input unflipped, torch applies its
  weight flipped, so the layout is ``kernel[::-1, ::-1].transpose(2, 3, 0, 1)``;
- LayerNorm ``scale`` -> ``weight``; ``bias`` stays ``bias``;
- ``initial_recurrent_state`` is copied as it is.

NatureCNN's ``fc`` rows need no permutation: flax flattens the NHWC conv
output in (H, W, C) order, and the port's ``NatureCNN`` permutes to NHWC
before it flattens, so the rows mean the same features on both sides.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.replay.device_buffer import DeviceReplayState

__all__ = [
    "flax_to_state_dict",
    "dreamer_v3_state_from_jax",
    "ppo_state_from_jax",
    "ppo_population_state_from_jax",
    "a2c_state_from_jax",
    "ppo_recurrent_state_from_jax",
    "sac_state_from_jax",
    "sac_ae_state_from_jax",
    "p2e_dv3_state_from_jax",
    "dreamer_v2_state_from_jax",
    "p2e_dv2_state_from_jax",
    "dreamer_v1_state_from_jax",
    "p2e_dv1_state_from_jax",
    "episode_buffer_from_jax",
    "sequence_ring_from_jax",
    "host_env_buffer_from_jax",
]

#: the flax module name of a transposed convolution's layer (the JAX
#: package's ``_ConvTranspose`` wraps an unnamed ``nn.ConvTranspose``)
CONV_TRANSPOSE = "ConvTranspose_0"


def _leaf(name: str, value: Any, module: str) -> "tuple[str, torch.Tensor]":
    a = np.asarray(value)
    if name == "kernel":
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 4 and module == CONV_TRANSPOSE:
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {a.ndim} has no torch layout here")
        name = "weight"
    elif name == "scale":
        name = "weight"
    return name, torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def flax_to_state_dict(tree: Mapping[str, Any], prefix: str = "", module: str = "") -> Dict[str, torch.Tensor]:
    """Flatten one flax variable tree (with or without its ``params``
    level) into ``state_dict`` entries under ``prefix``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(flax_to_state_dict(value, f"{prefix}{key}.", key))
        else:
            name, tensor = _leaf(key, value, module)
            out[f"{prefix}{name}"] = tensor
    return out


def dreamer_v3_state_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"world_model", "actor", "critic", "target_critic"}`` as the JAX
    ``build_agent`` returns them (numpy trees; the critics may be absent) ->
    the port's checkpoint state, one ``state_dict`` per present key. The
    whole world model crosses: encoder, RSSM (a decoupled representation
    model's narrower input as it is), decoders, reward and continue heads;
    the actor's heads, discrete or the continuous ``head_0`` of width ``2 *
    sum(actions_dim)``, as any Dense."""
    wm = params["world_model"]
    world_model: Dict[str, torch.Tensor] = {}
    for name, tree in wm.items():
        if name == "initial_recurrent_state":
            world_model[name] = torch.from_numpy(np.array(tree, dtype=np.float32))
        else:
            world_model.update(flax_to_state_dict(tree, f"{name}."))
    state = {"world_model": world_model}
    for name in ("actor", "critic", "target_critic"):
        if name in params:
            state[name] = flax_to_state_dict(params[name])
    return state


#: the PPO agent's encoders: children of the flax agent (its ``MultiEncoder``
#: holds no parameters), under ``feature_extractor`` in the port
PPO_ENCODERS = ("cnn_encoder", "mlp_encoder")


def ppo_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ``PPOAgent`` tree (numpy leaves, with or without its
    ``params`` level) -> the port's ``PPOAgent`` ``state_dict``: Dense
    kernels transposed, Conv kernels HWIO -> OIHW, the encoders nested
    under ``feature_extractor``. A continuous agent's ``actor_head_0``
    (``[mean, log_std]``, width ``2 * sum(actions_dim)``) carries over as
    any Dense does."""
    if set(params) == {"params"}:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for name, tree in params.items():
        prefix = f"feature_extractor.{name}." if name in PPO_ENCODERS else f"{name}."
        state.update(flax_to_state_dict(tree, prefix))
    return state


def ppo_population_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A member-stacked flax ``PPOAgent`` tree (every leaf ``(P, ...)``, as
    the JAX population checkpoints it) -> the port's population ``agent``:
    the ``PPOAgent`` ``state_dict`` keys, each tensor ``(P, ...)``, member
    ``m`` the conversion of flax member ``m``."""
    if set(params) == {"params"}:
        params = params["params"]
    leaves = []

    def collect(node):
        for v in node.values():
            if isinstance(v, Mapping):
                collect(v)
            else:
                leaves.append(np.asarray(v))

    collect(params)
    members = {int(leaf.shape[0]) for leaf in leaves}
    if len(members) != 1:
        raise ValueError(f"a member-stacked tree has one leading size, got {sorted(members)}")

    def member(node, m):
        return {k: member(v, m) if isinstance(v, Mapping) else np.asarray(v)[m] for k, v in node.items()}

    states = [ppo_state_from_jax(member(params, m)) for m in range(members.pop())]
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


#: the A2C agent is the PPO agent (the JAX package's ``A2CAgent = PPOAgent``)
a2c_state_from_jax = ppo_state_from_jax

#: flax ``OptimizedLSTMCell`` gates, in torch's ``nn.LSTM`` order
LSTM_GATES = ("i", "f", "g", "o")


def _lstm_state(tree: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """flax's ``lstm/{ii,if,ig,io}/kernel`` (input, no bias) and
    ``lstm/{hi,hf,hg,ho}/{kernel,bias}`` -> ``nn.LSTM``'s ``weight_ih_l0``
    and ``weight_hh_l0`` (the gates' transposed kernels stacked in i, f, g,
    o order), ``bias_hh_l0`` and a zero ``bias_ih_l0``."""

    def rows(name: str) -> np.ndarray:
        return np.concatenate([np.asarray(tree[f"{name}{g}"]["kernel"], np.float32).T for g in LSTM_GATES], axis=0)

    bias_hh = np.concatenate([np.asarray(tree[f"h{g}"]["bias"], np.float32) for g in LSTM_GATES])
    return {
        f"{prefix}weight_ih_l0": torch.from_numpy(np.ascontiguousarray(rows("i"))),
        f"{prefix}weight_hh_l0": torch.from_numpy(np.ascontiguousarray(rows("h"))),
        f"{prefix}bias_ih_l0": torch.zeros(bias_hh.shape, dtype=torch.float32),
        f"{prefix}bias_hh_l0": torch.from_numpy(bias_hh),
    }


def ppo_recurrent_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ``RecurrentPPOAgent`` tree (numpy leaves, with or without
    its ``params`` level) -> the port's ``RecurrentPPOAgent``
    ``state_dict``: the encoders under ``feature_extractor`` and the Dense
    and LayerNorm leaves as :func:`ppo_state_from_jax` carries them; the
    LSTM's gates into ``rnn.lstm`` (:func:`_lstm_state`)."""
    if set(params) == {"params"}:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for name, tree in params.items():
        if name == "rnn":
            for sub, subtree in tree.items():
                if sub == "lstm":
                    state.update(_lstm_state(subtree, "rnn.lstm."))
                else:
                    state.update(flax_to_state_dict(subtree, f"rnn.{sub}."))
        else:
            prefix = f"feature_extractor.{name}." if name in PPO_ENCODERS else f"{name}."
            state.update(flax_to_state_dict(tree, prefix))
    return state


def _stacked(tree: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """A ``nn.vmap``-ed flax tree, copied as it is: the port's stacked
    layers keep flax's ``kernel (n, in, out)`` and ``bias (n, out)``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_stacked(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return out


def sac_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX SAC tree ``{actor, critic, target_critic, log_alpha}`` (numpy
    leaves) -> the port's ``SACAgent`` ``state_dict``: the actor's Dense
    kernels transposed; both critic ensembles' stacked leaves as they are
    (DroQ's tree too: its critics' stacked LayerNorm ``scale`` and ``bias``
    cross as the stacked Dense leaves do)."""
    state = flax_to_state_dict(params["actor"], "actor.")
    for name in ("critic", "target_critic"):
        tree = params[name]
        state.update(_stacked(tree["params"] if set(tree) == {"params"} else tree, f"{name}."))
    state["log_alpha"] = torch.from_numpy(np.array(params["log_alpha"], dtype=np.float32).reshape(1))
    return state

def p2e_dv3_state_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX P2E-DV3 tree ``{world_model, actor_task, critic_task,
    target_critic_task, actor_exploration, critics_exploration: {name:
    {module, target}}, ensembles}`` (numpy leaves) -> the port's checkpoint
    entries (``sheeprl_tpu_torch.algos.p2e_dv3.agent.STATE_KEYS``): the world
    model as :func:`dreamer_v3_state_from_jax` carries it, each actor and
    critic as any flax tree, each exploration critic's pair under
    ``<name>.module.`` and ``<name>.target.``, and the stacked ensemble tree
    (its Dense kernels ``(n, in, out)`` and LayerNorm ``scale`` and ``bias``)
    as it is."""
    state = {"world_model": dreamer_v3_state_from_jax({"world_model": params["world_model"]})["world_model"]}
    for name in ("actor_task", "critic_task", "target_critic_task", "actor_exploration"):
        state[name] = flax_to_state_dict(params[name])
    critics: Dict[str, torch.Tensor] = {}
    for name, pair in params["critics_exploration"].items():
        for role in ("module", "target"):
            critics.update(flax_to_state_dict(pair[role], f"{name}.{role}."))
    state["critics_exploration"] = critics
    tree = params["ensembles"]
    state["ensembles"] = _stacked(tree["params"] if set(tree) == {"params"} else tree, "")
    return state


def dreamer_v2_state_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"world_model", "actor", "critic", "target_critic"}`` as the JAX
    Dreamer V2 ``build_agent`` returns them (numpy trees; any but the world
    model may be absent) -> the port's checkpoint state. The V2 world model
    has no initial recurrent state; its leaves cross as
    :func:`flax_to_state_dict` carries them: the VALID encoder's HWIO
    kernels to OIHW, the decoder's transposed kernels flipped
    (``deconv_i.ConvTranspose_0``, ``out.ConvTranspose_0``), the
    LayerNorm-GRU cell's ``fused`` Dense and its ``ln`` scale and bias."""
    state = {"world_model": {}}
    for name, tree in params["world_model"].items():
        state["world_model"].update(flax_to_state_dict(tree, f"{name}."))
    for name in ("actor", "critic", "target_critic"):
        if name in params:
            state[name] = flax_to_state_dict(params[name])
    return state


def p2e_dv2_state_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX P2E-DV2 tree ``{world_model, actor_task, critic_task,
    target_critic_task, actor_exploration, critic_exploration,
    target_critic_exploration, ensembles}`` (numpy leaves; entries may be
    absent) -> the port's checkpoint entries
    (``sheeprl_tpu_torch.algos.p2e_dv2.agent.STATE_KEYS``): the world model
    as :func:`dreamer_v2_state_from_jax` carries it, each actor and critic
    as any flax tree, and the stacked ensemble tree (Dense kernels ``(n, in,
    out)``) as it is."""
    state = {"world_model": dreamer_v2_state_from_jax({"world_model": params["world_model"]})["world_model"]}
    for name in ("actor_task", "critic_task", "target_critic_task", "actor_exploration", "critic_exploration",
                 "target_critic_exploration"):
        if name in params:
            state[name] = flax_to_state_dict(params[name])
    if "ensembles" in params:
        tree = params["ensembles"]
        state["ensembles"] = _stacked(tree["params"] if set(tree) == {"params"} else tree, "")
    return state


#: flax ``nn.GRUCell``'s gates, in the order of torch's packed weights
GRU_GATES = ("r", "z", "n")


def _gru_state(tree: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """flax ``nn.GRUCell``'s ``{ir,iz,in}/{kernel,bias}``, ``{hr,hz}/kernel``
    and ``hn/{kernel,bias}`` -> the port's ``GRUCell``: ``weight_ih`` and
    ``weight_hh`` (the gates' transposed kernels stacked in r, z, n order),
    ``bias_ih`` and ``bias_hn``. flax has no hidden bias on the r and z
    gates, and neither has the port's cell (it reads them as zeros)."""

    def rows(side: str) -> np.ndarray:
        return np.concatenate([np.asarray(tree[f"{side}{g}"]["kernel"], np.float32).T for g in GRU_GATES], axis=0)

    bias_ih = np.concatenate([np.asarray(tree[f"i{g}"]["bias"], np.float32) for g in GRU_GATES])
    return {
        f"{prefix}weight_ih": torch.from_numpy(np.ascontiguousarray(rows("i"))),
        f"{prefix}weight_hh": torch.from_numpy(np.ascontiguousarray(rows("h"))),
        f"{prefix}bias_ih": torch.from_numpy(bias_ih),
        f"{prefix}bias_hn": torch.from_numpy(np.array(tree["hn"]["bias"], dtype=np.float32)),
    }


def dreamer_v1_state_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"world_model", "actor", "critic"}`` as the JAX Dreamer V1
    ``build_agent`` returns them (numpy trees; any but the world model may be
    absent) -> the port's checkpoint state: the recurrent model's ``fc``
    Dense as any Dense and its flax GRU cell ``rnn`` packed
    (:func:`_gru_state`); every other leaf as :func:`flax_to_state_dict`
    carries it."""
    world_model: Dict[str, torch.Tensor] = {}
    for name, tree in params["world_model"].items():
        if name == "recurrent_model":
            tree = tree["params"] if set(tree) == {"params"} else tree
            world_model.update(flax_to_state_dict(tree["fc"], "recurrent_model.fc."))
            world_model.update(_gru_state(tree["rnn"], "recurrent_model.rnn."))
        else:
            world_model.update(flax_to_state_dict(tree, f"{name}."))
    state = {"world_model": world_model}
    for name in ("actor", "critic"):
        if name in params:
            state[name] = flax_to_state_dict(params[name])
    return state


def p2e_dv1_state_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX P2E-DV1 tree ``{world_model, actor_task, critic_task,
    actor_exploration, critic_exploration, ensembles}`` (numpy leaves;
    entries may be absent) -> the port's checkpoint entries
    (``sheeprl_tpu_torch.algos.p2e_dv1.agent.STATE_KEYS``): the world model
    as :func:`dreamer_v1_state_from_jax` carries it, each actor and critic
    as any flax tree, and the stacked ensemble tree as it is."""
    state = {"world_model": dreamer_v1_state_from_jax({"world_model": params["world_model"]})["world_model"]}
    for name in ("actor_task", "critic_task", "actor_exploration", "critic_exploration"):
        if name in params:
            state[name] = flax_to_state_dict(params[name])
    if "ensembles" in params:
        tree = params["ensembles"]
        state["ensembles"] = _stacked(tree["params"] if set(tree) == {"params"} else tree, "")
    return state


def episode_buffer_from_jax(rb: Any) -> Dict[str, Any]:
    """A JAX ``EpisodeBuffer`` (numpy episodes, open chunks, its numpy
    generator) -> the port's ``EpisodeBuffer.state_dict()``: the stored
    episodes' rows, the cumulative lengths, each env's open chunks and the
    generator state, so the restored buffer draws the JAX one's windows."""
    def tensors(data):
        return {k: torch.from_numpy(np.array(np.asarray(v), order="C")) for k, v in data.items()}

    return {
        "episodes": [tensors(ep) for ep in rb.buffer],
        "cum_lengths": [int(c) for c in rb._cum_lengths],
        "open": [[tensors(chunk) for chunk in chunks] for chunks in rb._open_episodes],
        "rng": rb._rng.bit_generator.state,
    }


#: the SAC-AE tree's batched Q ensembles (flax ``nn.vmap``), kept stacked
SAC_AE_ENSEMBLES = ("qfs", "target_qfs")


def sac_ae_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX SAC-AE tree ``{encoder, actor_enc_head, actor, qfs,
    target_encoder, target_qfs, decoder, log_alpha}`` (numpy leaves) -> the
    port's ``SACAEAgent`` ``state_dict``: convolution, Dense, LayerNorm and
    transposed-convolution leaves as :func:`flax_to_state_dict` carries
    them (the decoder's ``ConvTranspose_0`` kernels flipped), the two Q
    ensembles' stacked leaves as they are."""
    state: Dict[str, torch.Tensor] = {}
    for name, tree in params.items():
        if name == "log_alpha":
            state[name] = torch.from_numpy(np.array(tree, dtype=np.float32).reshape(1))
        elif name in SAC_AE_ENSEMBLES:
            state.update(_stacked(tree["params"] if set(tree) == {"params"} else tree, f"{name}."))
        elif tree:  # actor_enc_head is {} without pixel keys
            state.update(flax_to_state_dict(tree, f"{name}."))
    return state


def sequence_ring_from_jax(arrays: Any, meta: Optional[Mapping[str, Any]] = None) -> DeviceReplayState:
    """A JAX sequence ``DeviceReplayState`` -> the port's snapshot, which
    ``SequenceRingDriver.load_state_dict``, ``AsyncSequenceRing.load_state_dict``
    and ``restore_host_env_buffer`` read. Takes the snapshot itself (a
    ``SequenceRingDriver``'s or an ``AsyncSequenceRing``'s ``state_dict()``),
    or its numpy ``arrays`` (``storage/<key>``, ``pos``, ``valid``) and
    ``meta``. The JAX ``key`` is not carried: a threefry key has no Philox
    state that draws the same numbers, so the snapshot has no ``key`` and a
    ring restoring it keeps its generator as seeded."""
    if meta is None:
        if getattr(arrays, "kind", None) != "sequence":
            raise ValueError(f"sequence_ring_from_jax takes a 'sequence' snapshot, got {getattr(arrays, 'kind', arrays)!r}")
        arrays, meta = arrays.arrays, arrays.meta
    out = {name: torch.from_numpy(np.array(a, order="C")) for name, a in arrays.items() if name.startswith("storage/")}
    out["pos"] = torch.from_numpy(np.asarray(arrays["pos"], np.int64).copy())
    out["valid"] = torch.from_numpy(np.asarray(arrays["valid"], np.int64).copy())
    keep = {k: meta[k] for k in ("capacity", "n_envs", "seq_len") if k in meta}
    return DeviceReplayState("sequence", out, {k: int(v) for k, v in keep.items()})


def host_env_buffer_from_jax(rb: Any) -> Dict[str, Any]:
    """A JAX ``EnvIndependentReplayBuffer`` of ``SequentialReplayBuffer``s
    (numpy storage, per-env heads, numpy generators) -> the port's
    ``EnvIndependentReplayBuffer.state_dict()``, which its
    ``load_state_dict`` reads: per env, the filled rows (all of them once the
    buffer has wrapped), the head and the generator state; and the outer
    generator state. numpy generators carry over exactly, so the restored
    buffer draws what the JAX one draws next."""
    envs = []
    for sub in rb.buffer:
        full, pos = bool(sub.full), int(sub._pos)
        rows = sub.buffer_size if full else pos
        envs.append({
            "buffer": {k: torch.from_numpy(np.array(np.asarray(v)[:rows], order="C")) for k, v in sub.buffer.items()},
            "pos": pos,
            "full": full,
            "rng": sub._rng.bit_generator.state,
        })
    return {"envs": envs, "rng": rb._rng.bit_generator.state}
