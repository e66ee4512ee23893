"""The port's gradient collectives (``sheeprl_tpu_torch/parallel/comm.py``)
against the JAX package's (``sheeprl_tpu/parallel/comm.py``), on the CPU.

The same numpy gradients go through JAX's ``pmean_grads`` and
``all_gather_wire`` inside a ``shard_map`` over a 2-device CPU mesh (the
conftest's virtual devices) and through the port's functions on 2 gloo rank
processes (``tests/torch_dp_ranks.py``), at the float32 wire and at the
bfloat16 wire. Found: the means are bit-equal at both wires (tolerance 0 at
float32; at bfloat16 one bfloat16 ulp of the mean is allowed and none is
used), and the two ranks' results are bit-equal. The guard's verdict rides
the same all-reduce and is the group's minimum; each ``pmean_grads`` is one
collective; the row gathers are exact. At world size 1 every function
returns its input itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from sheeprl_tpu.parallel import comm as jax_comm
from sheeprl_tpu.parallel.compat import shard_map
from sheeprl_tpu_torch.parallel import comm
from tests.torch_dp_ranks import comm_job, spawn_ranks

SHAPES = [(3, 4), (7,), (2, 2, 5), (1,)]


def _grads(seed):
    """Per-rank gradients ``(2, *shape)``, with magnitudes from 1e-6 to 1e3
    (rounding at either wire shows on some element)."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(2, *s)) * 10.0 ** rng.integers(-6, 4, size=(2, *s))).astype(np.float32)
            for s in SHAPES]


def _jax(fn, wire, *arrays):
    """``fn`` of each device's block inside a shard_map over 2 CPU devices at
    ``wire``; device 0's result (the blocks carry a leading axis of 1)."""
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("dp",))
    jax_comm.set_grad_reduce_dtype(wire, fresh_run=True)
    try:
        out = jax.jit(shard_map(fn, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"), check_vma=False))(*arrays)
    finally:
        jax_comm.set_grad_reduce_dtype("float32", fresh_run=True)
    return jax.tree.map(lambda x: np.asarray(x)[0], out)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def reduced(request):
    wire = request.param
    grads = _grads(0)
    gather = np.random.default_rng(1).normal(size=(2, 3, 2)).astype(np.float32)
    envs = np.random.default_rng(2).normal(size=(5, 4, 3)).astype(np.float32)
    port = spawn_ranks(comm_job, {"wire": wire, "grads": grads, "ok": [True, False], "gather": gather, "envs": envs})
    want = _jax(lambda *g: jax_comm.pmean_grads(list(g), "dp"), wire, *[jnp.asarray(g) for g in grads])
    want_gather = _jax(lambda x: jax_comm.all_gather_wire(x[0], "dp")[None], wire, jnp.asarray(gather))
    return {"wire": wire, "port": port, "want": list(want), "want_gather": want_gather,
            "gather": gather, "envs": envs}


def test_torch_comm_parity_pmean_grads_matches_jax(reduced):
    for rank in range(2):
        for got, want, shape in zip(reduced["port"][rank]["pmean"], reduced["want"], SHAPES):
            assert got.shape == shape and got.dtype == np.float32
            if reduced["wire"] == "float32":
                np.testing.assert_array_equal(got, want)
            else:  # one bfloat16 ulp of the mean at most
                ulp = np.abs(want) * 2.0 ** -7 + np.finfo(np.float32).tiny
                assert np.all(np.abs(got - want) <= ulp)
        for a, b in zip(reduced["port"][0]["pmean"], reduced["port"][1]["pmean"]):
            np.testing.assert_array_equal(a, b)  # the ranks agree bit for bit


def test_torch_comm_parity_bf16_wire_rounds_the_mean(reduced):
    """At the bfloat16 wire every mean is a bfloat16 value, and it differs
    from the float32 mean somewhere: the wire really rounds."""
    exact = [g.mean(axis=0) for g in _grads(0)]
    got = reduced["port"][0]["pmean"]
    as_bf16 = [torch.from_numpy(g).to(torch.bfloat16).float().numpy() for g in got]
    if reduced["wire"] == "bfloat16":
        assert all(np.array_equal(g, b) for g, b in zip(got, as_bf16))
        assert any(not np.array_equal(g, e) for g, e in zip(got, exact))
    else:
        np.testing.assert_allclose(np.concatenate([g.ravel() for g in got]),
                                   np.concatenate([e.ravel() for e in exact]), rtol=1e-6)


def test_torch_comm_parity_verdict_is_the_group_minimum(reduced):
    """Rank 1's verdict is False: both ranks read False, and the gradients
    that carried it are the plain means."""
    for rank in range(2):
        out = reduced["port"][rank]
        assert out["verdict"] is False
        for a, b in zip(out["pmean_verdict"], out["pmean"]):
            np.testing.assert_array_equal(a, b)
        assert out["calls"]["calls"] == 2  # one all_reduce per pmean_grads call


def test_torch_comm_parity_gathers(reduced):
    for rank in range(2):
        out = reduced["port"][rank]
        np.testing.assert_array_equal(out["gather_wire"], reduced["want_gather"])
        np.testing.assert_array_equal(out["gather_rows"], np.concatenate(list(reduced["gather"])))
        np.testing.assert_array_equal(out["gather_envs"], reduced["envs"])


def test_torch_comm_parity_world_size_one_is_the_identity():
    grads = [torch.randn(3), torch.randn(2, 2)]
    before = comm.REDUCTIONS["calls"]
    out = comm.pmean_grads(grads)
    assert all(a is b for a, b in zip(out, grads))
    ok = torch.tensor(True)
    out, verdict = comm.pmean_grads_with_verdict(grads, ok)
    assert verdict is ok and all(a is b for a, b in zip(out, grads))
    x = torch.randn(4, 2)
    assert comm.all_gather_rows(x) is x and comm.all_reduce_mean(x) is x
    assert comm.all_gather_wire(x).shape == (1, 4, 2) and comm.broadcast_flag(True) is True
    assert comm.REDUCTIONS["calls"] == before


@pytest.mark.parametrize("spec,want", [
    ("float32", None), ("f32", None), ("fp32", None), ("32", None), ("none", None), (None, "auto"),
    ("auto", "auto"), ("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16), ("BF16", torch.bfloat16),
])
def test_torch_comm_parity_wire_spellings_are_jax_s(spec, want):
    assert comm.parse_grad_reduce_dtype(spec) == want
    if spec not in (None, "auto"):
        jax_comm.set_grad_reduce_dtype(spec, fresh_run=True)  # JAX takes the same spelling
        jax_comm.set_grad_reduce_dtype("float32", fresh_run=True)


@pytest.mark.parametrize("spec", ["bogus", "float16", "fp16", "int8"])
def test_torch_comm_parity_unknown_wire_raises_jax_s_error(spec):
    with pytest.raises(ValueError) as want:
        jax_comm.set_grad_reduce_dtype(spec)
    with pytest.raises(ValueError) as got:
        comm.parse_grad_reduce_dtype(spec)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Unsupported fabric.grad_reduce_dtype"):
        comm.set_grad_reduce_dtype(spec)


def test_torch_comm_parity_mid_run_change_warns(monkeypatch):
    """The JAX contract: a change of wire after this run's gradients were
    reduced warns; a fresh run's setting does not."""
    monkeypatch.setattr(comm, "_REDUCED_WITH", set())
    monkeypatch.setattr(comm, "_WIRE", None)
    comm.set_grad_reduce_dtype("float32", fresh_run=True)
    comm._REDUCED_WITH.add(None)  # what a reduction at the float32 wire records
    with pytest.warns(UserWarning, match="grad_reduce_dtype changed"):
        comm.set_grad_reduce_dtype("bfloat16")
    assert comm.get_grad_reduce_dtype() is torch.bfloat16
    comm._REDUCED_WITH.add(torch.bfloat16)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        comm.set_grad_reduce_dtype("float32", fresh_run=True)
    assert comm.get_grad_reduce_dtype() is None
