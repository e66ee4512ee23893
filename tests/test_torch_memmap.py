"""``MemmapArray`` and the memmapped host buffers against the JAX package's
(``sheeprl_tpu/data/memmap.py``, ``sheeprl_tpu/data/buffers.py``): file
creation and modes, ``from_array``, pickling as a non-owning view, and the
owner's deletion of its file and emptied directory; the buffers' argument
checks, their file layout (``<memmap_dir>/<key>.memmap``,
``<memmap_dir>/env_<i>/<key>.memmap``) and their seeded samples, equal
exactly to JAX's memmapped buffers'. A buffer's state holds its rows, so a
resumed buffer writes them into files of its own; a JAX checkpoint of a
memmapped buffer holds only the file names, which its process deletes when
it ends. A tiny memmapped DreamerV3 run trains exactly as the in-memory
one."""

import gc
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu.data import buffers as jb
from sheeprl_tpu.data.memmap import MemmapArray as JaxMemmapArray
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.data import buffers as tb
from sheeprl_tpu_torch.data.memmap import MemmapArray
from tests.test_torch_train_loop import TINY_RUN

ROOT = Path(__file__).resolve().parents[1]
IMPLS = {"port": MemmapArray, "jax": JaxMemmapArray}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("impl", list(IMPLS))
def test_torch_memmap_array_creation_and_modes(impl, tmp_path):
    cls = IMPLS[impl]
    a = cls(np.float32, (3, 2), filename=tmp_path / "d" / "a.memmap", mode="r+")
    assert Path(a.filename).is_file() and os.path.getsize(a.filename) == 24
    assert a.has_ownership and a.shape == (3, 2) and a.dtype == np.float32 and a.mode == "r+" and len(a) == 3
    assert not np.asarray(a).any()
    a[1] = [1.0, 2.0]
    assert np.asarray(a).tolist() == [[0, 0], [1, 2], [0, 0]] and a[1].tolist() == [1.0, 2.0]
    with pytest.raises(ValueError, match="Shape mismatch"):
        a.array = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="must be a numpy array"):
        a.array = [1.0]
    with pytest.raises(ValueError, match="Unsupported memmap mode 'rw'"):
        cls(np.float32, (1,), filename=tmp_path / "b.memmap", mode="rw")
    anonymous = cls(np.int64, (2,))
    assert Path(anonymous.filename).suffix == ".memmap" and anonymous.has_ownership


@pytest.mark.parametrize("impl", list(IMPLS))
def test_torch_memmap_from_array_pickling_and_ownership(impl, tmp_path):
    cls = IMPLS[impl]
    data = np.arange(6, dtype=np.float64).reshape(2, 3)
    owner = cls.from_array(data, filename=tmp_path / "x" / "a.memmap")
    assert owner.has_ownership and np.array_equal(np.asarray(owner), data)
    copy = cls.from_array(owner, filename=tmp_path / "x" / "b.memmap")  # another file: a copy it owns
    assert copy.has_ownership and np.array_equal(np.asarray(copy), data)
    view = cls.from_array(owner, filename=owner.filename)  # the same file: a view that owns nothing
    assert not view.has_ownership
    # the JAX package's view maps its file with "w+", which zeroes it; the
    # port's keeps the rows
    assert np.array_equal(np.asarray(owner), data if impl == "port" else np.zeros_like(data))
    restored = pickle.loads(pickle.dumps(owner))
    assert not restored.has_ownership and restored.filename == owner.filename
    assert np.array_equal(np.asarray(restored), np.asarray(owner))
    del restored, view
    gc.collect()
    assert Path(owner.filename).exists()  # views never delete
    name, other = owner.filename, copy.filename
    del owner
    gc.collect()
    assert not Path(name).exists() and Path(other).exists()  # the owner's last reference deletes its file
    del copy
    gc.collect()
    assert not (tmp_path / "x").exists()  # and the directory it emptied


@pytest.mark.parametrize("impl", list(IMPLS))
def test_torch_memmap_owner_keeps_its_file_while_its_array_is_held(impl, tmp_path):
    owner = IMPLS[impl](np.uint8, (4,), filename=tmp_path / "a.memmap")
    held = owner.array
    name = owner.filename
    del owner
    gc.collect()
    assert Path(name).exists() and held.shape == (4,)


def _jax_buffer(kind, size, n_envs, memmap_dir):
    if kind == "env_independent":
        return jb.EnvIndependentReplayBuffer(size, n_envs, obs_keys=("obs",), memmap=True, memmap_dir=memmap_dir,
                                             buffer_cls=jb.SequentialReplayBuffer)
    cls = jb.SequentialReplayBuffer if kind == "sequential" else jb.ReplayBuffer
    return cls(size, n_envs, obs_keys=("obs",), memmap=True, memmap_dir=memmap_dir)


def _port_buffer(kind, size, n_envs, memmap_dir):
    cls = {"env_independent": tb.EnvIndependentReplayBuffer, "sequential": tb.SequentialReplayBuffer,
           "flat": tb.ReplayBuffer}[kind]
    return cls(size, n_envs, ("obs",), memmap=True, memmap_dir=memmap_dir)


def _fill(rb, rng, rows: int, n_envs: int):
    for _ in range(rows):
        rb.add({
            "obs": rng.integers(0, 255, (1, n_envs, 4, 4, 3), dtype=np.uint8),
            "rewards": rng.standard_normal((1, n_envs, 1)).astype(np.float32),
            "terminated": (rng.random((1, n_envs, 1)) < 0.1).astype(np.float32),
        })


def _sample(rb, kind, seed):
    kw = {"sequence_length": 4} if kind != "flat" else {}
    return rb.sample(5, n_samples=3, **kw)


@pytest.mark.parametrize("rows", [9, 23], ids=["filling", "wrapped"])
@pytest.mark.parametrize("kind", ["flat", "sequential", "env_independent"])
def test_torch_memmap_buffers_match_jax_layout_and_samples(kind, rows, tmp_path):
    n_envs, size = 3, 16
    port = _port_buffer(kind, size, n_envs, tmp_path / "port")
    jax = _jax_buffer(kind, size, n_envs, tmp_path / "jax")
    for rb in (port, jax):
        rb.seed(7)
    _fill(port, np.random.default_rng(1), rows, n_envs)
    _fill(jax, np.random.default_rng(1), rows, n_envs)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    want = ["env_0/obs.memmap", "env_0/rewards.memmap", "env_0/terminated.memmap"] if kind == "env_independent" \
        else ["obs.memmap", "rewards.memmap", "terminated.memmap"]
    assert set(want) <= set(_files(tmp_path / "port"))
    for draw in range(3):
        a, b = _sample(port, kind, draw), _sample(jax, kind, draw)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])  # exact: the same rows in the same order


def test_torch_memmap_buffers_check_their_arguments_as_jax(tmp_path):
    for port_cls, jax_cls in ((tb.ReplayBuffer, jb.ReplayBuffer),
                              (tb.EnvIndependentReplayBuffer, jb.EnvIndependentReplayBuffer)):
        for kwargs, match in (({"memmap_mode": "rw", "memmap_dir": tmp_path}, "Accepted values for memmap_mode"),
                              ({}, "memmap=True requires a 'memmap_dir'")):
            with pytest.raises(ValueError, match=match):
                port_cls(4, 1, memmap=True, **kwargs)
            with pytest.raises(ValueError, match=match):
                jax_cls(4, 1, memmap=True, **kwargs)
    assert not tb.ReplayBuffer(4, 1, memmap=False, memmap_mode="rw").is_memmap  # unchecked when off, as in JAX
    assert tb.EnvIndependentReplayBuffer(4, 2, memmap=True, memmap_dir=tmp_path).is_memmap


@pytest.mark.parametrize("rows", [9, 23], ids=["filling", "wrapped"])
def test_torch_memmap_state_holds_the_rows_and_a_resume_writes_its_own_files(rows, tmp_path):
    rb = tb.EnvIndependentReplayBuffer(16, 2, ("obs",), memmap=True, memmap_dir=tmp_path / "old")
    rb.seed(3)
    _fill(rb, np.random.default_rng(0), rows, 2)
    saved = rb.state_dict()
    path = tmp_path / "ckpt.pt"
    torch.save(saved, path)
    del saved, rb  # a full buffer's state is a view of its files: it goes first
    gc.collect()
    assert _files(tmp_path / "old") == []  # the run is over: its files are gone
    saved = torch.load(path, weights_only=True)
    restored = tb.EnvIndependentReplayBuffer(16, 2, ("obs",), memmap=True, memmap_dir=tmp_path / "new")
    restored.load_state_dict(torch.load(path, weights_only=True))
    assert _files(tmp_path / "new") == [f"env_{e}/{k}.memmap" for e in range(2)
                                        for k in ("obs", "rewards", "terminated")]
    again = restored.state_dict()
    for e in range(2):
        assert again["envs"][e]["pos"] == saved["envs"][e]["pos"]
        for k, v in saved["envs"][e]["buffer"].items():
            assert torch.equal(again["envs"][e]["buffer"][k], v), k
    plain = tb.EnvIndependentReplayBuffer(16, 2, ("obs",))
    plain.load_state_dict(torch.load(path, weights_only=True))
    a, b = restored.sample(4, sequence_length=3), plain.sample(4, sequence_length=3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


_JAX_CHILD = """
import pickle, sys
import numpy as np
from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
rb = EnvIndependentReplayBuffer(8, 2, obs_keys=("obs",), memmap=True, memmap_dir=sys.argv[1],
                                buffer_cls=SequentialReplayBuffer)
rb.add({"obs": np.arange(8, dtype=np.float32).reshape(4, 2, 1)})
with open(sys.argv[2], "wb") as f:
    pickle.dump(rb, f)  # as the JAX checkpoint stores state["rb"]
"""


def test_torch_memmap_jax_checkpoint_needs_the_files_its_process_deletes(tmp_path):
    """The JAX package pickles a memmapped buffer as views that name its
    files; the run's process owns the files and deletes them when it ends,
    so the checkpoint cannot give the rows back. The port's state holds the
    rows (previous test)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "JAX_PLATFORMS": "cpu"}
    mm_dir, pkl = tmp_path / "memmap_buffer", tmp_path / "rb.pkl"
    proc = subprocess.run([sys.executable, "-c", _JAX_CHILD, str(mm_dir), str(pkl)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert pkl.stat().st_size < 4096  # names and shapes, not the rows
    assert _files(mm_dir) == []
    rb = pickle.loads(pkl.read_bytes())
    with pytest.raises(FileNotFoundError):
        np.asarray(rb.buffer[0]["obs"])


def test_torch_memmap_rssm_run_trains_as_the_in_memory_run(tmp_path, monkeypatch):
    """``buffer.memmap`` changes where the rows live, not what is drawn: a
    tiny DreamerV3 host-tier run gives the same training metrics memmapped
    and in memory, and its buffer files sit under the run's
    ``memmap_buffer/rank_0/env_0`` while it runs."""
    seen = []
    real = tb.EnvIndependentReplayBuffer.sample

    def spy(self, *args, **kwargs):
        if self.is_memmap and not seen:
            seen.extend(_files(Path(self.buffer[0].buffer["rgb"].filename).parents[2]))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(tb.EnvIndependentReplayBuffer, "sample", spy)
    runs = {m: cli.run(TINY_RUN + [f"log_root={tmp_path / m}", "algo.total_steps=12", "algo.run_test=false",
                                   f"buffer.memmap={m == 'on'}"]) for m in ("on", "off")}
    assert runs["on"]["gradient_steps"] == runs["off"]["gradient_steps"] > 0
    assert runs["on"]["metrics"] == runs["off"]["metrics"]  # exact
    keys = ["actions", "is_first", "rewards", "rgb", "terminated", "truncated"]
    assert seen == [f"rank_0/env_0/{k}.memmap" for k in keys]
    on = load_ckpt(runs["on"]["checkpoint"])
    off = load_ckpt(runs["off"]["checkpoint"])
    for k, v in off["rb"]["envs"][0]["buffer"].items():
        assert torch.equal(on["rb"]["envs"][0]["buffer"][k], v), k


def load_ckpt(path):
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    return load_checkpoint(path)
