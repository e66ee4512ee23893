"""The port's command line against the JAX CLI's verbs (``sheeprl_tpu/cli.py``
``main``), on the CPU: every JAX verb is either dispatched to the port's
function of that name or exits naming the verb as not ported, and never
falls through to ``run``; ``--pod`` on a ``run`` command line exits the same
way; a command line without a verb and the four ported verbs dispatch as
before."""

import pytest

from sheeprl_tpu_torch import cli


@pytest.fixture
def calls(monkeypatch):
    seen = []
    for name in ("run", "serve", "evaluation", "agents"):
        monkeypatch.setitem(cli._VERBS, name, lambda args, name=name: seen.append((name, list(args))))
    monkeypatch.setitem(cli._VERBS, "eval", cli._VERBS["evaluation"])
    monkeypatch.setattr(cli, "run", lambda args: seen.append(("run", list(args))))
    return seen


def test_torch_cli_verbs_are_the_jax_verbs():
    import ast
    import pathlib

    src = pathlib.Path(__file__).resolve().parents[1] / "sheeprl_tpu" / "cli.py"
    tree = ast.parse(src.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    tuples = [n for n in ast.walk(main) if isinstance(n, ast.Tuple) and len(n.elts) > 3]
    jax_verbs = {e.value for e in tuples[0].elts}
    assert set(cli.JAX_VERBS) == jax_verbs
    assert set(cli._VERBS) | set(cli.NOT_PORTED) == jax_verbs
    assert not set(cli._VERBS) & set(cli.NOT_PORTED)


@pytest.mark.parametrize("verb,reason", [("serve_fleet", "ROADMAP.md Queue 1"), ("registration", "mlflow")])
def test_torch_cli_verbs_not_ported_exit_naming_the_verb(calls, verb, reason):
    with pytest.raises(SystemExit, match=f"'{verb}'.*not ported.*{reason}"):
        cli.main([verb, "checkpoint_path=x.ckpt"])
    assert calls == []  # nothing reached run


@pytest.mark.parametrize("argv", [["--pod"], ["--pod", "4"], ["--pod=4"]], ids=["bare", "count", "equals"])
@pytest.mark.parametrize("with_verb", [True, False], ids=["run", "no_verb"])
def test_torch_cli_verbs_pod_flag_exits(calls, argv, with_verb):
    line = (["run"] if with_verb else []) + ["preset=ppo", *argv, "algo.total_steps=8"]
    with pytest.raises(SystemExit, match="pod.*not ported"):
        cli.main(line)
    assert calls == []


@pytest.mark.parametrize("argv,want", [
    (["run", "preset=ppo"], ("run", ["preset=ppo"])),
    (["preset=ppo", "seed=3"], ("run", ["preset=ppo", "seed=3"])),
    (["serve", "checkpoint_path=c"], ("serve", ["checkpoint_path=c"])),
    (["evaluation", "checkpoint_path=c"], ("evaluation", ["checkpoint_path=c"])),
    (["eval", "checkpoint_path=c"], ("evaluation", ["checkpoint_path=c"])),
    (["agents"], ("agents", [])),
], ids=["run", "no_verb", "serve", "evaluation", "eval", "agents"])
def test_torch_cli_verbs_ported_dispatch_unchanged(calls, argv, want):
    cli.main(argv)
    assert calls == [want]
