"""The port's command line against the JAX CLI's verbs (``sheeprl_tpu/cli.py``
``main``), on the CPU: every JAX verb is either dispatched to the port's
function of that name or exits naming the verb as not ported, and never
falls through to ``run``; ``--pod`` on a ``run`` command line (or a verbless
one) leaves the single-process path for the pod launcher with its worker
count; a command line without a verb and the ported verbs dispatch as before;
``serve_fleet`` reaches ``serve`` asking for a fleet (3 replicas unless
``serve.fleet.replicas`` says otherwise), and the ``--fleet``, ``--flywheel``,
``--from-serve`` and ``--pod`` flags parse as JAX's do."""

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


@pytest.mark.parametrize("verb,reason", [("registration", "mlflow")])
def test_torch_cli_verbs_not_ported_exit_naming_the_verb(calls, verb, reason):
    with pytest.raises(SystemExit, match=f"'{verb}'.*not ported.*{reason}"):
        cli.main([verb, "checkpoint_path=x.ckpt"])
    assert calls == []  # nothing reached run


@pytest.mark.parametrize("argv,workers", [(["--pod"], 2), (["--pod", "4"], 4), (["--pod=4"], 4)],
                         ids=["bare", "count", "equals"])
@pytest.mark.parametrize("with_verb", [True, False], ids=["run", "no_verb"])
def test_torch_cli_verbs_pod_flag_exits(monkeypatch, tmp_path, argv, workers, with_verb):
    """``--pod`` exits the single-process path into the pod launcher: the
    run's config carries the worker count, the workers' argv drops the
    flag, and no training starts in this process."""
    import sheeprl_tpu_torch.parallel.pod as pod

    pods = []
    monkeypatch.setattr(pod, "run_pod", lambda cfg, args: pods.append((cfg.fabric.pod.workers, list(args))))
    monkeypatch.setattr(cli, "resolve_device", lambda accelerator: pytest.fail("a training run started"))
    monkeypatch.delenv("SHEEPRL_POD_RANK", raising=False)
    rest = ["preset=ppo", "fabric.accelerator=cpu", f"log_root={tmp_path}", "algo.total_steps=8"]
    line = (["run"] if with_verb else []) + rest[:1] + argv + rest[1:]
    cli.main(line)
    assert pods == [(workers, rest)]


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


@pytest.mark.parametrize("argv,want", [
    (["serve_fleet", "checkpoint_path=c"], (["checkpoint_path=c"], 3, True)),
    (["serve_fleet", "checkpoint_path=c", "serve.fleet.replicas=5"],
     (["checkpoint_path=c", "serve.fleet.replicas=5"], None, True)),
], ids=["default_replicas", "replicas_key"])
def test_torch_cli_verbs_serve_fleet_asks_serve_for_a_fleet(monkeypatch, argv, want):
    seen = []
    monkeypatch.setattr(cli, "serve", lambda args, fleet=None, require_fleet=False: seen.append(
        (list(args), fleet, require_fleet)))
    cli.main(argv)
    assert seen == [want]


def test_torch_cli_verbs_from_serve_runs_the_learner_not_a_training_run(monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "learn_from_serve", lambda args, d: seen.append((list(args), d)))
    monkeypatch.setattr(cli, "compose_run_config", lambda args: pytest.fail("a training run was composed"))
    cli.main(["run", "--from-serve", "spool", "checkpoint_path=c"])
    assert seen == [(["checkpoint_path=c"], "spool")]


FLAG_CASES = [
    ["serve", "--fleet"], ["--fleet", "4", "x=1"], ["--fleet=2"], ["--fleet", "x=1"],
    ["--flywheel"], ["--flywheel", "spool", "x=1"], ["--flywheel=spool"], ["--flywheel", "--fleet", "2"],
    ["--flywheel", "x=1"], ["--flywheel="], ["--from-serve", "d", "x=1"], ["--from-serve=d"], ["x=1", "y=2"],
    ["--pod"], ["--pod", "4", "x=1"], ["--pod=3"], ["--pod", "x=1"], ["x=1", "--pod"],
]


@pytest.mark.parametrize("argv", FLAG_CASES, ids=lambda a: " ".join(a) or "empty")
@pytest.mark.parametrize("flag", ["fleet", "flywheel", "from_serve", "pod"])
def test_torch_cli_verbs_flags_parse_as_jax(flag, argv):
    from sheeprl_tpu import cli as jax_cli

    name = f"_extract_{flag}_flag"
    assert getattr(cli, name)(list(argv)) == getattr(jax_cli, name)(list(argv))


@pytest.mark.parametrize("argv", [["--from-serve"], ["--from-serve", "x=1"], ["--from-serve="]],
                         ids=["missing", "override", "empty"])
def test_torch_cli_verbs_from_serve_without_a_directory_raises_as_jax(argv):
    from sheeprl_tpu import cli as jax_cli

    with pytest.raises(ValueError) as want:
        jax_cli._extract_from_serve_flag(list(argv))
    with pytest.raises(ValueError) as got:
        cli._extract_from_serve_flag(list(argv))
    assert str(got.value) == str(want.value)
