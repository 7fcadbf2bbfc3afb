"""The port's CLI flags held to sat_tpu's: the same argv resolves to the
same Config in both packages (the five flags the port lacked until now,
the route and supervise flags, and their interplay with ``--port`` and
``--config``), and ``--print_config`` prints the same JSON."""

import json

import pytest

from sat_tpu import cli as jax_cli
from sat_tpu_torch import cli

ARGVS = {
    "anomaly_policy": ["--phase", "train", "--anomaly_policy", "skip"],
    "anomaly_policy_off": ["--anomaly_policy", "off"],
    "keep_checkpoints": ["--keep_checkpoints", "2"],
    "io_retries": ["--phase", "eval", "--io_retries", "0"],
    "watchdog": ["--watchdog", "0.5", "--set", "watchdog_step_s=5"],
    "watchdog_set_wins": ["--watchdog", "0.5", "--set", "watchdog_interval=2"],
    "print_config": ["--print_config", "--phase", "serve", "--port", "0"],
    "route_num_replicas": ["--phase", "route", "--num_replicas", "3", "--port", "0"],
    "route_replicas": ["--replicas", "127.0.0.1:9000,127.0.0.1:9001=decode", "--port", "8801"],
    "straggler_factor": ["--phase", "route", "--straggler_factor", "3.5"],
    "serve_port": ["--phase", "serve", "--port", "8123"],
    "supervise": ["--phase", "train", "--supervise", "--max_restarts", "5", "--watchdog", "1"],
    "all_five": ["--anomaly_policy", "rollback", "--keep_checkpoints", "1", "--io_retries", "7",
                 "--watchdog", "0.2", "--print_config"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_flags_resolve_to_the_jax_config(name):
    argv = ARGVS[name]
    config, opts = cli.build_config(argv)
    jconfig, jopts = jax_cli.build_config(argv)
    assert config.to_dict() == jconfig.to_dict()
    for key in ("print_config", "supervise", "max_restarts", "load", "model_file", "sweep"):
        assert opts[key] == jopts[key], key


@pytest.mark.parametrize("name", ["route_replicas", "all_five"])
def test_flags_over_a_config_file_resolve_to_the_jax_config(name, tmp_path):
    from sat_tpu_torch.config import Config

    path = str(tmp_path / "base.json")
    Config(phase="eval", anomaly_policy="warn", keep_checkpoints=4, route_port=9999).save(path)
    argv = ["--config", path] + ARGVS[name]
    assert cli.build_config(argv)[0].to_dict() == jax_cli.build_config(argv)[0].to_dict()


@pytest.mark.parametrize("extra", [[], ["--phase", "route", "--num_replicas", "4", "--watchdog", "1"],
                                   ["--supervise", "--repair_shards", "--anomaly_policy", "skip"]],
                         ids=["defaults", "route", "before_every_dispatch"])
def test_print_config_prints_the_jax_json_and_exits_first(extra, capsys):
    argv = ["--print_config", "--set", "beam_size=2"] + extra
    assert cli.main(argv) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(argv) == 0
    theirs = capsys.readouterr().out
    assert ours == theirs
    assert json.loads(ours)["beam_size"] == 2


def test_unknown_choices_refused_like_jax():
    for argv in (["--anomaly_policy", "panic"], ["--keep_checkpoints", "two"], ["--watchdog", "soon"]):
        with pytest.raises(SystemExit):
            cli.build_config(argv)
        with pytest.raises(SystemExit):
            jax_cli.build_config(argv)
