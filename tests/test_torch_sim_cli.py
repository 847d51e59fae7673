"""The port's sim CLI against the JAX CLI: `--crash`, `--byzantine`,
`--meter-bytes`, `--trace`, `--metrics`, `--checkpoint`, `--checkpoint-every`,
`--resume` and `--attack`.

Both CLIs' `main(argv)` run in-process on the host engine at 4 nodes x 2
epochs.  Their JSON lines are equal except for the wall-clock keys, the
`--metrics` files hold equal queue peaks, sim counters, gauge names and
state census gauges, and the
`--trace` files hold the same number of events of the same kinds, as
JSON lines and as Chrome trace JSON.  The fault flags exclude each other
as the JAX CLI's do.
"""
import json

import pytest
import torch

from hydrabadger_tpu.sim import __main__ as jcli
from hydrabadger_tpu_torch.sim import __main__ as cli

BASE = ["--engine", "cpu", "--nodes", "4", "--epochs", "2", "--json"]
WALL = {"wall_s", "epochs_per_sec", "txns_per_sec", "latency_p50_ms", "latency_p90_ms",
        "latency_p99_ms"}  # and txn_latency's quantiles


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(main, argv, capsys, tmp_path, tag, trace_ext):
    trace = str(tmp_path / f"{tag}{trace_ext}")
    metrics = str(tmp_path / f"{tag}-metrics.json")
    rc = main(argv + ["--trace", trace, "--metrics", metrics])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(metrics) as fh:
        met = json.load(fh)
    with open(trace) as fh:
        if trace_ext == ".jsonl":
            recs = [json.loads(r) for r in fh]
            meta = [r for r in recs if r["ph"] == "M"]
            kinds = sorted((r["name"], r["ph"]) for r in recs if r["ph"] != "M")
        else:
            doc = json.load(fh)
            meta = [doc["metadata"]]
            kinds = sorted((r["name"], r["ph"]) for r in doc["traceEvents"] if r["ph"] != "M")
    return rc, line, met, meta, kinds


def _timeless(d: dict) -> dict:
    out = {k: v for k, v in d.items() if k not in WALL}
    out["txn_latency"] = {k: v for k, v in d["txn_latency"].items() if not k.startswith("p")}
    return out


@pytest.mark.parametrize("flags,trace_ext", [
    (["--crash", "3"], ".jsonl"),
    (["--byzantine", "3"], ".json"),
    (["--meter-bytes"], ".jsonl"),
])
def test_cli_flags_equal_the_jax_cli(flags, trace_ext, capsys, tmp_path):
    argv = BASE + flags
    ours = _run(cli.main, argv, capsys, tmp_path, "port", trace_ext)
    theirs = _run(jcli.main, argv, capsys, tmp_path, "jax", trace_ext)
    (rc, line, met, meta, kinds), (jrc, jline, jmet, jmeta, jkinds) = ours, theirs
    assert rc == jrc == 0
    assert sorted(line) == sorted(jline)
    assert _timeless(line) == _timeless(jline)
    assert line["epochs_done"] == 2 and line["agreement_ok"]
    assert met["queue_peaks"] == jmet["queue_peaks"]
    assert met["queue_peaks"]["router_queue"] > 0
    assert met["sim"]["counters"] == jmet["sim"]["counters"]
    # the state census rides both sims: the same gauge names, census included
    assert sorted(met["sim"]["gauges"]) == sorted(jmet["sim"]["gauges"])
    census = {k: g for k, g in met["sim"]["gauges"].items() if k.startswith("state_census_")}
    assert census == {k: jmet["sim"]["gauges"][k] for k in census} and len(census) >= 17
    assert kinds == jkinds and len(kinds) > 0
    assert meta[0]["clock_domain"] == jmeta[0]["clock_domain"]
    if "--meter-bytes" in flags:
        assert line["bytes_tx_total"] > 0


def test_fault_flags_exclude_each_other_and_indices_are_checked(capsys):
    for argv in (BASE + ["--crash", "1", "--byzantine", "2"], BASE + ["--drop", "0.1", "--crash", "1"],
                 BASE + ["--crash", "4"]):
        with pytest.raises(SystemExit) as ours:
            cli.main(argv)
        with pytest.raises(SystemExit) as theirs:
            jcli.main(argv)
        assert ours.value.code == theirs.value.code == 2
    err = capsys.readouterr().err
    assert "mutually exclusive" in err and "out of range" in err


def test_checkpoint_and_resume_flags_equal_the_jax_cli(capsys, tmp_path):
    """Each CLI checkpoints every epoch of a 2-epoch run and resumes its own
    file for 2 more: the same epochs done (2, then 4), agreement, committed
    transactions, bytes, faults and messages (both CLIs take their native
    ACS core here, having no fault flag).  `--checkpoint-every` without `--checkpoint`, and `--trace` with
    `--resume`, are refused by both."""
    lines = {}
    for tag, main in (("port", cli.main), ("jax", jcli.main)):
        path = str(tmp_path / f"{tag}.ckpt")
        assert main(BASE + ["--checkpoint", path, "--checkpoint-every", "1"]) == 0
        first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert main(["--resume", path, "--epochs", "2", "--json", "--engine", "cpu"]) == 0
        lines[tag] = (first, json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    keys = ("epochs_done", "agreement_ok", "txns_committed", "bytes_committed", "faults",
            "messages_delivered")
    for ours, theirs in zip(lines["port"], lines["jax"]):
        assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
    assert lines["port"][0]["epochs_done"] == 2 and lines["port"][1]["epochs_done"] == 4
    assert lines["port"][1]["agreement_ok"]
    for argv in (BASE + ["--checkpoint-every", "1"],
                 BASE + ["--resume", str(tmp_path / "port.ckpt"), "--trace", "t.jsonl"]):
        with pytest.raises(SystemExit) as ours:
            cli.main(argv)
        with pytest.raises(SystemExit) as theirs:
            jcli.main(argv)
        assert ours.value.code == theirs.value.code == 2
    err = capsys.readouterr().err
    assert "requires --checkpoint" in err and "not supported with --resume" in err


def test_attack_json_line_equals_the_jax_cli(capsys):
    argv = ["--engine", "cpu", "--nodes", "4", "--epochs", "2", "--encrypt", "--coin", "threshold",
            "--verify", "--attack", "-1", "--json"]
    lines = []
    for main in (cli.main, jcli.main):
        assert main(argv) == 0
        captured = capsys.readouterr()
        injected = [ln for ln in captured.err.splitlines() if ln.startswith("attack scenario verified")]
        lines.append((json.loads(captured.out.strip().splitlines()[-1]), injected))
    (ours, our_log), (theirs, their_log) = lines
    assert _timeless(ours) == _timeless(theirs)
    assert our_log == their_log and len(our_log) == 1
    assert ours["epochs_done"] == 2 and ours["agreement_ok"] and ours["faults"] > 0


def test_attack_refusals_exit_2_as_the_jax_cli(capsys, tmp_path):
    attack = ["--encrypt", "--coin", "threshold", "--verify", "--attack", "-1"]
    for argv in (BASE + attack + ["--crash", "1"], BASE + attack + ["--drop", "0.1"],
                 BASE + attack + ["--checkpoint", str(tmp_path / "a.ckpt")],
                 BASE + attack + ["--resume", str(tmp_path / "a.ckpt")],
                 BASE + ["--encrypt", "--attack", "1"],
                 BASE + ["--attack", "2"]):
        with pytest.raises(SystemExit) as ours:
            cli.main(argv)
        with pytest.raises(SystemExit) as theirs:
            jcli.main(argv)
        assert ours.value.code == theirs.value.code == 2
    err = capsys.readouterr().err
    assert "mutually exclusive" in err and "not supported with --resume/--checkpoint" in err
    assert "requires --verify" in err and "need 0 <= f" in err
