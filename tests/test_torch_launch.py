"""The port's twins of scripts/launch_multihost.py and
scripts/run_scaling_report.py (vv_dsp_tpu_torch.tools.launch_multihost,
run_scaling_report) on the CPU at a tiny size: two processes joined over
gloo print the JAX script's lines and write its JSON keys, and a sweep
over 1 and 2 processes writes a report of the JAX report's shape (the
shape tests/test_scaling_report.py::test_report_shape checks). No
efficiency bar here: a contended CPU is no measure of one.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from vv_dsp_tpu_torch.tools import LAUNCHERS
from vv_dsp_tpu_torch.tools import __main__ as dispatcher
from vv_dsp_tpu_torch.tools import launch_multihost, run_scaling_report
from vv_dsp_tpu_torch.tools._cli import NO_DEVICE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "launch_multihost.py")
JAX_REPORT = os.path.join(REPO, "benchmarks", "scaling_report.json")
TINY = ["--per-device-samples", "12288", "--channels", "2"]
JOIN_S = 120.0


def jax_json_keys() -> list[str]:
    """The keys of the dict the JAX script passes to json.dump."""
    tree = ast.parse(open(JAX_SCRIPT).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "dump"):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dump in the JAX script")


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def test_launch_multihost_two_processes(tmp_path):
    """N = 2 on the CPU, rank 0 through the dispatcher: process 0 prints
    the JAX script's three lines and writes its JSON keys."""
    port = run_scaling_report.free_port()
    out = tmp_path / "run.json"
    procs = []
    for pid in range(2):
        head = (["-m", "vv_dsp_tpu_torch.tools", "launch_multihost"]
                if pid == 0 else
                ["-m", "vv_dsp_tpu_torch.tools.launch_multihost"])
        procs.append(subprocess.Popen(
            [sys.executable, *head, "--cpu", "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
             str(pid), *TINY, "--json-out", str(out)],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    rcs = run_scaling_report.wait_all(procs, JOIN_S)
    logs = [p.communicate(timeout=30)[0] for p in procs]
    assert rcs == [0, 0], logs
    lines = [ln for ln in logs[0].splitlines() if "socket.cpp" not in ln]
    assert lines[0] == "2 processes, 2 devices, mesh {'channel': 1, " \
                       "'block': 2}"
    assert re.fullmatch(r"sharded 1024-tap FIR: [\d.]+ ms/step, \d+ Msps "
                        r"\(\d+ Msps/device\)", lines[1]), lines
    assert re.fullmatch(r"sharded north-star chain: [\d.]+ ms/step -> \d+ "
                        r"Msps input-rate", lines[2]), lines
    got = json.loads(out.read_text())
    assert list(got) == jax_json_keys()
    assert (got["n_processes"], got["n_devices"], got["samples"],
            got["channels"]) == (2, 2, 2 * 12288, 2)
    assert got["fir_msps"] > 0 and got["chain_msps"] > 0


def test_scaling_report_shape(tmp_path):
    """--procs 1 2 --repeats 1: the report has the JAX report's keys and
    the shape test_report_shape checks."""
    out = tmp_path / "report.json"
    res = subprocess.run(
        [sys.executable, "-m", "vv_dsp_tpu_torch.tools.run_scaling_report",
         "--cpu", "--procs", "1", "2", "--repeats", "1", *TINY, "--out",
         str(out)], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    report = json.loads(out.read_text())
    with open(JAX_REPORT) as f:
        jax_report = json.load(f)
    assert set(report) == set(jax_report)
    assert set(report["configs"][0]) == set(jax_report["configs"][0])
    assert report["mode"] == "weak"
    assert "gloo" in report["backend"]
    ns = [c["n_processes"] for c in report["configs"]]
    assert ns == sorted(ns) == [1, 2]
    for c in report["configs"]:
        assert c["n_devices"] == c["n_processes"]
        assert c["samples"] == c["n_processes"] * report["per_device_samples"]
        assert c["chain_efficiency"] > 0 and c["fir_comm_efficiency"] > 0
    assert report["configs"][0]["chain_efficiency"] == 1.0


def test_no_gpu_without_cpu_flag(capsys, monkeypatch):
    """The card or nothing: without --cpu both return 1 before starting a
    process or joining a group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch_multihost.main(["--coordinator", "127.0.0.1:1",
                                  "--num-processes", "2",
                                  "--process-id", "0"]) == 1
    assert run_scaling_report.main(["--procs", "2"]) == 1
    err = capsys.readouterr().err.splitlines()
    assert err == [NO_DEVICE, NO_DEVICE]


def test_dispatcher_names_the_launchers(capsys):
    assert dispatcher.main(["launch_nothing"]) == 2
    err = capsys.readouterr().err.splitlines()
    assert err[2] == "launchers: " + " ".join(LAUNCHERS)
    assert LAUNCHERS == ["launch_multihost", "run_scaling_report"]


@pytest.mark.parametrize("tool", LAUNCHERS)
def test_launchers_load_no_jax(tool):
    """A fresh interpreter imports each launcher without jax or the JAX
    package."""
    code = (f"import sys, vv_dsp_tpu_torch.tools.{tool}\n"
            "print(sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith('jax.') or m == 'vv_dsp_tpu'\n"
            "             or m.startswith('vv_dsp_tpu.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
