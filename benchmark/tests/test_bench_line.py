"""The result line: its keys from a stub run, the checks last on both
streams; no result without the card or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.manifest import ROOT

STUB = {
    "correct": True, "attempted": 96, "failed": 0,
    "metrics": {"moves_per_s": {"value": 31.5, "unit": "moves/s"},
                "setup_s": {"value": 17.25, "unit": "s"}},
    "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
               "count": 1, "memory_peak_bytes": 14980163072},
    "window": {"seconds": 30.4, "moves": 96, "accepted": 40, "seed": 1},
    "checks": {"rd_gap": {"value": 1e-15, "limit": 1e-08},
               "n_gap": {"value": 0.0, "limit": 0}},
}


@pytest.mark.parametrize("trace_on", [0, 1])
def test_last_line_of_a_stub_run(monkeypatch, capsys, trace_on):
    stub = json.loads(json.dumps(STUB))
    if trace_on:
        stub["metrics"] = {"refresh_ms": {"value": 1500.0, "unit": "ms"}}
        stub["device"].update(busy_s=1.5, window_s=4.9)
        stub["breakdown"] = {"device_ops": [["K5 contract_planes_sym", 0.2]],
                             "idle_gaps": [["chunk (sum)", 2.7]]}
    seen = {}

    def fake(name, seed, seconds, trace, t_start=None):
        seen.update(name=name, seed=seed, seconds=seconds, trace=trace)
        return stub

    monkeypatch.setattr(harness, "run_cell", fake)
    rc = harness.main(["--workload", "h2-bulk-77k.fixed4", "--seed",
                       str(2 ** 31 + 5), "--seconds", "30", "--trace",
                       str(trace_on)])
    out, err = capsys.readouterr()
    assert rc == 0
    assert seen == {"name": "h2-bulk-77k.fixed4", "seed": 2 ** 31 + 5,
                    "seconds": 30.0, "trace": bool(trace_on)}
    line = json.loads(out.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == bool(trace_on)
    assert err.strip().splitlines()[-2:] == [
        "check rd_gap 1e-15 limit 1e-08", "check n_gap 0.0 limit 0"]


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = harness.main(["--workload", "h2-bulk-77k.fixed4", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "CUDA" in err


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder: the run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "h2-bulk-77k.fixed4",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "mpmcxx_tpu_torch" in out.stderr
