"""BENCHMARK.json keeps the benchmark's contract, and every file it names
loads by name."""

import json
import os
import re

import pytest

from benchmark.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_tok")


@pytest.fixture(scope="module")
def man():
    return Manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(man):
    d = man.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(d["paths"]) <= 16
    for p in d["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(d["command"]) <= 32 and all(map(_line, d["command"]))
    for word in d["command"][1:]:
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in d["paths"])
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51


def test_entries_and_names(man):
    d = man.data
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in d[section]]
        assert len(names) == len(set(names)), section
        for e in d[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert want <= set(e) <= want | extra, e["name"]
            assert NAME.match(e["name"])
    metrics = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert 1 <= len(d["configs"]) <= 24 and 1 <= len(d["workloads"]) <= 24


def test_configs(man):
    d = man.data
    used = {w["config"] for w in d["workloads"]}
    files = [c["file"] for c in d["configs"]]
    assert len(files) == len(set(files))
    for c in d["configs"]:
        assert c["name"] in used, c["name"]
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in d["paths"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTHS.search(k)
        f = man.config(c["name"])
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert f["source"] == c["source"]


def test_workloads(man):
    d = man.data
    pairs = [(w["config"], w["traffic"]) for w in d["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in d["workloads"])
    assert four <= max(1, len(d["workloads"]) // 4)
    for w in d["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        tr = man.traffic(w["traffic"])
        assert tr["corrtime"] % tr["chunk"] == 0
        assert tr["chunk"] * tr["profile_chunks"] <= tr["corrtime"]
        lim = man.limits(w["name"])
        assert set(lim) == {"rd_gap", "coul_gap", "recip_gap", "polar_gap",
                            "n_gap", "unmoved"}
        assert lim["n_gap"] == 0


def test_metrics(man):
    d = man.data
    names = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in names
    for m in d["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in d["per_layer"]:
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["moves"] in names
        for w in m.get("workloads", [x["name"] for x in d["workloads"]]):
            assert m["moves"] in {e["name"] for e in man.end_to_end(w)}
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in d["workloads"]:
        e2e = {m["name"] for m in man.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert man.per_layer(w["name"])


def test_every_file_loads_by_name(man):
    d = man.data
    for c in d["configs"]:
        man.config(c["name"])
    for w in d["workloads"]:
        man.traffic(w["traffic"])
        man.limits(w["name"])
    for m in d["per_layer"]:
        assert callable(man.reader(m["name"]))
    kernels = man.kernels()
    assert {k["work"] for k in kernels} >= {"scf_contraction"}
    for k in kernels:
        assert k["label"] and k["fragments"]
    assert man.peaks()


def test_paths_hold_only_the_benchmark(man):
    for p in man.data["paths"]:
        for dirpath, _, files in os.walk(os.path.join(ROOT, p)):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                if "__pycache__" in rel:
                    continue
                assert PATH.match(rel), rel
