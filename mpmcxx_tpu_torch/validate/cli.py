"""The command line of ``python -m mpmcxx_tpu_torch.validate``."""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import common, gibbs_vle, npt, ptemp, systems, uvt, warmstart

STUDIES = ("uvt-argon", "uvt-polar", "uvt-cavity", "npt", "gibbs-vle",
           "ptemp", "warmstart")


def _pick(value, default):
    return default if value is None else value


def run_study(study: str, args, device) -> dict:
    """One study at the command line's settings (each unset one the
    study's default): its JSON record."""
    if study.startswith("uvt-"):
        return uvt.run(study, steps=_pick(args.steps, uvt.STEPS),
                       corrtime=_pick(args.corrtime, uvt.CORRTIME),
                       seed=_pick(args.seed, uvt.SEED), device=device)
    if study == "npt":
        return npt.run(steps=_pick(args.steps, npt.STEPS),
                       corrtime=_pick(args.corrtime, npt.CORRTIME),
                       seed=_pick(args.seed, npt.SEED), device=device)
    if study == "gibbs-vle":
        return gibbs_vle.run(steps=_pick(args.steps, gibbs_vle.STEPS),
                             corrtime=_pick(args.corrtime,
                                            gibbs_vle.CORRTIME),
                             seed=_pick(args.seed, gibbs_vle.SEED),
                             device=device, nbox=args.nbox)
    if study == "ptemp":
        return ptemp.run(steps=_pick(args.steps, ptemp.STEPS),
                         seed=_pick(args.seed, ptemp.SEED), device=device,
                         swap_every=_pick(args.corrtime, ptemp.SWAP_EVERY))
    chunk_steps = _pick(args.corrtime, warmstart.CHUNK_STEPS)
    steps = _pick(args.steps, warmstart.CHUNKS * warmstart.CHUNK_STEPS)
    return warmstart.run(chunks=max(steps // chunk_steps, 1),
                         chunk_steps=chunk_steps, seed=_pick(args.seed, 0),
                         device=device, mini=args.mini)


def launch_counts() -> dict:
    """Each kernel wrapper's launch count (ops/cuda_polar, ops/cuda_cavity:
    one per kernel launched on the card, none for a CPU tensor)."""
    from ..ops import cuda_cavity, cuda_polar
    return {name: getattr(mod, name).launches for mod, name in (
        (cuda_polar, "contract_planes"), (cuda_polar, "contract_planes_sym"),
        (cuda_polar, "contract_planes_tri"),
        (cuda_polar, "write_plane_strips"), (cuda_cavity, "occupancy"))}


def record(study: str, args, device, card, rows_dir=None) -> dict:
    """The JSON line of ``study``: run_study's record with the kernels it
    launched, the device and the card added; its per-corrtime samples go
    to ``rows_dir``/<study>.rows.txt when a directory is given."""
    before = launch_counts()
    rec = run_study(study, args, device)
    rec["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    rows = rec.pop("rows", None)
    if rows_dir and rows is not None:
        os.makedirs(rows_dir, exist_ok=True)
        with open(os.path.join(rows_dir, f"{study}.rows.txt"), "w") as f:
            for r in rows:
                f.write(" ".join(repr(x) for x in r) + "\n")
    rec["device"] = str(device)
    rec["card"] = card
    return rec


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpmcxx_tpu_torch.validate",
        description="hold the port's sampled ensembles to outside truths")
    p.add_argument("study", choices=STUDIES + ("all",))
    p.add_argument("--steps", type=int, default=None,
                   help="MC steps (per run for ptemp, per variant for "
                        "warmstart); default: the tool's")
    p.add_argument("--corrtime", type=int, default=None,
                   help="steps per sample (ptemp: per swap; warmstart: "
                        "per checkpoint); default: the tool's")
    p.add_argument("--seed", type=int, default=None,
                   help="the chain's seed; default: the tool's")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="torch device to run on (default: cuda)")
    p.add_argument("--nbox", type=int, default=systems.N_BOX,
                   help="gibbs-vle: atoms per box at the even split")
    p.add_argument("--mini", action="store_true",
                   help="warmstart: the tool's shrunk CO2 geometry")
    p.add_argument("--rows", metavar="DIR", default=None,
                   help="write each study's per-corrtime samples to "
                        "DIR/<study>.rows.txt")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("mpmcxx-torch validate: no CUDA device is "
                         "available; pass --device cpu to run on the CPU\n")
        return 2
    card = common.card(device)
    studies = STUDIES if args.study == "all" else (args.study,)
    disagree = False
    for study in studies:
        rec = record(study, args, device, card, args.rows)
        print(json.dumps(rec), flush=True)
        disagree |= rec["verdict"] != "agree"
    return 1 if disagree else 0
