"""What the validation studies share: running an input in a directory,
the verdict of a set of sigma distances and the JSON line's common keys."""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import time

import torch

from .stats import GATE_SIGMA


def log(study: str, msg: str) -> None:
    """A progress line on stderr (stdout carries the JSON lines)."""
    print(f"[{study}] {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def in_dir(path: str):
    """Run the block with ``path`` as the working directory."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def write_inputs(d: str, run_in: str, box) -> None:
    """``run.in`` and ``boxA.pqr`` in ``d``: ``box`` is the PQR's text, or
    a path to copy."""
    with open(os.path.join(d, "run.in"), "w") as f:
        f.write(run_in)
    if os.path.exists(str(box)):
        shutil.copy(box, os.path.join(d, "boxA.pqr"))
    else:
        with open(os.path.join(d, "boxA.pqr"), "w") as f:
            f.write(box)


def run_simulation(d: str, device, polar_mixed: bool = False):
    """runner.Simulation of ``d``/run.in, run quietly in ``d`` on
    ``device`` (``polar_mixed`` set on the parsed config, as the uVT tool
    sets it for ``--polar``).  Returns (the finished Simulation, its
    molecule slots at the start)."""
    from ..config.parser import read_config
    from ..runner import Simulation
    with in_dir(d):
        cfg = read_config("run.in")
        if polar_mixed:
            cfg.polar_mixed = True
        sim = Simulation(cfg, quiet=True, device=device)
        slots = sim.state.n_mol_slots
        sim.run()
    return sim, slots


def verdict(sigmas) -> str:
    """"agree" when every sigma distance is under the tools' 3-sigma gate,
    else "disagree"."""
    return "agree" if all(s < GATE_SIGMA for s in sigmas) else "disagree"


def card(device) -> object:
    """The card's {"name", "power_limit"} from nvidia-smi, or "cpu"."""
    from ..bench import device_info
    return device_info(torch.device(device))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Clock:
    """Wall seconds since construction, the device synchronised first."""

    def __init__(self, device):
        self.device = device
        sync(device)
        self.t0 = time.time()

    def seconds(self) -> float:
        sync(self.device)
        return time.time() - self.t0


def mean_record(mean: float, berr: float, terr: float, **extra) -> dict:
    """A mean with its block and tau-corrected errors and the larger of
    the two, the one the gate uses."""
    return dict(mean=mean, block_err=berr, tau_err=terr,
                err=max(berr, terr), **extra)
