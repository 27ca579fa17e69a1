"""Command-line entry point.

JAX twin: mpmcxx_tpu/cli.py.  The reference CLI contract
(src/main.cpp:24-66, src/args_etc.h:216-263):
``mpmcxx-torch [-P <trotter#>] [-xyz <frames file>] <input file>``, plus
signal-safe shutdown (SIGTERM/SIGUSR1/SIGUSR2 print and exit, as in
src/args_etc.h:306-347), ``--replicas R`` and ``--device`` (default
``cuda``).  Without a CUDA device the default exits non-zero; ``--device
cpu`` runs the plain PyTorch versions of the kernels on the CPU.
``--trace FILE`` runs the program's tracer (``tracing.py``) from before
the set-up to the run's end, then writes its ``snapshot()`` to FILE as
JSON: per span its count and total, self and longest ns, the counters
(``host_sync`` by span on a CUDA device), the moves and K1-K6's launches.

The dispatch is the twin's (cli.py:57-71): a pi_nvt input runs
``PISimulation`` and a Gibbs input ``GibbsSimulation``, both ignoring
``--replicas``; then ``--replicas R > 1`` or ``parallel_tempering`` runs
R replica chains (at least 2 under tempering) through
``parallel.driver.ReplicaSimulation``; anything else ``Simulation``.

Usage: python -m mpmcxx_tpu_torch.cli [--device cpu] [-P 8]
       [-xyz frames.xyz] [--replicas 4] [--trace spans.json] input.in
"""

from __future__ import annotations

import argparse
import json
import signal
import sys

from . import constants as const
from . import tracing


def _install_signal_handlers():
    def handler(signum, frame):
        sys.stderr.write(f"MPMC-TORCH: received signal {signum}; exiting.\n")
        raise SystemExit(104)  # interrupt_signal_received

    for sig in (signal.SIGTERM, signal.SIGUSR1, signal.SIGUSR2):
        try:
            signal.signal(sig, handler)
        except (ValueError, OSError):
            pass


def dispatch(cfg, replicas: int = 1, quiet: bool = False, device="cuda"):
    """The simulation the command line runs for ``cfg`` (the twin's
    cli.py:57-71 order): PI, then Gibbs, then replicas, else one chain."""
    if cfg.ensemble in (const.ENSEMBLE_PATH_INTEGRAL_NVT,
                        const.ENSEMBLE_NVT_GIBBS) or \
            not (replicas > 1 or cfg.parallel_tempering):
        from .runner import make_simulation as one_system
        return one_system(cfg, quiet=quiet, device=device)
    from .parallel.driver import ReplicaSimulation
    n = max(replicas, 2 if cfg.parallel_tempering else 1)
    return ReplicaSimulation(cfg, n, quiet=quiet, device=device)


def run(argv=None):
    """Parse ``argv``, build and run the input's simulation (Simulation,
    PISimulation, GibbsSimulation or ReplicaSimulation); returns (exit
    code, the simulation or None)."""
    parser = argparse.ArgumentParser(
        prog="mpmcxx-torch",
        description="Massively Parallel Monte Carlo on PyTorch/CUDA")
    parser.add_argument("-P", type=int, default=0, metavar="TROTTER",
                        help="Trotter number (bead count) for pi_nvt runs")
    parser.add_argument("-xyz", type=str, default="", metavar="FILE",
                        help="write all-bead XYZ frames at each corrtime")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--replicas", type=int, default=1,
                        help="number of independent replica chains, run "
                             "one after the other on the device")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("--trace", default="", metavar="FILE",
                        help="trace the run's spans and host syncs and "
                             "write their totals to FILE as JSON")
    parser.add_argument("input", help="simulation input file")
    args = parser.parse_args(argv)

    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("mpmcxx-torch: no CUDA device is available; pass "
                         "--device cpu to run on the CPU\n")
        return 2, None

    _install_signal_handlers()
    if not args.trace:
        return _run(args, device)
    tracing.enable()
    try:
        return _run(args, device)
    finally:
        tracing.disable()
        with open(args.trace, "w") as f:
            json.dump(tracing.snapshot(), f, indent=1, sort_keys=True)


def _run(args, device):
    from .config.parser import read_config
    cfg = read_config(args.input)
    if not args.quiet:
        print(f"SIM_CONTROL: running parameters found in: {args.input}")
        print("SIM_CONTROL: Finished reading config file.")
    if args.P:
        cfg.total_trotter_number = args.P

    sim = dispatch(cfg, args.replicas, quiet=args.quiet, device=device)
    if args.xyz and cfg.ensemble == const.ENSEMBLE_PATH_INTEGRAL_NVT:
        sim.xyz_path = args.xyz
    if not args.quiet:
        from .io.output import display_sim_control
        n_sys = getattr(sim, "P", None) or \
            (2 if cfg.ensemble == const.ENSEMBLE_NVT_GIBBS else 1)
        display_sim_control(sim.cfg, n_systems=n_sys)
    sim.run()
    print("SIM_CONTROL: Simulation complete!")
    return 0, sim


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
