"""Command-line entry point.

JAX twin: mpmcxx_tpu/cli.py.  The reference CLI contract
(src/main.cpp:24-66, src/args_etc.h:216-263):
``mpmcxx-torch [-P <trotter#>] [-xyz <frames file>] <input file>``, plus
signal-safe shutdown (SIGTERM/SIGUSR1/SIGUSR2 print and exit, as in
src/args_etc.h:306-347) and ``--device`` (default ``cuda``).  Without a
CUDA device the default exits non-zero; ``--device cpu`` runs the plain
PyTorch versions of the kernels on the CPU.

Usage: python -m mpmcxx_tpu_torch.cli [--device cpu] input.in
"""

from __future__ import annotations

import argparse
import signal
import sys

from . import constants as const


def _install_signal_handlers():
    def handler(signum, frame):
        sys.stderr.write(f"MPMC-TORCH: received signal {signum}; exiting.\n")
        raise SystemExit(104)  # interrupt_signal_received

    for sig in (signal.SIGTERM, signal.SIGUSR1, signal.SIGUSR2):
        try:
            signal.signal(sig, handler)
        except (ValueError, OSError):
            pass


def run(argv=None):
    """Parse ``argv``, build and run the Simulation; returns (exit code,
    the Simulation or None)."""
    parser = argparse.ArgumentParser(
        prog="mpmcxx-torch",
        description="Massively Parallel Monte Carlo on PyTorch/CUDA")
    parser.add_argument("-P", type=int, default=0, metavar="TROTTER",
                        help="Trotter number (bead count) for pi_nvt runs")
    parser.add_argument("-xyz", type=str, default="", metavar="FILE",
                        help="write all-bead XYZ frames at each corrtime")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--replicas", type=int, default=1,
                        help="number of independent replica chains")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("input", help="simulation input file")
    args = parser.parse_args(argv)

    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("mpmcxx-torch: no CUDA device is available; pass "
                         "--device cpu to run on the CPU\n")
        return 2, None

    _install_signal_handlers()

    from .config.parser import read_config
    cfg = read_config(args.input)
    if not args.quiet:
        print(f"SIM_CONTROL: running parameters found in: {args.input}")
        print("SIM_CONTROL: Finished reading config file.")
    if args.P:
        cfg.total_trotter_number = args.P
    if cfg.ensemble == const.ENSEMBLE_PATH_INTEGRAL_NVT or args.xyz:
        raise NotImplementedError("path-integral runs (-P, -xyz)")
    if args.replicas > 1:
        raise NotImplementedError("--replicas")

    from .runner import Simulation
    sim = Simulation(cfg, quiet=args.quiet, device=device)
    if not args.quiet:
        from .io.output import display_sim_control
        display_sim_control(sim.cfg, n_systems=1)
    sim.run()
    print("SIM_CONTROL: Simulation complete!")
    return 0, sim


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
