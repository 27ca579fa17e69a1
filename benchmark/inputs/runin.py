"""The ``run.in`` of a cell: the configuration's physics keys, the traffic
mix's move and solver keys, the box, the seed and every output sent to
/dev/null."""

from __future__ import annotations

# every file the CLI would write; the benchmark keeps none of them
OUTPUTS = ("energy_output", "energy_output_csv", "pqr_output",
           "pqr_restart", "traj_output", "dipole_output", "field_output",
           "frozen_output", "pop_histogram_output")


def _word(v) -> str:
    if isinstance(v, bool):
        return "on" if v else "off"
    return str(v)


def run_in(config: dict, traffic: dict, seed: int, pqr: str) -> str:
    """The input file's text.  ``numsteps`` is never reached: the harness
    drives the chain itself."""
    L = config["geometry"]["box"]
    keys = {"job_name": "bench", **config["physics"], **traffic["runin"],
            "corrtime": traffic["corrtime"], "numsteps": 1 << 40,
            "seed": int(seed), "pqr_input": pqr,
            "basis1": f"{L} 0 0", "basis2": f"0 {L} 0",
            "basis3": f"0 0 {L}"}
    keys.update({k: "/dev/null" for k in OUTPUTS})
    return "".join(f"{k} {_word(v)}\n" for k, v in keys.items())
