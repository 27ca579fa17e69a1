"""The SCF contraction's share of its roofline in the profiled chunks, in
%: the least time of the contractions the solver needed (its iterations
per move, plus Palmo's one where configured; each one triangle of the
symmetric f32 planes at the state's slot count, benchmark/roofline.py)
over the device time of the kernels mapped to ``scf_contraction``
(kernels/*.json), whichever ran."""

from ..roofline import contraction_least_s


def read(record):
    if not record["ops"] or not record["chunk_iterations"] or \
            record["peak"] is None:
        return None
    frags = [f for k in record["kernels"] if k["work"] == "scf_contraction"
             for f in k["fragments"]]
    t = sum(d for name, _, d, lab in record["ops"]
            if lab == "chunk" and any(f in name for f in frags))
    if t <= 0.0:
        return None
    its = record["chunk_iterations"]
    n = sum(its) + (len(its) if record["palmo"] else 0)
    least = contraction_least_s(record["slots"], record["planes"],
                                record["peak"])
    return 100.0 * n * least / t
