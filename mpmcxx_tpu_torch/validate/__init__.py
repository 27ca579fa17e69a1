"""The port's physics validation: sampled ensembles held to outside truths.

Twins: the studies of tools/ that need no reference binary, each on the
port and, by default, on the card:

    python -m mpmcxx_tpu_torch.validate <study> [--steps N] [--seed S]
        [--corrtime C] [--device cuda|cpu] [--rows DIR]

==============  ====================================  =====================
study           twin                                  truth
==============  ====================================  =====================
``uvt-argon``   tools/uvt_crosscheck.py               the reference binary
``uvt-polar``   tools/uvt_crosscheck.py --polar       its saved rows, JAX's
``uvt-cavity``  tools/uvt_crosscheck.py --cavity      the reference binary
``npt``         tools/npt_crosscheck.py               the reference binary
``gibbs-vle``   tools/gibbs_vle.py (``--nbox``)       Lotfi/Vrabec/Fischer
``ptemp``       tools/ptemp_validate.py               independent chains,
                                                      the Metropolis law
``warmstart``   tools/warmstart_study.py (``--mini``) a converged SCF
``all``         each of the above in turn, each with the ``--steps`` given
==============  ====================================  =====================

Each study prints one JSON line on stdout: the steps and the wall time,
each mean with its block and tau-corrected errors, the sigma distance to
each truth, the verdict ("agree" when every distance is under 3 sigma,
the tools' gate) and the card's name and power limit.  Progress and the
tools' tables go to stderr.  The exit code is 1 when a study disagrees;
without CUDA and without ``--device cpu`` it is 2 (no fallback).

The package imports torch, numpy and the port; never jax, the JAX
package or tools/ (stats.py and systems.py keep their own copies).
"""
