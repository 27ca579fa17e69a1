"""Plain reference of the NVT-Gibbs ensemble's joint acceptance factors.

MPMC++'s ``boltzmann_factor_NVT_Gibbs`` (src/SimulationControl.Gibbs.cpp:
358-524) for the two moves that change both boxes at once, in float64
from a step's counts, volumes and energy changes (K):

- a transfer from box ``src`` to box ``dst`` (:416-441):
  (N_src / V_src) (V_dst / (N_dst + 1)) exp(-(dE_src + dE_dst) / T),
  with the counts after the move, as the reference evaluates them (the
  energy call refreshes its observables' N before the factor);
- a coupled volume exchange that draws ln V_A uniformly and gives box B
  the rest: (V_A' / V_A)^(N_A + 1) (V_B' / V_B)^N_B
  exp(-(dE_A + dE_B) / T).  The reference's algebra (:466-468) reduces
  to (V / V')^N, the reciprocal of detailed balance; this is the factor
  of that proposal, the Jacobian of ln V_A adding one power of
  V_A' / V_A, which the port keeps on purpose (README, Fidelity).

It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

# no product of the reference runs in TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def transfer_factor(n_src: float, n_dst: float, v_src: float, v_dst: float,
                    de_src: float, de_dst: float, temperature: float
                    ) -> float:
    """A transfer's factor; ``n_src``, ``n_dst`` the counts after it."""
    n_src, n_dst, v_src, v_dst = map(np.float64, (n_src, n_dst, v_src,
                                                  v_dst))
    return float((n_src / v_src) * (v_dst / (n_dst + 1.0)) *
                 np.exp(-(np.float64(de_src) + de_dst) / temperature))


def volume_factor(n_a: float, n_b: float, v_a: float, v_a_new: float,
                  v_b: float, v_b_new: float, de_a: float, de_b: float,
                  temperature: float) -> float:
    """A coupled volume exchange's factor; the counts are the boxes'
    (a volume exchange changes none)."""
    v_a, v_a_new, v_b, v_b_new = map(np.float64, (v_a, v_a_new, v_b,
                                                  v_b_new))
    return float((v_a_new / v_a) ** (np.float64(n_a) + 1.0) *
                 (v_b_new / v_b) ** np.float64(n_b) *
                 np.exp(-(np.float64(de_a) + de_b) / temperature))
