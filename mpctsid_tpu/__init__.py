"""mpctsid_tpu — batched JAX MPC + TSID whole-body-control engine for Solo-12-class quadrupeds.

A from-scratch JAX/XLA rebuild of the capability contract of the
``thomascbrs/mpc-tsid`` reference (convex centroidal-dynamics MPC cascaded into a
TSID-style inverse-dynamics QP).  The reference mount was empty at survey time
(SURVEY.md §0), so parity is defined against this repo's own CPU oracle
(``mpctsid_tpu.oracle``) and the capability contract in BASELINE.json:5-11.

Layout (SURVEY.md §7.1):
  model/    Solo-12 parameters, gait definitions (pure data)
  dyn/      JAX rigid-body dynamics: FK, Jacobians, CRBA, RNEA (replaces Pinocchio)
  plan/     gait scheduler, footstep planner, swing polynomials, x_ref rollout
  qp/       batched dense ADMM QP core (replaces OSQP + eiquadprog)
  mpc/      SRB discretization + condensation -> qp/ (centroidal MPC)
  wbc/      TSID-style task assembly -> qp/ (whole-body control)
  est/      complementary-filter state estimator
  cascade/  per-tick controller; lax.scan rollout at 1 kHz WBC / 50 Hz MPC
  env/      batched penalty-contact plant for Monte-Carlo rollouts
  dist/     Mesh / shard_map scenario sharding
  oracle/   independent numpy float64 CPU reference (the parity target)
  bench/    solves/s + latency harness
"""

__version__ = "0.1.0"
