"""Visual-inertial bundle adjustment on an accelerator, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
facebookresearch/visual_inertial_bundle_adjustment: full-state re-optimization
(poses, velocities, angular velocities, landmarks, and all sensor calibration
modeled as random walks over 5s windows) of Aria-style recordings by
Levenberg-Marquardt over a factor graph, with landmark Schur complement and a
distributed reduced-camera-system solve.

Design (data-parallel, not a port):
  - Variables live in flat structure-of-arrays tables (`problem.variables`),
    retraction is a pure function over the whole table.
  - Factors are dense batches per type; residuals are pure JAX functions, the
    Gauss-Newton matvec is JVP->reweight->VJP (no materialized global Hessian).
  - Landmarks are Schur-eliminated with batched 3x3 block inverses; the reduced
    system is solved by dense Cholesky (small) or block-Jacobi PCG (large /
    sharded over a device mesh).
  - IMU preintegration (incl. covariance and time-offset Jacobian columns) is a
    `lax.scan` over merged sample boundaries, vmapped over all intervals.
"""

__version__ = "0.1.0"
