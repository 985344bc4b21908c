"""rfs_slam_tpu — a Random-Finite-Set SLAM engine in JAX.

A JAX/XLA implementation of the capabilities of the
kykleung/RFS-SLAM C++ library (RB-PHD-SLAM, FastSLAM / MH-FastSLAM, OSPA/COLA
evaluation, Hungarian / Murty / JCBB data association), redesigned as
fixed-shape, masked, structure-of-arrays array programs:

* particles and per-particle Gaussian-mixture maps are padded SoA arrays
  (``[P, M, D]`` means, ``[P, M, D, D]`` covariances, ``[P, M]`` weights,
  alive masks) that shard over a ``jax.sharding.Mesh`` along the particle axis;
* every per-timestep phase (propagate, batched EKF map update, importance
  weighting with the RFS measurement likelihood, merge/prune, resampling) is a
  pure jitted function;
* cross-device communication is limited to weight normalization / ESS (psum)
  and the resampling ancestor gather, exactly the two globally synchronizing
  steps of the reference (reference: ParticleFilter.hpp:352-363, 399-492).

See SURVEY.md at the repository root for the full structural analysis of the
reference library and the mapping from its component inventory to this package.
"""

__version__ = "0.1.0"

from rfs_slam_tpu.core import gaussian  # noqa: F401
