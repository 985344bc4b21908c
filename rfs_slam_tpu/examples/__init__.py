"""Runnable examples mirroring the reference's ``bin/examples`` programs.

Reference: CMakeLists.txt:169-189 builds five example executables
(``linearAssignment_{MurtyAlgorithm,CostMatrixPartitioning,
LexicographicOrdering}``, ``ospaError``, ``spatialIndexTree``).  Each module
here is the JAX equivalent, runnable as
``python -m rfs_slam_tpu.examples.<name>``, and doubles as a semi-automated
oracle exactly like the reference examples (SURVEY.md section 4).
"""
