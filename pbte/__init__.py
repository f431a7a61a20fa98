"""pbte — JAX solver framework for the steady-state non-gray phonon
Boltzmann Transport Equation (PBTE) under the SMRT/BGK approximation.

A from-scratch JAX/XLA re-design of the capabilities of
dingtao-shen/DG-Solver-for-PBTE-with-MFEM:

- upwind Discontinuous Galerkin (L2) spatial discretization on unstructured
  2D tri/quad and 3D tet/hex meshes,
- discrete-ordinates angular discretization (product quadrature),
- non-gray spectral bands for 2 phonon branches (LA/TA, quadratic dispersion),
- source iteration with exact per-ordinate mesh sweeps.

Unlike the reference (per-element sequential sweeps + per-element dense LU on
CPU), the sweep here is expressed as a `lax.scan` over wavefront *levels* of the
per-direction upwind DAG with batched dense solves, so each step is a large
batched matmul suited to an accelerator; ordinates/bands/space are sharded over a
`jax.sharding.Mesh` with XLA collectives instead of MPI.

Layout (mirrors SURVEY.md section 7):
    material/  phonon spectral tables            (ref: src/PhononProperties.cpp)
    angular/   solid-angle quadrature            (ref: src/AngularQuadrature.cpp)
    mesh/      mesh ingestion -> MeshArrays      (ref: src/SpatialMesh.cpp)
    fem/       bases + batched DG assembly       (ref: src/ElementIntegrator.cpp)
    sweep/     upwind DAG levelization           (ref: src/AngularSweepOrder.cpp)
    solver/    source iteration                  (ref: src/PBTESolver.cpp)
    models/    macroscopic closure               (ref: src/MacroscopicQuantities.cpp)
    ops/       one-hot ring selection plans      (new; general-mesh ring)
    parallel/  device-mesh sharding, partitions  (ref: MPI/METIS machinery)
    io/        config + golden writers + VTU     (ref: src/Utils.cpp, config/)
    validation/ partition invariants             (ref: Validation/)
"""

__version__ = "0.1.0"
