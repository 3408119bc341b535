"""A frozen copy of the plain code of the port's ice dynamics: the
configuration schema, the mesh and its operators, the mesh data, the
predictor-corrector step with the DIVA and BPA stress balances, the
thickness solve, the Krylov solvers and the thermodynamics step.

The benchmark's plain reference. It is the port's code as the benchmark was
defined, kept apart so that no later change of the port changes it, with
three changes: every operator and column solve runs its plain tensor
version on any device (no CUDA kernel is built or loaded); and the type
that an operator rounds x through (`ops.cuda_spmv.ROUND_DTYPE`) and that
the heat solve rounds its operands through (`ops.cuda_heat.HEAT_ROUND`)
can be lowered, for the control of the comparison. It imports nothing of
the port or of the JAX package.
"""
