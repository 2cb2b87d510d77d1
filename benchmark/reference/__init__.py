"""The plain reference of the benchmark's check.

Frozen copies of the program's plain PyTorch code, taken when the benchmark
was defined, so that the check holds the program against code that later
changes to the program do not touch: the pipeline (``registration.py``),
the plain versions of the five hand-written kernels (FPS, the fused
stratified query, SPT moments and the cell query, the conv stack), the
geometry, the nets, the solvers and the snapshot reader. Nothing here
imports the program, JAX or the JAX package; docstrings that name a
"counterpart" refer to the module the program's copy mirrors.
"""
