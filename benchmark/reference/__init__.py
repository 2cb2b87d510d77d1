"""The plain references of the benchmark's check.

Frozen copies of the program's plain PyTorch code, taken when the benchmark
was defined, so that the check holds the program against code that later
changes to the program do not touch: the pipeline (``registration.py``),
the plain versions of the five hand-written kernels (FPS, the fused
stratified query, SPT moments and the cell query, the conv stack), the
geometry, the nets, the solvers and the snapshot reader. Nothing here
imports the program, JAX or the JAX package; docstrings that name a
"counterpart" refer to the module the program's copy mirrors.

A configuration file names its reference: ``"reference": "<name>"`` in
``configs/<config>.json`` makes the check load ``reference/<name>.py`` by
its file (``benchmark.check.load_reference``), as the harness loads
entries and generators; a file without the key takes ``registration``. A
new solver or pipeline brings its reference as a new module here and
names it in its configuration file, with no edit to another file.

What a reference module offers (``benchmark/check.py`` calls nothing else,
and checks at set-up, before the pool and the window, that each is there):

- ``Statics.from_dict(statics: dict) -> Statics``: the configuration
  file's ``"statics"``, with at least ``max_points`` and ``num_scales``.
  It raises ``ValueError`` or ``NotImplementedError`` for any statics the
  module does not implement (``registration`` takes the RANSAC solver and
  the fused stratified query alone), so that a configuration its
  reference cannot check stops at set-up with the reference's message.
- ``Cloud(xyz, mask)``: one cloud (``[N, 3]`` float32, ``[N]`` bool) or a
  batch of them (``[B, N, 3]``, ``[B, N]``).
- ``Draws(strat_src, strat_tgt, ransac)``: the served pairs' random draws,
  as the entry hands them over (``Draws(*draws)``), with a leading batch
  axis.
- ``Result(pose, num_inliers, num_mutual, num_consensus, scales_used,
  valid)``: tensors, ``pose`` a 4 x 4 rigid transform.
- ``build_models(statics, state_dicts, device) -> models``: the nets from
  ``weights.load_snapshot`` of the configuration's ``"snapshot"``.
- ``prepare_cloud(xyz: np.ndarray, max_points, seed, device) -> Cloud``:
  the host ingest of one raw cloud (the check's seeds: ``2 i`` for pair
  ``i``'s source, ``2 i + 1`` for its target).
- ``register_batch(models, statics, src: Cloud, tgt: Cloud, draws: Draws,
  scales: tuple) -> Result``: a batch of pairs through ``scales``, each
  field with the batch's leading axis. The check's single-pair groups (any
  kind but ``"two_phase"``: ``entries/online.py``'s ``"single"``) call it
  at a batch of one through every scale.
- ``register_batches(models, statics, srcs, tgts, batches, draws) ->
  list[Result]``: two-phase serving, the check's ``"two_phase"`` groups
  (``entries/batched.py``): ``batches`` lists the pair indices of each
  batch, ``draws`` a (phase-1, phase-2) pair of ``Draws`` a batch; one
  ``Result`` of single-pair tensors a pair, in pair order.

A reference runs in the configuration's precision and leaves the TF32
flags as the check sets them (off; on for the control), under
``torch.no_grad``.
"""
