"""One module a model, ``models/<model>.py``, found by file from the
configuration's ``options["model"]`` (spec.cell), so that a model is added
by adding files.  The harness reaches a model only through these names:

- ``make_inputs(options, seed, start_it, device, warm_radii)``: what both
  sides read, made by the benchmark from the seed (weights, pose noise,
  images); handed unchanged to ``build`` and to ``Reference``;
- ``build(inputs, device)``: the program's trainer at the cell's first
  iteration, keeping the trainer contract of program.py;
- ``params(trainer)``: {leaf: tensor} of the trainer's parameters, the
  same leaves the reference names; ``first_grad_norms(trainer)``: after
  the first step, {leaf: 0-d tensor}, the norm of each leaf's gradient as
  the model's optimiser received it;
- ``Reference``: ``Reference(inputs, device).run(n)`` works the first
  ``n`` steps out again in plain PyTorch and returns at least ``losses``,
  ``grad_norms`` and ``change_norms`` as program.first_steps does (what
  judge.py compares); ``tf32=True`` and ``fault=`` ("half_batch",
  "answer") give tools/control.py its control and planted faults;
- ``start_iteration(options, anchor)`` and ``schedule_moves(options, start,
  n)``: a traffic mix's ``start``, in whatever form the model reads (BAT:
  an anchor in its schedule lists; the test stub: ``{"iteration": n}``),
  as an iteration, and the schedule's changes to the trained function
  inside the ``n`` compared steps (none may be);
- ``step_shape(cell, ref)`` and ``census``: the shape the census counts,
  from the cell and the reference's result, and the module that counts it
  (per-layer readers see them as ``ctx.shape`` and ``ctx.census``);
- ``describe(trainer)``: one log line of the trainer as it stands.
"""
