"""System diagnostics: the counterparts of the JAX package's diagnostic
scripts, one module each, with the script's name, arguments, configuration
and printed keys.

- timing: ``perf_breakdown`` (the bench's frames by section),
  ``mapper_step_probe`` (ms a mapping iteration and a pose solve),
  ``dispatch_probe`` (cost per call, and a mapping iteration taken apart);
- accuracy: ``lag_probe`` (tracker lag against its warm start),
  ``track_diag`` (the loss landscape at the true pose), ``depth_diag``
  (depth error by stage), ``bias_probe`` (depth bias),
  ``saturation_probe`` (decoder saturation on fresh grids) and
  ``accuracy_probe`` (ATE, raw error and RPE under one variation).

Each runs as ``python -m niceslam_tpu_torch.diagnostics.<name>``, on the card
unless ``--cpu`` is given, and raises where no card is found. Each module
has a configuration builder, a ``measure`` that returns unrounded numbers,
and a ``main(argv)`` that rounds and prints as the script does.
``world.py`` holds the bench world that they share.
"""
