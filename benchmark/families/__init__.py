"""Model families: what the correctness check and the cost yardstick need to
know of one kind of map.

A configuration file under ``benchmark/configs/`` names its family in an
optional top-level ``"family"`` key, beside ``source`` and ``slam`` (not in
the ``slam`` block, so the port's configuration never sees it); without the
key the family is ``nice``, NICE-SLAM's hierarchical feature grids.
``spec.family(name)`` loads ``benchmark/families/<name>.py`` by its file,
as ``spec.metric_reader`` loads a metric. A new family is a new file here
(with its plain reference under ``benchmark/reference/``); nothing of the
harness changes.

What stays generic in ``harness/check.py``, for every family: the
``Recorder`` around the port's ``NiceSLAM._solve``, ``_map_pass`` and
``Programs.frustum_masks``; which frames map and how many iterations an
event runs (``mapping.iters``, or ``bootstrap_iters`` in the bootstrap);
keyframe admission and the store's ``max_keyframes``; the window and BA's
pinned set; the pixels each sampled call draws from its recorded generator
state (the half-batch fault keeps the first half of each draw); TF32 on or
off around the reference; the comparison of loss rows, of the maps a call
read and of the parameter groups' changes.

``cfg`` below is always a configuration's ``slam`` block as run (the cell's
traffic and any test overrides applied). ``grids`` is a dict of named
tensors (``{}`` for a map without grids) and ``decoders`` a tree of nested
dicts and lists of tensors, as the port's ``NiceSLAM.state`` holds them.
A family module defines these names:

``files(cfg, root) -> Dict[str, str]``
    The configuration's keys (dotted, as ``spec.with_overrides`` takes
    them) that name files the port reads, each with its path resolved
    under ``root``, the checkout's root. ``{}`` where it reads none.

``initial_map(cfg, seed, root) -> (grids, decoders)``
    The map the port must start from with ``seed``, built by the family's
    reference from the seed and the files ``files`` names, on the CPU.
    ``start_gap`` compares it leaf by leaf with the port's; it has to be
    exact.

``passes(cfg, iters, admitted) -> List[dict]``
    The mapping passes of one event, in order, where ``iters`` is the
    event's iteration count and ``admitted`` the number of keyframes
    admitted before it. Each dict has ``coarse`` (bool: a pass that keeps
    the fixed coarse window), ``iters`` (its iterations), ``lr_factor``
    (float), ``ba`` (bool: the window's cameras move) and ``plan`` (the
    stage name of each iteration, a list of ``iters`` strings, as the port
    names its stages).

``solve(cfg, item, draws, device) -> (pose, losses)``
    The reference's pose solve of a sampled solve: ``item`` is the
    recorder's dict (``grids``, ``decoders``, ``color``, ``depth``,
    ``init``: what the port's call read), ``draws`` the list of ``(i, j)``
    pixel index tensors of each iteration. Returns the final ``[4, 4]``
    camera-to-world pose and the ``[iters]`` loss of each iteration.

``map_pass(cfg, item, spec, fixed, draws, device, loss_scale) -> tuple``
    The reference's mapping pass of a sampled pass: ``item`` is the
    recorder's dict (``grids``, ``decoders``, ``cams``, ``poses``,
    ``colors``, ``depths``, ``valid``: what the port's call read), ``spec``
    the pass's dict from ``passes``, ``fixed`` the pinned window slots
    (bool array), ``draws`` the ``(frame, i, j)`` index tensors of each
    iteration, ``loss_scale`` a factor on the loss (2 for the half-batch
    fault). Returns ``(grids, decoders, cams, losses [iters], first)``,
    ``first`` the norm of the first gradient each trained leaf got, keyed
    by tuples whose first two entries are the leaf's group in ``groups``
    (``("grids", level)``, ``("decoders", level, path)``, ``("cams",)``).

``groups(grids, decoders, cams, cfg, ba) -> Dict[tuple, Tensor]``
    A pass's parameters as the family's optimiser groups them, each group
    one tensor (flattened where it has several leaves), the cameras as
    ``("cams",)`` when ``ba``. ``map_change_gap`` compares the norm of each
    group's change over a pass.

``costs``
    A module (or any object with these functions: the family's own file
    may define them) with the yardstick's formulas that the metric readers
    call:
    ``grid_bytes(cfg) -> Dict[str, int]`` (bytes of each grid),
    ``window_work(cfg, solves, stages, grid_bytes) -> (flops, bytes)`` of
    ``solves`` pose solves and the mapping iterations whose stage names are
    ``stages``, ``sampler_bytes(cfg, solves, rows, grid_bytes)`` (the least
    bytes of the trilinear sampler's work, ``rows`` the ``(stage, ba)`` of
    each mapping iteration; ``None`` for a family with no sampler, whose
    cells then report no ``sampler_roofline``) and ``peaks_for(device
    name) -> (fp32 FLOP/s, HBM bytes/s)``.
"""
