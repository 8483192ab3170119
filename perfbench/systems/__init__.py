"""The systems under test: one module a kind of system, named by a
configuration's ``"system"`` key (``<paths[0]>/systems/<system>.py``).

The harness (``pb/runner.py``, ``pb/cli.py``, ``pb/ranks.py``) knows a
system only through what its module gives:

- ``params(cfg, seed)``: the program's weights made from the seed, on
  the host (``None`` where it has none);
- ``build(cfg, params, device, ranks) -> System``; ``ranks`` is true
  for one rank's part of a run over several cards;
- ``feed(traffic, cfg, shards, seed, device)``: the cell's traffic for
  the program's ``shards`` (global shard ids); ``feed.tick(t)`` returns
  the tuple of arguments of tick ``t``'s ``System.step(*args)``, and
  ``feed.items_per_tick`` counts the work items that ``items_per_s``
  counts a tick, over every shard the run offers;
- ``check(cfg, params, traffic, seed, device, ticks, final, n_ticks,
  shards) -> (numbers, counter_diffs)``: the system's own plain
  reference over the same feed, made again from the seed, held against
  the program's checked ``ticks`` (``{t: {"out", "before",
  "after"}}``: ``System.outputs`` of the tick, ``System.counters``
  before and after it), its counters at the end (``final``) and its
  ``n_ticks`` ticks; ``numbers`` are judged against the configuration's
  ``limits`` and always hold ``ticks_checked`` (a floor; every other
  number a ceiling); ``counter_diffs``: ``{name: [program,
  reference]}`` of the final counters that differ;
- ``merge_numbers(list_of_numbers)``: the ranks' ``numbers`` as one;
- ``stretches``: the traced stretches the system runs under ``--trace
  1``, in order, after the runner's own (``trace_ticks`` graphed ticks
  under the profiler): each ``(ticker, cfg, device, scratch) -> dict``,
  merged into the run for the readers;
- ``small(cfg, traffic) -> (cfg, traffic)``: the sizes a CPU test run
  holds, every width as configured;
- ``sample_trace(cfg) -> (record, expected)``: a made-up stand-in for
  what only the card gives a ``--trace 1`` run of this system: the
  entries its ``stretches`` add to the run, and under ``graphed`` a
  ``kernels`` dict of its kernels' durations (added to the runner's
  own); ``expected`` maps each per-layer metric whose value a CPU test
  pins to that value.  Like ``small``, it serves the harness's own
  tests only.

A ``System`` offers a tick with ``step(*args)`` (no synchronize), reads
its counters with ``counters()`` and a tick's outputs with
``outputs(out)`` (both on the host, in the reference's names), holds
``shards`` of the run's shards from ``first_shard`` (0 if absent), and
frees itself with ``close()``.
"""
